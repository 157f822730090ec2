# Copy of hgtpu/utils/bam.py.
"""Pure-Python BAM I/O (BGZF container + BAM record codec).

The reference shells out to `samtools view/index` for every BAM
operation (hisatgenotype:114-241, typing_common.py:1038-1056).  This
module replaces that process boundary with an in-process reader/writer:

- BGZF is a sequence of gzip members with a BC/BSIZE extra subfield;
  Python's gzip module reads multi-member streams transparently, so
  reading needs no special casing.  Writing emits spec-compliant BGZF
  blocks (<= 64 KiB payload, BSIZE extra field, 28-byte EOF marker) so
  produced files interoperate with samtools/pysam.
- Region queries run as a linear scan with a refID/coordinate filter
  (no .bai index; locus slices are small relative to scan cost here).

`reads_from_bam` mirrors the reference's extraction semantics
(hisatgenotype:127-241): group records by read name, require an NH==1
record in the group, reverse-complement reverse-strand mates back to
original orientation — without the reference's loop-exit bug that
drops all but the final read group.
"""
from __future__ import annotations

import gzip
import struct
import zlib

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NT = "=ACMGRSVTWYHKDBN"
_NT_CODE = {c: i for i, c in enumerate(_SEQ_NT)}
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


# --------------------------------------------------------------------- #
# BGZF writer
# --------------------------------------------------------------------- #
class BgzfWriter:
    """Writes BGZF blocks: gzip members carrying a BSIZE extra field."""

    MAX_PAYLOAD = 0xFF00  # samtools convention: leave header room

    def __init__(self, path):
        self._f = open(path, "wb")
        self._buf = bytearray()

    def write(self, data: bytes):
        self._buf += data
        while len(self._buf) >= self.MAX_PAYLOAD:
            self._flush_block(self._buf[: self.MAX_PAYLOAD])
            del self._buf[: self.MAX_PAYLOAD]

    def _flush_block(self, payload: bytes):
        payload = bytes(payload)
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
        bsize = len(comp) + 25 + 1  # header(12)+extra(6)+footer(8) - 1
        block = (b"\x1f\x8b\x08\x04" + b"\x00" * 6
                 + struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize)
                 + comp
                 + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                               len(payload)))
        self._f.write(block)

    def close(self):
        if self._buf:
            self._flush_block(self._buf)
            self._buf = bytearray()
        self._f.write(_BGZF_EOF)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------- #
# record codec
# --------------------------------------------------------------------- #
def _encode_record(rec, ref_ids):
    name = rec["name"].encode() + b"\x00"
    cigar = rec.get("cigar") or []
    seq = rec.get("seq", "")
    qual = rec.get("qual", "")
    l_seq = len(seq)
    packed = bytearray((l_seq + 1) // 2)
    for i, c in enumerate(seq):
        code = _NT_CODE.get(c.upper(), 15)
        packed[i // 2] |= code << (4 if i % 2 == 0 else 0)
    q = bytes((min(93, ord(c) - 33) for c in qual)) if qual \
        else b"\xff" * l_seq
    refid = ref_ids.get(rec.get("rname", "*"), -1)
    nrefid = ref_ids.get(rec.get("rnext", "*"), -1)
    pos = rec.get("pos", -1)
    body = struct.pack(
        "<iiBBHHHiiii", refid, pos, len(name),
        rec.get("mapq", 0), rec.get("bin", 0), len(cigar),
        rec.get("flag", 0), l_seq, nrefid, rec.get("pnext", -1),
        rec.get("tlen", 0))
    body += name
    for op, ln in cigar:
        body += struct.pack("<I", (ln << 4) | _CIGAR_OPS.index(op))
    body += bytes(packed) + q
    for tag, (ttype, val) in rec.get("tags", {}).items():
        body += tag.encode() + ttype.encode()
        if ttype == "i":
            body += struct.pack("<i", val)
        elif ttype == "A":
            body += val.encode()
        elif ttype == "f":
            body += struct.pack("<f", val)
        elif ttype == "Z":
            body += val.encode() + b"\x00"
        else:
            raise ValueError("unsupported tag type %r" % ttype)
    return struct.pack("<i", len(body)) + body


def write_bam(path, refs, records, header_text=""):
    """refs: [(name, length)]; records: dicts as produced by read_bam
    (pos 0-based; cigar [(op, len)]; tags {tag: (type, value)})."""
    ref_ids = {name: i for i, (name, _l) in enumerate(refs)}
    with BgzfWriter(path) as w:
        text = header_text.encode()
        w.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
        w.write(struct.pack("<i", len(refs)))
        for name, length in refs:
            nm = name.encode() + b"\x00"
            w.write(struct.pack("<i", len(nm)) + nm
                    + struct.pack("<i", length))
        for rec in records:
            w.write(_encode_record(rec, ref_ids))


def _parse_tags(buf):
    tags = {}
    i = 0
    n = len(buf)
    while i + 3 <= n:
        tag = buf[i:i + 2].decode()
        t = chr(buf[i + 2])
        i += 3
        if t in "cC":
            val = struct.unpack_from("<b" if t == "c" else "<B", buf, i)[0]
            i += 1
            t = "i"
        elif t in "sS":
            val = struct.unpack_from("<h" if t == "s" else "<H", buf, i)[0]
            i += 2
            t = "i"
        elif t in "iI":
            val = struct.unpack_from("<i" if t == "i" else "<I", buf, i)[0]
            i += 4
            t = "i"
        elif t == "f":
            val = struct.unpack_from("<f", buf, i)[0]
            i += 4
        elif t == "A":
            val = chr(buf[i])
            i += 1
        elif t in "ZH":
            end = buf.index(b"\x00", i)
            val = buf[i:end].decode()
            i = end + 1
        elif t == "B":
            sub = chr(buf[i])
            cnt = struct.unpack_from("<I", buf, i + 1)[0]
            size = {"c": 1, "C": 1, "s": 2, "S": 2,
                    "i": 4, "I": 4, "f": 4}[sub]
            fmt = "<%d%s" % (cnt, sub if sub != "f" else "f")
            val = list(struct.unpack_from(fmt, buf, i + 5))
            i += 5 + cnt * size
        else:
            raise ValueError("unknown tag type %r" % t)
        tags[tag] = (t, val)
    return tags


def read_bam(path, region=None):
    """Yield BAM records as dicts.  region: (rname, left, right) keeps
    records whose [pos, end) overlaps the 0-based inclusive range —
    the `samtools view bam chr:l-r` equivalent, by linear scan."""
    with gzip.open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"BAM\x01":
            raise ValueError("%s is not a BAM file" % path)
        (l_text,) = struct.unpack("<i", f.read(4))
        f.read(l_text)
        (n_ref,) = struct.unpack("<i", f.read(4))
        refs = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", f.read(4))
            name = f.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", f.read(4))
            refs.append((name, l_ref))
        want_ref = None
        if region is not None:
            names = [n for n, _l in refs]
            want_ref = names.index(region[0]) if region[0] in names else -2
        while True:
            head = f.read(4)
            if len(head) < 4:
                break
            (block,) = struct.unpack("<i", head)
            buf = f.read(block)
            (refid, pos, l_name, mapq, bin_, n_cigar, flag, l_seq,
             nrefid, pnext, tlen) = struct.unpack_from("<iiBBHHHiiii", buf)
            off = 32
            name = buf[off:off + l_name - 1].decode()
            off += l_name
            cigar = []
            ref_span = 0
            for k in range(n_cigar):
                (v,) = struct.unpack_from("<I", buf, off + 4 * k)
                op = _CIGAR_OPS[v & 0xF]
                ln = v >> 4
                cigar.append((op, ln))
                if op in "MDN=X":
                    ref_span += ln
            off += 4 * n_cigar
            if want_ref is not None and (
                    refid != want_ref or pos > region[2]
                    or pos + max(ref_span, 1) <= region[1]):
                continue
            seq = "".join(
                _SEQ_NT[(buf[off + i // 2] >> (4 if i % 2 == 0 else 0))
                        & 0xF]
                for i in range(l_seq))
            off += (l_seq + 1) // 2
            q = buf[off:off + l_seq]
            qual = "" if (l_seq and q[:1] == b"\xff") else \
                "".join(chr(c + 33) for c in q)
            off += l_seq
            yield {
                "name": name, "flag": flag,
                "rname": refs[refid][0] if refid >= 0 else "*",
                "pos": pos, "mapq": mapq, "cigar": cigar,
                "rnext": refs[nrefid][0] if nrefid >= 0 else "*",
                "pnext": pnext, "tlen": tlen, "seq": seq, "qual": qual,
                "tags": _parse_tags(buf[off:]),
            }


def reads_from_bam(path, chrom, left, right, paired=True):
    """Extract read pairs overlapping chrom:left-right (0-based incl.).

    Returns (reads_1, reads_2): [(name, seq, qual)], reverse-strand
    records reverse-complemented back to sequencer orientation, groups
    kept only when some record has NH==1 (unique mapping), as the
    reference requires (hisatgenotype:208-236).
    """
    from .dna import revcomp

    groups = {}
    for rec in read_bam(path, region=(chrom, left, right)):
        g = groups.setdefault(rec["name"], {"nh1": False, 1: None, 2: None})
        nh = rec["tags"].get("NH")
        if nh is not None and nh[1] == 1:
            g["nh1"] = True
        seq, qual = rec["seq"], rec["qual"]
        if rec["flag"] & 0x10:
            seq, qual = revcomp(seq), qual[::-1]
        mate = 2 if (paired and (rec["flag"] & 0x80)) else 1
        if g[mate] is None:
            g[mate] = (seq, qual)
    reads_1, reads_2 = [], []
    for name, g in groups.items():
        if not g["nh1"]:
            continue
        if paired:
            if g[1] is not None and g[2] is not None:
                reads_1.append((name, g[1][0], g[1][1]))
                reads_2.append((name, g[2][0], g[2][1]))
        elif g[1] is not None:
            reads_1.append((name, g[1][0], g[1][1]))
    return reads_1, reads_2
