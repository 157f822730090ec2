# Copy of hgtpu/sim/simulator.py.
"""Read simulator with truth-encoded read names.

Port of the reference's simulate_reads / simulate_reads_impl / get_info
(hisatgenotype_typing_common.py:696-982).  Reads are tiled every
`simulate_interval` bp along each chosen allele; read names encode the true
backbone alignment, CIGAR and variant list, e.g.::

    12|L_483_61M5D38M_46|S|hv154,3|D|hv185

i.e. "<index>|<L/R>_<1-based backbone pos>_<CIGAR>[_<var events>]", the
oracle every alignment/typing test checks against.
"""
from __future__ import annotations

import dataclasses
import random as _random

from ..db.catalog import GeneRef, VT_SINGLE, VT_DELETION, VT_INSERTION
from ..utils.dna import revcomp


@dataclasses.dataclass
class SimRead:
    name: str          # "<i>|<L/R>_<info>"
    seq: str


def _annotated_allele(ref: GeneRef, allele_name: str):
    """Annotated allele sequence w.r.t the backbone.

    Ref: typing_common.py:884-938.  ex_seq is the backbone with the
    allele's variants applied where deleted backbone positions become 'D',
    inserted positions become 'I' and SNP positions carry the alternative
    base; ex_desc labels every variant-derived position with its var id.
    Returns (allele_seq, seq_map, ex_seq_map, ex_seq, ex_desc) where
    seq_map maps allele coords -> backbone coords and ex_seq_map maps
    allele coords -> annotated coords.
    """
    ex_seq = list(ref.backbone)
    ex_desc = [""] * len(ex_seq)
    add = 0
    for vi in ref.allele_var_indices(allele_name):
        vt = int(ref.var_type[vi])
        pos = int(ref.var_pos[vi]) + add
        vid = ref.var_ids[vi]
        if vt == VT_SINGLE:
            ex_seq[pos] = ref.var_data[vi]
            ex_desc[pos] = vid
        elif vt == VT_DELETION:
            dlen = int(ref.var_len[vi])
            ex_seq[pos:pos + dlen] = ["D"] * dlen
            ex_desc[pos:pos + dlen] = [vid] * dlen
        else:
            ilen = int(ref.var_len[vi])
            ex_seq[pos:pos] = ["I"] * ilen
            ex_desc[pos:pos] = [vid] * ilen
            add += ilen
    ex_seq = "".join(ex_seq)

    allele_seq = ref.allele_seq(allele_name)
    seq_map = [0] * len(allele_seq)
    ex_seq_map = [0] * len(allele_seq)
    prev_j = 0
    minus_pos = 0
    for i in range(len(allele_seq)):
        j = prev_j
        while j < len(ex_seq):
            if ex_seq[j] != "D":
                if ex_seq[j] == "I":
                    minus_pos += 1
                break
            j += 1
        seq_map[i] = j - minus_pos
        ex_seq_map[i] = j
        prev_j = j + 1
    return allele_seq, seq_map, ex_seq_map, ex_seq, ex_desc


def _get_info(read_seq, pos, read_len, seq_map, ex_seq_map, ex_seq, ex_desc):
    """Truth string for one read.  Ref: get_info (typing_common.py:782-843)."""
    info = "%d_" % (seq_map[pos] + 1)
    match = 0
    sub_match = 0
    var_str = ""
    ins_var = ""
    for i in range(pos, pos + read_len):
        map_i = ex_seq_map[i]
        assert ex_seq[map_i] != "D"
        match += 1
        if ex_seq[map_i] == "I":
            if ins_var != "":
                assert ins_var == ex_desc[map_i]
            ins_var = ex_desc[map_i]
        elif ins_var != "":
            if var_str != "":
                var_str += ","
            var_str += "%s|I|%s" % (sub_match, ins_var)
            ins_var = ""
            sub_match = 0

        if ex_seq[map_i] != "I":
            if ex_desc[map_i] != "" or read_seq[i - pos] != ex_seq[map_i]:
                if var_str != "":
                    var_str += ","
                if ex_desc[map_i] != "":
                    var_str += "%d|S|%s" % (sub_match, ex_desc[map_i])
                else:
                    var_str += "unknown"
                sub_match = 0
            else:
                sub_match += 1

        if i + 1 < pos + read_len and ex_seq[map_i + 1] == "D":
            assert match > 0
            info += "%dM" % match
            match = 0
            del_len = 1
            while map_i + 1 + del_len < len(ex_seq):
                if ex_seq[map_i + 1 + del_len] != "D":
                    break
                del_len += 1
            info += "%dD" % del_len
            if var_str != "":
                var_str += ","
            var_str += "%s|D|%s" % (sub_match, ex_desc[map_i + 1])
            sub_match = 0

    assert match > 0
    info += "%dM" % match
    if var_str:
        info += "_" + var_str
    return info


def _introduce_errors(seq, rate, rng):
    """Per-base error injection (ref: introduce_seq_err, :758-778 —
    variant-covered positions are exempt there; we inject anywhere and let
    tests use rate=0 for exact oracles)."""
    out = list(seq)
    for i in range(len(out)):
        if rng.random() * 100 < rate:
            alts = [b for b in "ACGT" if b != out[i]]
            rng.shuffle(alts)
            out[i] = alts[0]
    return "".join(out)


def simulate_reads(
    ref: GeneRef,
    allele_names,
    simulate_interval: int = 1,
    read_len: int = 100,
    frag_len: int = 250,
    perbase_errorrate: float = 0.0,
    perbase_snprate: float = 0.0,
    skip_fragment_regions=(),
    seed=None,
):
    """Simulate tiled paired reads from the given alleles of one gene.

    Returns (reads_1, reads_2, num_pairs_per_allele); reads_2 are
    reverse-complemented, truth info is always in forward orientation.
    Ref: simulate_reads (typing_common.py:696-982).
    """
    rng = _random.Random(seed)
    reads_1 = []
    reads_2 = []
    num_pairs = []
    for allele_name in allele_names:
        (allele_seq, seq_map, ex_seq_map,
         ex_seq, ex_desc) = _annotated_allele(ref, allele_name)
        if perbase_snprate > 0:
            # germline SNPs mutate the allele once, so every read drawn
            # from the region carries them consistently (they surface as
            # novel variants downstream) — ref introduce_snps,
            # typing_common.py:726-745, applied at :889-890
            chars = list(allele_seq)
            for j, c in enumerate(chars):
                if c in "ACGT" and rng.random() * 100 < perbase_snprate:
                    chars[j] = rng.choice("ACGT".replace(c, ""))
            allele_seq = "".join(chars)
        cnt = 0
        for i in range(0, len(allele_seq) - frag_len + 1, simulate_interval):
            skip = False
            for sl, sr in skip_fragment_regions:
                if i <= sr and i + frag_len > sl:
                    skip = True
                    break
            if skip:
                continue
            pos1 = i
            seq1 = allele_seq[pos1:pos1 + read_len]
            if perbase_errorrate > 0:
                seq1 = _introduce_errors(seq1, perbase_errorrate, rng)
            info1 = _get_info(seq1, pos1, read_len, seq_map, ex_seq_map,
                              ex_seq, ex_desc)
            reads_1.append((seq1, info1))
            pos2 = i + frag_len - read_len
            seq2 = allele_seq[pos2:pos2 + read_len]
            if perbase_errorrate > 0:
                seq2 = _introduce_errors(seq2, perbase_errorrate, rng)
            info2 = _get_info(seq2, pos2, read_len, seq_map, ex_seq_map,
                              ex_seq, ex_desc)
            reads_2.append((revcomp(seq2), info2))
            cnt += 1
        num_pairs.append(cnt)

    out_1 = [SimRead(name="%d|L_%s" % (k + 1, info)[:251], seq=s)
             for k, (s, info) in enumerate(reads_1)]
    out_2 = [SimRead(name="%d|R_%s" % (k + 1, info)[:251], seq=s)
             for k, (s, info) in enumerate(reads_2)]
    return out_1, out_2, num_pairs


def parse_truth_name(name: str):
    """Decode a truth-encoded read name.

    Returns dict(index, mate, pos (0-based backbone), cigar,
    vars=[var ids], has_unknown).
    """
    head, info = name.split("_", 1)
    idx, mate = head.split("|")
    parts = info.split("_")
    pos = int(parts[0]) - 1
    cigar = parts[1]
    vids = []
    has_unknown = False
    if len(parts) > 2:
        for ev in parts[2].split(","):
            if ev == "unknown":
                has_unknown = True
                continue
            _sub, _t, vid = ev.split("|")
            vids.append(vid)
    return dict(index=int(idx), mate=mate, pos=pos, cigar=cigar,
                vars=vids, has_unknown=has_unknown)


def write_fasta(reads, path):
    with open(path, "w") as f:
        for r in reads:
            print(">%s" % r.name, file=f)
            print(r.seq, file=f)
