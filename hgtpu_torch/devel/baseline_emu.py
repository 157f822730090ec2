# Twin of devel/baseline_emu.py: its emulator copied as it is (the
# reference's cost model); the SAM input aligned with the port on the
# device the caller names, and the anchor written where the caller says.
"""Measured baseline: pure-Python emulator of the reference typing hot loop.

The reference's HISAT2 binary cannot run here, but its Python typing
stage is specified precisely enough to re-create for measurement: this
module emulates the SAM-line hot loop of hisatgenotype_typing_core.py:
800-1543 — CIGAR+MD+Zs string decode (:876-1124), per-read haplotype
construction (:1370-1406), the add_count allele-set intersection algebra
(:626-677), add_stat equivalence-class accumulation (:1171-1236) — and
the dict-based SQUAREM EM of hisatgenotype_typing_common.py:1282-1410,
using the reference's data shapes (Links dict of allele-name lists,
Gene_Vars dict, sorted (pos, id) variant list, string class keys).

Run on the SAME synthetic reads hgtpu_torch.devel.bench measures, it
gives that bench an anchor measured on the bench's own host.  The
emulator is GENEROUS to the reference: alignment (C++ hisat2), mpileup
error correction, alternative-haplotype trimming and assembly are all
skipped, so the real reference pipeline would be strictly slower than
this anchor.  The emulator itself runs on the host CPU; only the SAM
input (simulate, then align with the port's GeneAligner: not timed) uses
the device.

    python -m hgtpu_torch.devel.baseline_emu [--out PATH]

writes hgtpu_torch/devel/out/BASELINE_MEASURED.json by default (never the
repository's BASELINE_MEASURED.json, which a 2-CPU VM measured) and
prints it.  The alignment runs on the card unless HGTPU_TORCH_DEVICE
names another device (`HGTPU_TORCH_DEVICE=cpu`).
"""
import argparse
import json
import math
import os
import platform
import sys
import time

from . import HERE

OUT = os.path.join(HERE, "out", "BASELINE_MEASURED.json")



# --------------------------------------------------------------------- #
# Reference-shaped gene tables (typing_core.py:2417-2443 load these from
# the text DB files; here they come from the compiled GeneRef)
# --------------------------------------------------------------------- #

def reference_tables(ref):
    import numpy as np

    type_names = {0: "single", 1: "deletion", 2: "insertion"}
    gene_vars = {}
    links = {}
    var_list = []
    for vi in range(ref.n_vars):
        vid = ref.var_ids[vi]
        gene_vars[vid] = (type_names[int(ref.var_type[vi])],
                          int(ref.var_pos[vi]), ref.var_data[vi])
        links[vid] = [ref.allele_names[a]
                      for a in np.flatnonzero(ref.links[vi])]
        var_list.append((int(ref.var_pos[vi]), vid))
    var_list.sort()
    # gene_var_maxrights: running max of var right ends in position order
    # (typing_core.py:504-521 builds this for the add_count early break)
    maxrights = {}
    mr = -1
    for pos, vid in var_list:
        t, p, d = gene_vars[vid]
        right = p + int(d) - 1 if t == "deletion" else p
        mr = max(mr, right)
        maxrights[vid] = mr
    return gene_vars, links, var_list, maxrights


# --------------------------------------------------------------------- #
# The emulated hot loop
# --------------------------------------------------------------------- #

def _decode_sam_line(line, gene_vars):
    """CIGAR+MD+Zs string decode -> list of var ids + span, the way the
    reference walks it (typing_core.py:876-1124): pure string/dict ops."""
    cols = line.rstrip("\n").split("\t")
    flag = int(cols[1])
    if flag & 0x4:
        return None
    pos = int(cols[3]) - 1
    cigar_str = cols[5]
    read_seq = cols[9]
    md, zs, nm = "", "", 0
    for col in cols[11:]:
        if col.startswith("MD:Z:"):
            md = col[5:]
        elif col.startswith("Zs:Z:"):
            zs = col[5:]
        elif col.startswith("NM:i:"):
            nm = int(col[5:])

    # CIGAR tokenize (the reference's manual digit walk, :869-875)
    cigars = []
    num = 0
    for ch in cigar_str:
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            cigars.append((ch, num))
            num = 0

    # Zs events (offset|type|var_id)
    zs_list = []
    if zs:
        for ev in zs.split(","):
            off, typ, vid = ev.split("|")
            zs_list.append([int(off), typ, vid])
    zs_i, zs_pos = 0, (zs_list[0][0] if zs_list else -1)

    # MD tokenize
    md_str_pos = 0

    def md_match_len():
        nonlocal md_str_pos
        n = 0
        while md_str_pos < len(md) and md[md_str_pos].isdigit():
            n = n * 10 + int(md[md_str_pos])
            md_str_pos += 1
        return n

    vars_used = []
    read_pos = 0
    right_pos = pos
    md_run = md_match_len()
    for op, length in cigars:
        if op == "M":
            left = length
            while left > 0:
                if md_run >= left:
                    md_run -= left
                    read_pos += left
                    right_pos += left
                    left = 0
                    break
                read_pos += md_run
                right_pos += md_run
                left -= md_run
                md_run = 0
                # mismatch: skip the ref base char in MD
                if md_str_pos < len(md) and md[md_str_pos].isalpha():
                    md_str_pos += 1
                if zs_i < len(zs_list) and read_pos == zs_pos \
                        and zs_list[zs_i][1] == "S":
                    vars_used.append(zs_list[zs_i][2])
                    zs_i += 1
                    if zs_i < len(zs_list):
                        zs_pos += 1 + zs_list[zs_i][0]
                read_pos += 1
                right_pos += 1
                left -= 1
                md_run = md_match_len()
        elif op == "D":
            if md_str_pos < len(md) and md[md_str_pos] == "^":
                md_str_pos += 1
                while md_str_pos < len(md) and md[md_str_pos].isalpha():
                    md_str_pos += 1
            if zs_i < len(zs_list) and read_pos == zs_pos \
                    and zs_list[zs_i][1] == "D":
                vars_used.append(zs_list[zs_i][2])
                zs_i += 1
                if zs_i < len(zs_list):
                    zs_pos += zs_list[zs_i][0]
            right_pos += length
            md_run = md_match_len()
        elif op == "I":
            if zs_i < len(zs_list) and read_pos == zs_pos \
                    and zs_list[zs_i][1] == "I":
                vars_used.append(zs_list[zs_i][2])
                zs_i += 1
                if zs_i < len(zs_list):
                    zs_pos += length + zs_list[zs_i][0]
            read_pos += length
        elif op == "S":
            read_pos += length
        elif op == "N":
            right_pos += length
    qname = cols[0]
    return qname, pos, right_pos - 1, vars_used, nm, len(read_seq)


def emulate_typing(sam_lines, allele_names, ref_allele, gene_vars, links,
                   var_list, maxrights, num_editdist=2):
    """The reference per-read loop + EM.  Returns (Gene_prob, counts,
    n_reads) — abundance list sorted desc, per-allele counts."""
    all_alleles = set(allele_names) - {ref_allele}
    allele_set_cache = {vid: set(v) for vid, v in links.items()}

    def lower_bound(lst, pos):
        lo, hi = 0, len(lst)
        while lo < hi:
            mid = (lo + hi) // 2
            if lst[mid][0] < pos:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def add_count(count_per_read, ht):
        # typing_core.py:626-677: intersect Links over the ht's vars,
        # subtract alleles carrying extra in-range vars, bump survivors
        toks = ht.split("-")
        left, right = int(toks[0]), int(toks[-1])
        mid = toks[1:-1]
        alleles = set(all_alleles)
        for vid in mid:
            if vid.startswith("nv") or vid not in links:
                continue
            alleles &= allele_set_cache[vid]
        mid_set = set(mid)
        tmp = set()
        vi = min(lower_bound(var_list, right + 1), len(var_list) - 1)
        while vi >= 0:
            _, vid = var_list[vi]
            if vid.startswith("nv") or vid in mid_set or vid not in links:
                vi -= 1
                continue
            if vid in maxrights and maxrights[vid] < left:
                break
            vtype, vleft, vdata = gene_vars[vid]
            vright = vleft + int(vdata) - 1 if vtype == "deletion" else vleft
            if (left <= vleft <= right) or (left <= vright <= right):
                tmp |= allele_set_cache[vid]
            vi -= 1
        alleles -= tmp
        alleles &= set(count_per_read.keys())
        for allele in alleles:
            count_per_read[allele] += 1

    def add_stat(Gene_cmpt, Gene_cnts, count_per_read):
        # typing_core.py:1171-1236: alleles at max count form the class
        max_count = max(count_per_read.values())
        if max_count <= 0:
            return
        cur = [a for a, c in count_per_read.items() if c == max_count]
        cur.sort()
        key = "-".join(cur)
        Gene_cmpt[key] = Gene_cmpt.get(key, 0) + 1
        for a in cur:
            Gene_cnts[a] = Gene_cnts.get(a, 0) + 1

    Gene_cmpt, Gene_cnts = {}, {}
    prev_qname = None
    positive_hts = set()
    n_reads = 0

    def flush():
        if not positive_hts:
            return
        count_per_read = {a: 0 for a in all_alleles}
        for ht in sorted(positive_hts):
            add_count(count_per_read, ht)
        add_stat(Gene_cmpt, Gene_cnts, count_per_read)

    for line in sam_lines:
        if line.startswith("@"):
            continue
        dec = _decode_sam_line(line, gene_vars)
        if dec is None:
            continue
        qname, left, right, vars_used, nm, _rl = dec
        if nm > num_editdist:
            continue
        n_reads += 1
        base = qname.split("|")[0]
        if base != prev_qname:
            flush()
            positive_hts = set()
            prev_qname = base
        positive_hts.add("-".join([str(left)] + vars_used + [str(right)]))
    flush()

    prob = single_abundance_emu(Gene_cmpt)
    return prob, Gene_cnts, n_reads


def single_abundance_emu(Gene_cmpt, remove_low=False):
    """Dict-shaped SQUAREM EM exactly as typing_common.py:1282-1410."""
    def normalize(prob):
        total = sum(prob.values())
        if total > 0:
            for a in prob:
                prob[a] /= total

    def next_prob(cmpt, prob):
        nxt = {}
        for cls, count in cmpt.items():
            alleles = cls.split("-")
            denom = 0.0
            for a in alleles:
                denom += prob.get(a, 0.0)
            if denom <= 0.0:
                continue
            for a in alleles:
                if a in prob:
                    nxt[a] = nxt.get(a, 0.0) + count * prob[a] / denom
        normalize(nxt)
        return nxt

    prob = {}
    for cls, count in Gene_cmpt.items():
        alleles = cls.split("-")
        for a in alleles:
            prob[a] = prob.get(a, 0.0) + float(count) / len(alleles)
    normalize(prob)
    diff, it = 1.0, 0
    while diff > 0.0001 and it < 1000:
        p1 = next_prob(Gene_cmpt, prob)
        p2 = next_prob(Gene_cmpt, p1)
        ssq_r = ssq_v = 0.0
        pr, pv = {}, {}
        for a in prob:
            pr[a] = p1.get(a, 0.0) - prob[a]
            ssq_r += pr[a] * pr[a]
            pv[a] = p2.get(a, 0.0) - p1.get(a, 0.0) - pr[a]
            ssq_v += pv[a] * pv[a]
        if ssq_v > 0.0:
            gamma = -math.sqrt(ssq_r / ssq_v)
            nxt2 = {a: max(0.0, prob[a] - 2 * gamma * pr[a]
                           + gamma * gamma * pv[a]) for a in prob}
            p1 = next_prob(Gene_cmpt, nxt2)
        diff = sum(abs(p1.get(a, 0.0) - prob.get(a, 0.0))
                   for a in set(prob) | set(p1))
        prob = p1
        it += 1
    normalize(prob)
    return sorted(prob.items(), key=lambda kv: kv[1], reverse=True)




# --------------------------------------------------------------------- #
# Measurement
# --------------------------------------------------------------------- #

def _sam_lines_for(ref, alleles, interval, seed=None, device=None):
    """Simulate + align with the port on `device` (stand-in for the
    missing hisat2 binary; NOT timed), emit reference-format SAM lines."""
    import tempfile

    from ..align import GeneAligner
    from ..align.sam import write_sam
    from ..sim import simulate_reads

    kw = {"seed": seed} if seed is not None else {}
    r1, r2, _ = simulate_reads(ref, alleles, simulate_interval=interval,
                               **kw)
    aligner = GeneAligner(ref, device=device)
    out1, out2 = aligner.align_batches([
        ([r.name for r in r1], [r.seq for r in r1], "L"),
        ([r.name for r in r2], [r.seq for r in r2], "R")])
    by_read = {}
    for r, a in zip(r1 + r2, out1 + out2):
        if a is not None:
            by_read.setdefault(r.name.split("|")[0], []).append(a)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "emu.sam")
        write_sam(path, ref, sorted(by_read.items()))
        with open(path) as f:
            lines = f.read().splitlines()
    n_reads = len(r1) + len(r2)
    return lines, n_reads


def measure(ref, alleles, interval, seed=None, repeats=3, device=None):
    lines, n_reads = _sam_lines_for(ref, alleles, interval, seed, device)
    tables = reference_tables(ref)
    ref_allele = ref.backbone_name.split("*")[0] + "*BACKBONE"
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        prob, cnts, n_used = emulate_typing(
            lines, ref.allele_names, ref_allele, *tables)
        dt = time.perf_counter() - t0
        if best is None or dt < best[0]:
            best = (dt, prob, n_used)
    dt, prob, n_used = best
    top = prob[0][0] if prob else None
    return {"reads": n_reads, "reads_used": n_used,
            "seconds": round(dt, 3),
            "reads_per_s": round(n_reads / dt, 1),
            "top_call": top}


def measure_all(device=None):
    """The anchor: the emulator on the bench's toy (60 alleles / 3 kb,
    4 truths, best of 3) and scale read sets (3,600 alleles / 3.5 kb, the
    heterozygous pair at seed 1, one run), aligned on `device`."""
    from ..cli.main import pick_device
    from .bench import SCALE, TOY, _build, scale_truths

    device = pick_device(device)
    out = {"host": platform.node(),
           "cpu_count": os.cpu_count(),
           "note": "pure-Python emulator of the reference typing hot loop "
                   "(typing_core.py:800-1543 decode + add_count/add_stat + "
                   "SQUAREM EM); alignment, error correction, alt trimming "
                   "and assembly omitted, so the real reference is slower "
                   "than these numbers."}
    ref = _build("A", *TOY)
    print("[emu] measuring toy (60 alleles / 3 kb)", file=sys.stderr)
    out["toy"] = measure(ref, ref.allele_names[:4], 1, device=device)
    print("[emu] toy: %s" % out["toy"], file=sys.stderr)

    big = _build("A", *SCALE, scale=True)
    print("[emu] measuring scale (3,600 alleles / 3.5 kb)", file=sys.stderr)
    # production regime: a heterozygous truth pair at full simulation
    # depth (~13k reads) — the read set the bench measures on
    out["scale"] = measure(big, scale_truths(big), 1, seed=1, repeats=1,
                           device=device)
    print("[emu] scale: %s" % out["scale"], file=sys.stderr)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="hgtpu_torch.devel.baseline_emu")
    p.add_argument("--out", default=OUT,
                   help="where to write the anchor (default %(default)s)")
    args = p.parse_args(argv)
    out = measure_all()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("[emu] wrote %s" % args.out, file=sys.stderr)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
