# Copy of hgtpu/assemble/nodes.py, on the port's db.catalog and typer.alts.
"""Builders for assembly nodes.

- allele_node: backbone + an allele's variants as an AsmNode
  (ref: create_allele_node, typing_core.py:495-533 — insertions skipped
  there too).
- read_nodes_from_hts: reconstruct per-haplotype read realignments into
  AsmNodes (ref: typing_core.py:1408-1540).
"""
from __future__ import annotations

from ..db.catalog import GeneRef, VT_SINGLE, VT_DELETION, VT_INSERTION
from ..typer.alts import VarTable
from .graph import AsmNode


def allele_node(gene: GeneRef, allele_name: str, var_table=None):
    seq = list(gene.backbone)
    var = [""] * len(seq)
    for vi in gene.allele_var_indices(allele_name):
        vt = int(gene.var_type[vi])
        pos = int(gene.var_pos[vi])
        vid = gene.var_ids[vi]
        if vt == VT_SINGLE:
            seq[pos] = gene.var_data[vi]
            var[pos] = vid
        elif vt == VT_DELETION:
            dlen = int(gene.var_len[vi])
            seq[pos:pos + dlen] = ["D"] * dlen
            var[pos:pos + dlen] = [vid] * dlen
        # insertions skipped (ref: typing_core.py:518-520)
    return AsmNode(allele_name, 0, seq, None, var, gene.backbone,
                   var_table or VarTable(gene), None)


def cmp_list_from_ht(gene: GeneRef, var_table: VarTable, ht_str, read_seq):
    """Reconstruct a cmp list by realigning the read along one haplotype
    spelling (ref: typing_core.py:1416-1476)."""
    toks = ht_str.split("-")
    left = int(toks[0])
    vars_ = toks[1:]
    cmp_list = []
    read_pos = 0
    for var_i, vid in enumerate(vars_):
        if var_i == len(vars_) - 1:
            right = int(vid)
        else:
            vtype, vpos, vdata = var_table[vid]
            right = vpos - 1
        for pos in range(left, right + 1):
            if read_pos >= len(read_seq):
                break
            if read_seq[read_pos] != gene.backbone[pos]:
                if left < pos:
                    cmp_list.append(["match", left, pos - left])
                cmp_list.append(["mismatch", pos, 1, "unknown"])
                left = pos + 1
            read_pos += 1
        if left <= right:
            cmp_list.append(["match", left, right - left + 1])
        if var_i == len(vars_) - 1:
            break
        if vtype == "single":
            cmp_list.append(["mismatch", vpos, 1, vid])
            left = vpos + 1
            read_pos += 1
        elif vtype == "deletion":
            dlen = int(vdata)
            cmp_list.append(["deletion", vpos, dlen, vid])
            left = vpos + dlen
        else:
            ilen = len(vdata)
            cmp_list.append(["insertion", vpos, ilen, vid])
            left = vpos
            read_pos += ilen
    return cmp_list


def read_nodes_from_hts(gene: GeneRef, var_table: VarTable, node_read_id,
                        hts, read_seq, read_qual=None):
    """Build one AsmNode per haplotype spelling (ref:
    typing_core.py:1478-1540).  Returns [(node_read_id, idx, AsmNode)]."""
    out = []
    for cmp_i, ht in enumerate(sorted(hts)):
        cmp_list = cmp_list_from_ht(gene, var_table, ht, read_seq)
        if not cmp_list:
            continue
        read_pos = 0
        node_pos = -1
        node_seq = []
        node_var = []
        for entry in cmp_list:
            kind, pos, length = entry[0], entry[1], entry[2]
            vid = entry[3] if len(entry) > 3 else ""
            if kind in ("match", "mismatch") and node_pos < 0:
                node_pos = pos
            if kind == "match":
                seg = read_seq[read_pos:read_pos + length]  # clipped at end
                node_seq += list(seg)
                node_var += [""] * len(seg)
                read_pos += length
            elif kind == "mismatch":
                if read_pos >= len(read_seq):
                    break
                node_seq += [read_seq[read_pos]]
                node_var += [vid]
                read_pos += 1
            elif kind == "deletion":
                node_seq += ["D"] * length
                node_var += [vid] * length
            else:  # insertion (may be truncated by the read end)
                ins = read_seq[read_pos:read_pos + length]
                node_seq += ["I%s" % nt for nt in ins]
                node_var += [vid] * len(ins)
                read_pos += length
        if node_pos < 0:
            continue
        node = AsmNode(node_read_id, node_pos, node_seq, None, node_var,
                       gene.backbone, var_table, None)
        out.append((node_read_id, cmp_i, node))
    return out
