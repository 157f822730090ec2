"""The traffic generator: samples are a function of (seed, index)."""
import pytest

import gen
import tiny


def specs():
    return gen.catalog_specs(tiny.config())


def test_same_seed_same_sample_and_large_seeds():
    sp = specs()
    for seed in (0, 2 ** 31 + 11, 2 ** 40 + 3):
        a = gen.draw_sample(sp, tiny.MIX, seed, 5)
        b = gen.draw_sample(sp, tiny.MIX, seed, 5)
        assert a == b


def test_samples_differ_by_index_and_seed():
    sp = specs()
    seen = {repr(gen.draw_sample(sp, tiny.MIX, s, i))
            for s in (1, 2) for i in range(6)}
    assert len(seen) == 12


def test_truths_are_full_length_and_reads_tile_them():
    sp = specs()
    spec = sp["A"]
    truth, r1, r2 = gen.draw_sample(sp, tiny.MIX, 9, 0)
    a, b = truth["A"]
    assert a != b and a not in spec["partial"] and b not in spec["partial"]
    seqs = [spec["rows"][spec["names"].index(x)].replace(".", "")
            for x in (a, b)]
    assert all(len(s) == tiny.MIX["read_len"] for _, s in r1 + r2)
    for (n1, s1), (n2, s2) in zip(r1, r2):
        assert n1 == n2
        assert any(s1 in s and gen.revcomp(s2) in s for s in seqs)
    n_frag = sum((len(s) - tiny.MIX["frag_len"]) // tiny.MIX["interval"]
                 for s in seqs)
    assert abs(len(r1) - n_frag) <= 2


def test_catalog_has_the_reference_layout_and_lineages():
    import numpy as np

    cfg = tiny.config()
    spec = specs()["A"]
    names, rows = spec["names"], spec["rows"]
    assert names == sorted(names) and len(set(rows)) == len(rows)
    assert spec["ref_allele"] == "A*01:01:01:01"
    ref = rows[names.index(spec["ref_allele"])].replace(".", "")
    assert len(ref) == cfg["length"]
    assert {n.split(":")[0] for n in names} <= \
        {"A*%02d" % g for g in cfg["groups"]}
    full = [i for i, n in enumerate(names) if n not in spec["partial"]]
    part = [i for i, n in enumerate(names) if n in spec["partial"]]
    assert len(part) > len(full) > 1
    # an exon-only allele's row is the full-length consensus outside the
    # exons it is known over, and its own inside them
    mat = np.frombuffer("".join(rows).encode(), np.uint8).reshape(
        len(rows), -1)
    codes = np.frombuffer(b"ACGT.", np.uint8)
    cons = codes[np.argmax([(mat[full] == c).sum(axis=0) for c in codes],
                           axis=0)]
    ref_cols = np.flatnonzero(mat[names.index(spec["ref_allele"])] != 46)
    known = np.zeros(mat.shape[1], bool)
    for i in cfg["partial_exons"]:
        left, right = cfg["exons"][i]
        known[ref_cols[left]:ref_cols[right] + 1] = True
    assert (mat[np.ix_(part, np.flatnonzero(~known))]
            == cons[~known][None, :]).all()
    assert len({mat[i, known].tobytes() for i in part}) == len(part)


def ref_seq(spec):
    return spec["rows"][spec["names"].index(spec["ref_allele"])] \
        .replace(".", "")


def test_a_genes_own_layout_keys_override_and_missing_ones_fall_back():
    cfg = tiny.panel_config()
    sp = gen.catalog_specs(cfg)
    a, b, c = sp["A"], sp["B"], sp["C"]
    # A has no keys of its own: the top level's layout, exactly as a
    # one-gene configuration lays it out
    assert a == specs()["A"]
    assert len(ref_seq(b)) == 1400 and len(b["names"]) == 50
    assert b["exons"] == [tuple(e) for e in cfg["exons"]]
    assert {n.split(":")[0] for n in b["names"]} <= \
        {"B*%02d" % g for g in cfg["groups"]}
    assert len(ref_seq(c)) == 1300 and len(c["names"]) == 40
    assert c["exons"] == [(100, 200), (400, 600), (800, 900)]
    assert c["primary_exon_idx"] == (1,)
    # C's exon-only alleles are known over its exon 2 alone
    part = [c["rows"][c["names"].index(n)] for n in sorted(c["partial"])]
    assert part and len(set(part)) == len(part)


def share_differing(x, y):
    n = min(len(x), len(y))
    return sum(p != q for p, q in zip(x[:n], y[:n])) / n


def test_a_paralogs_backbone_differs_from_its_parents_by_its_divergence():
    for div in (0.05, 0.15, 0.3):
        sp = gen.catalog_specs(tiny.panel_config(div))
        # the reference allele carries no event: it is the backbone
        assert abs(share_differing(ref_seq(sp["A"]), ref_seq(sp["B"]))
                   - div) < 0.03
        # C, a gene of its own, shares a random sequence's 1 in 4
        assert abs(share_differing(ref_seq(sp["A"]), ref_seq(sp["C"]))
                   - 0.75) < 0.05
    import numpy as np

    parent, _ = gen.backbone(4, 1500)
    longer, _ = gen.backbone(5, 1800, parent, 0.0)
    assert (longer[:1500] == parent).all() and len(longer) == 1800
    shorter, _ = gen.backbone(5, 900, parent, 0.2)
    assert np.mean(shorter != parent[:900]) == pytest.approx(0.2, abs=1e-3)


def test_paralog_of_names_an_earlier_gene():
    cfg = tiny.panel_config()
    cfg["genes"][1]["paralog_of"] = "C"
    with pytest.raises(ValueError):
        gen.catalog_specs(cfg)
    cfg = tiny.panel_config(1.0)
    with pytest.raises(ValueError):
        gen.catalog_specs(cfg)
