"""What the hla-a-imgt cells read, pinned: the catalogue's specs, the
first samples of each mix at a fixed seed and the reference's output on
them hash as they did before the generator took per-gene layouts and
paralogs and the reference took the NH==1 drop.  The digests were
computed on the tree before those changes."""
import hashlib
import json
import os

import pytest

import gen
import reference
import tiny

SEED = 2 ** 31 + 21
SPECS = "5ebe6600c992f2bed4a1e44e55da8dc874879508243916751299e26b5d520f1c"
MIXES = {
    "wgs30": ("9a6847df60349128aad8ba7501dd2ee8bdd26e0613dbb05b3785c377c7b5eefe",
              "3ee00cb624a8286c7a01ff71c9574101cc742a66e666eb3d7462a8f85e53314b"),
    "deep": ("b5e2bdaa96f408e1ae06b250ec44b47b348f8214c9e3c4b57827bdbdc114ae6d",
             "ed2ed038c4a71de32fe241cc950b1fdd108df76d53de0cb2b407121b16184e70"),
}


def digest(obj):
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()) \
        .hexdigest()


def load(*parts):
    with open(os.path.join(tiny.BENCH, *parts)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def hla_a():
    specs = gen.catalog_specs(load("configs", "hla-a-imgt.json"))
    genes = [reference.RefGene(g, s) for g, s in specs.items()]
    return specs, genes, reference.Placer(genes)


def test_specs_are_the_parents(hla_a):
    specs, _, _ = hla_a
    assert digest({g: [s["names"], s["rows"], sorted(s["partial"]),
                       s["ref_allele"], s["exons"], s["primary_exon_idx"]]
                   for g, s in specs.items()}) == SPECS


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_samples_and_the_reference_are_the_parents(hla_a, mix):
    specs, genes, placer = hla_a
    pool = gen.Pool(specs, load("mixes", mix + ".json"), SEED)
    pool.fill(2)
    warm = gen.draw_sample(specs, load("mixes", mix + ".json"), SEED, 0,
                           salt=1)
    assert digest([pool.samples, warm]) == MIXES[mix][0]
    r1, r2 = pool.samples[0]
    out = reference.type_sample(genes, placer, r1, r2)
    # abundances to 12 significant digits: the EM's sums may round
    # differently under another BLAS
    view = {g: dict(r, prob=[[a, "%.12g" % p] for a, p in r["prob"]])
            for g, r in out.items()}
    assert digest(view) == MIXES[mix][1]
