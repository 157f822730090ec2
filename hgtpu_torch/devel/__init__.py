"""The port's devel runs: the twins of hgtpu's devel/ and scripts/ programs.

  testdb     the deterministic synthetic test database
             (devel/make_testdb.py)
  golden     the five golden command-line runs held against
             devel/expected/ (devel/integration_test.py)
  campaign   the randomized closed-loop regression campaign
             (devel/campaign.py)
  scaling    the sharded place and count sweep over 1, 2, 4 and 8 shards
             (scripts/scaling_bench.py)
  punts      punt and exclusion rates, causes and tiers of count_classes
             (devel/measure_punts.py)
  edges      the edge-case genes and read sets hgtpu's tests pin
             (tests/test_fuzz.py, test_haplotype_paths.py, ...), as data;
             the kernels' degenerate shapes

Each runs on the card unless asked for the CPU (``device="cpu"`` or
``HGTPU_TORCH_DEVICE=cpu``), and imports nothing of hgtpu or jax; the
synthetic generators come from tests/synth.py, which is jax-free.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def use_synth():
    """Put tests/ on sys.path for synth.py (the shared, jax-free
    synthetic MSA generators)."""
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
