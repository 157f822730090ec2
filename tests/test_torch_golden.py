"""The port's golden command-line runs (hgtpu_torch.devel.golden, the
twin of devel/integration_test.py) equal hgtpu's goldens on the CPU.

  test database   hgtpu_torch.devel.testdb writes the files hgtpu's
                  devel/make_testdb.py writes, byte for byte, each into
                  its own directory.
  golden runs     each of the five configurations, as `python -m
                  hgtpu_torch` subprocesses with HGTPU_TORCH_DEVICE=cpu,
                  once with "--device-typing auto" (the host engine on
                  the CPU) and once with "on" (the production path for
                  hg_test1 and 2; the host engine for the assembly and
                  real-read runs): every marker check passes, the path
                  taken is the one expected, and every report, and
                  hg_test3's .fasta, equals devel/expected/ after
                  normalize.
"""
import importlib.util
import os

import pytest

from hgtpu_torch.devel import golden, testdb
from tests.torch_threads import _torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def test_testdb_equals_hgtpus(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "make_testdb", os.path.join(ROOT, "devel", "make_testdb.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(str(tmp_path / "hgtpu"))
    testdb.main(str(tmp_path / "port"))
    want = _files(tmp_path / "hgtpu")
    assert len(want) >= 9 and "hla.snp" in want
    assert _files(tmp_path / "port") == want


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return testdb.ensure(str(tmp_path_factory.mktemp("testdb")))


@pytest.mark.parametrize("mode", ["auto", "on"])
@pytest.mark.parametrize("name", golden.CONFIGS)
def test_golden_run_equals_expected(db, tmp_path, name, mode):
    g = golden.Golden(db, str(tmp_path), device_typing=mode, device="cpu")
    g.run(name)
    assert g.failures == []
    st = g.stats[name]
    want = "production" if mode == "on" and name in golden.PRODUCTION \
        else "host engine"
    assert st["path"] == want
    # the run stats came back: no hand kernel launches on the CPU
    assert set(st["launches"].values()) == {0}
