"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

They run on the CPU at small sizes; the ones marked ``cuda`` skip
without a card.  benchmark/ goes on sys.path as the harness puts it."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(0, os.path.dirname(BENCH))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


def _load_system():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "systems_gene", os.path.join(BENCH, "systems", "gene.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules["systems_gene"] = mod


_load_system()
