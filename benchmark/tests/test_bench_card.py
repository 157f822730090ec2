"""A cell as the driver runs it, on the card (marked cuda: skips without
one).  On the chip: python -m pytest benchmark/tests/test_bench_card.py"""
import json
import os
import subprocess
import sys

import pytest

import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    proc = subprocess.run(
        [sys.executable, os.path.join(tiny.BENCH, "run.py"), "--workload",
         "hla-a.wgs30", "--seed", str(2 ** 31 + 5), "--seconds", "3",
         "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=tiny.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["compared"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
    assert list(out)[-1] == "compared"
