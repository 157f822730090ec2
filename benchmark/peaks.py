"""The card's peaks and the kernels' work, frozen for the benchmark.

Peaks are the data sheet's for the H100 SXM at 700 W (dense, without
sparsity), keyed by the name torch.cuda.get_device_name() gives.  K1's
operations and bytes follow chip_smoke.py's bound arithmetic: the
product of one-hot reads [N, 5m] by PWM windows [5m, P1] in bf16 with
float32 sums, the codes, the PWM and the float32 scores each moved once.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bytes_s=3.35e12, bf16_s=989e12),
}


def k1_work(n: int, m: int, pwm_rows: int):
    """(operations, bytes) of one K1 launch at reads [n, m] against a PWM
    of pwm_rows rows (P1 = pwm_rows - m + 1 diagonals)."""
    p1 = pwm_rows - m + 1
    return 2.0 * n * 5 * m * p1, float(n * m + pwm_rows * 5 * 4 + n * p1 * 4)


def least_time(ops: float, nbytes: float, peak: dict) -> float:
    """Seconds the card needs at least: the larger of the operations over
    the bf16 peak and the bytes over the memory rate."""
    return max(ops / peak["bf16_s"], nbytes / peak["bytes_s"])
