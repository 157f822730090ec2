"""K1 — all-diagonal placement scores as a hand-written CUDA kernel.

Replaces hgtpu/ops/placement_pallas.py:placement_scores_pallas (through
its wrapper correlate_scores_pallas), which computed the scores as a
tiled bf16 matmul of one-hot reads [N, m*5] by backbone windows
[m*5, P1] on the MXU:

    score[n, p] = sum_{j < m} pwm_ext[p + j, reads[n, j]]

Source: ``hgtpu_torch/csrc/placement_scores.cu``.  The kernel keeps the
MXU's arithmetic on Hopper's tensor cores (wgmma, bf16 operands, float32
sums): the one-hot operand is built in registers from the codes, and the
window operand is one small Hankel tile of the PWM per base in shared
memory.  No cuBLAS, no ``torch.matmul``.  Entries of the PWM are rounded
through bf16 as the Pallas operands were, and codes outside [0, 5) score
0 as an all-zero one-hot row did, so the kernel and
``placement_scores_plain`` agree exactly with hgtpu's ``correlate_scores``
for 0/1 PWMs.

``placement_scores`` takes the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.  With no read (N = 0), a
read width of 0 or no diagonal (P1 = 0: one PWM row fewer than the read
width, where hgtpu's product is [N, 0]) there is nothing to compute: it
returns the zero scores, launches nothing and counts no launch; the C
launcher refuses those shapes.  The kernel reads the
codes in 16-byte copies along rows of 16-code chunks: a read width m
that is not a multiple of 16 is padded with code 5 (scores 0) and the PWM
with as many zero rows, and codes whose base address is not 16-byte
aligned are copied first (``k16_operands``).
"""
from __future__ import annotations

import torch

from . import count_launch, cuda_lib

_PAD_CODE = 5      # outside [0, 5): scores 0 against any PWM column


def _check(pwm_ext, reads):
    if pwm_ext.device != reads.device:
        raise ValueError("pwm_ext on %s, reads on %s"
                         % (pwm_ext.device, reads.device))
    if pwm_ext.dtype != torch.float32 or reads.dtype != torch.int8:
        raise TypeError("want float32 pwm_ext and int8 reads, got %s, %s"
                        % (pwm_ext.dtype, reads.dtype))
    if pwm_ext.dim() != 2 or pwm_ext.shape[1] != 5 or reads.dim() != 2:
        raise ValueError("want pwm_ext [P+2m, 5] and reads [N, m], got %s, %s"
                         % (tuple(pwm_ext.shape), tuple(reads.shape)))
    if pwm_ext.shape[0] < reads.shape[1] - 1:
        raise ValueError("pwm_ext has fewer rows than the read width less "
                         "one")
    if not (pwm_ext.is_contiguous() and reads.is_contiguous()):
        raise ValueError("pwm_ext and reads must be contiguous")


def placement_scores_plain(pwm_ext: torch.Tensor,
                           reads: torch.Tensor) -> torch.Tensor:
    """The same scores in plain torch: hgtpu's im2col product."""
    n, m = reads.shape
    P1 = pwm_ext.shape[0] - m + 1
    if P1 == 0:
        return torch.zeros((n, 0), dtype=torch.float32, device=reads.device)
    pwm = pwm_ext.to(torch.bfloat16).to(torch.float32)
    classes = torch.arange(5, device=reads.device)
    onehot = (reads.long()[:, :, None] == classes).to(torch.float32)
    windows = pwm.unfold(0, m, 1).transpose(1, 2).reshape(P1, m * 5)
    return onehot.reshape(n, m * 5) @ windows.T


def k16_operands(pwm_ext: torch.Tensor, reads: torch.Tensor):
    """(pwm_ext, reads) as the kernel takes them, with the same scores:
    m padded to a multiple of 16 with code-5 columns and as many zero
    PWM rows (P1 = rows - m + 1 is unchanged), and the codes copied when
    their base is not 16-byte aligned."""
    n, m = reads.shape
    pad = -m % 16
    if pad:
        reads = torch.cat([reads, reads.new_full((n, pad), _PAD_CODE)], 1)
        pwm_ext = torch.cat([pwm_ext, pwm_ext.new_zeros((pad, 5))], 0)
    elif reads.data_ptr() % 16:
        reads = reads.clone()
    return pwm_ext, reads


def placement_scores(pwm_ext: torch.Tensor,
                     reads: torch.Tensor) -> torch.Tensor:
    """pwm_ext: [P1 + m - 1, 5] float32; reads: [N, m] int8 codes.
    Returns [N, P1] float32 scores."""
    _check(pwm_ext, reads)
    if reads.device.type == "cpu":
        return placement_scores_plain(pwm_ext, reads)
    if reads.device.type != "cuda":
        raise RuntimeError("no placement kernel for device %s"
                           % reads.device)
    n = reads.shape[0]
    P1 = pwm_ext.shape[0] - reads.shape[1] + 1
    if n == 0 or reads.shape[1] == 0 or P1 == 0:
        # no read, no base or no diagonal: every score is 0, and no kernel
        # launches
        return torch.zeros((n, P1), dtype=torch.float32, device=reads.device)
    pwm_ext, reads = k16_operands(pwm_ext, reads)
    lib = cuda_lib.load()
    out = torch.empty((n, P1), dtype=torch.float32, device=reads.device)
    with torch.cuda.device(reads.device):
        err = lib.hgtpu_torch_placement_scores(
            pwm_ext.data_ptr(), pwm_ext.shape[0], reads.data_ptr(), n,
            reads.shape[1], out.data_ptr(), P1,
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, "placement_scores")
    count_launch(placement_scores)
    return out


placement_scores.launches = 0
