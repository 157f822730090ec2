"""The proposal lower bound of the verify prep as a hand-written CUDA kernel.

Replaces no TPU kernel: hgtpu bounds its proposal entries on the host
(``hgtpu/align/aligner.py:_lb_core``), and the port does so on the CPU.
On the card the chunk's read codes are already there (the placement's
``both``, [2n, L] int8: row i forward, n + i reverse), so the bound runs
as ``csrc/proposal_bound.cu``, one warp per entry.

Inputs:

* ``codes`` [rows, L] int8, the read codes;
* ``mask`` [T] uint8: bit c of mask[p] set when base code c is free at
  table position p (the aligner's dilated match table, ``pack_mask``);
  code 5 is never free;
* ``entries`` [E, 3] int32: row, base (table position of column 0) and
  clip | win << 16 (the entry reads codes[row, clip + j] for j < win);
* ``cap``: the bound is min(misses, cap).

Returns the bound [E] int8, on the card.  The plain version is the
aligner's numpy ``GeneAligner._lb_core``, which bounds the same entries
on the CPU.  E = 0 launches nothing and counts nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from . import count_launch, cuda_lib


def pack_mask(table):
    """[T, 6] bool free table -> [T] uint8 bit masks (bit c for code
    c)."""
    return (table[:, :6].astype(np.uint8)
            << np.arange(6, dtype=np.uint8)[None, :]).sum(1, dtype=np.uint8)


def pack_entries(rows, base, clip, win):
    """The kernel's [E, 3] int32 entry words."""
    return np.stack([rows, base, clip | (win << 16)], 1).astype(np.int32)


def _check(codes, mask, entries, cap):
    if codes.dtype != torch.int8 or codes.dim() != 2 \
            or not codes.is_contiguous():
        raise ValueError("want contiguous [rows, L] int8 codes")
    if mask.dtype != torch.uint8 or mask.dim() != 1 \
            or not mask.is_contiguous():
        raise ValueError("want a contiguous [T] uint8 mask")
    if entries.dtype != torch.int32 or entries.dim() != 2 \
            or entries.shape[1] != 3 or not entries.is_contiguous():
        raise ValueError("want contiguous [E, 3] int32 entries")
    if not (mask.device == entries.device == codes.device):
        raise ValueError("codes, mask and entries on different devices")
    if not 0 <= cap <= 127:
        raise ValueError("cap %d outside an int8" % cap)


def proposal_bound(codes, mask, entries, cap):
    """The bound of every entry, by the kernel (CUDA tensors only)."""
    _check(codes, mask, entries, cap)
    if codes.device.type != "cuda":
        raise RuntimeError("no proposal bound kernel on %s" % codes.device)
    E = entries.shape[0]
    out = torch.empty(E, dtype=torch.int8, device=codes.device)
    if E == 0:
        return out
    lib = cuda_lib.load()
    name = "hgtpu_torch_proposal_bound"
    with torch.cuda.device(codes.device):
        err = getattr(lib, name)(
            codes.data_ptr(), codes.shape[0], codes.shape[1],
            mask.data_ptr(), mask.numel(), entries.data_ptr(), E, int(cap),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, name)
    count_launch(proposal_bound)
    return out


proposal_bound.launches = 0
