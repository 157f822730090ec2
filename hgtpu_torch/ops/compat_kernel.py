"""K2 — link-bitset AND-reduce as hand-written CUDA kernels.

Replaces hgtpu/ops/compat_kernel.py:and_reduce_pallas:

    incl[h] = AND_k links_packed[vars[h, k]]

the inner bitwise reduction of the read->allele compatibility test
(``hgtpu_torch.typer.device_count._compat``).  Words hold uint32 bit
patterns stored as int32, since torch's uint32 support is thin.  Padding
slots point at the all-ones sentinel row V.  An index is read as hgtpu's
gathers read it (jnp indexing, and the Pallas kernel in interpret mode):
a negative one counts from the end (v + V + 1), then the index is
clamped into [0, V], as an XLA gather clamps it.

Source: ``hgtpu_torch/csrc/and_reduce.cu``, two variants of the same
function, chosen by ``k2_plan`` from the table's shape (V+1, W):

* ``and_reduce_slab``: each block stages a slab of WS words of every link
  row in shared memory once (by TMA, multicast over a cluster of blocks
  of the same slab) and walks over tiles of haplotypes, so the H * K row
  gathers are served from shared memory instead of L2 (their bound on
  the card; see the source's note);
* ``and_reduce_wide``: for tables whose rows do not fit at WS = 4 (V+1
  past ~12,000), one thread per output word gathering from L2.

The table's rows may lie further apart than W words (a view of a wider
buffer): ``pitched`` pads them to a multiple of 4 words, the layout a TMA
tensor map can describe, which the slab kernel needs; DeviceCounter keeps
its table so, and ``and_reduce_slab`` pads any other table first.

Each wrapper counts its own launches.  ``and_reduce`` and both variants
take the plain version only for CPU tensors; for CUDA tensors they launch
a kernel or raise.  An empty result (H = 0 or W = 0) launches nothing and
counts nothing.
"""
from __future__ import annotations

import torch

from . import count_launch, cuda_lib

# the slab kernel's constants (csrc/and_reduce.cu)
KC = 16                  # vars columns per ring stage
VPITCH = KC + 4          # ring row pitch, words
SMEM_MAX = 232_448       # dynamic shared memory one block may take
SLAB_WIDTHS = (32, 16, 8, 4)
RING_STAGES = 2
BARRIER = 16             # bytes of the slab's mbarrier, after the slab


def slab_threads(ws: int) -> int:
    """Threads of a slab block: 16 warps for ws >= 16, else 8."""
    return 512 if ws >= 16 else 256


def tile_rows(ws: int) -> int:
    """Haplotypes per tile: 128, or one per thread group where there are
    more groups (256 at ws = 4)."""
    return max(128, slab_threads(ws) // (ws // 4))


def slab_smem(V1: int, ws: int) -> int:
    """Bytes of shared memory of one slab block: the vars ring
    (RING_STAGES stages of [tile_rows(ws), VPITCH] words), the slab's V1
    rows of ws words (V1 rounded up to 8, so every TMA box lands 128-byte
    aligned) and its mbarrier."""
    return (4 * (RING_STAGES * tile_rows(ws) * VPITCH + -(-V1 // 8) * 8 * ws)
            + BARRIER)


def k2_plan(V1: int, W: int):
    """The K2 variant for a [V1, W] table: ``("slab", ws)`` with the
    widest slab of 32 / 16 / 8 / 4 words that fits beside the vars ring
    and is no wider than W needs, else ``("wide", None)``."""
    need = max(4, 1 << (max(W, 1) - 1).bit_length())
    for ws in SLAB_WIDTHS:
        if ws <= need and slab_smem(V1, ws) <= SMEM_MAX:
            return "slab", ws
    return "wide", None


def _check(links, vars_):
    if links.device != vars_.device:
        raise ValueError("links on %s, vars on %s"
                         % (links.device, vars_.device))
    if links.dtype != torch.int32 or vars_.dtype != torch.int32:
        raise TypeError("want int32 links and vars, got %s, %s"
                        % (links.dtype, vars_.dtype))
    if links.dim() != 2 or vars_.dim() != 2 or links.shape[0] < 1:
        raise ValueError("want links [V+1, W] and vars [H, K], got %s, %s"
                         % (tuple(links.shape), tuple(vars_.shape)))
    if links.stride(1) != 1 or links.stride(0) < links.shape[1] \
            or not vars_.is_contiguous():
        raise ValueError("links rows and vars must be contiguous")


def pitched(links: torch.Tensor) -> torch.Tensor:
    """links [V+1, W] as the [V+1, W] view of a zero-padded buffer whose
    rows are a multiple of 4 words long (16 bytes), a layout the slab
    kernel's TMA tensor map can describe."""
    V1, W = links.shape
    buf = links.new_zeros((V1, -(-W // 4) * 4))
    buf[:, :W] = links
    return buf[:, :W]


def and_reduce_plain(links: torch.Tensor, vars_: torch.Tensor) -> torch.Tensor:
    """The same AND-reduce in plain torch (hgtpu's gather path)."""
    V1 = links.shape[0]
    idx = vars_.long()
    idx = torch.where(idx < 0, idx + V1, idx).clamp(0, V1 - 1)
    acc = torch.full((vars_.shape[0], links.shape[1]), -1, dtype=torch.int32,
                     device=links.device)
    for k in range(vars_.shape[1]):
        acc &= links[idx[:, k]]
    return acc


def _launch(fn, links, vars_, out_pitch, *extra):
    """Run one variant's C launcher on CUDA tensors, into rows of
    out_pitch words, and return the [H, W] view; None for CPU tensors
    (the caller takes the plain version)."""
    _check(links, vars_)
    if links.device.type == "cpu":
        return None
    if links.device.type != "cuda":
        raise RuntimeError("no and_reduce kernel for device %s"
                           % links.device)
    V1, W = links.shape
    H, K = vars_.shape
    out = torch.empty((H, out_pitch), dtype=torch.int32, device=links.device)
    if H == 0 or W == 0:
        return out[:, :W]               # nothing to launch, nor to count
    lib = cuda_lib.load()
    with torch.cuda.device(links.device):
        err = getattr(lib, "hgtpu_torch_" + fn.__name__)(
            links.data_ptr(), V1, W, links.stride(0), vars_.data_ptr(), H, K,
            out.data_ptr(), out_pitch, *extra,
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, fn.__name__)
    count_launch(fn)
    return out[:, :W]


def and_reduce_slab(links: torch.Tensor, vars_: torch.Tensor,
                    ws: int | None = None) -> torch.Tensor:
    """The shared-memory slab kernel; ``ws`` defaults to k2_plan's width
    (a width whose slab does not fit raises).  The result is the [H, W]
    view of rows padded to a multiple of 4 words, which the kernel writes
    with 16-byte stores."""
    _check(links, vars_)
    if ws is None:
        ws = k2_plan(*links.shape)[1] or SLAB_WIDTHS[-1]
    if links.device.type == "cuda" and (links.stride(0) % 4
                                        or links.data_ptr() % 16):
        links = pitched(links)              # a table TMA can map
    out = _launch(and_reduce_slab, links, vars_,
                  -(-links.shape[1] // 4) * 4, ws)
    return and_reduce_plain(links, vars_) if out is None else out


def and_reduce_wide(links: torch.Tensor, vars_: torch.Tensor) -> torch.Tensor:
    """The L2 kernel, for tables of any size."""
    out = _launch(and_reduce_wide, links, vars_, links.shape[1])
    return and_reduce_plain(links, vars_) if out is None else out


and_reduce_slab.launches = 0
and_reduce_wide.launches = 0


def and_reduce(links: torch.Tensor, vars_: torch.Tensor) -> torch.Tensor:
    """links: [V+1, W] int32 bit rows; vars_: [H, K] int32 -> [H, W],
    through the variant k2_plan picks for the table."""
    _check(links, vars_)
    kind, ws = k2_plan(*links.shape)
    if kind == "slab":
        return and_reduce_slab(links, vars_, ws)
    return and_reduce_wide(links, vars_)
