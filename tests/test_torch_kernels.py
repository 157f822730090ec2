"""The port's two kernels against hgtpu's.

K1 (placement scores) and K2 (link-bitset AND-reduce): on the CPU the
port's wrappers take their plain versions, which must equal hgtpu's XLA
path and its Pallas kernel (interpret mode) exactly.  The tolerance
everywhere is exact equality: scores are sums of 0/1 entries and the
bitsets are integers.  The CUDA kernels themselves are held against
these plain versions on the card by tests/test_torch_cuda.py; here each
kernel's index algebra (K1's tiles, K2's slabs, tiles and vars ring) is
decomposed in numpy as the card runs it and held against hgtpu, and the
choice of K2's variant is tested as the pure function of the table's
shape that it is.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgtpu.ops.compat_kernel import and_reduce_pallas
from hgtpu.ops.placement import correlate_scores as jax_correlate_scores
from hgtpu.ops.placement_pallas import correlate_scores_pallas
from hgtpu_torch.ops import compat_kernel as ck
from hgtpu_torch.ops import cuda_lib
from hgtpu_torch.ops import placement as tp
from hgtpu_torch.ops.compat_kernel import (and_reduce, and_reduce_plain,
                                           and_reduce_slab, and_reduce_wide,
                                           k2_plan)
from hgtpu_torch.ops.placement_kernel import (k16_operands, placement_scores,
                                              placement_scores_plain)
from tests.torch_threads import _torch_threads  # noqa: F401


def _pwm_reads(seed, n, m, P, periodic=False):
    """A 0/1 PWM padded with m zero rows per side, and int8 reads with
    some N codes.  periodic=True makes backbone and reads a 4-periodic
    repeat, so most diagonals tie."""
    rng = np.random.default_rng(seed)
    pwm = np.zeros((P, 5), np.float32)
    if periodic:
        pwm[np.arange(P), np.arange(P) % 4] = 1.0
        reads = np.tile(np.arange(4, dtype=np.int8), (n, m // 4 + 1))[:, :m]
        reads = np.roll(reads, rng.integers(0, 4), axis=1).copy()
        reads[:, -3:] = 4
    else:
        pwm[np.arange(P), rng.integers(0, 4, P)] = 1.0
        snp = np.flatnonzero(rng.random(P) < 0.1)
        pwm[snp, rng.integers(0, 4, len(snp))] = 1.0
        reads = rng.integers(0, 5, (n, m)).astype(np.int8)
    ext = np.concatenate([np.zeros((m, 5), np.float32), pwm,
                          np.zeros((m, 5), np.float32)])
    return ext, reads


CASES = [
    # (seed, N, m, P, periodic) — ragged N and P1 against 128-tiles
    (3, 40, 96, 700, False),
    (5, 130, 128, 333, False),
    (7, 24, 64, 256, True),
]


@pytest.mark.parametrize("seed,n,m,P,periodic", CASES)
def test_k1_plain_equals_hgtpu(seed, n, m, P, periodic):
    ext, reads = _pwm_reads(seed, n, m, P, periodic)
    want = np.asarray(jax_correlate_scores(jnp.asarray(ext),
                                           jnp.asarray(reads)))
    pallas = np.asarray(correlate_scores_pallas(jnp.asarray(ext),
                                                jnp.asarray(reads)))
    got = placement_scores(torch.from_numpy(ext), torch.from_numpy(reads))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), pallas)


# the CUDA kernel's tiling (hgtpu_torch/csrc/placement_scores.cu)
TILE_N, TILE_P, SLAB, K16 = 128, 128, 512, 16


def _scores_as_tiled_on_the_card(ext, reads):
    """K1's scores decomposed the way the CUDA kernel computes them, on
    the operands the wrapper hands it: K base-major; per TILE_P-diagonal
    tile and SLAB of read positions one Hankel matrix per base,
    M_b[r, t] = bf16(pwm[p0 + js + r + t, b]) for t < 16 (zero past the
    PWM); the B tile of k16 chunk (b, j0) is rows [j0, j0 + TILE_P) of
    M_b; rows past N read the last row's codes and, like diagonals past
    P1, are masked at the store."""
    ext_t, reads_t = k16_operands(torch.from_numpy(ext),
                                  torch.from_numpy(reads))
    pwm = ext_t.to(torch.bfloat16).to(torch.float32).numpy()
    codes_all = reads_t.numpy()
    n, m = codes_all.shape
    rows = pwm.shape[0]
    P1 = rows - m + 1
    hrows = TILE_P + min(m, SLAB) - 16
    out = np.full((n, P1), np.nan, np.float32)
    for n0 in range(0, n, TILE_N):
        codes = codes_all[np.minimum(np.arange(n0, n0 + TILE_N), n - 1)]
        for p0 in range(0, P1, TILE_P):
            acc = np.zeros((TILE_N, TILE_P), np.float32)
            for js in range(0, m, SLAB):
                r = p0 + js + np.arange(hrows)[:, None] + np.arange(K16)
                for b in range(5):
                    M_b = np.where(r < rows, pwm[np.minimum(r, rows - 1), b],
                                   np.float32(0))
                    for j0 in range(0, min(SLAB, m - js), K16):
                        a = codes[:, js + j0:js + j0 + K16] == b
                        acc += a.astype(np.float32) @ M_b[j0:j0 + TILE_P].T
            nv, pv = min(TILE_N, n - n0), min(TILE_P, P1 - p0)
            out[n0:n0 + nv, p0:p0 + pv] = acc[:nv, :pv]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("seed,n,m,P,periodic",
                         CASES + [(9, 17, 1024, 500, False)])
def test_k1_card_tiling_equals_hgtpu(seed, n, m, P, periodic):
    """The kernel's index algebra (b-major K, Hankel B tiles addressed by
    row offset, slabs, ragged N and P1) against hgtpu, exactly."""
    ext, reads = _pwm_reads(seed, n, m, P, periodic)
    reads[0, :7] = 9                     # out-of-range codes score 0
    want = np.asarray(jax_correlate_scores(jnp.asarray(ext),
                                           jnp.asarray(reads)))
    pallas = np.asarray(correlate_scores_pallas(jnp.asarray(ext),
                                                jnp.asarray(reads)))
    got = _scores_as_tiled_on_the_card(ext, reads)
    assert np.array_equal(got, want)
    assert np.array_equal(got, pallas)


@pytest.mark.parametrize("m", [40, 64])
def test_k16_operands_keep_the_scores(m):
    """The wrapper's padding of m to a multiple of 16 (code 5, zero PWM
    rows) and its copy of misaligned codes change no score."""
    ext, reads = _pwm_reads(m, 21, m, 300)
    ext_t = torch.from_numpy(ext)
    buf = torch.empty(reads.size + 1, dtype=torch.int8)
    reads_t = buf[1:].view(reads.shape)            # base not 16-aligned
    reads_t.copy_(torch.from_numpy(reads))
    pwm_k, reads_k = k16_operands(ext_t, reads_t)
    assert reads_k.shape[1] % 16 == 0 and reads_k.data_ptr() % 16 == 0
    assert pwm_k.shape[0] - reads_k.shape[1] == ext.shape[0] - m
    assert torch.equal(placement_scores_plain(pwm_k, reads_k),
                       placement_scores_plain(ext_t, reads_t))


@pytest.mark.parametrize("seed,n,m,P,periodic", CASES)
def test_k1_top_diagonals_tie_order(seed, n, m, P, periodic):
    """lax.top_k's lowest-index-first order among tied scores."""
    ext, reads = _pwm_reads(seed, n, m, P, periodic)
    scores = placement_scores(torch.from_numpy(ext), torch.from_numpy(reads))
    s_t, p_t = tp._top_diagonals(scores, 8)
    s_j, p_j = jax.lax.top_k(jnp.asarray(scores.numpy()), 8)
    assert np.array_equal(s_t.numpy(), np.asarray(s_j).astype(np.int64))
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))
    if periodic:
        assert (np.asarray(s_j)[:, 0] == np.asarray(s_j)[:, 1]).all()


def _links_vars(seed, V, A, H, K):
    rng = np.random.default_rng(seed)
    W = (A + 31) // 32
    links = rng.integers(0, 2**32, (V + 1, W), dtype=np.uint64)
    links = links.astype(np.uint32)
    links[V] = 0xFFFFFFFF                    # all-ones sentinel row
    vars_ = rng.integers(0, V, (H, K)).astype(np.int32)
    # ragged variant lists: padding slots point at the sentinel
    for h in range(H):
        vars_[h, rng.integers(1, K + 1):] = V
    return links, vars_


@pytest.mark.parametrize("H,K,A", [(13, 16, 3600), (64, 32, 100),
                                   (5, 16, 31)])
def test_k2_plain_equals_pallas(H, K, A):
    links, vars_ = _links_vars(H + K, 40, A, H, K)
    want = np.asarray(and_reduce_pallas(jnp.asarray(links),
                                        jnp.asarray(vars_)))
    got = and_reduce(torch.from_numpy(links.view(np.int32)),
                     torch.from_numpy(vars_))
    assert got.dtype == torch.int32 and got.shape == (H, want.shape[1])
    assert np.array_equal(got.numpy().view(np.uint32), want)


def _edge_links_vars(seed, V1, W, H, K):
    """Random words (bit 31 set in about half), the all-ones sentinel
    row last, and indices spread over [-(V1 + 4), V1 + 4): below -V1 and
    past V they clamp, in [-V1, -1] they count from the end."""
    rng = np.random.default_rng(seed)
    links = rng.integers(0, 2**32, (V1, W), dtype=np.uint64).astype(np.uint32)
    links[:, 0] |= 0x80000000
    links[V1 - 1] = 0xFFFFFFFF
    vars_ = rng.integers(-V1 - 4, V1 + 4, (H, K)).astype(np.int32)
    vars_[::3, K // 2:] = V1 - 1                   # padding slots
    return links, vars_


def _and_reduce_as_on_the_card(links, vars_, n_share):
    """K2's slab kernel decomposed as the card runs it: the width k2_plan
    picks; per slab of ws words (words past W hold garbage, as the
    unstaged shared memory does) and per block of the slab (n_share of
    them, each walking tiles share, share + n_share, ...), the tile's
    vars staged KC columns at a time with zeros past H and K, hgtpu's
    index (negatives from the end, then clamped) into the slab rows, an
    accumulator reset at the first chunk and stored at the last, masked
    to the slab's valid words and to h < H."""
    V1, W = links.shape
    H, K = vars_.shape
    kind, ws = k2_plan(V1, W)
    assert kind == "slab"
    HT = ck.tile_rows(ws)
    n_tiles, n_kc = -(-H // HT), max(1, -(-K // ck.KC))
    rng = np.random.default_rng(1)
    out = np.zeros((H, W), np.uint32)
    written = np.zeros((H, W), np.int64)
    for w_base in range(0, W, ws):
        wv = min(ws, W - w_base)
        slab = rng.integers(0, 2**32, (V1, ws), dtype=np.uint64) \
            .astype(np.uint32)
        slab[:, :wv] = links[:, w_base:w_base + wv]
        for share in range(min(n_share, n_tiles)):
            for t in range(share, n_tiles, n_share):
                h = t * HT + np.arange(HT)
                for c in range(n_kc):
                    k = c * ck.KC + np.arange(ck.KC)
                    ok = (h[:, None] < H) & (k[None, :] < K)
                    ring = np.where(ok, vars_[np.minimum(h, H - 1)][
                        :, np.minimum(k, K - 1)], 0).astype(np.int64)
                    if c == 0:
                        acc = np.full((HT, ws), 0xFFFFFFFF, np.uint32)
                    for kk in range(min(ck.KC, K - c * ck.KC)):
                        v = ring[:, kk]
                        acc &= slab[np.clip(np.where(v < 0, v + V1, v), 0,
                                            V1 - 1)]
                keep = h < H
                out[h[keep], w_base:w_base + wv] = acc[keep, :wv]
                written[h[keep], w_base:w_base + wv] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("W", [1, 3, 4, 113, 200])
@pytest.mark.parametrize("K", [1, 16, 33])
def test_k2_equals_pallas_at_slab_edges(W, K):
    """The plain version and the slab kernel's decomposition against
    hgtpu's Pallas kernel (interpret mode): ragged last slabs, H = 301
    (a multiple of no tile), K across the ring's chunks, indices out of
    range on both sides, words with bit 31 set."""
    links, vars_ = _edge_links_vars(W * 7 + K, 41, W, 301, K)
    want = np.asarray(and_reduce_pallas(jnp.asarray(links),
                                        jnp.asarray(vars_)))
    got = and_reduce_plain(torch.from_numpy(links.view(np.int32)),
                           torch.from_numpy(vars_))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    for n_share in (1, 3):
        assert np.array_equal(_and_reduce_as_on_the_card(links, vars_,
                                                         n_share), want)


@pytest.mark.parametrize("V1,ws", [(3000, 16), (6000, 8), (11000, 4)])
def test_k2_narrow_slabs_equal_pallas(V1, ws):
    """Tables tall enough that the slab narrows (W = 113)."""
    assert k2_plan(V1, 113) == ("slab", ws)
    links, vars_ = _edge_links_vars(V1, V1, 113, 301, 16)
    want = np.asarray(and_reduce_pallas(jnp.asarray(links),
                                        jnp.asarray(vars_)))
    assert np.array_equal(_and_reduce_as_on_the_card(links, vars_, 2), want)


def test_k2_plan_is_a_function_of_the_table_shape():
    """The widest slab that fits beside the vars ring and that W can
    use; past WS = 4 the wide variant."""
    assert k2_plan(1498, 113) == ("slab", 32)    # the 3,600-allele panel
    assert k2_plan(1, 1) == ("slab", 4)
    assert k2_plan(1498, 3) == ("slab", 4)
    assert k2_plan(1498, 16) == ("slab", 16)
    assert k2_plan(1498, 17) == ("slab", 32)
    limit = max(v for v in range(1, 20000)
                if ck.slab_smem(v, 4) <= ck.SMEM_MAX)
    assert 11_000 < limit < 14_000
    assert k2_plan(limit, 113) == ("slab", 4)
    assert k2_plan(limit + 1, 113) == ("wide", None)
    edges = [max(v for v in range(1, 20000)
                 if ck.slab_smem(v, ws) <= ck.SMEM_MAX)
             for ws in ck.SLAB_WIDTHS]
    assert edges[0] >= 1498                       # the panel takes WS = 32
    for V1 in [1, 41, 1498] + edges + [e + 1 for e in edges]:
        for W in (1, 3, 4, 5, 8, 9, 16, 17, 32, 33, 113, 200):
            need = max(4, 1 << (W - 1).bit_length())
            fits = [ws for ws in ck.SLAB_WIDTHS
                    if ws <= need and ck.slab_smem(V1, ws) <= ck.SMEM_MAX]
            assert k2_plan(V1, W) == (("slab", max(fits)) if fits
                                      else ("wide", None)), (V1, W)


def test_k2_variants_take_plain_on_cpu_and_count_no_launch():
    links, vars_ = _edge_links_vars(5, 41, 7, 20, 5)
    lt = torch.from_numpy(links.view(np.int32))
    vt = torch.from_numpy(vars_)
    before = and_reduce_slab.launches, and_reduce_wide.launches
    want = and_reduce_plain(lt, vt)
    for fn in (and_reduce, and_reduce_slab, and_reduce_wide):
        assert torch.equal(fn(lt, vt), want)
    assert (and_reduce_slab.launches, and_reduce_wide.launches) == before
    with pytest.raises(RuntimeError, match="no and_reduce kernel"):
        and_reduce_slab(lt.to("meta"), vt.to("meta"))


def test_kernel_build_is_one_nvcc_per_source(tmp_path, monkeypatch):
    """cuda_lib.build compiles every source in its own nvcc process and
    links the objects into one library; a failing source raises and
    leaves no library."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!%s\nimport sys\nargs = sys.argv[1:]\n"
        "open(%r, 'a').write(' '.join(args) + '\\n')\n"
        "if any('fail' in a for a in args): sys.exit(3)\n"
        "open(args[args.index('-o') + 1], 'w').write('x')\n"
        % (sys.executable, str(tmp_path / "calls")))
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path / "build"))
    path = cuda_lib.build()
    calls = (tmp_path / "calls").read_text().splitlines()
    srcs = cuda_lib.sources()
    assert len(srcs) >= 2 and len(calls) == len(srcs) + 1
    assert sorted(c.split()[-1] for c in calls[:-1]) == sorted(srcs)
    assert all(" -c " in c for c in calls[:-1])
    assert "-shared" in calls[-1] and " -c " not in calls[-1]
    assert os.path.exists(path) and os.path.exists(path + ".log")
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [os.path.basename(path), os.path.basename(path) + ".log"])
    monkeypatch.setattr(cuda_lib, "sources", lambda: srcs + ["fail.cu"])
    monkeypatch.setattr(cuda_lib, "library_path", lambda: path + "2")
    with pytest.raises(RuntimeError, match="fail.cu"):
        cuda_lib.build()
    assert not os.path.exists(path + "2")


def test_wrappers_reject_bad_input():
    ext, reads = _pwm_reads(1, 4, 32, 64)
    with pytest.raises(TypeError):
        placement_scores(torch.from_numpy(ext), torch.from_numpy(reads).long())
    with pytest.raises(ValueError):
        placement_scores(torch.from_numpy(ext).T.contiguous(),
                         torch.from_numpy(reads))
    links, vars_ = _links_vars(1, 8, 64, 4, 4)
    with pytest.raises(TypeError):
        and_reduce(torch.from_numpy(links.view(np.int32)),
                   torch.from_numpy(vars_).long())
    with pytest.raises(ValueError):
        and_reduce(torch.from_numpy(links.view(np.int32))[:, :1],
                   torch.from_numpy(vars_).T)
