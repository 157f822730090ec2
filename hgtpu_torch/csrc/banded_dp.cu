// The banded variant-aware DP of device verify, as one CUDA kernel.
//
// Replaces hgtpu/ops/banded_dp.py:_banded_costs, which hgtpu writes in jnp
// (a lax.scan over the W + 1 read positions, fused by XLA into one
// program): no Pallas kernel, but a scan on the hot path, which eager
// torch would run as ~10^4 small launches per call.  The plain torch
// version beside it is ops/banded_dp.py:banded_costs_plain; both must give
// the same cost and over, bit for bit.
//
// Per proposal e (read codes reads[e, :W], length lens[e], backbone start
// starts[e]) the state is a band of D = 33 diagonals d (backbone position
// start + i + d - DNEG after i read chars): cur[D], IL pending planes of
// catalog and novel insertions, final and over.  Every transition is a
// shift of the band by a deletion length (right, <= DPOS) or an insertion
// length (left, <= IL), masked by per-row flags of a packed table (four
// int32 words a row, ops/banded_dp.py:pack_rows).
//
// Bound on the card: integer operations.  It reads E * W code bytes, two
// ints a proposal and a table that stays in L2 (16 bytes a row, ~123 KB on
// the 3,600-allele panel), and does ~(5 * (n_del + 2) + 8) masked mins and
// selects over the 33 diagonals per read position, all on the CUDA cores;
// the positions are a dependent chain.
//
// Design (simple and right first): one warp per proposal, lane l holds
// diagonal d = l, and lane 0 holds d = 32 in a second slot.  A shift by L
// is one __shfl_sync (lane l reads lane l - L, or l + L; lane 0's second
// slot reads lane 32 - L), so a relaxation costs one shuffle and no
// shared memory.  Each lane loads its own table row (neighbouring lanes,
// neighbouring rows: one 512-byte request per warp and read position).
// The deletion and insertion lengths are bit masks (bit L set), walked
// with __ffs, in place of hgtpu's static tuples.  over is OR'd per lane
// and reduced once at the end; final is a warp min at i == lens[e], and
// the warp stops there: past it no state reaches final or over
// (live and indels_on are off, every plane stays saturated).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DNEG = 8;
constexpr int DPOS = 24;
constexpr int D = DNEG + DPOS + 1;    // 33
constexpr int NI = 2;
constexpr int IL = 4;
constexpr int NITER = 4;
constexpr int OFF = DNEG + 2;
constexpr int INF = 1 << 20;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;              // proposals per block

static_assert(D == 33, "the layout holds d = 32 in lane 0's second slot");

__device__ __forceinline__ int sat(int x, int max_novel) {
  return x > max_novel ? INF : x;
}

// dst[d] = min(dst[d], src[d - L]) for L <= d < D: src is the lanes' first
// slot (d = lane); lane 0's second slot (d = 32) reads d = 32 - L.
__device__ __forceinline__ void rshift_min(int (&dst)[2], int src, int L,
                                           int lane) {
  const int v = __shfl_sync(FULL, src, (lane - L) & 31);
  if (lane >= L) dst[0] = min(dst[0], v);
  if (lane == 0) dst[1] = min(dst[1], v);
}

// dst[d] = min(dst[d], src[d + L]) for 0 <= d < D - L: d + L = 32 is lane
// 0's second slot; d = 32 itself takes nothing.
__device__ __forceinline__ void lshift_min(int (&dst)[2], int src_lo,
                                           int src_hi, int L, int lane) {
  const int v = __shfl_sync(FULL, src_lo, (lane + L) & 31);
  const int vh = __shfl_sync(FULL, src_hi, 0);
  if (lane + L < 32)
    dst[0] = min(dst[0], v);
  else if (lane + L == 32)
    dst[0] = min(dst[0], vh);
}

// pend[L - 1] <- lshift_min; L is warp-uniform, so the branch is too
__device__ __forceinline__ void pend_min(int (&pend)[IL][2], int L,
                                         int src_lo, int src_hi, int lane) {
#pragma unroll
  for (int q = 0; q < IL; ++q)
    if (q == L - 1) lshift_min(pend[q], src_lo, src_hi, L, lane);
}

// One relaxation of the intra-layer closure (catalog deletions free,
// novel deletions of length 1-2 at their length), on a layer whose
// indels are on.  ov collects the band-edge overflows.
__device__ __forceinline__ void relax(const int (&c)[2], int (&nw)[2],
                                      const bool (&pok)[2],
                                      const bool (&fr)[2],
                                      const int (&w1)[2], int del_mask,
                                      int max_novel, int lane, bool& ov) {
  const bool g0 = c[0] < INF && pok[0];
  const bool g1 = c[1] < INF && pok[1];
  nw[0] = c[0];
  nw[1] = c[1];
  int k = 0;
  for (int m = del_mask; m; m &= m - 1, ++k) {
    const int L = __ffs(m) - 1;
    const bool h0 = g0 && ((w1[0] >> k) & 1);
    const bool h1 = g1 && ((w1[1] >> k) & 1);
    rshift_min(nw, h0 ? c[0] : INF, L, lane);
    ov |= (h0 && lane >= D - L) || h1;     // d = 32 >= D - L for any L
  }
#pragma unroll
  for (int L = 1; L <= 2; ++L) {
    const bool n0 = g0 && !fr[0];
    const bool n1 = g1 && !fr[1];
    rshift_min(nw, n0 ? c[0] + L : INF, L, lane);
    ov |= (n0 && lane >= D - L) || n1;
  }
  nw[0] = sat(nw[0], max_novel);
  nw[1] = sat(nw[1], max_novel);
}

__global__ void __launch_bounds__(WARPS * 32)
banded_dp_kernel(const int4* __restrict__ table, int rows,
                 const int8_t* __restrict__ reads, int E, int W,
                 const int* __restrict__ lens, const int* __restrict__ starts,
                 int P, int max_novel, int del_mask, int ins_mask,
                 int* __restrict__ cost, bool* __restrict__ over_out) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (e >= E) return;                       // the whole warp
  const int len = lens[e];
  const int start = starts[e];
  const int8_t* rd = reads + (size_t)e * W;
  const bool hi = lane == 0;                // owns d = 32 in slot 1

  int cur[2] = {lane == DNEG ? 0 : INF, INF};
  int pend[IL][2];
#pragma unroll
  for (int q = 0; q < IL; ++q) pend[q][0] = pend[q][1] = INF;
  int fin = INF;
  bool ov = false;

  const int last = len < 0 ? -1 : min(len, W);
  for (int i = 0; i <= last; ++i) {
    cur[0] = min(cur[0], pend[0][0]);
    cur[1] = min(cur[1], pend[0][1]);
#pragma unroll
    for (int q = 0; q < IL - 1; ++q) {
      pend[q][0] = pend[q + 1][0];
      pend[q][1] = pend[q + 1][1];
    }
    pend[IL - 1][0] = pend[IL - 1][1] = INF;
    if (i == len)
      fin = min(fin, __reduce_min_sync(FULL, min(cur[0], hi ? cur[1] : INF)));
    const bool live = i < len;
    const bool ind = i > 0 && live;         // indels allowed this layer
    const int ch = min(max((int)rd[min(i, W - 1)], 0), 7);

    int w0[2], w1[2], sq[2][NI];
    bool pok[2], fr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int pos = start + i + lane + 32 * j - DNEG;
      int4 r = make_int4(0, 0, 0, 0);
      if (j == 0 || hi)
        r = __ldg(table + min(max(pos + OFF, 0), rows - 1));
      w0[j] = r.x;
      w1[j] = r.y;
      sq[j][0] = r.z;
      sq[j][1] = r.w;
      pok[j] = (j == 0 || hi) && pos >= 0 && pos < P;
      fr[j] = (r.x >> ch) & 1;
      // rows whose catalog indels exceed the packed slots poison any
      // finite state that touches them
      ov |= ind && cur[j] < INF && pok[j] && ((r.x >> 8) & 1);
    }

    // ---- intra-layer closure: catalog + novel deletions ---- //
    if (ind) {
      int c[2] = {cur[0], cur[1]};
      int nw[2];
#pragma unroll 1
      for (int it = 0; it < NITER; ++it) {
        relax(c, nw, pok, fr, w1, del_mask, max_novel, lane, ov);
        c[0] = nw[0];
        c[1] = nw[1];
      }
      relax(c, nw, pok, fr, w1, del_mask, max_novel, lane, ov);
      // the closure did not converge: chains deeper than NITER
      ov |= nw[0] < c[0] || nw[1] < c[1];
      cur[0] = c[0];
      cur[1] = c[1];
    } else {
      // every gate closed: each relaxation only saturates
      cur[0] = sat(cur[0], max_novel);
      cur[1] = sat(cur[1], max_novel);
    }

    // ---- catalog insertions: free, il chars at a fixed position ---- //
    if (ind) {
      int win[IL];
#pragma unroll
      for (int k = 0; k < IL; ++k) win[k] = i + k < W ? (int)rd[i + k] : 6;
      const bool gi0 = cur[0] < INF && pok[0];
      const bool gi1 = cur[1] < INF && pok[1];
#pragma unroll
      for (int s = 0; s < NI; ++s) {
        int il[2];
        bool mt[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          il[j] = (w0[j] >> (9 + 3 * s)) & 7;
          mt[j] = true;
#pragma unroll
          for (int k = 0; k < IL; ++k)
            if (k < il[j] && win[k] != ((sq[j][s] >> (8 * k)) & 0xFF))
              mt[j] = false;
        }
        for (int m = ins_mask; m; m &= m - 1) {
          const int L = __ffs(m) - 1;
          const bool fits = i + L <= len;
          const bool h0 = gi0 && il[0] == L && mt[0] && fits;
          const bool h1 = gi1 && il[1] == L && mt[1] && fits;
          pend_min(pend, L, h0 ? cur[0] : INF, h1 ? cur[1] : INF, lane);
          ov |= h0 && lane < L;             // d = 32 < L never holds
        }
      }
    }

    // ---- consume char i ---- //
    int nx[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int step = pok[j] ? (fr[j] ? 0 : 1) : INF;
      nx[j] = sat(min(cur[j] + step, INF), max_novel);
    }
    // novel insertions: 1-2 chars at a fixed position, at their length
    if (ind) {
#pragma unroll
      for (int L = 1; L <= 2; ++L) {
        const bool fits = i + L <= len;
        const bool h0 = cur[0] < INF && pok[0] && !fr[0] && fits;
        const bool h1 = cur[1] < INF && pok[1] && !fr[1] && fits;
        lshift_min(pend[L - 1], h0 ? cur[0] + L : INF,
                   h1 ? cur[1] + L : INF, L, lane);
        ov |= h0 && lane < L;
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      pend[q][0] = sat(pend[q][0], max_novel);
      pend[q][1] = sat(pend[q][1], max_novel);
    }
    if (live) {
      cur[0] = nx[0];
      cur[1] = nx[1];
    }
  }
  const bool any_over = __any_sync(FULL, ov);
  if (lane == 0) {
    cost[e] = fin;
    over_out[e] = any_over;
  }
}

}  // namespace

extern "C" int hgtpu_torch_banded_dp(const int* table, int rows,
                                     const int8_t* reads, int E, int W,
                                     const int* lens, const int* starts,
                                     int P, int max_novel, int del_mask,
                                     int ins_mask, int* cost, bool* over,
                                     void* stream) {
  if (E == 0) return 0;
  if (W <= 0 || rows <= 0 || (uintptr_t)table % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((E + WARPS - 1) / WARPS);
  banded_dp_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(table), rows, reads, E, W, lens, starts,
      P, max_novel, del_mask, ins_mask, cost, over);
  return (int)cudaGetLastError();
}
