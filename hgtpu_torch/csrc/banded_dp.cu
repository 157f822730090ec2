// The banded variant-aware DP of device verify, as two CUDA kernels.
//
// Replaces hgtpu/ops/banded_dp.py:140 (_banded_costs), which hgtpu writes
// in jnp (a lax.scan over the W + 1 read positions, fused by XLA into one
// program): no Pallas kernel, but a scan on the hot path, which eager
// torch would run as ~10^4 small launches per call.  The plain torch
// version beside it is ops/banded_dp.py:banded_costs_plain; both kernels
// must give the same cost and over, bit for bit.  ops/banded_dp.py:dp_plan
// picks one from the edit budget alone: the bit kernel for budgets 0..7,
// the warp kernel above.
//
// Per proposal e (read codes reads[e, :W], length lens[e], backbone start
// starts[e]) the state is a band of D = 33 diagonals d (backbone position
// start + i + d - DNEG after i read chars): cur[D], IL pending planes of
// catalog and novel insertions, final and over.  Every transition is a
// shift of the band by a deletion length (right, <= DPOS) or an insertion
// length (left, <= IL), masked by per-row flags.
//
// What bounds it on this card: the positions of a read are a dependent
// chain, and each is some 5 * (n_del + 2) + 8 masked mins over the band,
// integer work on the CUDA cores (64 int32 lanes per SM and clock).  The
// bytes are small: E * W code bytes, two ints a proposal, row flags that
// stay on chip.
//
// Bit kernel (budgets b <= 7).  With saturation every value of every plane
// is in {0..b} or INF, so a plane is b + 1 threshold masks T_k = {d :
// v[d] <= k}, one uint64_t each, bit d for diagonal d (d = 32 is bit 32).
// Then the scan is word logic on the b + 1 levels of one thread: min is
// OR, where(mask, v, INF) is AND, a shift by L diagonals is a word shift
// of every level, + L (novel edits) moves level k - L into level k, sat is
// dropping levels above b, final is the lowest non-empty level, c_extra <
// c is a level of c_extra holding a bit its twin in c lacks, and a
// band-edge test is an AND with the top or bottom L bits.  One thread per
// proposal, the levels in registers (NL = b + 1 is a template argument).
// Row flags are bit planes over the rows (ops/banded_dp.py:bit_planes):
// free per base code, over, "a catalog insertion", "a catalog deletion",
// one plane per deletion length.  A position reads 33-bit windows of them
// (two words and a funnel shift); the planes (11 + n_del of about
// (P + 10) / 64 + 2 words: 16 KB with all 24 deletion lengths at P =
// 3,557) are staged in shared memory per block, up to SMEM_PLANES bytes
// (above 48 KB as dynamic shared memory, after cudaFuncSetAttribute);
// taller genes read them through L1 from device memory.  Catalog
// insertions are sparse rows: the set bits of window(insertion) & gate
// are walked with __ffsll and checked against the packed table and a
// register of the next four read codes.  Each thread loads its read 16
// codes at a time.  The closure stops once a relaxation changes nothing:
// every later one would repeat it, over included.  A thread ends at
// min(len, W), as the warp kernel does.
//
// Warp kernel (any budget; simple and right first): one warp per
// proposal, lane l holds diagonal d = l, and lane 0 holds d = 32 in a
// second slot.  A shift by L is one __shfl_sync (lane l reads lane l - L,
// or l + L; lane 0's second slot reads lane 32 - L), so a relaxation
// costs one shuffle and no shared memory.  Each lane loads its own row of
// the packed table (four int32 words a row, ops/banded_dp.py:pack_rows;
// neighbouring lanes, neighbouring rows).  The deletion and insertion
// lengths are bit masks (bit L set), walked with __ffs, in place of
// hgtpu's static tuples.  over is OR'd per lane and reduced once at the
// end; final is a warp min at i == lens[e], and the warp stops there: past
// it no state reaches final or over (live and indels_on are off, every
// plane stays saturated).
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
constexpr int WARPS = 4;              // warp kernel: proposals per block

static_assert(D == 33, "the layout holds d = 32 in lane 0's second slot");
static_assert(IL == 4, "the bit kernel gathers catalog insertions of 1-4");

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
banded_dp_warp_kernel(const int4* __restrict__ table, int rows,
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


// ---------------------------------------------------------------------- //
// Bit kernel: threshold masks, one thread per proposal.
// ---------------------------------------------------------------------- //

constexpr int BITS_THREADS = 64;      // proposals per block
constexpr int PL_OVER = 8, PL_INS = 9, PL_DEL_ANY = 10, PL_DEL = 11;
constexpr int PLANE_PAD = 64;         // bit PLANE_PAD + r is row r
constexpr uint64_t BAND = (1ull << D) - 1;
// the planes are staged in shared memory up to this size (of the 227 KB a
// block may have); taller genes read them from device memory through L1
constexpr int SMEM_PLANES = 200 * 1024;

// bits idx .. idx + 32 of a plane
__device__ __forceinline__ uint64_t window(const uint64_t* plane, int idx) {
  const int w = idx >> 6, s = idx & 63;
  const uint64_t lo = plane[w];
  const uint64_t hi = plane[w + 1];
  return (s ? (lo >> s) | (hi << (64 - s)) : lo) & BAND;
}

// One read's codes, walked forward: the next code comes from a 16-byte
// chunk loaded at once (one int4 where the row allows it), 6 past W.
struct CodeStream {
  const int8_t* rd;
  int W;
  bool vec;                           // 16-byte aligned rows
  uint4 buf;
  int at = -1;                        // first code of buf

  __device__ __forceinline__ uint32_t get(int j) {
    if (j >= W) return 6u;
    const int c0 = j & ~15;
    if (c0 != at) {
      at = c0;
      if (vec) {
        buf = __ldg(reinterpret_cast<const uint4*>(rd + c0));
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int t = 0; t < 16; ++t)
          if (c0 + t < W) w[t >> 2] |= (uint32_t)(uint8_t)rd[c0 + t]
                                       << (8 * (t & 3));
        buf = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    const uint32_t word = (j & 8) ? ((j & 4) ? buf.w : buf.z)
                                  : ((j & 4) ? buf.y : buf.x);
    return (word >> (8 * (j & 3))) & 0xFFu;
  }
};

// One relaxation of the closure on levels c into nw (catalog deletions
// free, novel deletions of length 1-2 at their length), on a layer whose
// indels are on; idx is the band's window in the planes, pok the
// diagonals inside the backbone, fr the free ones among them.
template <int NL>
__device__ __forceinline__ void relax_bits(
    const uint64_t (&c)[NL], uint64_t (&nw)[NL], const uint64_t* planes,
    int words, int idx, uint64_t pok, uint64_t fr, uint64_t dany,
    int del_mask, bool& ov) {
  const uint64_t gate = c[NL - 1] & pok;
#pragma unroll
  for (int j = 0; j < NL; ++j) nw[j] = c[j];
  if (gate & dany) {
    int k = 0;
    for (int m = del_mask; m; m &= m - 1, ++k) {
      const int L = __ffs(m) - 1;
      const uint64_t has = gate & window(planes + (PL_DEL + k) * words, idx);
      if (!has) continue;
      ov |= (has >> (D - L)) != 0;        // mass past d = D - 1
#pragma unroll
      for (int j = 0; j < NL; ++j) nw[j] |= ((c[j] & has) << L) & BAND;
    }
  }
  const uint64_t ng = gate & ~fr;          // novel deletions cost their len
  if (ng) {
#pragma unroll
    for (int L = 1; L <= 2; ++L) {
      ov |= (ng >> (D - L)) != 0;
#pragma unroll
      for (int j = L; j < NL; ++j) nw[j] |= ((c[j - L] & ng) << L) & BAND;
    }
  }
}

template <int NL>
__global__ void __launch_bounds__(BITS_THREADS)
banded_dp_bits_kernel(const uint64_t* __restrict__ planes_g, int words,
                      int smem_words, const int4* __restrict__ table,
                      const int8_t* __restrict__ reads, int E, int W,
                      const int* __restrict__ lens,
                      const int* __restrict__ starts, int P, int del_mask,
                      int ins_mask, int* __restrict__ cost,
                      bool* __restrict__ over_out) {
  extern __shared__ __align__(16) uint64_t smem[];
  const uint64_t* planes = planes_g;
  if (smem_words) {                         // every plane, 16 bytes a load
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(planes_g);
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(smem);
    for (int k = threadIdx.x; k < smem_words / 2; k += blockDim.x)
      dst[k] = __ldg(src + k);
    __syncthreads();
    planes = smem;
  }
  const int e = blockIdx.x * BITS_THREADS + threadIdx.x;
  if (e >= E) return;
  const int len = lens[e];
  const int start = starts[e];
  const int8_t* rd = reads + (size_t)e * W;
  CodeStream cs{rd, W, ((uintptr_t)reads & 15) == 0 && (W & 15) == 0};
  const int last_code = rd[W - 1];

  uint64_t cur[NL], pend[IL][NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    cur[j] = 1ull << DNEG;                  // cost 0 on the start diagonal
#pragma unroll
    for (int q = 0; q < IL; ++q) pend[q][j] = 0;
  }
  int fin = INF;
  bool ov = false;
  // codes i .. i + 3, one byte each (6 past W)
  uint32_t win4 = cs.get(0) | cs.get(1) << 8 | cs.get(2) << 16
                  | cs.get(3) << 24;

  const int last = len < 0 ? -1 : min(len, W);
  for (int i = 0; i <= last; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      cur[j] |= pend[0][j];
#pragma unroll
      for (int q = 0; q < IL - 1; ++q) pend[q][j] = pend[q + 1][j];
      pend[IL - 1][j] = 0;
    }
    if (i == len) {
#pragma unroll
      for (int j = NL - 1; j >= 0; --j)
        if (cur[j]) fin = j;
    }
    const bool live = i < len;
    const bool ind = i > 0 && live;         // indels allowed this layer
    const int ch = min(max(i < W ? (int)(int8_t)(win4 & 0xFF) : last_code,
                           0), 7);
    // diagonals inside the backbone: 0 <= base + d < P
    const int base = start + i - DNEG;
    const int dlo = max(0, -base), dhi = min(D, P - base);
    const uint64_t pok = dhi > dlo ? ((1ull << (dhi - dlo)) - 1) << dlo : 0;
    const int idx = base + OFF + PLANE_PAD; // bit of row(d = 0) when pok
    const uint64_t fr = pok ? window(planes + ch * words, idx) & pok : 0;

    if (ind && pok) {
      // rows whose catalog indels exceed the packed slots poison any
      // finite state that touches them
      ov |= (cur[NL - 1] & pok & window(planes + PL_OVER * words, idx)) != 0;

      // ---- intra-layer closure: catalog + novel deletions ---- //
      const uint64_t dany = window(planes + PL_DEL_ANY * words, idx);
      uint64_t c[NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) c[j] = cur[j];
#pragma unroll 1
      for (int it = 0; it <= NITER; ++it) {
        uint64_t nw[NL];
        relax_bits<NL>(c, nw, planes, words, idx, pok, fr, dany, del_mask,
                       ov);
        uint64_t diff = 0;
#pragma unroll
        for (int j = 0; j < NL; ++j) diff |= nw[j] ^ c[j];
        // converged: every later relaxation repeats this one, over
        // included, and the extra one finds nothing lower
        if (!diff) break;
        // the extra relaxation lowered a cost: chains deeper than NITER
        if (it == NITER) {
          ov = true;
          break;
        }
#pragma unroll
        for (int j = 0; j < NL; ++j) c[j] = nw[j];
      }
#pragma unroll
      for (int j = 0; j < NL; ++j) cur[j] = c[j];

      // ---- catalog insertions: free, il chars at a fixed position ---- //
      // the diagonals each length moves, gathered first: pend indexed by
      // a length known only here would leave registers for local memory
      uint64_t to1 = 0, to2 = 0, to3 = 0, to4 = 0;
      uint64_t cand = cur[NL - 1] & pok & window(planes + PL_INS * words, idx);
      while (cand) {
        const int d = __ffsll(cand) - 1;
        cand &= cand - 1;
        const int4 r = __ldg(table + (base + OFF + d));
#pragma unroll
        for (int s = 0; s < NI; ++s) {
          const int il = (r.x >> (9 + 3 * s)) & 7;
          if (!il || !((ins_mask >> il) & 1) || i + il > len) continue;
          const uint32_t seq = (uint32_t)(s ? r.w : r.z);
          const uint32_t bytes = il >= 4 ? 0xFFFFFFFFu : (1u << (8 * il)) - 1;
          if ((win4 ^ seq) & bytes) continue;
          if (d < il) {                     // lands left of d = 0
            ov = true;
            continue;
          }
          const uint64_t bit = 1ull << d;
          to1 |= il == 1 ? bit : 0;
          to2 |= il == 2 ? bit : 0;
          to3 |= il == 3 ? bit : 0;
          to4 |= il == 4 ? bit : 0;
        }
      }
      const uint64_t to[IL] = {to1, to2, to3, to4};
#pragma unroll
      for (int q = 0; q < IL; ++q)
        if (to[q]) {
#pragma unroll
          for (int j = 0; j < NL; ++j)
            pend[q][j] |= (cur[j] & to[q]) >> (q + 1);
        }
    }

    // ---- consume char i: + 0 where free, + 1 elsewhere in the backbone //
    const uint64_t miss = pok & ~fr;
    uint64_t nx[NL];
    nx[0] = cur[0] & fr;
#pragma unroll
    for (int j = 1; j < NL; ++j) nx[j] = (cur[j] & fr) | (cur[j - 1] & miss);
    // novel insertions: 1-2 chars at a fixed position, at their length
    if (ind) {
      const uint64_t ng = cur[NL - 1] & miss;
      if (ng) {
#pragma unroll
        for (int L = 1; L <= 2; ++L) {
          if (i + L > len) continue;
          ov |= (ng & ((1ull << L) - 1)) != 0;
#pragma unroll
          for (int j = L; j < NL; ++j)
            pend[L - 1][j] |= (cur[j - L] & ng) >> L;
        }
      }
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < NL; ++j) cur[j] = nx[j];
    }
    win4 = (win4 >> 8) | cs.get(i + 4) << 24;
  }
  cost[e] = fin;
  over_out[e] = ov;
}

template <int NL>
int launch_bits(const uint64_t* planes, int n_planes, int words,
                const int4* table, const int8_t* reads, int E, int W,
                const int* lens, const int* starts, int P, int del_mask,
                int ins_mask, int* cost, bool* over, cudaStream_t stream) {
  const size_t bytes = (size_t)n_planes * words * sizeof(uint64_t);
  const int smem = bytes <= (size_t)SMEM_PLANES ? (int)bytes : 0;
  static int allowed = 48 * 1024;           // dynamic bytes set so far
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_dp_bits_kernel<NL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const dim3 grid((E + BITS_THREADS - 1) / BITS_THREADS);
  banded_dp_bits_kernel<NL><<<grid, BITS_THREADS, smem, stream>>>(
      planes, words, smem ? n_planes * words : 0, table, reads, E, W, lens,
      starts, P, del_mask, ins_mask, cost, over);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hgtpu_torch_banded_dp_warp(const int* table, int rows,
                                          const int8_t* reads, int E, int W,
                                          const int* lens, const int* starts,
                                          int P, int max_novel, int del_mask,
                                          int ins_mask, int* cost, bool* over,
                                          void* stream) {
  if (E == 0) return 0;
  if (W <= 0 || rows <= 0 || (uintptr_t)table % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((E + WARPS - 1) / WARPS);
  banded_dp_warp_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(table), rows, reads, E, W, lens, starts,
      P, max_novel, del_mask, ins_mask, cost, over);
  return (int)cudaGetLastError();
}

extern "C" int hgtpu_torch_banded_dp_bits(
    const int64_t* planes, int n_planes, int words, const int* table,
    int rows, const int8_t* reads, int E, int W, const int* lens,
    const int* starts, int P, int max_novel, int del_mask, int ins_mask,
    int* cost, bool* over, void* stream) {
  if (E == 0) return 0;
  // every row a diagonal inside the backbone reads must be in the table,
  // and the planes must hold the word after the last window's
  if (W <= 0 || P + OFF > rows || (words & 1)
      || words < (OFF + P + 63) / 64 + 2
      || n_planes < PL_DEL + __builtin_popcount(del_mask)
      || (uintptr_t)table % 16 != 0 || (uintptr_t)planes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* pl = reinterpret_cast<const uint64_t*>(planes);
  const auto* tb = reinterpret_cast<const int4*>(table);
  cudaStream_t st = (cudaStream_t)stream;
#define HGTPU_BITS(NL)                                                      \
  case NL - 1:                                                              \
    return launch_bits<NL>(pl, n_planes, words, tb, reads, E, W, lens,      \
                           starts, P, del_mask, ins_mask, cost, over, st);
  switch (max_novel) {
    HGTPU_BITS(1)
    HGTPU_BITS(2)
    HGTPU_BITS(3)
    HGTPU_BITS(4)
    HGTPU_BITS(5)
    HGTPU_BITS(6)
    HGTPU_BITS(7)
    HGTPU_BITS(8)
  }
#undef HGTPU_BITS
  return (int)cudaErrorInvalidValue;        // budgets past 7: the warp kernel
}
