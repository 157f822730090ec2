// K2: link-bitset AND-reduce for compatibility counting.
//
// Replaces hgtpu/ops/compat_kernel.py:and_reduce_pallas:
//
//     out[h, w] = AND_{k < K} links[row(vars[h, k]), w]
//
// over 32-bit words holding uint32 bit patterns (int32 in torch).  Padding
// slots of vars point at the all-ones sentinel row V.  row(v) is hgtpu's
// gather index: v + V + 1 for a negative v (numpy-style indexing, as
// jnp's gather and the Pallas kernel's interpret mode read it), then
// clamped into [0, V], as an XLA gather clamps it.
//
// Bound on the card: the bytes it must move are small (the [V+1, W] table
// once, vars once, out once: 10.2 MB at H = 16,384, K = 32 on the
// 3,600-allele panel, 3.0 us at 3.35 TB/s), but it gathers H * K rows of
// W words (237 MB there).  Served from L2 as 4-byte loads, those gathers
// are the kernel's time; served from shared memory they are bounded by
// its 128 B/clk per SM (~33.5 TB/s over 132 SMs, ~7 us there).
//
// Two variants, chosen by shape in the wrapper (ops/compat_kernel.py,
// k2_plan) from (V+1, W):
//
// * and_reduce_slab_kernel<WS>: the table in shared memory.  Each block
//   owns a slab of WS consecutive words of every link row (WS = 32, 16, 8
//   or 4: the widest whose V+1 rows fit beside the vars ring).
//   - Staging.  The slab comes in once, by TMA: the table's rows are
//     padded to a multiple of 4 words (DeviceCounter keeps it so; the
//     wrapper pads any other table), so a 2D tensor map describes it, and
//     the CLUSTER blocks of a cluster, all of one slab, each load a share
//     of its boxes and multicast them to all, so L2 serves each slab a
//     quarter as often.  4-byte cp.async of the unpadded rows (452 bytes
//     apart at W = 113) took longer than the whole reduction.
//   - The slab's row pitch is WS words: rows taken by neighbouring
//     threads (a haplotype's variants are near each other, so often v and
//     v + 1) tile the 32 banks, and every row stays 16-byte aligned.
//   - Persistent over H: the grid is (slabs) x (blocks per slab to fill
//     the SMs), and each block walks over tiles of HT = 128 haplotypes
//     (256 at WS = 4), so one staged slab serves many tiles.
//   - A tile's vars come into a two-stage ring in chunks of KC columns
//     (16-byte cp.async where K and the pointer allow).  Each warp stages
//     and reads only its own rows, so the ring needs __syncwarp and no
//     block barrier; a stage holds 8 KB per block, enough to cover L2's
//     latency while the stage before it reduces.  The ring's row pitch is
//     KC + 4 words, so eight rows read at one column by a quarter-warp hit
//     eight distinct 4-bank groups.
//   - Each thread owns 4 consecutive words (one uint4) of R of the tile's
//     haplotypes and ANDs 16-byte shared-memory rows, the k loop unrolled
//     by 8 so that eight independent loads are in flight; 16 warps per SM
//     where the slab leaves room (WS >= 16): at 8 warps the loop ran
//     about a third slower.
//   - Stores: one 16-byte store per thread into rows padded to a multiple
//     of 4 words (the wrapper returns the [H, W] view; single 4-byte
//     stores scattered over W = 113-word rows cost as much as the
//     staging), else single words; the ragged last slab is masked.
//   Tried on the card and dropped: turning a stage's indices into slab
//   offsets once (an extra pass per stage; slower), 32 warps per SM (no
//   faster), a one-stage prefetch of 32-haplotype tiles (slower).
// * and_reduce_wide_kernel: tables whose V+1 rows do not fit at WS = 4
//   (V+1 past ~12,000; no catalog the repo builds comes near).  One thread
//   per output word (h, w), looping over k; a warp covers 32 consecutive
//   words of one haplotype, so each link-row load is coalesced along w and
//   each vars load is one broadcast; the rows come from L2.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;          // the wide kernel's block
constexpr int KC = 16;               // vars columns per ring stage
constexpr int VPITCH = KC + 4;       // ring row pitch, words
constexpr int RING_STAGES = 2;
constexpr int CLUSTER = 4;           // blocks of one slab sharing its loads
constexpr int BOX_MAX = 256;         // rows of one TMA box
constexpr int SMEM_MAX = 232448;     // dynamic shared memory of one block

// by slab width: threads of a slab block (16 warps where the slab leaves
// room for their ring rows), haplotypes per tile (a ring stage of
// tile_rows(WS) rows of KC indices is 8 KB; 16 KB at WS = 4) and a
// thread's rows of each tile
__host__ __device__ constexpr int slab_threads(int ws) {
  return ws >= 16 ? 512 : 256;
}

__host__ __device__ constexpr int tile_rows(int ws) {
  return slab_threads(ws) / (ws / 4) > 128 ? slab_threads(ws) / (ws / 4)
                                           : 128;      // 128, ..., 256
}

__host__ __device__ constexpr int rows_per_thread(int ws) {
  return tile_rows(ws) / (slab_threads(ws) / (ws / 4));   // 2, 1, 1, 1
}

// shared memory of one block: the ring, the slab's rows (V1 rounded up to
// 8, so that every box lands 128-byte aligned), the slab's mbarrier
__host__ __device__ constexpr long long ring_bytes(int ws) {
  return 4LL * RING_STAGES * tile_rows(ws) * VPITCH;
}

__host__ __device__ inline long long slab_rows(int V1) {
  return (V1 + 7) / 8 * 8;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one box of the table, [rows, WS words] from (col, row), into the same
// shared-memory offset of every block in `mask`, counted on each one's bar
__device__ __forceinline__ void tma_multicast(void* dst, const CUtensorMap* map,
                                              int col, int row, uint64_t* bar,
                                              uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// This warp's rows of one ring stage, vars[h0 + r, k0 : k0 + KC] for the
// tile rows r its threads reduce (w * HPW + j + q * G, j < HPW, q < R):
// each warp fills and reads only its own rows, so the ring needs no block
// barrier.  Rows past H and columns past K are zero (read by no store /
// by no k step).
template <int WS>
__device__ __forceinline__ void stage_warp(int32_t* buf,
                                           const int32_t* __restrict__ vars,
                                           int H, int K, int h0, int k0,
                                           bool vec) {
  constexpr int TPH = WS / 4, G = slab_threads(WS) / TPH, HPW = 32 / TPH;
  constexpr int N = HPW * rows_per_thread(WS);   // rows of this warp
  const int lane = threadIdx.x % 32, w0 = threadIdx.x / 32 * HPW;
  if (vec) {                          // K % 4 == 0, vars 16-byte aligned
    constexpr int Q = KC / 4;
    for (int i = lane; i < N * Q; i += 32) {
      const int rr = i / Q, q = i % Q;
      const int r = w0 + rr % HPW + rr / HPW * G, h = h0 + r, k = k0 + 4 * q;
      int32_t* dst = buf + r * VPITCH + 4 * q;
      if (h < H && k < K)
        cp_async16(dst, vars + (long long)h * K + k);
      else
        *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
  } else {
    for (int i = lane; i < N * KC; i += 32) {
      const int rr = i / KC, j = i % KC;
      const int r = w0 + rr % HPW + rr / HPW * G, h = h0 + r, k = k0 + j;
      int32_t* dst = buf + r * VPITCH + j;
      if (h < H && k < K)
        cp_async4(dst, vars + (long long)h * K + k);
      else
        *dst = 0;
    }
  }
}

// hgtpu's gather index of v into a table of vmax + 1 rows
__device__ __forceinline__ int row(int v, int vmax) {
  return min(max(v < 0 ? v + vmax + 1 : v, 0), vmax);
}

__device__ __forceinline__ void and4(uint4& acc, const uint4 r) {
  acc.x &= r.x;
  acc.y &= r.y;
  acc.z &= r.z;
  acc.w &= r.w;
}

template <int WS>
__global__ void __launch_bounds__(slab_threads(WS))
    and_reduce_slab_kernel(const __grid_constant__ CUtensorMap map, int V1,
                           int W, int box, int n_box,
                           const int32_t* __restrict__ vars, int H, int K,
                           int32_t* __restrict__ out, int opitch,
                           bool vec_in, bool vec_out) {
  constexpr int TPH = WS / 4;             // threads per haplotype
  constexpr int G = slab_threads(WS) / TPH;   // haplotypes at once
  constexpr int R = rows_per_thread(WS);  // a thread's rows per tile
  constexpr int HT = tile_rows(WS);       // haplotypes per tile, G * R
  constexpr int S = RING_STAGES;
  extern __shared__ __align__(128) int4 smem4[];
  int32_t* ring = reinterpret_cast<int32_t*>(smem4);
  int32_t* slab = ring + S * HT * VPITCH;
  uint64_t* bar = reinterpret_cast<uint64_t*>(slab + slab_rows(V1) * WS);
  cg::cluster_group cluster = cg::this_cluster();

  const int w_base = blockIdx.x * WS;
  const int wv = min(WS, W - w_base);     // valid words of this slab
  const int share = blockIdx.y, n_share = gridDim.y;
  const int n_tiles = (H + HT - 1) / HT;
  const int n_kc = max(1, (K + KC - 1) / KC);
  const int my_tiles =
      share < n_tiles ? (n_tiles - 1 - share) / n_share + 1 : 0;
  const int n_stage = my_tiles * n_kc;

  // the slab: every block of the cluster expects all n_box boxes; block
  // rank r loads boxes r, r + CLUSTER, ... for all of them (blocks with no
  // tile still load their share)
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_expect(bar, (unsigned)(n_box * box * WS * 4));
  }
  cluster.sync();                         // every barrier armed
  if (threadIdx.x == 0) {
    const int last = (int)slab_rows(V1) - box;
    for (int b = (int)cluster.block_rank(); b < n_box; b += CLUSTER) {
      const int r0 = min(b * box, last);
      tma_multicast(slab + r0 * WS, &map, w_base, r0, bar,
                    (uint16_t)((1 << CLUSTER) - 1));
    }
  }
  // stage s: tile share + n_share * (s / n_kc), columns (s % n_kc) * KC
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_stage)
      stage_warp<WS>(ring + s * HT * VPITCH, vars, H, K,
                     (share + n_share * (s / n_kc)) * HT, (s % n_kc) * KC,
                     vec_in);
    cp_async_commit();                    // empty groups keep the count
  }
  mbar_wait(bar, 0);                      // the whole slab has landed here
  // ... so no more of it comes in: arrive now, wait before leaving
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  const int hl = threadIdx.x / TPH, g = threadIdx.x % TPH;
  const bool active = 4 * g < wv;
  const int32_t* my_col = slab + 4 * g;
  const int vmax = V1 - 1;
  uint4 acc[R];                           // rows hl, hl + G, ...

  for (int i = 0; i < n_stage; ++i) {
    const int t = share + n_share * (i / n_kc), c = i % n_kc;
    cp_async_wait<S - 2>();               // this warp's stage i landed
    __syncwarp();                         // ... for all its lanes, and its
    {                                     // rows of stage i - 1 are free
      const int s = i + S - 1;
      if (s < n_stage)
        stage_warp<WS>(ring + (s % S) * HT * VPITCH, vars, H, K,
                       (share + n_share * (s / n_kc)) * HT, (s % n_kc) * KC,
                       vec_in);
      cp_async_commit();
    }
    if (!active) continue;
    const int kn = min(KC, K - c * KC);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int32_t* vr =
          ring + (i % S) * HT * VPITCH + (hl + q * G) * VPITCH;
      if (c == 0) acc[q] = make_uint4(~0u, ~0u, ~0u, ~0u);
      int k = 0;
      for (; k + 8 <= kn; k += 8) {
        const int4 a = *reinterpret_cast<const int4*>(vr + k);
        const int4 b = *reinterpret_cast<const int4*>(vr + k + 4);
        const int idx[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        uint4 r[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          r[u] = *reinterpret_cast<const uint4*>(my_col +
                                                 row(idx[u], vmax) * WS);
#pragma unroll
        for (int u = 0; u < 8; ++u) and4(acc[q], r[u]);
      }
      for (; k < kn; ++k)
        and4(acc[q], *reinterpret_cast<const uint4*>(
                         my_col + row(vr[k], vmax) * WS));
      const int h = t * HT + hl + q * G;
      if (c == n_kc - 1 && h < H) {
        int32_t* o = out + (long long)h * opitch + w_base + 4 * g;
        if (vec_out) {                  // words past W land in the padding
          *reinterpret_cast<uint4*>(o) = acc[q];
        } else {
          const unsigned word[4] = {acc[q].x, acc[q].y, acc[q].z, acc[q].w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (4 * g + j < wv) o[j] = (int32_t)word[j];
        }
      }
    }
  }
  // no block leaves before every block of the cluster has its whole slab
  // (the boxes this one multicast included)
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void and_reduce_wide_kernel(const int32_t* __restrict__ links,
                                       int V1, int W, int pitch,
                                       const int32_t* __restrict__ vars,
                                       int H, int K, int32_t* __restrict__ out,
                                       int opitch) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)H * W) return;
  const int h = (int)(idx / W), w = (int)(idx % W);
  const int32_t* vr = vars + (long long)h * K;
  int32_t acc = -1;                      // all ones
  for (int k = 0; k < K; ++k)
    acc &= links[(long long)row(vr[k], V1 - 1) * pitch + w];
  out[(long long)h * opitch + w] = acc;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int WS>
int launch_slab(const int32_t* links, int V1, int W, int pitch,
                const int32_t* vars, int H, int K, int32_t* out, int opitch,
                cudaStream_t stream) {
  const long long smem = ring_bytes(WS) + 4LL * slab_rows(V1) * WS + 16;
  if (smem > SMEM_MAX || pitch % 4 || ((uintptr_t)links & 15))
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // the table as a 2D tensor [V1 rows, W words], rows pitch words apart;
  // a box is [box rows, WS words]; columns past W and rows past V1 read 0
  const int box = (int)(slab_rows(V1) < BOX_MAX ? slab_rows(V1) : BOX_MAX);
  const int n_box = (int)((slab_rows(V1) + box - 1) / box);
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)V1};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 4};
  const cuuint32_t box_dim[2] = {(cuuint32_t)WS, (cuuint32_t)box};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, (void*)links, dims,
             strides, box_dim, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  auto kernel = and_reduce_slab_kernel<WS>;
  // per-variant cache of the shared-memory opt-in and of the occupancy
  static long long set_bytes = 0, occ_bytes = -1;
  static int clusters = 1;
  cudaError_t err;
  if (smem > set_bytes) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    set_bytes = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = CLUSTER;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(slab_threads(WS));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int n_slabs = (W + WS - 1) / WS;
  if (smem != occ_bytes) {
    cfg.gridDim = dim3(n_slabs, CLUSTER);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    clusters = clusters < 1 ? 1 : clusters;
    occ_bytes = smem;
  }
  // blocks per slab: a multiple of CLUSTER, filling the resident clusters
  int n_share = clusters / n_slabs * CLUSTER;
  n_share = n_share < CLUSTER ? CLUSTER : n_share;
  const int n_tiles = (H + tile_rows(WS) - 1) / tile_rows(WS);
  const int most = (n_tiles + CLUSTER - 1) / CLUSTER * CLUSTER;
  n_share = n_share > most ? most : n_share;
  if (n_share > 65532) n_share = 65532;
  cfg.gridDim = dim3(n_slabs, n_share);
  const bool vec_in = K % 4 == 0 && ((uintptr_t)vars & 15) == 0;
  const bool vec_out = opitch % 4 == 0 && ((uintptr_t)out & 15) == 0;
  err = cudaLaunchKernelEx(&cfg, kernel, map, V1, W, box, n_box, vars, H, K,
                           out, opitch, vec_in, vec_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// links: [V1, W] int32 rows `pitch` words apart (pitch >= W; the slab
// kernel wants pitch % 4 == 0 and a 16-byte aligned table), vars: [H, K]
// int32, out: [H, W] int32 rows `opitch` words apart (opitch >= W; with
// opitch a multiple of 4, the slab kernel may write the padding); ws is
// the slab width in words (32, 16, 8 or 4).  Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a width whose slab does not fit or
// a table it cannot map).
extern "C" int hgtpu_torch_and_reduce_slab(const int32_t* links, int V1,
                                           int W, int pitch,
                                           const int32_t* vars, int H, int K,
                                           int32_t* out, int opitch, int ws,
                                           void* stream) {
  if ((long long)H * W == 0) return 0;
  if (pitch < W || opitch < W) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ws) {
    case 32:
      return launch_slab<32>(links, V1, W, pitch, vars, H, K, out, opitch, s);
    case 16:
      return launch_slab<16>(links, V1, W, pitch, vars, H, K, out, opitch, s);
    case 8:
      return launch_slab<8>(links, V1, W, pitch, vars, H, K, out, opitch, s);
    case 4:
      return launch_slab<4>(links, V1, W, pitch, vars, H, K, out, opitch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same function for any table size, its rows read from L2.
extern "C" int hgtpu_torch_and_reduce_wide(const int32_t* links, int V1,
                                           int W, int pitch,
                                           const int32_t* vars, int H, int K,
                                           int32_t* out, int opitch,
                                           void* stream) {
  const long long total = (long long)H * W;
  if (total == 0) return 0;
  if (pitch < W || opitch < W) return (int)cudaErrorInvalidValue;
  const long long blocks = (total + THREADS - 1) / THREADS;
  and_reduce_wide_kernel<<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(links, V1, W, pitch, vars,
                                                   H, K, out, opitch);
  return (int)cudaGetLastError();
}
