// K1: all-diagonal placement scores on Hopper's tensor cores.
//
// Replaces hgtpu/ops/placement_pallas.py:placement_scores_pallas (through
// its wrapper correlate_scores_pallas): the bf16 product of one-hot reads
// [N, m*5] by backbone windows [m*5, P1], summed in float32,
//
//     out[n, p] = sum_{j < m} sum_{b < 5} [reads[n, j] == b] * bf16(pwm[p + j, b])
//
// Codes outside [0, 5) score 0, as an all-zero one-hot row did.  PWM
// entries are 0/1 on the main path, so every partial sum is an integer
// <= m, exact in float32 in any order: the result equals the plain version.
//
// Bound on the card: 2 * N * 5m * P1 tensor-core FLOP (38.6 G at N = 8192,
// m = 128, P1 = 3,686: 39 us at the bf16 dense peak) against the [N, P1]
// float32 output write (120.8 MB: 36 us at 3.35 TB/s).  Neither operand of
// the product ever exists in device memory.  What bounds this design (H100
// SXM, 700 W, that shape: ~0.107 ms): the product phase alone takes
// ~0.085 ms, because the blocks of a wave load, build their Hankel tiles
// and drain their wgmmas in step, and the stores alone ~0.056 ms; they
// overlap only across blocks.  A persistent block that overlaps one
// tile's stores with the next tile's products is the next step.  Design:
//
//  * K is ordered base-major (k = b * m + j), so a k16 chunk is one base b
//    and 16 consecutive read positions j0 .. j0 + 15.  A block owns
//    TILE_P = 128 diagonals (wgmma N) and TILE_N = 128 reads in two
//    warpgroups of 64 (wgmma M): wgmma.mma_async m64n128k16, bf16 in, f32
//    sums, as the MXU did.
//  * A from registers: each thread builds its fragment from the int8 codes
//    of its two fragment rows, (code == b) ? 1.0 : 0.0 in bf16 (vcmpeq4 on
//    four packed codes, byte_perm, AND with the bits of 1.0).  The codes of
//    a chunk are loaded once and serve all five bases; the one-hot matrix
//    never exists in memory.
//  * B as a Hankel tile: M_b[r, t] = bf16(pwm[p0 + r + t, b]) for t < 16.
//    The B tile of chunk (b, j0) is rows [j0, j0 + 128) of M_b, K-major.
//    M_b is kept in the no-swizzle canonical layout (core matrices of
//    8 rows x 16 bytes; LBO = 128 B between the two k-halves, SBO = 256 B
//    between 8-row groups), whose pattern repeats every 8 rows, so every
//    chunk's descriptor is the same matrix with its start moved j0 rows
//    (j0 * 32 bytes).  B takes 5 * (128 + slab - 16) * 32 bytes of shared
//    memory (38 KB at m = 128) where the window tile would take 160 KB.
//    Reads longer than SLAB = 512 rebuild M_b for each slab of 512.
//  * The codes stream along j through a 3-stage cp.async ring of
//    [128 reads x 64 positions], so the copy of a stage overlaps the
//    wgmmas of the one before.
//  * The epilogue stages the [128 x 128] float32 tile in the shared memory
//    the products no longer need and stores it row by row, 256 contiguous
//    bytes a warp instruction (128 where P1 is odd).  The row stride P1 * 4 is not 16-byte
//    aligned at P1 = 3,686, so there is no TMA or float4 store, and
//    stores straight from the accumulator fragments (8 rows x 32 bytes a
//    warp instruction, each straddling two sectors) ran at 0.9 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_P = 128;               // diagonals per block: wgmma N
constexpr int WG_ROWS = 64;               // reads per warpgroup: wgmma M
constexpr int N_WG = 2;                   // warpgroups per block
constexpr int TILE_N = WG_ROWS * N_WG;    // reads per block
constexpr int THREADS = 128 * N_WG;
constexpr int JC = 64;                    // read positions per ring stage
constexpr int STAGES = 3;                 // depth of the codes ring
constexpr int CODE_ROW = JC + 16;         // ring row bytes, padded so the
                                          // fragment loads hit 8 banks
constexpr int SLAB = 512;                 // read positions per Hankel build
constexpr int HROW = 32;                  // bytes per Hankel row (16 bf16)
constexpr int OUT_ROW = TILE_P + 8;       // staged output row (floats),
                                          // padded: conflict-free float2s
constexpr uint32_t BF16_ONE_X2 = 0x3F803F80u;

__host__ __device__ constexpr int slab_of(int m) { return m < SLAB ? m : SLAB; }
__host__ __device__ constexpr int hankel_rows(int slab) {
  return TILE_P + slab - 16;
}

// Dynamic shared memory for read width m: the five M_b, the codes ring,
// and the slab's PWM span as bf16 [5][TILE_P + slab - 1]; the output
// tile reuses it from the start once the products are done.
size_t smem_bytes(int m) {
  const int slab = slab_of(m);
  const size_t main = 5 * (size_t)hankel_rows(slab) * HROW
                      + (size_t)STAGES * TILE_N * CODE_ROW
                      + 5 * (size_t)(TILE_P + slab - 1) * sizeof(uint16_t);
  const size_t tile = (size_t)TILE_N * OUT_ROW * sizeof(float);
  return main > tile ? main : tile;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across this point.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory descriptor of a K-major B tile in the no-swizzle layout:
// start address, LBO = 128 B (k-half to k-half), SBO = 256 B (8-row group
// to 8-row group), all in 16-byte units; layout type 0.
__device__ __forceinline__ uint64_t hankel_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)(128 >> 4) << 16)
         | ((uint64_t)(256 >> 4) << 32);
}

// d[64 x 128] += A[64 x 16] (bf16 fragment in registers) * B[16 x 128]
// (bf16 in shared memory, K-major, through desc); f32 sums.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// m % 16 == 0, m > 0, reads 16-byte aligned (the launcher checks).
__global__ void __launch_bounds__(THREADS, 2)
placement_scores_kernel(const float* __restrict__ pwm, int n_rows,
                        const int8_t* __restrict__ reads, int N, int m,
                        float* __restrict__ out, int P1) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int slab = slab_of(m);
  const int hrows = hankel_rows(slab);
  const int span = TILE_P + slab - 1;
  uint8_t* hankel = smem;                                  // [5][hrows][32 B]
  int8_t* ring = reinterpret_cast<int8_t*>(hankel + 5 * hrows * HROW);
  uint16_t* pwm_s =                                        // [5][span] bf16
      reinterpret_cast<uint16_t*>(ring + STAGES * TILE_N * CODE_ROW);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TILE_N;
  const int p0 = blockIdx.y * TILE_P;
  const int n_stages = (m + JC - 1) / JC;

  // Stage s of the codes: [TILE_N reads x JC positions], 16 bytes a copy.
  auto load_stage = [&](int s) {
    if (s < n_stages) {
      int8_t* dst = ring + (s % STAGES) * TILE_N * CODE_ROW;
      for (int q = tid; q < TILE_N * (JC / 16); q += THREADS) {
        const int r = q / (JC / 16), jj = (q % (JC / 16)) * 16;
        if (s * JC + jj < m) {
          const int n = min(n0 + r, N - 1);   // rows past N are never stored
          cp_async16(dst + r * CODE_ROW + jj,
                     reads + (size_t)n * m + s * JC + jj);
        }
      }
    }
    cp_async_commit();                         // one group per stage
  };

  // This thread's fragment rows (row and row + 8) and column pair 2t.
  const int lane = tid % 32;
  const int row = (tid / 128) * WG_ROWS + (tid % 128) / 32 * 16 + lane / 4;
  const int t = lane % 4;
  const uint32_t hankel_base = smem_addr(hankel);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_stage(s);

  for (int s = 0; s < n_stages; ++s) {
    const int js = s * JC;
    if (js % SLAB == 0) {
      // (Re)build the five M_b for positions [js, js + slab), once no
      // wgmma of the block still reads the previous slab's.
      wgmma_wait_all();
      __syncthreads();
      for (int i = tid; i < span * 5; i += THREADS) {
        const int r = i / 5, b = i % 5;        // [rows, 5]: coalesced
        const int prow = p0 + js + r;
        const float v = prow < n_rows ? pwm[(size_t)prow * 5 + b] : 0.f;
        pwm_s[b * span + r] = __bfloat16_as_ushort(__float2bfloat16(v));
      }
      __syncthreads();
      // Task q writes bytes [16q, 16q + 16): base b, row r, k-half h of
      // the core-matrix layout, i.e. bf16 pwm rows r + 8h .. r + 8h + 7.
      for (int q = tid; q < 5 * hrows * 2; q += THREADS) {
        const int b = q / (2 * hrows), qq = q % (2 * hrows);
        const int r = qq / 16 * 8 + qq % 8, h = qq / 8 % 2;
        const uint16_t* src = pwm_s + b * span + r + 8 * h;
        uint4 v;
        v.x = src[0] | (uint32_t)src[1] << 16;
        v.y = src[2] | (uint32_t)src[3] << 16;
        v.z = src[4] | (uint32_t)src[5] << 16;
        v.w = src[6] | (uint32_t)src[7] << 16;
        reinterpret_cast<uint4*>(hankel)[q] = v;
      }
      // make the generic-proxy stores visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    load_stage(s + STAGES - 1);
    cp_async_wait<STAGES - 1>();               // stage s has landed
    __syncthreads();

    const int8_t* codes = ring + (s % STAGES) * TILE_N * CODE_ROW;
    const uint16_t* ca =
        reinterpret_cast<const uint16_t*>(codes + row * CODE_ROW);
    const uint16_t* cb =
        reinterpret_cast<const uint16_t*>(codes + (row + 8) * CODE_ROW);
    const int nk = min(JC, m - js) / 16;
#pragma unroll
    for (int c = 0; c < JC / 16; ++c) {
      if (c < nk) {
        // codes at j = js + 16c + {2t, 2t+1, 2t+8, 2t+9}, one byte each
        const uint32_t qa = ca[8 * c + t] | (uint32_t)ca[8 * c + t + 4] << 16;
        const uint32_t qb = cb[8 * c + t] | (uint32_t)cb[8 * c + t + 4] << 16;
        uint32_t a[5][4];
#pragma unroll
        for (int b = 0; b < 5; ++b) {
          const uint32_t ea = __vcmpeq4(qa, 0x01010101u * b);
          const uint32_t eb = __vcmpeq4(qb, 0x01010101u * b);
          a[b][0] = __byte_perm(ea, 0, 0x1100) & BF16_ONE_X2;  // row,   2t..
          a[b][1] = __byte_perm(eb, 0, 0x1100) & BF16_ONE_X2;  // row+8, 2t..
          a[b][2] = __byte_perm(ea, 0, 0x3322) & BF16_ONE_X2;  // row,   2t+8..
          a[b][3] = __byte_perm(eb, 0, 0x3322) & BF16_ONE_X2;  // row+8, 2t+8..
        }
        const uint32_t off = (uint32_t)(js % SLAB + 16 * c) * HROW;
        wgmma_fence();
#pragma unroll
        for (int b = 0; b < 5; ++b)
          wgmma_m64n128k16(
              acc, a[b], hankel_desc(hankel_base + b * hrows * HROW + off));
        wgmma_commit();
        wgmma_wait_all();                      // a[] is rebuilt next chunk
      }
    }
    __syncthreads();                           // ring slot s % STAGES is free
  }
  wgmma_wait_all();
  pin(acc);

  // Stage the tile in shared memory (the Hankel tiles and the ring are
  // free now): acc[4i + {0,1}] is (row, 8i + 2t + {0,1}), acc[4i + {2,3}]
  // the same columns of row + 8.
  float* tile = reinterpret_cast<float*>(smem);     // [TILE_N][OUT_ROW]
#pragma unroll
  for (int i = 0; i < TILE_P / 8; ++i) {
    *reinterpret_cast<float2*>(tile + row * OUT_ROW + 8 * i + 2 * t) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(tile + (row + 8) * OUT_ROW + 8 * i + 2 * t) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();
  // Row by row: a warp instruction stores 256 consecutive bytes of a row
  // as float2 where P1 is even (rows, and the tile's width, are then
  // 8-byte aligned), 128 as floats otherwise.
  const int width = min(TILE_P, P1 - p0);
  for (int r = tid / 32; r < TILE_N && n0 + r < N; r += THREADS / 32) {
    float* orow = out + (size_t)(n0 + r) * P1 + p0;
    const float* trow = tile + r * OUT_ROW;
    if (P1 % 2 == 0) {
      for (int c = 2 * lane; c < width; c += 64)
        *reinterpret_cast<float2*>(orow + c) =
            *reinterpret_cast<const float2*>(trow + c);
    } else {
      for (int c = lane; c < width; c += 32) orow[c] = trow[c];
    }
  }
}

}  // namespace

// pwm: [n_rows, 5] float32, reads: [N, m] int8 with m % 16 == 0 and a
// 16-byte-aligned base, out: [N, P1] float32 with P1 = n_rows - m + 1.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for an
// empty problem, which the wrapper answers without a launch, or for an
// unsupported m or alignment).
extern "C" int hgtpu_torch_placement_scores(const float* pwm, int n_rows,
                                            const int8_t* reads, int N, int m,
                                            float* out, int P1,
                                            void* stream) {
  if (N <= 0 || m <= 0 || P1 <= 0 || m % 16 != 0 ||
      (uintptr_t)reads % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = smem_bytes(m);
  cudaError_t e = cudaFuncSetAttribute(
      placement_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + TILE_N - 1) / TILE_N, (P1 + TILE_P - 1) / TILE_P);
  placement_scores_kernel<<<grid, THREADS, smem, st>>>(pwm, n_rows, reads, N,
                                                       m, out, P1);
  return (int)cudaGetLastError();
}
