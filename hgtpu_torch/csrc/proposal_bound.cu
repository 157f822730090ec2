// The verify prep's lower bound on the novel cost of each proposal entry.
//
// Replaces no TPU kernel: hgtpu computes the bound on the host in numpy
// (hgtpu/align/aligner.py, _lb_core), and so does the port on the CPU
// (hgtpu_torch/align/aligner.py:_lb_core).  On the card the chunk's read
// codes are already on the device (the placement's `both`), so the bound
// runs here instead of as [E, 64] fancy-indexed scans on the host.  The
// kernel and _lb_core must give the same bound, bit for bit.
//
// Per entry e (entries[3e .. 3e + 2] = row, base, clip | win << 16): the
// entry reads codes[row, clip + j] for j < win, and the bound is the number
// of those j whose code is not free at table position base + j, capped at
// cap.  mask[p] holds one bit per base code (bit c: code c is free at p on
// some diagonal within the edit budget, the aligner's dilated match
// table); code 5, and any code past the row, is never free.
//
// What bounds it on this card: latency.  Each entry reads 12 bytes of its
// own, one or two 32-byte runs of codes (most wrong proposals reach the
// cap within the first 32 columns), about as many table bytes, and writes
// one byte; a call of tens of thousands of entries is a few hundred KB.
// One warp per entry, 32 columns a step: each lane tests one column,
// __ballot_sync and __popc count the warp's misses, and the warp stops
// once the count reaches the cap, as the host scan drops an entry at the
// cap.  The table (about 13 KB for an 11 kb gene) is read through L1.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // warps a block, one entry each

__global__ void __launch_bounds__(WARPS * 32)
proposal_bound_kernel(const int8_t* __restrict__ codes, int n_rows, int L,
                      const uint8_t* __restrict__ mask, int T,
                      const int* __restrict__ entries, int E, int cap,
                      int8_t* __restrict__ out) {
  const int e = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (e >= E) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int row = __ldg(entries + 3 * e);
  const int base = __ldg(entries + 3 * e + 1);
  const int cw = __ldg(entries + 3 * e + 2);
  const int clip = cw & 0xFFFF;
  const int win = cw >> 16;
  int lb = cap;
  if (row >= 0 && row < n_rows) {
    const int8_t* rp = codes + (size_t)row * L;
    lb = 0;
    for (int at = 0; at < win && lb < cap; at += 32) {
      const int j = at + lane;
      bool miss = false;
      if (j < win) {
        const int col = clip + j;
        const int c = col < L ? __ldg(rp + col) : 5;
        const int p = base + j;
        const unsigned m = (p >= 0 && p < T && c >= 0 && c < 6)
                               ? (unsigned)__ldg(mask + p) : 0u;
        miss = !((m >> c) & 1u);
      }
      lb += __popc(__ballot_sync(0xffffffffu, miss));
    }
  }
  if (lane == 0) out[e] = (int8_t)(lb < cap ? lb : cap);
}

}  // namespace

extern "C" int hgtpu_torch_proposal_bound(const int8_t* codes, int n_rows,
                                          int L, const uint8_t* mask, int T,
                                          const int* entries, int E, int cap,
                                          int8_t* out, void* stream) {
  if (E == 0) return 0;
  if (n_rows <= 0 || L <= 0 || T <= 0 || cap < 0 || cap > 127)
    return (int)cudaErrorInvalidValue;
  proposal_bound_kernel<<<(E + WARPS - 1) / WARPS, WARPS * 32, 0,
                          (cudaStream_t)stream>>>(
      codes, n_rows, L, mask, T, entries, E, cap, out);
  return (int)cudaGetLastError();
}
