// Kernel D: the entry scan and the backtrack of align_on_device.
//
// Replaces XLA code, not a Pallas kernel: the entry scan and the
// lax.while_loop backtrack of repeatresolver_tpu/ops/editdp.py
// (align_on_device :135, the loop at :177). Its plain version is
// repeatresolver_tpu_torch/ops/editdp.py::walk_plain; both give the same
// bits.
//
// What it computes, per batch row b: the entry column, the minimum of the
// final row over columns [1, Lt-1] with ties to the largest column
// (column 0 is never examined), then the walk from (qlen-1, entry) while
// x >= 0 and y >= 0: codes 0 and 3 write out[x] = y and take x-1, y-1;
// code 1 takes y-1; code 2 takes x-1. out is -1 wherever no base was
// placed; a row of qlen 0 is all -1.
//
// What bounds it on an H100: neither bytes nor operations but the serial
// chain of a row: each step's load address depends on the code the step
// before read, up to qlen + Lt steps a row, and a load that misses the L1
// costs hundreds of cycles. The rows walk side by side.
//
// Design: one warp per row. The warp scans the final row (coalesced, a
// shuffle reduction that keeps the largest column on ties) and writes
// the row's -1s; then its first lane walks. The codes are kernel C's
// packed layout (editdp_layout.cuh).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "editdp_layout.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32) editdp_walk_kernel(
    const unsigned* __restrict__ codes,  // [B, nseg, steps, T]
    const int* __restrict__ qlens,       // [B]
    const int* __restrict__ fr,          // [B, Lt]
    int* __restrict__ out,               // [B, Lq]
    int* __restrict__ walked,            // [B] steps a row, or null
    int lq, int lt, int T, int nseg, int steps) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int* frb = fr + (size_t)b * lt;
  int best = INT_MAX, col = -1;
  for (int y = 1 + lane; y < lt; y += 32) {
    const int v = frb[y];
    if (v <= best) {                     // ascending y: the largest wins
      best = v;
      col = y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_down_sync(FULL, best, off);
    const int oc = __shfl_down_sync(FULL, col, off);
    if (ob < best || (ob == best && oc > col)) {
      best = ob;
      col = oc;
    }
  }
  int* ob = out + (size_t)b * lq;
  for (int x = lane; x < lq; x += 32) ob[x] = -1;
  __syncwarp();
  if (lane != 0) return;
  const unsigned* cb = codes + (size_t)b * nseg * steps * T;
  int x = min(qlens[b], lq) - 1;
  int y = col;
  int n = 0;
  while (x >= 0 && y >= 0) {
    const int j = y / STRIP;
    const int seg = j / T;
    const int k = j - seg * T;
    const unsigned w = cb[packed_word(seg, k, x + k, T, steps)];
    const unsigned code = (w >> (2 * (y % STRIP))) & 3u;
    if (code != 1u) {                    // diagonal or 'd'
      if (code != 2u) ob[x] = y;         // diagonal: a placed base
      --x;
    }
    if (code != 2u) --y;                 // diagonal or 'i'
    ++n;
  }
  if (walked != nullptr) walked[b] = n;
}

}  // namespace

extern "C" int editdp_walk_launch(const void* codes, const void* qlens,
                                  const void* fr, void* out, void* walked,
                                  int B, int lq, int lt, int threads,
                                  int nseg, int steps, void* stream) {
  if (B <= 0) return 0;
  if (lq < 0 || lt < 2 || threads <= 0 || nseg <= 0
      || (long long)nseg * threads * STRIP < lt || steps < lq + threads - 1)
    return (int)cudaErrorInvalidValue;
  editdp_walk_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      (const unsigned*)codes, (const int*)qlens, (const int*)fr, (int*)out,
      (int*)walked, lq, lt, threads, nseg, steps);
  return (int)cudaGetLastError();
}

extern "C" const char* editdp_walk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
