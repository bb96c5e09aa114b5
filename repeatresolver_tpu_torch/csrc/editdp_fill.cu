// Kernel C: the edit-DP fill of cut and align.
//
// Replaces XLA code, not a Pallas kernel: the row scans of
// repeatresolver_tpu/ops/editdp.py (last_rows :69, its lax.scan at :102;
// align_with_codes :107, its lax.scan at :130; the fill inside
// align_on_device :135). Its plain version is the torch row loop
// repeatresolver_tpu_torch/ops/editdp.py::forward_plain; both give the
// same bits.
//
// What it computes, per batch row b (query q, target t):
//   M[-1][y] = 0,  M[x][-1] = x + 1
//   M[x][y]  = min(M[x-1][y-1] + (q[x] != t[y]), M[x-1][y] + 1,
//                  M[x][y-1] + 1)
//   code     = c_up ? 2 : c_left ? 1 : mismatch ? 0 : 3, with
//              c_left = M[x][y-1]+1 < diag and
//              c_up = M[x-1][y]+1 < (c_left ? M[x][y-1]+1 : diag)
// and the final row M[qlen-1][:] (left 0 when qlen is 0). The symbols are
// compared as the int16 values they are: the pads (100 for queries and
// for the template part past the template, 200 for cut's targets) never
// equal a base.
//
// Three modes: FINAL_ROWS (cut: the final rows only, rows x < qlen),
// CODES_INT8 (align_with_codes: a byte a code for every x < Lq, the
// layout [Lq, B, Lt] of the plain version, rows past qlen included) and
// CODES_PACKED (align_on_device: two bits a code, rows x < qlen only, in
// the layout kernel D reads; see below).
//
// What bounds it on an H100: int32 operations. A cell needs about ten
// (mismatch test, three adds, three mins, two compares, the code select
// and its shift into the word); the codes leave at two bits a cell, a
// quarter of a byte, which the memory moves about five times faster than
// the SMs can compute them.
//
// Design (M is unique, so any order that respects the dependencies gives
// the plain version's bits; the recurrence is evaluated directly, with
// M[x][y-1] + 1 as the left term):
//   * one CTA per batch row; each thread owns a strip of 16 consecutive
//     target columns and keeps that strip of the previous DP row, and of
//     the target, in registers;
//   * a wavefront skewed along the query: at step s thread k computes row
//     x = s - k of its strip, left to right. The left boundary
//     M[x][y0-1] is the right end of thread k-1's strip from step s-1: a
//     warp shuffle inside a warp, and across warps one slot a warp in
//     shared memory, double-buffered by step parity, with one
//     __syncthreads a step. The diagonal boundary M[x-1][y0-1] is the
//     left boundary of the row before, kept in a register;
//   * a row wider than 512 threads x 16 columns runs as segments one after
//     the other, the last thread of a segment leaving its right column
//     M[x][.] in a per-row buffer in device memory for the next segment's
//     first thread (the read of x comes T-1 steps before the write of x);
//   * CODES_PACKED: the 16 codes of a thread's strip are one 32-bit word
//     in the layout of editdp_layout.cuh, [b][segment][step s][thread k]:
//     at a step the threads of a warp store 32 neighbouring words, one
//     128-byte line;
//   * the query symbol of the next row is loaded a step ahead.
#include <cuda_runtime.h>
#include <stdint.h>

#include "editdp_layout.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;
// a target column at or past Lt: equal to no int16 symbol
constexpr int NO_SYMBOL = 1 << 20;

enum { FINAL_ROWS = 0, CODES_INT8 = 1, CODES_PACKED = 2 };

template <int MODE>
__global__ void __launch_bounds__(MAX_THREADS) editdp_fill_kernel(
    const short* __restrict__ q, int q_sb, int q_sx,  // queries [B, Lq]
    const int* __restrict__ qlens,                    // [B]
    const short* __restrict__ t, int t_sb, int t_sy,  // targets [B, Lt]
    int B, int lq, int lt, int nseg, int steps,
    signed char* __restrict__ codes8,  // CODES_INT8: [Lq, B, Lt]
    unsigned* __restrict__ codes2,     // CODES_PACKED: [B, nseg, steps, T]
    int* __restrict__ fr,              // [B, Lt], zero on entry
    int* __restrict__ bcol) {          // [B, Lq] when nseg > 1
  __shared__ int s_edge[2][MAX_THREADS / 32];

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int T = blockDim.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  const int qlen = qlens[b];
  const int xend = MODE == CODES_INT8 ? lq : min(max(qlen, 0), lq);
  const short* qb = q + (size_t)b * q_sb;
  const short* tb = t + (size_t)b * t_sb;
  int* bc = nseg > 1 ? bcol + (size_t)b * lq : nullptr;
  const int nsteps = xend > 0 ? xend + T - 1 : 0;

  for (int seg = 0; seg < nseg; ++seg) {
    const int y0 = (seg * T + k) * STRIP;
    int tv[STRIP];                     // the strip's target symbols
    int m[STRIP];                      // the strip of the row before
#pragma unroll
    for (int i = 0; i < STRIP; ++i) {
      tv[i] = y0 + i < lt ? (int)tb[(size_t)(y0 + i) * t_sy] : NO_SYMBOL;
      m[i] = 0;                        // M[-1][y] = 0
    }
    // M[x-1][y0-1]: 0 for x = 0 (for the first strip, M[-1][-1] = 0 as
    // the scan's boundary x gives it)
    int prev_left = 0;
    int right = 0;                     // M[x][y0+15], for thread k+1
    const bool hands_on = k == T - 1 && seg + 1 < nseg;
    int q_next = xend > 0 ? (int)qb[0] : 0;
    unsigned* out2 = MODE == CODES_PACKED
        ? codes2 + (size_t)b * nseg * steps * T : nullptr;
    // the bits of columns past Lt stay 0
    const int ncols = min(max(lt - y0, 0), STRIP);
    const unsigned colmask = ncols == STRIP ? FULL : (1u << (2 * ncols)) - 1u;

    for (int s = 0; s < nsteps; ++s) {
      const int x = s - k;
      int left = __shfl_up_sync(FULL, right, 1);
      // a warp's first lane: the last lane of the warp below, from the
      // step before (at s = 0 only thread 0 works, which reads no slot)
      if (lane == 0 && warp > 0) left = s_edge[(s + 1) & 1][warp - 1];
      if (x >= 0 && x < xend) {
        const int qc = q_next;
        if (x + 1 < xend) q_next = (int)qb[(size_t)(x + 1) * q_sx];
        if (k == 0) left = seg == 0 ? x + 1 : bc[x];
        int dg = prev_left;
        prev_left = left;
        unsigned word = 0u;            // CODES_PACKED
        unsigned bytes[4] = {0u, 0u, 0u, 0u};   // CODES_INT8
#pragma unroll
        for (int i = 0; i < STRIP; ++i) {
          const int up = m[i];
          const int mism = qc != tv[i];
          const int diag = dg + mism;
          const int left1 = left + 1;
          const int up1 = up + 1;
          const int cur = min(diag, left1);
          const int v = min(cur, up1);
          if (MODE != FINAL_ROWS) {
            const bool c_left = left1 < diag;
            const bool c_up = up1 < cur;
            const unsigned code =
                c_up ? 2u : (c_left ? 1u : (mism ? 0u : 3u));
            if (MODE == CODES_PACKED) word |= code << (2 * i);
            if (MODE == CODES_INT8) bytes[i >> 2] |= code << (8 * (i & 3));
          }
          dg = up;
          m[i] = v;
          left = v;
        }
        right = left;
        if (hands_on) bc[x] = right;
        if (MODE == CODES_PACKED)
          out2[packed_word(seg, k, s, T, steps)] = word & colmask;
        if (MODE == CODES_INT8) {
          signed char* dst = codes8 + ((size_t)x * B + b) * lt + y0;
          if ((lt & 15) == 0 && y0 + STRIP <= lt) {
            *reinterpret_cast<uint4*>(dst) =
                make_uint4(bytes[0], bytes[1], bytes[2], bytes[3]);
          } else {
#pragma unroll
            for (int i = 0; i < STRIP; ++i)
              if (y0 + i < lt)
                dst[i] = (signed char)((bytes[i >> 2] >> (8 * (i & 3)))
                                       & 0xffu);
          }
        }
        if (x == qlen - 1) {
          int* dst = fr + (size_t)b * lt + y0;
#pragma unroll
          for (int i = 0; i < STRIP; ++i)
            if (y0 + i < lt) dst[i] = m[i];
        }
      }
      if (lane == 31) s_edge[s & 1][warp] = right;
      __syncthreads();
    }
  }
}

}  // namespace

// mode: 0 final rows, 1 int8 codes [Lq, B, Lt], 2 packed codes
// [B, nseg, steps, threads]. Strides are in elements.
extern "C" int editdp_fill_launch(
    const void* q, int q_sb, int q_sx, const void* qlens, const void* t,
    int t_sb, int t_sy, int B, int lq, int lt, int mode, int threads,
    int nseg, int steps, void* codes8, void* codes2, void* fr, void* bcol,
    void* stream) {
  if (B <= 0) return 0;
  if (lq < 0 || lt <= 0 || threads <= 0 || threads > MAX_THREADS
      || threads % 32 != 0 || nseg <= 0
      || (long long)nseg * threads * STRIP < lt
      || (long long)(nseg - 1) * threads * STRIP >= lt
      || (nseg > 1 && bcol == nullptr) || fr == nullptr
      || (mode == CODES_INT8 && codes8 == nullptr)
      || (mode == CODES_PACKED
          && (codes2 == nullptr || steps < lq + threads - 1)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B), block(threads);
  cudaStream_t st = (cudaStream_t)stream;
  const short* qs = (const short*)q;
  const short* ts = (const short*)t;
  const int* ql = (const int*)qlens;
  switch (mode) {
    case FINAL_ROWS:
      editdp_fill_kernel<FINAL_ROWS><<<grid, block, 0, st>>>(
          qs, q_sb, q_sx, ql, ts, t_sb, t_sy, B, lq, lt, nseg, steps,
          nullptr, nullptr, (int*)fr, (int*)bcol);
      break;
    case CODES_INT8:
      editdp_fill_kernel<CODES_INT8><<<grid, block, 0, st>>>(
          qs, q_sb, q_sx, ql, ts, t_sb, t_sy, B, lq, lt, nseg, steps,
          (signed char*)codes8, nullptr, (int*)fr, (int*)bcol);
      break;
    case CODES_PACKED:
      editdp_fill_kernel<CODES_PACKED><<<grid, block, 0, st>>>(
          qs, q_sb, q_sx, ql, ts, t_sb, t_sy, B, lq, lt, nseg, steps,
          nullptr, (unsigned*)codes2, (int*)fr, (int*)bcol);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* editdp_fill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
