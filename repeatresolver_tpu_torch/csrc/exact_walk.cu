// Kernel G: the entry scan and the backtrack walk of the exact band.
//
// Replaces the XLA code of repeatresolver_tpu/ops/banded_realign.py::
// entry_scan (:210-244) and the `lax.while_loop` walk of
// entry_and_backtrack (:247-401), over kernel F's packed codes. Its plain
// version is repeatresolver_tpu_torch/ops/cuda_exact.py::exact_walk_plain
// (ops/banded_realign.py::entry_scan, then the walk in torch ops).
//
// What it computes, per row: the entry column of the final band (the
// minimum over columns (bound, ncols-1] of the last position's band,
// seeded at ncols-1, ties to the largest column; columns above the band
// read its top lane), then the walk in descending x. As in kernel B each
// position x is consumed by exactly one move (diagonal or insert), and the
// gap moves before it form one run of code-0 cells, so the walk's gap run
// and its x-move are one search: the largest band lane <= y - anf(x) with
// a nonzero code; lanes above the band are forced gaps. It emits
// y_at << 2 | move into [ceil(L/16), B, 16], or -1 where the walk is
// inactive or dies (no such lane: y falls to -1). Unlike kernel B, the
// band start moves every position, and a walk that enters a position
// below its band (a diagonal from lane 0 when the band did not move)
// reads lane 0's code there at its own column, as the lockstep walk of
// the JAX package clamps it.
//
// What bounds it on an H100: the serial chain along x (up to ~33k
// dependent steps a row), not bytes or operations; the entry scan reads
// each row's final band once and scans the padded width.
//
// Design: one CTA of 256 threads a row. All of them scan the row's
// columns for the entry; then one warp walks: a window of 64 band lanes
// of one word-row of codes (16 positions a word) is held in two registers
// a thread, the nonzero and insert bits of the step's position gathered
// by four ballots, the lanes above the walk masked off and the highest
// remaining lane taken by one find-first-set. A window is kept while the
// walk stays inside it; a gap run longer than the window slides it down.
// The band starts of a word-row are loaded once, one per thread, and
// shuffled to the step; the 16 move records leave as one 64-byte store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// (value, column) of the entry scan: the smaller value, ties to the
// larger column
__device__ __forceinline__ void better(int& v, int& y, int v2, int y2) {
  if (v2 < v || (v2 == v && y2 > y)) {
    v = v2;
    y = y2;
  }
}

__global__ void __launch_bounds__(THREADS) exact_walk_kernel(
    const unsigned* __restrict__ codes,  // [NW, B, W] packed time-major
    const int* __restrict__ band,        // [B, W] the final band
    const int* __restrict__ fanf,        // [B] its band start
    const int* __restrict__ bound,       // [B] the entry scan's lower end
    const int* __restrict__ anf_full,    // [B, L] band start a position
    const int* __restrict__ lengths,     // [B]
    int* __restrict__ moves,             // [NW, B, 16]
    int* __restrict__ wayin_out,         // [B]
    int* __restrict__ best_out,          // [B]
    int B, int w, int nw, int L, int ncols, int cpad) {
  __shared__ int s_v[THREADS / 32], s_y[THREADS / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;

  // ---- the entry scan over columns [0, cpad)
  {
    const int a = fanf[b];
    const int lo = bound[b];
    const int* bd = band + (size_t)b * w;
    const int topv = bd[w - 1];
    int bv = 0x7fffffff, by = -1;
    for (int y = tid; y < cpad; y += THREADS) {
      const int j = y - a;
      int v = BIG;
      if (y < ncols) v = j >= w ? topv : j >= 0 ? bd[j] : BIG;
      const bool scan = (y > lo && y < ncols) || y == ncols - 1;
      better(bv, by, scan ? v : BIG, y);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int v2 = __shfl_down_sync(FULL, bv, o);
      const int y2 = __shfl_down_sync(FULL, by, o);
      better(bv, by, v2, y2);
    }
    if (lane_id == 0) {
      s_v[warp] = bv;
      s_y[warp] = by;
    }
    __syncthreads();
    if (warp != 0) return;
    bv = lane_id < THREADS / 32 ? s_v[lane_id] : 0x7fffffff;
    by = lane_id < THREADS / 32 ? s_y[lane_id] : -1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int v2 = __shfl_down_sync(FULL, bv, o);
      const int y2 = __shfl_down_sync(FULL, by, o);
      better(bv, by, v2, y2);
    }
    bv = __shfl_sync(FULL, bv, 0);
    by = __shfl_sync(FULL, by, 0);
    if (lane_id == 0) {
      wayin_out[b] = by;
      best_out[b] = bv;
    }
    // ---- the walk (warp 0 alone)
    const int len = min(lengths[b], min(nw * 16, L));
    int y = by;
    const int r0 = len > 0 ? (len - 1) >> 4 : -1;
    for (int r = nw - 1; r > r0; --r)
      if (lane_id < 16) moves[((size_t)r * B + b) * 16 + lane_id] = -1;
    const int* anf_row = anf_full + (size_t)b * L;
    const int wm1 = w - 1;
    for (int r = r0; r >= 0; --r) {
      const unsigned* src = codes + ((size_t)r * B + b) * w;
      // the band starts of this word-row, one a thread
      const int xr = r * 16 + (lane_id & 15);
      const int anf_r = xr < L ? anf_row[xr] : 0;
      const int i_hi = r == r0 ? len - 1 - r * 16 : 15;
      int top = -1;                      // the window: lanes top-63..top
      unsigned wa = 0u, wb = 0u;
      auto load_window = [&](int t) {
        const int la = t - lane_id;
        const int lb = t - 32 - lane_id;
        wa = la >= 0 ? src[la] : 0u;
        wb = lb >= 0 ? src[lb] : 0u;
      };
      int myout = -1;
      for (int i = i_hi; i >= 0; --i) {
        const int anf = __shfl_sync(FULL, anf_r, i);
        int out = -1;
        if (y > -1) {
          const int sh = 2 * i;
          const int j = y - anf;
          if (j < 0) {
            // below the band: the lockstep walk reads lane 0 here
            const int c = (int)((src[0] >> sh) & 3u);
            if (c != 0) {
              out = (y << 2) | c;
              y = c == 2 ? y : y - 1;
            } else {
              y = -1;
            }
          } else {
            int hi = min(j, wm1);
            if (top < 0 || hi > top || top - hi >= 64) {
              top = hi;
              load_window(top);
            }
            int found = -1, mv = 0;
            while (true) {
              const unsigned ca = (wa >> sh) & 3u;
              const unsigned cb = (wb >> sh) & 3u;
              // bit k of the 64-bit masks: window lane top - k
              const unsigned long long m0 =
                  ((unsigned long long)__ballot_sync(FULL, cb & 1u) << 32)
                  | __ballot_sync(FULL, ca & 1u);
              const unsigned long long m1 =
                  ((unsigned long long)__ballot_sync(FULL, cb >> 1) << 32)
                  | __ballot_sync(FULL, ca >> 1);
              const unsigned long long nzm =
                  (m0 | m1) & (~0ull << (top - hi));
              if (nzm) {
                const int k = __ffsll((long long)nzm) - 1;  // highest lane
                found = top - k;
                mv = (int)((m0 >> k) & 1ull) | ((int)((m1 >> k) & 1ull) << 1);
                break;
              }
              if (top < 64) break;       // the walk dies at this x
              top -= 64;                 // the gap run leaves the window
              hi = top;
              load_window(top);
            }
            if (found >= 0) {
              const int y_at = anf + found;
              out = (y_at << 2) | mv;
              y = mv == 2 ? y_at : y_at - 1;
            } else {
              y = -1;
            }
          }
        }
        if (lane_id == i) myout = out;
      }
      if (lane_id < 16) moves[((size_t)r * B + b) * 16 + lane_id] = myout;
    }
  }
}

}  // namespace

extern "C" int exact_walk_launch(const void* codes, const void* band,
                                 const void* fanf, const void* bound,
                                 const void* anf_full, const void* lengths,
                                 void* moves, void* wayin, void* best, int B,
                                 int w, int nw, int L, int ncols, int cpad,
                                 void* stream) {
  if (B <= 0) return 0;
  if (w <= 0 || nw <= 0 || L <= 0 || ncols <= 0 || cpad < ncols)
    return (int)cudaErrorInvalidValue;
  exact_walk_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned*)codes, (const int*)band, (const int*)fanf,
      (const int*)bound, (const int*)anf_full, (const int*)lengths,
      (int*)moves, (int*)wayin, (int*)best, B, w, nw, L, ncols, cpad);
  return (int)cudaGetLastError();
}

extern "C" const char* exact_walk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
