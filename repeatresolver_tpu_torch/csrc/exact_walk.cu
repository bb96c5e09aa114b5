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
// each row's final band once and scans the padded width. A step that
// waits for device memory costs several hundred cycles, so the design
// takes memory out of the step, as kernel B does.
//
// Design: one CTA of 256 threads a row. All of them scan the row's
// columns for the entry; then one warp walks:
//   * a ring of tiles in shared memory (512 lanes of each of the next
//     four word-rows of codes) is filled by cp.async ahead of the walk,
//     each tile centred on where the walk will be if it goes on falling
//     as in its last word-row; the band starts of the word-rows are
//     staged eight word-rows ahead in a ring of their own, so a step
//     reads its position's band start from shared memory and the tile's
//     placement is known when its copy starts;
//   * steps go in groups of four, in columns rather than band lanes:
//     the walk's column never rises, while its lane moves with the band
//     start. Thread t holds column y-31+t of each of the group's four
//     positions (its lane there from the staged band start, the word
//     from the tile), and the group's masks (nonzero code, insert) are
//     taken by eight ballots up front. A step is then kernel B's six
//     dependent integer operations: mask off the columns above the walk,
//     count leading zeros, pick the insert bit, and the walk's new
//     offset below the window top is clz + 1 - insert. A group runs
//     speculatively; whether every step found its move inside the
//     window and in its band is checked once, after the group;
//   * a group that did not is redone by the general loop: a window of
//     64 band lanes in two registers a thread, four ballots a step, the
//     lanes above the walk masked off and the highest remaining lane
//     taken by one find-first-set, gap runs of any length, the clamp
//     below the band. The band start moves every position, so the
//     walk's lane can rise; that window's top is set 32 lanes above the
//     walk. A window that its tile does not cover (a long gap run, a
//     band jump) is read from device memory directly: the same result,
//     rare;
//   * the 16 move records of a word-row leave as one 64-byte store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int DEPTH = 4;               // word-rows of tiles in flight
constexpr int TL = 512;                // lanes a tile: 16 a thread
constexpr int ADEPTH = 8;              // word-rows of band starts staged
constexpr int UPM = 32;                // window lanes above the walk

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
  __shared__ __align__(16) unsigned s_tile[DEPTH][TL];
  __shared__ int s_anf[ADEPTH][16];
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
    if (r0 < 0) return;
    const int* anf_row = anf_full + (size_t)b * L;
    const int wm1 = w - 1;
    const bool vec = (w & 3) == 0;       // rows are 16-byte aligned
    // the band starts of word-row r into its slot of the ring
    auto stage_anf = [&](int r) {
      if (r >= 0 && lane_id < 16)
        cp_async4(&s_anf[r & (ADEPTH - 1)][lane_id],
                  anf_row + min(r * 16 + lane_id, L - 1));
    };
    // columns the walk fell by in the last word-row
    int fall = 16;
    // start the copy of word-row r's tile, `ahead` word-rows before the
    // walk gets there: TL lanes centred on the lane it would read if it
    // went on falling as in its last word-row
    auto prefetch = [&](int r, int ahead) -> int {
      int tlo = 0;                       // the tile's first lane
      if (r >= 0) {
        const int a_r = s_anf[r & (ADEPTH - 1)][15];
        const int top = min(max(y - ahead * fall - a_r, 0), wm1);
        const int wend = (w + 3) & ~3;
        tlo = max(0, min((top + TL / 2) & ~3, wend) - TL);
        unsigned* dst = s_tile[r & (DEPTH - 1)];
        const unsigned* src = codes + ((size_t)r * B + b) * w;
        if (vec) {
#pragma unroll
          for (int q = 0; q < TL / 128; ++q) {
            const int l0 = tlo + (q * 32 + lane_id) * 4;
            if (l0 + 4 <= w) cp_async16(dst + (l0 - tlo), src + l0);
          }
        } else {
#pragma unroll
          for (int q = 0; q < TL / 32; ++q) {
            const int l = tlo + q * 32 + lane_id;
            if (l < w) cp_async4(dst + (l - tlo), src + l);
          }
        }
      }
      return tlo;
    };
    for (int k = 0; k < ADEPTH; ++k) stage_anf(r0 - k);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    static_assert(DEPTH == 4, "the tile starts are kept in four registers");
    int tl[DEPTH];
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      tl[k] = prefetch(r0 - k, k);
      cp_async_commit();
    }
    for (int r = r0; r >= 0; --r) {
      cp_async_wait<DEPTH - 1>();        // word-row r's tile has landed
      __syncwarp();
      const int tlo = tl[0];
      const unsigned* tile = s_tile[r & (DEPTH - 1)] - tlo;
      const unsigned* gsrc = codes + ((size_t)r * B + b) * w;
      const int* sa = s_anf[r & (ADEPTH - 1)];
      const int i_hi = r == r0 ? len - 1 - r * 16 : 15;
      const int y_in = y;
      int top = -1;                      // the window: lanes top-63..top
      unsigned wa = 0u, wb = 0u;
      auto load_window = [&](int t) {
        const unsigned* src = max(t - 63, 0) >= tlo && t < tlo + TL
                                  ? tile : gsrc;
        const int la = t - lane_id;
        const int lb = t - 32 - lane_id;
        wa = la >= 0 ? src[la] : 0u;
        wb = lb >= 0 ? src[lb] : 0u;
      };
      int myout = -1;
#pragma unroll 1
      for (int g = 3; g >= 0; --g) {
        if (4 * g > i_hi || y < 0) continue;         // past the end, dead
        if (4 * g + 3 <= i_hi) {
          // four speculative steps over the 32 columns y-31 .. y, thread
          // t holding column y-31+t at each position: its code (0 above
          // the band, no candidate below it) by two ballots a position
          const int ytop = y;
          unsigned nz[4], b1[4];
          int lim[4];                    // the walk stays in its band
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 4 * g + j;
            const int a = sa[i];
            const int lane = ytop - 31 + lane_id - a;
            unsigned c = 0u;
            if (lane >= 0 && lane < w) {
              const unsigned wd =
                  lane >= tlo && lane < tlo + TL ? tile[lane] : gsrc[lane];
              c = (wd >> (2 * i)) & 3u;
            }
            nz[j] = __ballot_sync(FULL, c != 0u);
            b1[j] = __ballot_sync(FULL, (c & 2u) != 0u);
            lim[j] = ytop - a;
          }
          // off = ytop - the walk's column; a step is six dependent
          // integer operations
          int off = 0;
          unsigned bad = 0u;
          int zs[4], bits[4];
#pragma unroll
          for (int j = 3; j >= 0; --j) {
            bad |= off > lim[j] ? 32u : 0u;          // below the band
            const unsigned m = nz[j] & (FULL >> (off & 31));
            const int z = __clz((int)m);             // 32: nothing found
            const int bit = (int)((b1[j] << (z & 31)) >> 31);
            bad |= (unsigned)off | (unsigned)z;      // bit 5: left window
            zs[j] = z;
            bits[j] = bit;
            off = z + 1 - bit;
          }
          if ((bad & 32u) == 0u) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (lane_id == 4 * g + j)
                myout = ((ytop - zs[j]) << 2) | (1 + bits[j]);
            y = ytop - off;
            continue;
          }
        }
        // the general loop: this group's steps one by one
        for (int i = min(4 * g + 3, i_hi); i >= 4 * g; --i) {
          const int anf = sa[i];
          int out = -1;
          if (y > -1) {
            const int sh = 2 * i;
            const int j = y - anf;
            if (j < 0) {
              // below the band: the lockstep walk reads lane 0 here
              const unsigned w0 = tlo == 0 ? tile[0] : gsrc[0];
              const int c = (int)((w0 >> sh) & 3u);
              if (c != 0) {
                out = (y << 2) | c;
                y = c == 2 ? y : y - 1;
              } else {
                y = -1;
              }
            } else {
              int hi = min(j, wm1);
              if (top < 0 || hi > top || top - hi >= 64) {
                top = min(hi + UPM, wm1);
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
      }
      if (lane_id < 16) moves[((size_t)r * B + b) * 16 + lane_id] = myout;
      __syncwarp();                      // the slots of row r are free
      if (y > -1) fall = y_in - y;
#pragma unroll
      for (int k = 0; k + 1 < DEPTH; ++k) tl[k] = tl[k + 1];
      stage_anf(r - ADEPTH);
      tl[DEPTH - 1] = prefetch(r - DEPTH, DEPTH - 1);
      cp_async_commit();
    }
    cp_async_wait<0>();
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
