// Kernel B: the backtrack walk over the packed staircase codes.
//
// Replaces repeatresolver_tpu/ops/pallas_backtrack.py::_kernel (launched
// by _backtrack_moves at pallas_backtrack.py:129, wrapped by
// entry_and_backtrack_pallas). Its plain version is
// repeatresolver_tpu_torch/ops/cuda_backtrack.py::walk_plain.
//
// What it computes: each sequence position x is consumed by exactly one
// move (diagonal or insert), and the gap moves between two x-moves form
// one run of code-0 cells at that x. So per row and x, in descending x,
// the walk's gap run and its x-move are one search: the largest window
// lane <= y - a with a nonzero code. It emits y_at << 2 | move, or -1
// when the walk is inactive or dies (no such lane: y falls to -1), and
// updates y. Lanes above the window are forced gaps and never candidates.
// Rows join the walk at their own x = len-1.
//
// What bounds it on an H100: neither bytes nor operations (a walk needs
// one 32-byte sector of codes per 16 positions, and a handful of integer
// operations per position) but the serial chain along x: up to ~33k
// dependent steps a row, so the kernel's time is steps x the latency of
// one step. A step that waits for device memory costs several hundred
// cycles; the design takes memory out of the step.
//
// Design: one warp per row, one CTA per warp, so a block of 64 rows
// spreads over 64 SMs. One int32 word holds the codes of 16 consecutive
// x of a lane, and y falls by 0 or 1 a step outside a gap run, so:
//   * the words of a 32-lane window at and below the walk's lane are held
//     in one register per thread, the top lane in thread 31 so that the
//     highest lane is the highest bit. Steps go in groups of four: the
//     group's masks (nonzero code, insert) do not depend on the walk and
//     are taken by eight ballots up front. A step is then six dependent
//     integer operations and no branch: mask off the lanes above the
//     walk, count leading zeros, pick the insert bit, and the walk's new
//     offset below the window top is clz + 1 - insert. A group runs
//     speculatively; whether every step found its move inside the window
//     is checked once, after the group, and a group that did not is
//     redone by a general loop (a 64-lane window, ballots per step, gap
//     runs of any length). The window is kept from group to group while
//     it has room below the walk.
//   * the window is loaded from shared memory, where a ring of tiles
//     (512 lanes of each of the next word-rows) is filled by cp.async
//     four word-rows ahead of the walk. The tile is centred on where the
//     walk will be if it goes on falling as it did in its last word-row
//     (the window start of every chunk is known). A window that a tile
//     does not cover (a long gap run, a band jump) is read from device
//     memory directly: the same result, rare.
//   * the row's window starts `a` are staged in shared memory once, and
//     the 16 move records of a word-row leave as one 64-byte store.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int DEPTH = 4;               // word-rows of tiles in flight
constexpr int TL = 512;                // lanes per tile: 16 per thread

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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(32) walk_backtrack_kernel(
    const unsigned* __restrict__ codes,  // [NW, B, W2] packed time-major
    const int* __restrict__ wayin,       // [B] entry column
    const int* __restrict__ aint,        // [B, NC] window start per chunk
    const int* __restrict__ lengths,     // [B]
    int* __restrict__ moves,             // [NW, B, 16]
    int B, int w2, int t, int nw, int ncw) {
  __shared__ __align__(16) unsigned s_tile[DEPTH][TL];
  extern __shared__ int s_a[];           // [ncw] the row's window starts

  const int b = blockIdx.x;
  const int lane_id = threadIdx.x;
  const int len = min(lengths[b], nw * 16);
  const bool vec = (w2 & 3) == 0;        // rows are 16-byte aligned
  int y = wayin[b];

  // word-rows past the row's end hold no move
  const int r0 = len > 0 ? (len - 1) >> 4 : -1;
  for (int r = nw - 1; r > r0; --r)
    if (lane_id < 16) moves[((size_t)r * B + b) * 16 + lane_id] = -1;
  if (r0 < 0) return;
  for (int i = lane_id; i < ncw; i += 32) s_a[i] = aint[(size_t)b * ncw + i];
  __syncwarp();
  // columns the walk fell by in the last word-row: where it will be a
  // few word-rows on is guessed from it
  int fall = 16;

  // start the copy of word-row r's tile, `ahead` word-rows before the
  // walk gets there: TL lanes around the lane it would read if it went
  // on falling as in its last word-row (the window start of every chunk
  // is known), a quarter of them above that lane
  auto prefetch = [&](int r, int ahead) -> int {
    int tile_lo = 0;                     // the tile's first lane
    if (r >= 0) {
      const int a_r = s_a[(r * 16) / t];
      const int top = min(max(y - ahead * fall - a_r, 0), w2 - 1);
      const int wend = (w2 + 3) & ~3;
      const int tlo = max(0, min(((top + TL / 4) & ~3), wend) - TL);
      const int slot = r & (DEPTH - 1);
      const unsigned* src = codes + ((size_t)r * B + b) * w2;
      if (vec) {
#pragma unroll
        for (int q = 0; q < TL / 128; ++q) {
          const int l0 = tlo + (q * 32 + lane_id) * 4;
          if (l0 + 4 <= w2) cp_async16(&s_tile[slot][l0 - tlo], src + l0);
        }
      } else {
#pragma unroll
        for (int q = 0; q < TL / 32; ++q) {
          const int l = tlo + q * 32 + lane_id;
          if (l < w2) cp_async4(&s_tile[slot][l - tlo], src + l);
        }
      }
      tile_lo = tlo;
    }
    cp_async_commit();
    return tile_lo;
  };

  // where word-row r's words are read from for window lanes [lo, top]:
  // the row's tile where it covers them, else device memory
  int tlo = 0, tlo1 = 0, tlo2 = 0, tlo3 = 0;   // tiles of rows r .. r-3
  auto window_src = [&](int r, int lo, int top) -> const unsigned* {
    if (max(lo, 0) >= tlo && top < tlo + TL)
      return s_tile[r & (DEPTH - 1)] - tlo;
    return codes + ((size_t)r * B + b) * w2;
  };
  // general loop's window: lanes top-lane_id (wa) and top-32-lane_id (wb)
  auto load_window = [&](int r, int top, unsigned& wa, unsigned& wb) {
    const unsigned* src = window_src(r, top - 63, top);
    const int la = top - lane_id;
    const int lb = top - 32 - lane_id;
    wa = la >= 0 ? src[la] : 0u;
    wb = lb >= 0 ? src[lb] : 0u;
  };

  static_assert(DEPTH == 4, "the tile starts are kept in four registers");
  tlo = prefetch(r0, 0);
  tlo1 = prefetch(r0 - 1, 1);
  tlo2 = prefetch(r0 - 2, 2);
  tlo3 = prefetch(r0 - 3, 3);
  const int w2m1 = w2 - 1;
  for (int r = r0; r >= 0; --r) {
    cp_async_wait<DEPTH - 1>();          // word-row r's tile has landed
    __syncwarp();
    const int a = s_a[(r * 16) / t];
    const int y_in = y;
    const int i_hi = r == r0 ? len - 1 - r * 16 : 15;   // first active step
    int top = -1;                        // general loop: no window yet
    unsigned wa = 0u, wb = 0u;
    int ftop = -1;                       // fast path: no window yet
    unsigned fw = 0u;                    // word of lane ftop - 31 + lane_id
    int myout = -1;

#pragma unroll 1
    for (int g = 3; g >= 0; --g) {
      if (4 * g > i_hi || y < 0) continue;         // past the end, or dead
      const int h = min(y - a, w2m1);              // the walk's window lane
      if (4 * g + 3 <= i_hi && h >= 0) {
        if (ftop < 0 || (unsigned)(ftop - h) > 4u) {
          ftop = h;                      // no room for a group: new window
          const int l = ftop - 31 + lane_id;
          if (max(ftop - 31, 0) >= tlo && ftop < tlo + TL)
            fw = l >= 0 ? s_tile[r & (DEPTH - 1)][l - tlo] : 0u;
          else
            fw = l >= 0 ? codes[((size_t)r * B + b) * w2 + l] : 0u;
        }
        unsigned nz[4], b1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned c = fw >> (2 * (4 * g + j));
          nz[j] = __ballot_sync(FULL, (c & 3u) != 0u);
          b1[j] = __ballot_sync(FULL, (c & 2u) != 0u);
        }
        // four speculative steps; off = window top - the walk's lane
        int off = ftop - h;
        unsigned bad = 0u;
        int zs[4], bits[4];
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          const unsigned m = nz[j] & (0xffffffffu >> (off & 31));
          const int z = __clz((int)m);             // 32: nothing found
          const int bit = (int)((b1[j] << (z & 31)) >> 31);
          bad |= (unsigned)off | (unsigned)z;      // bit 5: out of window
          zs[j] = z;
          bits[j] = bit;
          off = z + 1 - bit;
        }
        if ((bad & 32u) == 0u) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (lane_id == 4 * g + j)
              myout = ((a + ftop - zs[j]) << 2) | (1 + bits[j]);
          y = a + ftop - off;
          continue;
        }
      }
      // the general loop: this group's steps one by one
      for (int i = min(4 * g + 3, i_hi); i >= 4 * g; --i) {
        int out = -1;
        if (y > -1) {
          int hi = min(y - a, w2m1);
          int found = -1, mv = 0;
          if (hi >= 0) {
            if (top < 0 || hi > top || top - hi >= 64) {
              top = hi;
              load_window(r, top, wa, wb);
            }
            const int sh = 2 * i;
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
                mv = (int)((m0 >> k) & 1ull)
                     | ((int)((m1 >> k) & 1ull) << 1);
                break;
              }
              if (top < 64) break;       // the walk dies at this x
              top -= 64;                 // the gap run leaves the window
              hi = top;
              load_window(r, top, wa, wb);
            }
          }
          if (found >= 0) {
            const int y_at = a + found;
            out = (y_at << 2) | mv;
            y = mv == 2 ? y_at : y_at - 1;
          } else {
            y = -1;
          }
        }
        if (lane_id == i) myout = out;
      }
    }
    if (lane_id < 16) moves[((size_t)r * B + b) * 16 + lane_id] = myout;
    __syncwarp();                        // the tile's slot is free again
    if (y > -1) fall = y_in - y;
    tlo = tlo1;
    tlo1 = tlo2;
    tlo2 = tlo3;
    tlo3 = prefetch(r - DEPTH, DEPTH - 1);
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" int walk_backtrack_launch(const void* codes, const void* wayin,
                                     const void* aint, const void* lengths,
                                     void* moves, int B, int w2, int t,
                                     int nw, int ncw, void* stream) {
  if (B <= 0 || nw <= 0) return 0;
  if (t <= 0 || t % 16 != 0 || w2 <= 0) return (int)cudaErrorInvalidValue;
  if ((size_t)ncw * sizeof(int) > 40 * 1024)
    return (int)cudaErrorInvalidValue;
  walk_backtrack_kernel<<<B, 32, (size_t)ncw * sizeof(int),
                          (cudaStream_t)stream>>>(
      (const unsigned*)codes, (const int*)wayin, (const int*)aint,
      (const int*)lengths, (int*)moves, B, w2, t, nw, ncw);
  return (int)cudaGetLastError();
}

extern "C" const char* walk_backtrack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
