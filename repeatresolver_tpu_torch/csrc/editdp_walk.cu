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
// chain of a row: each step's code decides where the next one is read,
// up to qlen + Lt steps a row. Read from device memory, a step waits for
// its load (the first version of this kernel took about 490 ns a step).
//
// Design: one warp a row, several rows a CTA. The warp scans the final
// row (coalesced, a shuffle reduction that keeps the largest column on
// ties) and writes the row's -1s. Then it walks over tiles of the packed
// codes (editdp_layout.cuh) in shared memory: a tile holds the pairs of
// TILE_STEPS steps s0 - 63 .. s0 of the TILE_WORDS words k0 - 3 .. k0,
// 128 columns. A walk step moves s = x + k back by 0-2 and the word k
// back by 0-1, never forward, so the walk stays in a tile for dozens of
// steps. The next tile, 64 steps deeper at the walk's current word, is
// copied in by cp.async while the walk runs on the current one (two
// buffers a warp); a walk that leaves both waits once for the tile at
// its position. The warp takes up to five steps at once: lane j follows
// the five moves the bits of j name (diagonal or 'd') and reads the five
// codes on its path together; the lanes that match the most steps hold
// the walk's path, which only an 'i' (taken alone after it) or the tile's
// edge can end sooner. Every lane holds the same (x, y).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "editdp_layout.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 4;                // rows (warps) a CTA
constexpr int TILE_WORDS = 4;          // words a tile, k0 - 3 .. k0
constexpr int TILE_STEPS = 64;         // steps a tile, s0 - 63 .. s0

constexpr int TILE = TILE_STEPS * TILE_WORDS;   // pairs
constexpr int TREE = 5;                // the tree's depth: 2^5 lanes

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sa),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// start copying the tile anchored at (seg, s0, k0) into buf: the pair of
// step s0 - r and word k0 - d at buf[r * TILE_WORDS + d]
__device__ __forceinline__ void fetch_tile(uint2* buf, const uint2* cb,
                                           int seg, int s0, int k0, int T,
                                           int steps, int lane) {
  for (int e = lane; e < TILE; e += 32) {
    const int s = s0 - e / TILE_WORDS;
    const int kk = k0 - e % TILE_WORDS;
    if (s >= 0 && kk >= 0)
      cp_async8(buf + e, cb + packed_word(seg, kk, s, T, steps));
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(32 * ROWS) editdp_walk_kernel(
    const uint2* __restrict__ codes,     // [B, nseg, steps, T]
    const int* __restrict__ qlens,       // [B]
    const int* __restrict__ fr,          // [B, Lt]
    int* __restrict__ out,               // [B, Lq]
    int* __restrict__ walked,            // [B] steps a row, or null
    int B, int lq, int lt, int T, int nseg, int steps) {
  __shared__ __align__(16) uint2 s_tiles[ROWS][2 * TILE];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (b >= B) return;                    // warps never meet: no barrier
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
    const int ob = __shfl_xor_sync(FULL, best, off);
    const int oc = __shfl_xor_sync(FULL, col, off);
    if (ob < best || (ob == best && oc > col)) {
      best = ob;
      col = oc;
    }
  }
  int* ob = out + (size_t)b * lq;
  for (int x = lane; x < lq; x += 32) ob[x] = -1;
  __syncwarp();

  const uint2* cb = codes + (size_t)b * nseg * steps * T;
  uint2* bufs = s_tiles[threadIdx.x >> 5];
  int x = min(qlens[b], lq) - 1;
  int y = col;                           // the same in every lane
  int n = 0;
  int seg = y / (WORD * T);
  int y_seg = seg * WORD * T;            // the segment's first column
  // the current tile (buffer cur) and the one being fetched: anchors
  int cur = 0;
  int c_seg = -1, c_s0 = 0, c_k0 = 0;
  int n_seg = -1, n_s0 = 0, n_k0 = 0;
  while (x >= 0 && y >= 0) {
    if (y < y_seg) {                     // into the segment before
      --seg;
      y_seg -= WORD * T;
    }
    const int k = (y - y_seg) / WORD;
    const int s = x + k;
    // s <= c_s0 and k <= c_k0 hold inside a tile: the walk never goes up
    if (seg != c_seg || s <= c_s0 - TILE_STEPS || k <= c_k0 - TILE_WORDS) {
      // the fetched tile has landed, and every lane is done with the
      // buffer that is refilled next
      cp_async_wait_all();
      __syncwarp();
      if (seg == n_seg && s <= n_s0 && s > n_s0 - TILE_STEPS && k <= n_k0
          && k > n_k0 - TILE_WORDS) {
        cur ^= 1;
        c_seg = n_seg;
        c_s0 = n_s0;
        c_k0 = n_k0;
      } else {
        fetch_tile(bufs + cur * TILE, cb, seg, s, k, T, steps, lane);
        c_seg = seg;
        c_s0 = s;
        c_k0 = k;
        cp_async_wait_all();
        __syncwarp();
      }
      // the steps below this tile, at the walk's word
      n_seg = seg;
      n_s0 = c_s0 - TILE_STEPS;
      n_k0 = k;
      fetch_tile(bufs + (cur ^ 1) * TILE, cb, n_seg, n_s0, n_k0, T, steps,
                 lane);
    }
    // the code at (px, py), or -1 outside the tile, the segment or the DP
    // (no branch: the reads of a lane's positions go out together)
    auto code_at = [&](int px, int py) {
      const int kk = (py - y_seg) >> 5;  // floor: negative before y_seg
      const int ss = px + kk;
      const bool in = px >= 0 && py >= y_seg && ss > c_s0 - TILE_STEPS
          && kk > c_k0 - TILE_WORDS;
      const uint2 pr = bufs[cur * TILE
          + (in ? (c_s0 - ss) * TILE_WORDS + (c_k0 - kk) : 0)];
      const int bit = py & (WORD - 1);
      const int code = (int)((((pr.y >> bit) & 1u) << 1)
                             | ((pr.x >> bit) & 1u));
      return in ? code : -1;
    };
    // lane j follows the TREE moves of the bits of j (0 diagonal, 1 'd');
    // the lanes whose moves match the codes the longest hold the path,
    // which only an 'i' or the tile's edge can end sooner
    int px = x, py = y, matched = 0, end_code = -1;
    bool alive = true;
#pragma unroll
    for (int t = 0; t < TREE; ++t) {
      const int up = (lane >> t) & 1;
      const int code = code_at(px, py);
      const bool ok = code >= 0 && (up ? code == 2 : (code == 0 || code == 3));
      if (alive && !ok) end_code = code;
      alive = alive && ok;
      matched += alive;
      --px;
      py -= 1 - up;
    }
    const int m = __reduce_max_sync(FULL, (unsigned)matched);
    const int path = __ffs(__ballot_sync(FULL, matched == m)) - 1;
    // lane t < m places the base of step t if that step is diagonal
    const unsigned diag = ~(unsigned)path & ((1u << m) - 1u);
    if (lane < m && ((diag >> lane) & 1u))
      ob[x - lane] = y - __popc(diag & ((1u << lane) - 1u));
    x -= m;
    y -= __popc(diag);
    n += m;
    if (m < TREE && __shfl_sync(FULL, end_code, path) == 1) {
      --y;                               // the 'i' that ended the path
      ++n;
    }
  }
  cp_async_wait_all();
  if (walked != nullptr && lane == 0) walked[b] = n;
}

}  // namespace

extern "C" int editdp_walk_launch(const void* codes, const void* qlens,
                                  const void* fr, void* out, void* walked,
                                  int B, int lq, int lt, int threads,
                                  int nseg, int steps, void* stream) {
  if (B <= 0) return 0;
  if (lq < 0 || lt < 2 || threads <= 0 || nseg <= 0
      || (long long)nseg * threads * WORD < lt || steps < lq + threads - 1)
    return (int)cudaErrorInvalidValue;
  editdp_walk_kernel<<<(B + ROWS - 1) / ROWS, 32 * ROWS, 0,
                       (cudaStream_t)stream>>>(
      (const uint2*)codes, (const int*)qlens, (const int*)fr, (int*)out,
      (int*)walked, B, lq, lt, threads, nseg, steps);
  return (int)cudaGetLastError();
}

extern "C" const char* editdp_walk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
