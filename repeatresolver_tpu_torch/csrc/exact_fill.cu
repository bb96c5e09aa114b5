// Kernel F: the exact-band realignment DP fill for a block of rows.
//
// Replaces the XLA scan of repeatresolver_tpu/ops/banded_realign.py::
// banded_fill (:54-208; its `lax.scan`s over chunks and positions at
// :198 and :204), with the per-row cost arrays of `_row_costs` (:37-51)
// folded in. Its plain version is repeatresolver_tpu_torch/ops/
// banded_realign.py::banded_fill (at its default chunk of 256 positions,
// the JAX package's), with the codes packed by ops/cuda_exact.py::
// pack_codes; both give the same bits.
//
// What it computes: per sequence position x, every row fills its W-lane
// band, lane i at column y = anf(x) + i with anf(x) = max(0, way[x] - W/2):
//   A[i] = min(M'[i+d-1] + sub(y, base_x), M'[i+d] + ins(y))   (0<y<C-1)
//   M[i] = min_{j<=i} A[j] + g[y+1] - g[j's y+1]                (gap runs)
// with d = anf(x) - anf(x-1), M' the previous position's band, reads past
// its top paying the gap costs up to y (the jump rule, PW_ReAligner.c
// :285-295), and 2-bit move codes by the backtracker's priority (gap, the
// flat arm at a row's last position, diagonal, insert). A row that has
// ended keeps its band; codes still come out of it, as in the plain
// version.
//
// What bounds it on an H100: integer operations and the serial chain. A
// band cell costs about a dozen int32 operations, and each row is a chain
// of up to ~33k dependent positions through a W-lane prefix-min, with a
// block of only 64 rows (a trajectory parameter). Memory is far from the
// bound: codes leave 2-bit packed, W/4 bytes a row and position.
//
// Design (the simple one; kernel A's ring of prefixes is the model for a
// faster one):
//   * one CTA a row, K contiguous lanes a thread (K = ceil(W / 512), so a
//     CTA has at most 512 threads and a band at most 4,096 lanes);
//   * phase 0: the row's gap-cost prefix g and its non-space counts ns
//     (own base removed) into scratch rows in device memory, one pass;
//   * a step: the cost window is read through L1 (the band moves by d
//     columns a step, so neighbouring steps read the same lines), the
//     previous band from a double buffer in shared memory; a thread-local
//     min-scan, a warp shuffle scan, one barrier, the warps' totals
//     scanned by every warp from shared memory, the codes shifted into a
//     register word a lane (stored every 16 positions, in kernel B's
//     time-major packed layout [ceil(L/16), B, W]), the new band into the
//     other buffer, a second barrier.
//
// Every DP sum wraps modulo 2^32 (wadd/wsub), as XLA's int32 arithmetic
// does: `BIG + cost` ties decide codes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wrap_int.cuh"

namespace {

constexpr int BIG = 1 << 30;
constexpr int NEUTRAL = 0x7fffffff;    // the identity of min
constexpr int MAX_THREADS = 512;
constexpr int MAX_K = 8;               // lanes a thread: W <= 4,096
constexpr int LPT0 = 8;                // columns a thread in phase 0
// the plain version's chunk of positions: at a chunk's first position the
// jump rule's base reads the carried band start, elsewhere the previous
// position's (the two differ only on rows whose ways are not edge-padded)
constexpr int PLAIN_CHUNK = 256;
constexpr unsigned FULL = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(MAX_THREADS) exact_fill_kernel(
    const int* __restrict__ counts,      // [C, 6]
    const int8_t* __restrict__ rows,     // [B, C]
    const int8_t* __restrict__ seqs,     // [B, L]
    const int* __restrict__ ways,        // [B, L]
    const int* __restrict__ lengths,     // [B]
    int* __restrict__ gbuf,              // [B, C+1] scratch: g
    int* __restrict__ nsbuf,             // [B, C] scratch: ns
    unsigned* __restrict__ codes,        // [ceil(L/16), B, W]
    int* __restrict__ band_out,          // [B, W]
    int* __restrict__ anf_out,           // [B]
    int B, int C, int L, int ncols, int w) {
  extern __shared__ int s_band[];        // [2][blockDim.x * K]
  __shared__ int s_wt[2][32];            // warps' totals, by step parity

  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nlanes = blockDim.x * K;
  const int b = blockIdx.x;
  const int base = tid * K;              // this thread's first lane
  const int8_t* row = rows + (size_t)b * C;
  const int8_t* seq = seqs + (size_t)b * L;
  const int* way = ways + (size_t)b * L;
  int* g = gbuf + (size_t)b * (C + 1);
  int* ns = nsbuf + (size_t)b * C;
  const int len = lengths[b];
  const int bh = w / 2;

  // ---- phase 0: g[y] = sum of gapcost over columns < y (gapcost = bases
  // in the column minus this row's own base) and ns[y] (non-space symbols
  // in the column minus this row's own)
  if (tid == 0) g[0] = 0;
  int carry = 0;
  for (int c0 = 0; c0 < C; c0 += blockDim.x * LPT0) {
    int v[LPT0];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < LPT0; ++k) {
      const int y = c0 + tid * LPT0 + k;
      v[k] = 0;
      if (y < C) {
        const int* cy = counts + 6 * (size_t)y;
        const int own = row[y];
        const int bases = wadd(wadd(cy[0], cy[1]), wadd(cy[2], cy[3]));
        v[k] = wsub(bases, own < 4 ? 1 : 0);
        ns[y] = wsub(wadd(bases, cy[4]), own < 5 ? 1 : 0);
      }
      sum = wadd(sum, v[k]);
    }
    int xs = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, xs, o);
      if (lane_id >= o) xs = wadd(xs, u);
    }
    if (lane_id == 31) s_wt[0][warp] = xs;
    __syncthreads();
    int pre = carry, tot = carry;
    for (int i = 0; i < nwarps; ++i) {
      const int wv = s_wt[0][i];
      if (i < warp) pre = wadd(pre, wv);
      tot = wadd(tot, wv);
    }
    const int ex = __shfl_up_sync(FULL, xs, 1);
    if (lane_id != 0) pre = wadd(pre, ex);
#pragma unroll
    for (int k = 0; k < LPT0; ++k) {
      const int y = c0 + tid * LPT0 + k;
      pre = wadd(pre, v[k]);
      if (y < C) g[y + 1] = pre;
    }
    carry = tot;
    __syncthreads();
  }
  // the band before the first position is 0 (MatrixOut(-1, .) = 0)
  for (int i = tid; i < nlanes; i += blockDim.x) s_band[nlanes + i] = 0;
  __syncthreads();                       // g, ns and the band are visible

  // ---- phase 1: the fill, one position a step
  unsigned word[K];
#pragma unroll
  for (int k = 0; k < K; ++k) word[k] = 0u;
  int anf_prev = 0;                      // carried: frozen past the row
  int anf_last = 0;                      // anf(x-1) from the ways
  for (int x = 0; x < L; ++x) {
    const int anf = max(0, way[x] - bh);
    const int s = seq[x];
    const int* prev = s_band + ((x + 1) & 1) * nlanes;   // position x-1
    int* cur = s_band + (x & 1) * nlanes;
    const bool first = x == 0;
    const bool active = x < len;
    const bool is_last = len == x + 1;
    const int d = anf - anf_prev;
    const int dc = min(max(d, 0), w + 1);
    const int gta = x % PLAIN_CHUNK == 0 ? anf_prev : anf_last;
    const int top = first ? 0 : wsub(prev[w - 1], g[min(gta + w, C)]);

    // the cost window: lane k at column y = anf + base + k
    int gy[K + 1], nsv[K + 1];
#pragma unroll
    for (int j = 0; j <= K; ++j) {
      const int y = anf + base + j;
      gy[j] = g[min(y, C)];              // g[y] past the array: g[C]
      const int ym1 = min(y - 1, C - 1);
      nsv[j] = ym1 >= 0 ? ns[ym1] : 0;   // ns[y - 1]
    }
    int diag[K], m[K], loc[K];
    int run = NEUTRAL;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = base + k;
      const int y = anf + i;
      int dprev = 0, uprev = 0;
      if (!first) {
        const int jd = i + d - 1;
        const int ju = i + d;
        dprev = jd >= w ? wadd(top, gy[k])
                : jd >= 0 ? prev[i + dc - 1] : BIG;
        uprev = ju >= w ? wadd(top, gy[k + 1])
                : ju >= 0 ? prev[i + dc] : BIG;
      }
      int sub = 0, ins = 0;
      if (y < C) {
        const int nsy = nsv[k + 1];
        const int nsm = y > 0 ? nsv[k] : nsy;
        ins = max(nsy, nsm);
        sub = wadd(wsub(nsy, counts[6 * (size_t)y + s]),
                   row[y] == s ? 1 : 0);
      }
      diag[k] = wadd(dprev, sub);
      const bool ok = y > 0 && y < ncols - 1;
      int a = min(diag[k], ok ? wadd(uprev, ins) : BIG);
      if (!(y < ncols) || i >= w) a = BIG;
      run = min(run, wsub(a, gy[k + 1]));
      loc[k] = run;
    }
    // the prefix-min across the band: warp scan, then the warps' totals
    int xs = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, xs, o);
      if (lane_id >= o) xs = min(xs, u);
    }
    int ext = __shfl_up_sync(FULL, xs, 1);   // the lanes below, in-warp
    if (lane_id == 0) ext = NEUTRAL;
    if (lane_id == 31) s_wt[x & 1][warp] = xs;
    __syncthreads();
    int wt = lane_id < nwarps ? s_wt[x & 1][lane_id] : NEUTRAL;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, wt, o);
      if (lane_id >= o) wt = min(wt, u);
    }
    int exw = __shfl_sync(FULL, wt, (warp + 31) & 31);
    if (warp == 0) exw = NEUTRAL;
    const int pre = min(exw, ext);       // over every lane below `base`

    // the band, the codes and the next band
    int left = base == 0 ? BIG : wadd(pre, gy[0]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      m[k] = wadd(min(pre, loc[k]), gy[k + 1]);
      const int gap = wsub(gy[k + 1], gy[k]);
      const bool gap_hit = m[k] == wadd(left, gap) || (is_last && m[k] == left);
      const unsigned code = gap_hit ? 0u : (m[k] == diag[k] ? 1u : 2u);
      word[k] = __funnelshift_r(word[k], code, 2);
      left = m[k];
    }
    if ((x & 15) == 15 || x == L - 1) {
      const int sh = 2 * (15 - (x & 15));   // a partial last word: pad 0
      unsigned* out = codes + ((size_t)(x >> 4) * B + b) * w;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (base + k < w) out[base + k] = word[k] >> sh;
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (base + k < nlanes) cur[base + k] = active ? m[k] : prev[base + k];
    if (active) anf_prev = anf;
    anf_last = anf;
    __syncthreads();                     // the new band is visible
  }
  const int* fin = s_band + ((L - 1) & 1) * nlanes;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (base + k < w) band_out[(size_t)b * w + base + k] = fin[base + k];
  if (tid == 0) anf_out[b] = anf_prev;
}

template <int K>
cudaError_t launch_k(int threads, const void* counts, const void* rows,
                     const void* seqs, const void* ways, const void* lengths,
                     void* gbuf, void* nsbuf, void* codes, void* band_out,
                     void* anf_out, int B, int C, int L, int ncols, int w,
                     cudaStream_t stream) {
  const size_t smem = (size_t)2 * threads * K * sizeof(int);
  exact_fill_kernel<K><<<B, threads, smem, stream>>>(
      (const int*)counts, (const int8_t*)rows, (const int8_t*)seqs,
      (const int*)ways, (const int*)lengths, (int*)gbuf, (int*)nsbuf,
      (unsigned*)codes, (int*)band_out, (int*)anf_out, B, C, L, ncols, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" int exact_fill_launch(
    const void* counts, const void* rows, const void* seqs, const void* ways,
    const void* lengths, void* gbuf, void* nsbuf, void* codes,
    void* band_out, void* anf_out, int B, int C, int L, int ncols, int w,
    void* stream) {
  if (B <= 0) return 0;
  if (L <= 0 || C <= 0 || w <= 0 || w > MAX_THREADS * MAX_K)
    return (int)cudaErrorInvalidValue;
  const int k = (w + MAX_THREADS - 1) / MAX_THREADS;
  const int threads = (((w + k - 1) / k) + 31) / 32 * 32;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
#define EXACT_FILL_CASE(KK)                                                 \
  case KK:                                                                  \
    err = launch_k<KK>(threads, counts, rows, seqs, ways, lengths, gbuf,    \
                       nsbuf, codes, band_out, anf_out, B, C, L, ncols, w,  \
                       st);                                                 \
    break;
  switch (k) {
    EXACT_FILL_CASE(1)
    EXACT_FILL_CASE(2)
    EXACT_FILL_CASE(3)
    EXACT_FILL_CASE(4)
    EXACT_FILL_CASE(5)
    EXACT_FILL_CASE(6)
    EXACT_FILL_CASE(7)
    EXACT_FILL_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef EXACT_FILL_CASE
  return (int)err;
}

extern "C" const char* exact_fill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
