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
// and the final row M[qlen-1][:] (left 0 when qlen is 0). Symbols arrive
// as dense codes (ops/cuda_editdp.py::symbol_codes), equal exactly where
// the int16 symbols are: the pads (100 for queries and for the template
// part past the template, 200 for cut's targets) never equal a base.
//
// Three modes: FINAL_ROWS (cut: the final rows only, rows x < qlen),
// CODES_INT8 (align_with_codes: a byte a code for every x < Lq, the
// layout [Lq, B, Lt] of the plain version, rows past qlen included) and
// CODES_PACKED (align_on_device: two bits a code, rows x < qlen only, in
// the layout kernel D reads, editdp_layout.cuh).
//
// The recurrence is evaluated a word of 32 target columns at a time:
// neighbouring cells differ by -1, 0 or +1, so a row of a word is two
// bit vectors of deltas, and Myers' bit-vector recurrence in Hyyro's
// block form advances it a row in a few word operations (the bits run
// along the target, a step is a query row). A thread keeps its word's
// vertical deltas Pv / Mv (bit i: M[x][y0+i] - M[x][y0+i-1] is +1 / -1;
// row -1 is 0, so both start at 0). A step takes the carry h_in =
// M[x][y0-1] - M[x-1][y0-1] from the word before (+1 at column -1) and
// gives h_out at its last column. The codes follow from the same bits:
// c_left = Mh_in & ~Eq and c_up = Mv_before & ~Eq & ~c_left, where Mh_in
// is the step's shifted -1 carries and Mv_before the -1 deltas of row
// x-1, so the two code planes are lo = Mh_in | Eq and hi = (Mv_before &
// ~Mh_in) | Eq. The final row is expanded from the absolute value of the
// word's last column, which a thread carries from row to row.
// (tests/test_torch_editdp_bitparallel.py holds a numpy model of this
// arithmetic to the plain version and to the JAX package.)
//
// What bounds it on an H100: the bytes of the codes at two bits a cell
// (CODES_PACKED); the operations are 25 a 32-column word step, 0.78 a
// cell (chip_smoke.py's EDIT_OPS_PER_WORD lists them). At 256 rows of
// four words a row, an SM holds about 8 warps, too few to hide a step's
// chain of dependent operations and shuffles: the kernel is bound by
// that latency more than by either.
//
// Design:
//   * each thread owns a 32-column word of one batch row: its Pv / Mv in
//     registers, its match masks Peq[symbol] in shared memory (a column
//     of the table a thread, so a step's lookup is conflict-free);
//   * a wavefront skewed along the query: at warp step st lane l computes
//     row x = st - l, its carry coming from lane l-1's step before by a
//     shuffle, with the query symbol of the row. A row's warps run as a
//     pipeline with no barrier: the last lane of a warp hands {x, carry,
//     symbol} to the next warp through a ring of 32-bit slots in shared
//     memory, tagged with x; the next warp reads 32 rows of slots at
//     once, and publishes how far it has read so that the writer never
//     overwrites a slot not yet read. The first warp reads its symbols
//     (and, in a later segment, its carries) a batch of 32 rows ahead;
//   * steps go in batches of 32, and a batch in which every lane's row
//     lies inside the fill and none is the final row runs unrolled,
//     without a test a step;
//   * several batch rows a CTA where a row has few words, so that a CTA
//     holds at least 256 threads;
//   * a row wider than 1,024 words runs as segments one after the other,
//     the last lane of a segment leaving its carries in a per-row buffer
//     for the next segment's first warp (two buffers by segment parity);
//   * CODES_PACKED: a step's two planes are one 8-byte store, and the 32
//     lanes of a warp store 32 neighbouring pairs (editdp_layout.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "editdp_layout.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_SYMBOLS = 8;
constexpr int RING = 128;              // hand-off slots between two warps
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned EMPTY = 0xffffffffu;  // no row's tag (Lq < 2^26)

enum { FINAL_ROWS = 0, CODES_INT8 = 1, CODES_PACKED = 2 };

__device__ __forceinline__ unsigned ld_volatile(const unsigned* p) {
  return *(const volatile unsigned*)p;
}
__device__ __forceinline__ void st_volatile(unsigned* p, unsigned v) {
  *(volatile unsigned*)p = v;
}

// four bits of a plane spread to the low bits of four bytes
__device__ __forceinline__ unsigned spread4(unsigned nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

template <int MODE>
__global__ void __launch_bounds__(MAX_THREADS) editdp_fill_kernel(
    const uint8_t* __restrict__ q,     // [B, Lq] symbol codes
    const int* __restrict__ qlens,     // [B]
    const uint8_t* __restrict__ t,     // [B, Lt] codes, row stride t_sb
    long long t_sb, int B, int lq, int lt, int T, int rows_per_cta,
    int nseg, int steps, int nsym,
    signed char* __restrict__ codes8,  // CODES_INT8: [Lq, B, Lt]
    uint2* __restrict__ codes2,        // CODES_PACKED: [B, nseg, steps, T]
    int* __restrict__ fr,              // [B, Lt], zero on entry
    uint8_t* __restrict__ bcol) {      // [2, B, Lq] when nseg > 1
  extern __shared__ unsigned smem[];
  const int nthr = blockDim.x;
  unsigned* s_peq = smem;                          // [nsym][nthr]
  unsigned* s_ring = s_peq + nsym * nthr;          // [nthr / 32][RING]
  unsigned* s_read = s_ring + (nthr >> 5) * RING;  // [nthr / 32]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gw = tid >> 5;               // warp of the CTA
  const int r = tid / T;                 // batch row of the CTA
  const int k = tid - r * T;             // word of the segment
  const int w = k >> 5;                  // warp of the row
  const bool has_next = w + 1 < (T >> 5);
  const int b = blockIdx.x * rows_per_cta + r;
  const bool live = b < B;
  const int qlen = live ? qlens[b] : 0;
  const int xend = !live ? 0 : MODE == CODES_INT8 ? lq : min(max(qlen, 0), lq);
  const uint8_t* qb = q + (size_t)(live ? b : 0) * lq;
  const uint8_t* tb = t + (size_t)(live ? b : 0) * t_sb;
  unsigned* ring_in = s_ring + gw * RING;          // from warp w-1
  unsigned* ring_out = s_ring + (gw + 1) * RING;   // to warp w+1
  const unsigned* peq = s_peq + tid;
  const int nst = xend > 0 ? xend + 31 : 0;        // this warp's steps

  for (int seg = 0; seg < nseg; ++seg) {
    const int y0 = (seg * T + k) * WORD;
    for (int c = 0; c < nsym; ++c) s_peq[c * nthr + tid] = 0u;
    for (int i = 0; i < WORD; ++i)
      if (live && y0 + i < lt) s_peq[(int)tb[y0 + i] * nthr + tid] |= 1u << i;
    for (int i = lane; i < RING; i += 32) ring_in[i] = EMPTY;
    if (lane == 0) s_read[gw] = 0u;
    __syncthreads();

    const int ncols = min(max(lt - y0, 0), WORD);
    const unsigned colmask = ncols == WORD ? FULL : (1u << ncols) - 1u;
    const uint8_t* bc_in =
        seg > 0 ? bcol + ((size_t)(seg & 1) * B + b) * lq : nullptr;
    uint8_t* bc_out = seg + 1 < nseg
        ? bcol + ((size_t)((seg + 1) & 1) * B + b) * lq : nullptr;
    // the pair this lane stores at step st (s = x + k = 32w + st)
    uint2* p2 = MODE == CODES_PACKED
        ? codes2 + (size_t)b * nseg * steps * T
              + packed_word(seg, k, 32 * w, T, steps)
        : nullptr;
    unsigned pv = 0u, mv = 0u;         // row -1 is all 0
    int last = 0;                      // M[x][y0 + 31]
    unsigned hand = 0u;                // (symbol << 2) | (h_out + 1)

    // one step at row x = st - lane from in = (symbol << 2) | (h_in + 1):
    // the new deltas, the carry for lane + 1 and the two code planes
    auto step = [&](unsigned in, unsigned& lo, unsigned& hi) {
      const unsigned neg = (in & 3u) == 0u;       // h_in = -1
      const unsigned pos = (in & 3u) == 2u;       // h_in = +1
      const unsigned eq = peq[(in >> 2) * nthr];
      const unsigned xv = eq | mv;
      const unsigned eqh = eq | neg;
      const unsigned xh = (((eqh & pv) + pv) ^ pv) | eqh;
      unsigned ph = mv | ~(xh | pv);
      unsigned mh = pv & xh;
      const unsigned h1 = 1u + (ph >> 31) - (mh >> 31);
      hand = (in & ~3u) | h1;
      last += (int)h1 - 1;
      ph = (ph << 1) | pos;
      mh = (mh << 1) | neg;
      lo = (mh | eq) & colmask;
      hi = ((mv & ~mh) | eq) & colmask;
      pv = mh | ~(xv | ph);
      mv = ph & xv;
    };
    // the last lane hands its carry on, to the next warp or segment
    auto hand_on = [&](int x) {
      if (lane == 31) {
        if (has_next)
          st_volatile(ring_out + (x & (RING - 1)), ((unsigned)x << 5) | hand);
        else if (bc_out != nullptr)
          bc_out[x] = (uint8_t)(hand & 3u);
      }
    };
    // the first warp's inputs come from device memory a batch ahead
    auto first_input = [&](int row) {
      return row < xend ? ((unsigned)qb[row] << 2)
                              | (seg == 0 ? 2u : (unsigned)bc_in[row])
                        : 0u;
    };
    unsigned pre = w == 0 ? first_input(lane) : 0u;

    for (int st0 = 0; st0 < nst; st0 += 32) {
      if (has_next && st0 + 1 > RING) {
        // the slots of rows st0-31 .. st0, written in this batch of 32
        // steps, must have been read by the next warp
        while ((int)ld_volatile(s_read + gw + 1) < st0 + 1 - RING) {
        }
      }
      // lane j: the input of row st0 + j
      unsigned inbuf;
      if (w == 0) {
        inbuf = pre;
        pre = first_input(st0 + 32 + lane);
      } else {
        const int xr = st0 + lane;
        const bool need = xr < xend;
        unsigned v;
        do {
          v = ld_volatile(ring_in + (xr & (RING - 1)));
        } while (__any_sync(FULL, need && (v >> 5) != (unsigned)xr));
        inbuf = v & 31u;
        __syncwarp();
        if (lane == 0) st_volatile(s_read + gw, (unsigned)(st0 + 32));
      }
      if (MODE != CODES_INT8 && st0 >= 32 && st0 + 32 < xend) {
        // every lane's row lies in [0, xend) for the whole batch, and
        // none is the final row: no tests
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const unsigned from_left = __shfl_up_sync(FULL, hand, 1);
          const unsigned from_in = __shfl_sync(FULL, inbuf, i);
          unsigned lo, hi;
          step(lane == 0 ? from_in : from_left, lo, hi);
          hand_on(st0 + i - 31);
          if (MODE == CODES_PACKED) {
            *p2 = make_uint2(lo, hi);
            p2 += T;
          }
        }
        continue;
      }
      for (int i = 0; i < 32 && st0 + i < nst; ++i) {
        const unsigned from_left = __shfl_up_sync(FULL, hand, 1);
        const unsigned from_in = __shfl_sync(FULL, inbuf, i);
        const int x = st0 + i - lane;
        if (x >= 0 && x < xend) {
          unsigned lo, hi;
          step(lane == 0 ? from_in : from_left, lo, hi);
          hand_on(x);
          if (MODE == CODES_PACKED) *p2 = make_uint2(lo, hi);
          if (MODE == CODES_INT8) {
            unsigned by[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              by[j] = spread4((lo >> (4 * j)) & 15u)
                      | (spread4((hi >> (4 * j)) & 15u) << 1);
            signed char* dst = codes8 + ((size_t)x * B + b) * lt + y0;
            if ((lt & 15) == 0 && y0 + WORD <= lt) {
              uint4* d4 = reinterpret_cast<uint4*>(dst);
              d4[0] = make_uint4(by[0], by[1], by[2], by[3]);
              d4[1] = make_uint4(by[4], by[5], by[6], by[7]);
            } else {
#pragma unroll
              for (int j = 0; j < WORD; ++j)
                if (j < ncols)
                  dst[j] = (signed char)((by[j >> 2] >> (8 * (j & 3)))
                                         & 0xffu);
            }
          }
          if (x == qlen - 1) {
            // expand the row down from the word's last column
            int* dst = fr + (size_t)b * lt + y0;
            for (int j = 0; j < ncols; ++j) {
              const unsigned above = 0xfffffffeu << j;
              dst[j] = last - (__popc(pv & above) - __popc(mv & above));
            }
          }
        }
        if (MODE == CODES_PACKED) p2 += T;
      }
    }
    if (seg + 1 < nseg) __syncthreads();   // the tables are reused
  }
}

template <int MODE>
cudaError_t launch(dim3 grid, dim3 block, size_t smem, cudaStream_t st,
                   const uint8_t* q, const int* ql, const uint8_t* t,
                   long long t_sb, int B, int lq, int lt, int T, int rpc,
                   int nseg, int steps, int nsym, signed char* codes8,
                   uint2* codes2, int* fr, uint8_t* bcol) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        editdp_fill_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  editdp_fill_kernel<MODE><<<grid, block, smem, st>>>(
      q, ql, t, t_sb, B, lq, lt, T, rpc, nseg, steps, nsym, codes8, codes2,
      fr, bcol);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 final rows, 1 int8 codes [Lq, B, Lt], 2 packed codes
// [B, nseg, steps, threads, 2]. q and t are uint8 symbol codes, q
// [B, Lq] contiguous, t rows of Lt contiguous codes t_sb apart (0: one
// target for the batch).
extern "C" int editdp_fill_launch(
    const void* q, const void* qlens, const void* t, int t_sb, int B,
    int lq, int lt, int mode, int threads, int rows_per_cta, int nseg,
    int steps, int nsym, void* codes8, void* codes2, void* fr, void* bcol,
    void* stream) {
  if (B <= 0) return 0;
  if (lq < 0 || lq >= (1 << 26) || lt <= 0 || (t_sb != 0 && t_sb < lt)
      || threads <= 0 || threads % 32 != 0 || rows_per_cta <= 0
      || threads * rows_per_cta > MAX_THREADS || nsym <= 0
      || nsym > MAX_SYMBOLS || nseg <= 0
      || (long long)nseg * threads * WORD < lt
      || (long long)(nseg - 1) * threads * WORD >= lt
      || (nseg > 1 && (bcol == nullptr || rows_per_cta != 1))
      || fr == nullptr || (mode == CODES_INT8 && codes8 == nullptr)
      || (mode == CODES_PACKED
          && (codes2 == nullptr || steps < lq + threads - 1)))
    return (int)cudaErrorInvalidValue;
  const int nthr = threads * rows_per_cta;
  const size_t smem =
      ((size_t)nsym * nthr + (size_t)(nthr / 32) * (RING + 1)) * 4;
  const dim3 grid((B + rows_per_cta - 1) / rows_per_cta), block(nthr);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* qs = (const uint8_t*)q;
  const uint8_t* ts = (const uint8_t*)t;
  const int* ql = (const int*)qlens;
  cudaError_t e;
  switch (mode) {
    case FINAL_ROWS:
      e = launch<FINAL_ROWS>(grid, block, smem, st, qs, ql, ts, t_sb, B, lq,
                             lt, threads, rows_per_cta, nseg, steps, nsym,
                             nullptr, nullptr, (int*)fr, (uint8_t*)bcol);
      break;
    case CODES_INT8:
      e = launch<CODES_INT8>(grid, block, smem, st, qs, ql, ts, t_sb, B, lq,
                             lt, threads, rows_per_cta, nseg, steps, nsym,
                             (signed char*)codes8, nullptr, (int*)fr,
                             (uint8_t*)bcol);
      break;
    case CODES_PACKED:
      e = launch<CODES_PACKED>(grid, block, smem, st, qs, ql, ts, t_sb, B,
                               lq, lt, threads, rows_per_cta, nseg, steps,
                               nsym, nullptr, (uint2*)codes2, (int*)fr,
                               (uint8_t*)bcol);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

extern "C" const char* editdp_fill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
