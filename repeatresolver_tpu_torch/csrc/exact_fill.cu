// Kernel F: the exact-band realignment DP fill for a block of rows.
//
// Replaces the XLA scan of repeatresolver_tpu/ops/banded_realign.py::
// banded_fill (:54-208; its `lax.scan`s over chunks and positions at
// :198 and :204), with the per-row cost arrays of `_row_costs` (:37-51)
// folded in. Its plain version is repeatresolver_tpu_torch/ops/
// banded_realign.py::banded_fill (at its default chunk of 256 positions,
// the JAX package's), with the codes packed by ops/cuda_exact.py::
// pack_codes; both give the same bits. tests/test_torch_exact_fill_model.py
// holds a numpy model of this kernel's arithmetic, split as below.
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
// What bounds it on an H100: the serial chain. A band cell costs about a
// dozen int32 operations, but each row is a chain of up to ~33k dependent
// positions through a W-lane prefix-min, with a block of only 64 rows (a
// trajectory parameter), so a position's latency is what counts. Memory
// is far from the bound: codes leave 2-bit packed, W/4 bytes a row and
// position.
//
// Design. The band is kept in band coordinates (lane i at column
// anf(x) + i), so the codes leave in the packed layout of the plain
// version with no transpose, and the prefix-min always starts at lane 0.
// What moves is the data: lane i reads lanes i+d-1 and i+d of x-1, that
// is, values flow down by d lanes a step.
//   * The band is reduced: r = M - g[y+1], g the row's gap-cost prefix.
//     r of a column does not change when the band moves, so a shift is a
//     plain move of r, the jump rule (a read past the band's top at x-1)
//     is the source lane clamped to W-1, the diagonal is r' + (sub - gap)
//     and the insert r' + ins, and every equality of the plain version
//     (gap: M[i] == M[i-1] + gap; diagonal: M == diag) is the same test
//     on r. g itself is needed only at the band's edges.
//   * A row is one cluster of 1, 2, 4 or 8 CTAs (one up to 2,048 lanes,
//     two up to 4,096, four up to 8,192, eight up to 16,384), four lanes
//     a thread. At band 1,000 one CTA a row (8 warps) beat two and four:
//     the CTA border's hand-offs cost more than the SMs gain
//     (chip_smoke.py phase 9, PERF.md §6). The
//     warps of a row run skewed in x with no block barrier inside a
//     chunk: a warp takes the running prefix of the lanes below it
//     through tagged 64-bit {x, value} slots (kernel A's ring; the next
//     CTA's first warp through distributed shared memory), and publishes
//     its band of x into a double buffer in shared memory with a progress
//     count (release and acquire at CTA scope). A warp reads its sources
//     of x-1 from its own warp and the warp above once that warp's count
//     reaches x-1; the top warp of a CTA reads the next CTA's first warp from a
//     strip that warp pushes into it every step as {x, value} pairs, read
//     until they carry x-1 (no cluster-scope fence in the chain). Upper
//     warps need the lower warps' prefix of x+1 before they can overwrite
//     x-1, so the double buffer needs nothing more; a warp's first lane
//     reads the lane below from the prefix it was handed at x-1, and a
//     step that does not shift (past a row's end) reads its own lanes
//     from registers.
//   * A chunk is at most 128 positions whose bands stay within 512
//     columns of its first band. Its cost window (six planes: the four
//     substitution costs less the gap cost, the insert cost and g[y+1],
//     precomputed per row in phase 0) and its ways and bases are staged
//     into shared memory by cp.async one chunk ahead, so no step loads
//     device memory. The cluster meets once a chunk.
//   * The large-shift path: a step whose shift is negative or passes a
//     warp's span of lanes, or whose jump rule reads a base that is not
//     the carried band start (only past a row's end with ways that are
//     not edge-padded), starts a chunk. A chunk's first step runs after
//     the cluster barrier and reads any lane of any CTA, and g from
//     device memory where the plain version's rules need it.
//   * What is uniform is decided once per warp and step: a warp whose
//     columns touch the MSA's edges, and a row's last position, take a
//     body with the plain version's masks and flat rule.
//   * Codes shift into one register word a lane and are stored every 16
//     positions in kernel B's time-major packed layout [ceil(L/16), B, W].
//   * A band past 16,384 lanes, which no cluster of 8 CTAs holds at four
//     lanes a thread in shared memory, takes the wide layout
//     (exact_fill_wide_kernel below): every step the chunk-first step's
//     rules, the band in device memory, two cluster barriers a step. Only
//     device memory bounds its band.
//
// Every DP sum wraps modulo 2^32 (wadd/wsub), as XLA's int32 arithmetic
// does: `BIG + cost` ties decide codes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wrap_int.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BIG = 1 << 30;
constexpr int NEUTRAL = 0x7fffffff;    // the identity of min
constexpr int K = 4;                   // band lanes a thread
constexpr int SPAN = 32 * K;           // band lanes a warp
constexpr int MAX_THREADS = 512;
constexpr int TMAX = 128;              // positions a chunk at most
constexpr int SLACK = 512;             // columns a chunk's bands may move
constexpr int NP = 6;                  // cost planes
constexpr int LPT0 = 8;                // columns a thread in phase 0
// the plain version's chunk of positions: at a chunk's first position the
// jump rule's base reads the carried band start, elsewhere the previous
// position's (the two differ only on rows whose ways are not edge-padded)
constexpr int PLAIN_CHUNK = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// the hand-off slots: one 8-byte {x, value} word, read and written whole
__device__ __forceinline__ unsigned long long ld_slot(unsigned addr) {
  unsigned long long v;
  asm volatile("ld.volatile.shared.u64 %0, [%1];" : "=l"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void st_slot(unsigned addr, unsigned long long v) {
  asm volatile("st.volatile.shared::cluster.u64 [%0], %1;" ::"r"(addr),
               "l"(v)
               : "memory");
}
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr),
      "r"(rank));
  return r;
}
__device__ __forceinline__ void st_slot_cta(unsigned addr,
                                            unsigned long long v) {
  asm volatile("st.volatile.shared.u64 [%0], %1;" ::"r"(addr), "l"(v)
               : "memory");
}
// progress counts: a warp's band of x is written before its count says x
__device__ __forceinline__ int ld_acq_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];" : "=r"(v)
               : "r"(saddr(p)) : "memory");
  return v;
}
__device__ __forceinline__ void st_rel_cta(int* p, int v) {
  asm volatile("st.release.cta.shared::cta.b32 [%0], %1;" ::"r"(saddr(p)),
               "r"(v) : "memory");
}
// the strip: the next CTA's first warp's band, {x, value} a lane, 8
// bytes read and written whole, so its reader needs no fence
__device__ __forceinline__ int2 ld_strip(const int2* p) {
  int2 v;
  asm volatile("ld.volatile.shared.v2.b32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "r"(saddr(p)));
  return v;
}
__device__ __forceinline__ void st_strip_remote(unsigned addr, int x, int a,
                                                int b) {
  asm volatile("st.volatile.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};"
               ::"r"(addr), "r"(x), "r"(a), "r"(x), "r"(b) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   saddr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   saddr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Phase 0 of both layouts: the cost planes of a row, cluster-wide, each
// CTA a contiguous slice of columns: subg_s = sub_s - gapcost, ins, and
// g[y+1], the prefix of gapcost (each CTA scans its slice, then adds the
// totals of the CTAs below). Column y at index y + 4 of each plane row.
__device__ __forceinline__ void row_planes(const int* __restrict__ counts,
                                           const int8_t* __restrict__ row,
                                           int* __restrict__ pl, int C,
                                           int cps, int* s_wt, int* s_total,
                                           cg::cluster_group& cluster) {
  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int nthr = blockDim.x;
  const int nwarps = nthr >> 5;
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  int* g1p = pl + 5 * (size_t)cps;
  const int slice = ((cps + cs - 1) / cs + 3) & ~3;
  const int s_lo = min(rank * slice, cps);
  const int s_hi = min(s_lo + slice, cps);
  {
    int carry = 0;
    for (int t0 = s_lo; t0 < s_hi; t0 += nthr * LPT0) {
      int gv[LPT0];
      int sum = 0;
      int nsm = 0;                       // ns of the column below
#pragma unroll
      for (int k = 0; k < LPT0; ++k) {
        const int idx = t0 + tid * LPT0 + k;
        const int y = idx - 4;
        int v[NP] = {0, 0, 0, 0, 0, 0};
        if (idx < s_hi && y >= 0 && y < C) {
          const int2 c01 = *(const int2*)(counts + 6 * (size_t)y);
          const int2 c23 = *(const int2*)(counts + 6 * (size_t)y + 2);
          const int2 c45 = *(const int2*)(counts + 6 * (size_t)y + 4);
          const int own = row[y];
          const int bases = wadd(wadd(c01.x, c01.y), wadd(c23.x, c23.y));
          const int ns = wsub(wadd(bases, c45.x), own < 5 ? 1 : 0);
          const int gap = wsub(bases, own < 4 ? 1 : 0);
          if (k == 0 || y == 0) {
            if (y > 0) {
              const int* cm = counts + 6 * (size_t)(y - 1);
              const int bm = wadd(wadd(cm[0], cm[1]), wadd(cm[2], cm[3]));
              nsm = wsub(wadd(bm, cm[4]), row[y - 1] < 5 ? 1 : 0);
            } else {
              nsm = ns;
            }
          }
          const int cv[4] = {c01.x, c01.y, c23.x, c23.y};
#pragma unroll
          for (int s = 0; s < 4; ++s)
            v[s] = wsub(wadd(wsub(ns, cv[s]), own == s ? 1 : 0), gap);
          v[4] = max(ns, nsm);
          v[5] = gap;
          nsm = ns;
        }
        if (idx < s_hi) {
#pragma unroll
          for (int p = 0; p < 5; ++p) pl[(size_t)p * cps + idx] = v[p];
        }
        gv[k] = v[5];
        sum = wadd(sum, v[5]);
      }
      int xs = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, xs, o);
        if (lane_id >= o) xs = wadd(xs, u);
      }
      if (lane_id == 31) s_wt[warp] = xs;
      __syncthreads();
      int pre = carry, tot = carry;
      for (int i = 0; i < nwarps; ++i) {
        const int wv = s_wt[i];
        if (i < warp) pre = wadd(pre, wv);
        tot = wadd(tot, wv);
      }
      const int ex = __shfl_up_sync(FULL, xs, 1);
      if (lane_id != 0) pre = wadd(pre, ex);
#pragma unroll
      for (int k = 0; k < LPT0; ++k) {
        const int idx = t0 + tid * LPT0 + k;
        pre = wadd(pre, gv[k]);
        if (idx < s_hi) g1p[idx] = pre;
      }
      carry = tot;
      __syncthreads();
    }
    if (tid == 0) *s_total = carry;
  }
  cluster.sync();                        // the slices' totals, the flags
  {
    int off = 0;
    for (int r = 0; r < rank; ++r)
      off = wadd(off, *cluster.map_shared_rank(s_total, r));
    if (off != 0)
      for (int idx = s_lo + tid; idx < s_hi; idx += nthr)
        g1p[idx] = wadd(g1p[idx], off);
  }
  cluster.sync();                        // every plane is complete
}

template <int MAXT>
__global__ void __launch_bounds__(MAXT) exact_fill_kernel(
    const int* __restrict__ counts,      // [C, 6]
    const int8_t* __restrict__ rows,     // [B, C]
    const int8_t* __restrict__ seqs,     // [B, L]
    const int* __restrict__ ways,        // [B, L]
    const int* __restrict__ lengths,     // [B]
    int* __restrict__ planes,            // [B, 6, cps] scratch
    unsigned* __restrict__ codes,        // [ceil(L/16), B, W]
    int* __restrict__ band_out,          // [B, W]
    int* __restrict__ anf_out,           // [B]
    int B, int C, int L, int ncols, int w, int cps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_wt[MAX_THREADS / 32];
  __shared__ int s_total;                // this CTA's slice of gap costs
  __shared__ int s_prog[MAX_THREADS / 32];   // a warp's last band written

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int nthr = blockDim.x;
  const int nwarps = nthr >> 5;
  const int LC = nthr * K;               // band lanes of a CTA
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int lb = tid * K;                // first lane within the CTA
  const int base = rank * LC + lb;       // first lane in the band
  const int WIN = LC + SLACK + 4;        // columns of a staged window
  const int bh = w / 2;
  const int len = lengths[b];
  const int8_t* row = rows + (size_t)b * C;
  const int8_t* seq = seqs + (size_t)b * L;
  const int* way = ways + (size_t)b * L;
  int* pl = planes + (size_t)b * NP * cps;   // column y at y + 4
  int* g1p = pl + 5 * (size_t)cps;           // g[y+1] at y + 4

  // dynamic shared memory: hand-off slots, band double buffer, the
  // strip, staged cost planes, staged ways and bases, the step table
  unsigned long long* hand = (unsigned long long*)smem_raw;  // [nw][TMAX]
  int* s_band = (int*)(hand + (size_t)nwarps * TMAX);        // [2][LC]
  int2* s_strip = (int2*)(s_band + 2 * LC);                  // [2][SPAN]
  int* s_pl = (int*)(s_strip + 2 * SPAN);                    // [2][6][WIN]
  int* s_way = s_pl + 2 * NP * WIN;                          // [2][TMAX+4]
  int* s_seq = s_way + 2 * (TMAX + 4);             // [2][TMAX + 16] bytes
  int2* s_tab = (int2*)(s_seq + 2 * (TMAX / 4 + 4));         // [TMAX]

  // ---- phase 0: the flags, then the cost planes of the row
  for (int i = tid; i < nwarps * TMAX; i += nthr) hand[i] = ~0ull;
  if (tid < nwarps) s_prog[tid] = -1;
  for (int i = tid; i < 2 * SPAN; i += nthr) s_strip[i] = make_int2(-1, 0);
  row_planes(counts, row, pl, C, cps, s_wt, &s_total, cluster);
  // g[v] of the row (the generic path's rules and the final band)
  auto gval = [&](int v) -> int {
    return g1p[min(max(v, 0), cps - 4) + 3];
  };

  // the slots this warp reads its lower neighbours' prefix from, and the
  // slots it publishes its own into (in the next CTA at the border)
  const unsigned hand_a = saddr(hand);
  const unsigned hin = hand_a + (unsigned)(warp * TMAX) * 8u;
  const bool has_in = rank > 0 || warp > 0;
  const bool top_warp = warp + 1 == nwarps;
  const bool out_local = !top_warp;
  const bool publisher = lane_id == 31 && (!top_warp || rank + 1 < cs);
  const unsigned hout =
      out_local ? hand_a + (unsigned)((warp + 1) * TMAX) * 8u
      : rank + 1 < cs ? map_rank(hand_a, (unsigned)(rank + 1)) : 0u;
  // the first warp of CTAs past the first pushes its band into the strip
  // of the CTA below
  const bool pusher = rank > 0 && warp == 0;
  const unsigned push_band =
      pusher ? map_rank(saddr(s_strip + lb), (unsigned)(rank - 1)) : 0u;
  // where a warp waits for the band of x-1 above it: the next warp's
  // count; the CTA's top warp reads the strip's lanes until they carry
  // x-1
  const int up_kind = !top_warp ? 1 : rank + 1 < cs ? 2 : 0;
  const int* prog_up = &s_prog[min(warp + 1, nwarps - 1)];
  const int wfirst = rank * LC + warp * SPAN;  // the warp's first lane

  // the band start a row carries past its end
  const int a_f = len >= 1 ? max(0, way[min(len, L) - 1] - bh) : 0;
  // rr: this thread's lanes of the band of x-1 (frozen past the row's
  // end); first the band before x = 0, which a row of length 0 keeps:
  // M = 0 at columns 0..W-1 (reduced)
  int rr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) rr[k] = wsub(0, gval(base + k + 1));
  int frzm1 = wsub(0, gval(base));       // lane base-1 of the frozen band
  int pin_prev = frzm1;                  // lane base-1 of x-1
  const bool seq_words = (L & 3) == 0;   // rows of bases 4-byte aligned

  // stage a chunk starting at x1 (band start a1) into buffer nb: its
  // ways (positions x1-1 .. x1+TMAX), its bases (from x1 & ~3) and this
  // CTA's cost window from column cw
  auto stage = [&](int nb, int x1, int a1) {
    int* sw = s_way + nb * (TMAX + 4);
    for (int j = tid; j < TMAX + 2; j += nthr) {
      const int x = x1 - 1 + j;
      if (x >= 0 && x < L) cp_async4(sw + j, way + x);
    }
    int cw = ((a1 + rank * LC - 1) >> 2) << 2;
    cw = min(cw, cps - 4 - WIN);         // only ways past the array
    int* sp = s_pl + nb * NP * WIN;
    for (int q = tid; q < NP * (WIN / 4); q += nthr) {
      const int p = q / (WIN / 4), c4 = q - p * (WIN / 4);
      cp_async16(sp + p * WIN + 4 * c4,
                 pl + (size_t)p * cps + cw + 4 + 4 * c4);
    }
    uint8_t* sb = (uint8_t*)(s_seq + nb * (TMAX / 4 + 4));
    const int xs = x1 & ~3;
    if (seq_words) {
      for (int q = tid; q < TMAX / 4 + 2; q += nthr)
        if (xs + 4 * q < L) cp_async4(sb + 4 * q, seq + xs + 4 * q);
    } else {
      for (int j = tid; j < TMAX + 8; j += nthr)
        if (xs + j < L) sb[j] = (uint8_t)seq[xs + j];
    }
    cp_async_commit();
    return cw;
  };

  // ---- phase 1: the fill, chunk by chunk
  unsigned word[K];
#pragma unroll
  for (int k = 0; k < K; ++k) word[k] = 0u;
  int cw_cur = stage(0, 0, max(0, way[0] - bh));
  int x0 = 0;
  int cbuf = 0;
#pragma unroll 1
  while (x0 < L) {
    cp_async_wait_all();
    // the chunk's staging has landed in every CTA, and every warp of the
    // cluster has finished the previous chunk
    cluster.sync();
    const int* sw = s_way + cbuf * (TMAX + 4);   // ways of x0-1+j
    const uint8_t* sb = (const uint8_t*)(s_seq + cbuf * (TMAX / 4 + 4))
                        - (x0 & ~3);             // bases of x
    const int* sp = s_pl + cbuf * NP * WIN;
    const int a0 = max(0, sw[1] - bh);
    // the chunk's end: the first position the pipeline cannot take
    int x1 = min(L, x0 + TMAX);
    for (int xb = x0 + 1; xb < x1; xb += 32) {
      const int x = xb + lane_id;
      bool irregular = false;
      if (x < x1) {
        const int ax = max(0, sw[x - x0 + 1] - bh);
        const int am = max(0, sw[x - x0] - bh);
        const int ap = len == 0 ? 0 : x <= len ? am : a_f;
        const int d = ax - ap;
        const int gta = x % PLAIN_CHUNK == 0 ? ap : am;
        irregular = d < 0 || d > SPAN || (d >= 1 && gta != ap)
                    || ax - a0 < 0 || ax - a0 > SLACK;
      }
      const unsigned m = __ballot_sync(FULL, irregular);
      if (m) {
        x1 = xb + __ffs(m) - 1;
        break;
      }
    }
    // this CTA's window index of lane 0 at the chunk's first band
    const int off0 = a0 + rank * LC - cw_cur;
    // the chunk's step table: window index of this CTA's lane 0 at x,
    // and the shift and base of x
    for (int tt = tid; tt < x1 - x0; tt += nthr) {
      const int x = x0 + tt;
      const int ax = max(0, sw[tt + 1] - bh);
      const int am = x > 0 ? max(0, sw[tt] - bh) : 0;
      const int ap = len == 0 || x == 0 ? 0 : x <= len ? am : a_f;
      s_tab[tt] = make_int2(ax - a0 + off0, ((ax - ap) << 2) | (sb[x] & 3));
    }
    int cw_next = 0;
    if (x1 < L)
      cw_next = stage(cbuf ^ 1, x1, max(0, sw[x1 - x0 + 1] - bh));
    __syncthreads();                     // the step table is complete

#pragma unroll 1
    for (int x = x0; x < x1; ++x) {
      const int tt = x - x0;
      const int2 e = s_tab[tt];
      const int o = e.x;                 // window index of lane rank*LC
      const int d = e.y >> 2;
      const int s = e.y & 3;
      const int ax = o - off0 + a0;      // anf(x)
      const bool active = x < len;
      const bool is_last = x == len - 1;
      if (x == len && x > 0) frzm1 = pin_prev;   // the band freezes
      // this lane's window column and costs
      const int* pls = sp + s * WIN + o + lb - 1;
      const int* pli = sp + 4 * WIN + o + lb - 1;
      const int* plg = sp + 5 * WIN + o + lb - 1;
      const int* prev = s_band + ((x - 1) & 1) * LC;   // the band of x-1
      int* cur = s_band + (x & 1) * LC;
      const int y0 = ax + base;              // column of lane base
      const bool gen = x == 0 || is_last || ax + wfirst <= 0
                       || ax + wfirst + SPAN - 1 >= ncols - 1;
      unsigned long long hv = has_in ? ld_slot(hin + (unsigned)tt * 8u) : 0ull;

      int dg[K], up[K];                  // the sources of x-1, reduced
      int c0r = 0;                       // lane 0: BIG below it, reduced
      if (base == 0) c0r = wsub(BIG, plg[0]);
      if (x == 0) {
        // MatrixOut(-1, .) = 0
#pragma unroll
        for (int k = 0; k < K; ++k) {
          up[k] = wsub(0, plg[k + 1]);
          dg[k] = wsub(0, plg[k]);
        }
      } else if (x != x0) {
        // inside a chunk: 0 <= d <= SPAN, sources clamped to W-1
        int v[K + 1];
        if (d == 0) {
          // this thread's lanes of x-1 and the lane below
          const int below = __shfl_up_sync(FULL, rr[K - 1], 1);
          v[0] = base == 0 ? c0r : lane_id == 0 ? pin_prev : below;
#pragma unroll
          for (int k = 0; k < K; ++k) v[k + 1] = rr[k];
        } else {
          // lanes base+d-1 .. base+d+K-1 of x-1, in this warp, the warp
          // above (once its count says x-1) or the next CTA's strip
          if (up_kind != 2) {
            if (up_kind == 1)
              while (ld_acq_cta(prog_up) < x - 1) {
              }
#pragma unroll
            for (int j = 0; j <= K; ++j)
              v[j] = prev[min(base + d - 1 + j, w - 1) - rank * LC];
          } else {
#pragma unroll
            for (int j = 0; j <= K; ++j) {
              const int l = min(base + d - 1 + j, w - 1) - rank * LC;
              if (l >= LC) {
                const int2* e = s_strip + ((x - 1) & 1) * SPAN + (l - LC);
                int2 t2 = ld_strip(e);
                while (t2.x != x - 1) t2 = ld_strip(e);
                v[j] = t2.y;
              } else {
                v[j] = prev[l];
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dg[k] = v[k];
          up[k] = v[k + 1];
        }
      } else {
        // a chunk's first step, after the cluster barrier: any shift;
        // the plain version's rules in full
        const int am = max(0, sw[0] - bh);
        const int ap = len == 0 ? 0 : x <= len ? am : a_f;
        const int gta = x % PLAIN_CHUNK == 0 ? ap : am;
        const int adj = d >= 1 && gta != ap
                            ? wsub(gval(ap + w), gval(gta + w)) : 0;
        auto rd = [&](int j) -> int {    // the band of x-1 at lane j
          if (j == base - 1 && lane_id == 0) return pin_prev;
          const int r = min(j / LC, cs - 1);
          return cluster.map_shared_rank(s_band, r)[((x - 1) & 1) * LC + j
                                                    - r * LC];
        };
        const int top = wadd(rd(w - 1), adj);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = base + k;
          const int ju = i + d, jd = i + d - 1;
          const int gy1 = plg[k + 1], gy0 = plg[k];
          int u, g_;
          if (ju >= w) u = top;
          else if (ju >= 0)
            u = d >= 0 ? rd(ju)
                       : wsub(wadd(rd(i), gval(ap + i + 1)), gy1);
          else u = wsub(BIG, gy1);
          if (jd >= w) g_ = top;
          else if (jd >= 0)
            g_ = d >= 0 ? rd(jd) : wsub(wadd(rd(i - 1), gval(ap + i)), gy0);
          else g_ = wsub(BIG, gy0);
          up[k] = u;
          dg[k] = g_;
        }
      }

      // the candidates and the thread-local running min
      int dr[K], loc[K];
      int run = NEUTRAL;
      if (!gen) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dr[k] = wadd(dg[k], pls[k + 1]);
          run = min(run, min(dr[k], wadd(up[k], pli[k + 1])));
          loc[k] = run;
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int y = y0 + k;
          dr[k] = wadd(dg[k], pls[k + 1]);
          const int bigr = wsub(BIG, plg[k + 1]);
          const bool ok = y > 0 && y < ncols - 1;
          int av = min(dr[k], ok ? wadd(up[k], pli[k + 1]) : bigr);
          if (!(y < ncols)) av = bigr;
          run = min(run, av);
          loc[k] = run;
        }
      }
      // warp-inclusive min-scan of the threads' totals (a lane whose
      // source does not exist gets its own value back)
      int xs = run;
#pragma unroll
      for (int o2 = 1; o2 < 32; o2 <<= 1)
        xs = min(xs, __shfl_up_sync(FULL, xs, o2));
      // the prefix over every lane below this warp, for this x
      int pin = NEUTRAL;
      if (has_in) {
        while ((unsigned)(hv >> 32) != (unsigned)x)
          hv = ld_slot(hin + (unsigned)tt * 8u);
        pin = (int)(unsigned)hv;
      }
      if (publisher) {
        const unsigned long long hw =
            ((unsigned long long)(unsigned)x << 32) | (unsigned)min(pin, xs);
        if (out_local)
          st_slot_cta(hout + (unsigned)tt * 8u, hw);
        else
          st_slot(hout + (unsigned)tt * 8u, hw);
      }
      const int ex = __shfl_up_sync(FULL, xs, 1);
      const int pre = lane_id == 0 ? pin : min(pin, ex);

      // the new reduced band and the codes. Gap: M[i] == M[i-1] + gap,
      // on reduced values r[i] == r[i-1]; diagonal: r[i] == diag - g.
      // Past the row's end the band stays frozen
      int left = base == 0 ? c0r : pre;
      if (gen && is_last) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int rn = min(pre, loc[k]);
          // the flat rule: M[i] == M[i-1]
          const bool gap_hit =
              rn == left
              || wadd(rn, wsub(plg[k + 1], plg[k])) == left;
          const unsigned code = gap_hit ? 0u : rn == dr[k] ? 1u : 2u;
          word[k] = __funnelshift_r(word[k], code, 2);
          left = rn;
          rr[k] = active ? rn : rr[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int rn = min(pre, loc[k]);
          const unsigned code = rn == left ? 0u : rn == dr[k] ? 1u : 2u;
          word[k] = __funnelshift_r(word[k], code, 2);
          left = rn;
          rr[k] = active ? rn : rr[k];
        }
      }
#pragma unroll
      for (int q = 0; q < K / 4; ++q)
        *(int4*)(cur + lb + 4 * q) = make_int4(rr[4 * q], rr[4 * q + 1],
                                               rr[4 * q + 2], rr[4 * q + 3]);
      if (pusher) {
        const unsigned at = push_band + (unsigned)((x & 1) * SPAN) * 8u;
#pragma unroll
        for (int k = 0; k < K; k += 2)
          st_strip_remote(at + 8u * k, x, rr[k], rr[k + 1]);
      }
      __syncwarp();
      if (lane_id == 0) st_rel_cta(&s_prog[warp], x);
      pin_prev = active ? pin : frzm1;
      if ((x & 15) == 15 || x == L - 1) {
        const int sh = 2 * (15 - (x & 15));   // a partial last word: pad 0
        unsigned* out = codes + ((size_t)(x >> 4) * B + b) * w;
        if ((w & 3) == 0 && base + K <= w) {
#pragma unroll
          for (int q = 0; q < K / 4; ++q)
            *(uint4*)(out + base + 4 * q) = make_uint4(
                word[4 * q] >> sh, word[4 * q + 1] >> sh,
                word[4 * q + 2] >> sh, word[4 * q + 3] >> sh);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (base + k < w) out[base + k] = word[k] >> sh;
        }
      }
    }
    cw_cur = cw_next;
    cbuf ^= 1;
    x0 = x1;
  }
  // the final band (frozen past the row's end)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = base + k;
    if (i < w)
      band_out[(size_t)b * w + i] = wadd(rr[k], gval(a_f + i + 1));
  }
  if (rank == 0 && tid == 0) anf_out[b] = a_f;
  // a CTA's shared memory must outlive its neighbours' reads
  cluster.sync();
}

// ---- the wide layout: bands past the clustered layout's 16,384 lanes
//
// Sized by device memory alone. A row is a cluster of WCS CTAs of
// MAX_THREADS threads; a CTA holds `groups` groups of WG lanes, four
// lanes a thread, neighbouring threads on neighbouring lanes, so the
// band's lanes run CTA by CTA, group by group, thread by thread. The
// reduced band of x-1 and of x lives in a [B, 2, W] scratch in device
// memory, read and written through L2 (other SMs of the cluster wrote
// it), so no band is too wide for shared memory. Every step takes the
// plain version's rules in full, as the clustered layout's chunk-first
// step does (any shift, the jump rule's base, the edges' masks, the flat
// rule), in two passes over the thread's groups: the first takes each
// warp's min of its candidates into a table (groups x warps), which one
// warp scans into exclusive prefixes and the CTA's min; after a cluster
// barrier each thread adds the CTAs below (distributed shared memory),
// and the second pass recomputes the candidates, writes the band of x
// and ORs each lane's code into its word in place. A second cluster
// barrier makes the band of x visible to the next step. Slow beside the
// clustered layout (two cluster barriers and device-memory reads a
// step), and only for bands that layout cannot hold.
constexpr int WCS = 8;                 // CTAs a row
constexpr int WG = MAX_THREADS * 4;    // lanes a group

__global__ void __launch_bounds__(MAX_THREADS) exact_fill_wide_kernel(
    const int* __restrict__ counts,      // [C, 6]
    const int8_t* __restrict__ rows,     // [B, C]
    const int8_t* __restrict__ seqs,     // [B, L]
    const int* __restrict__ ways,        // [B, L]
    const int* __restrict__ lengths,     // [B]
    int* __restrict__ planes,            // [B, 6, cps] scratch
    int* __restrict__ wband,             // [B, 2, W] scratch
    unsigned* __restrict__ codes,        // [ceil(L/16), B, W]
    int* __restrict__ band_out,          // [B, W]
    int* __restrict__ anf_out,           // [B]
    int B, int C, int L, int ncols, int w, int cps, int groups) {
  extern __shared__ int s_tab[];         // [groups][warps]
  __shared__ int s_wt[MAX_THREADS / 32];
  __shared__ int s_total;
  __shared__ int s_cta;                  // this CTA's min at x

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = MAX_THREADS / 32;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / WCS;
  const int lanes_cta = groups * WG;
  const int bh = w / 2;
  const int len = lengths[b];
  const int8_t* seq = seqs + (size_t)b * L;
  const int* way = ways + (size_t)b * L;
  int* pl = planes + (size_t)b * NP * cps;
  const int* g1p = pl + 5 * (size_t)cps;
  int* bnd = wband + (size_t)b * 2 * w;
  row_planes(counts, rows + (size_t)b * C, pl, C, cps, s_wt, &s_total,
             cluster);
  // the planes and the band are read through L2: other CTAs wrote them
  auto gval = [&](int v) -> int {
    return __ldcg(g1p + min(max(v, 0), cps - 4) + 3);
  };
  auto plane = [&](int p, int y) -> int {
    return __ldcg(pl + (size_t)p * cps + y + 4);
  };
  const int a_f = len >= 1 ? max(0, way[min(len, L) - 1] - bh) : 0;
  // the band before x = 0 (slot 1), which a row of length 0 keeps: M = 0
  // at columns 0..W-1, reduced
  for (int g = 0; g < groups; ++g)
    for (int k = 0; k < 4; ++k) {
      const int i = rank * lanes_cta + g * WG + 4 * tid + k;
      if (i < w) __stcg(bnd + w + i, wsub(0, gval(i + 1)));
    }

#pragma unroll 1
  for (int x = 0; x < L; ++x) {
    const int ax = max(0, way[x] - bh);
    const int s = seq[x] & 3;
    const bool active = x < len;
    const bool is_last = x == len - 1;
    const int* prev = bnd + ((x - 1) & 1) * w;   // the band of x-1
    int* cur = bnd + (x & 1) * w;
    int d = 0, ap = 0, top = 0;
    if (x > 0) {
      const int am = max(0, way[x - 1] - bh);
      ap = len == 0 ? 0 : x <= len ? am : a_f;
      d = ax - ap;
      const int gta = x % PLAIN_CHUNK == 0 ? ap : am;
      const int adj = d >= 1 && gta != ap
                          ? wsub(gval(ap + w), gval(gta + w)) : 0;
      top = wadd(__ldcg(prev + w - 1), adj);
    }
    // lane i's candidate (reduced) and its diagonal
    auto cand = [&](int i, int& dr) -> int {
      const int y = ax + i;
      const int gy0 = gval(y), gy1 = gval(y + 1);
      int u, dg;
      if (x == 0) {
        // MatrixOut(-1, .) = 0
        u = wsub(0, gy1);
        dg = wsub(0, gy0);
      } else {
        const int ju = i + d, jd = i + d - 1;
        if (ju >= w) u = top;
        else if (ju >= 0)
          u = d >= 0 ? __ldcg(prev + ju)
                     : wsub(wadd(__ldcg(prev + i), gval(ap + i + 1)), gy1);
        else u = wsub(BIG, gy1);
        if (jd >= w) dg = top;
        else if (jd >= 0)
          dg = d >= 0 ? __ldcg(prev + jd)
                      : wsub(wadd(__ldcg(prev + i - 1), gval(ap + i)), gy0);
        else dg = wsub(BIG, gy0);
      }
      dr = wadd(dg, plane(s, y));
      const int bigr = wsub(BIG, gy1);
      const bool ok = y > 0 && y < ncols - 1;
      const int av = min(dr, ok ? wadd(u, plane(4, y)) : bigr);
      return y < ncols ? av : bigr;
    };

    // pass 1: each warp's min of its group's candidates
    for (int g = 0; g < groups; ++g) {
      const int i0 = rank * lanes_cta + g * WG + 4 * tid;
      int run = NEUTRAL;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int dr;
        if (i0 + k < w) run = min(run, cand(i0 + k, dr));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        run = min(run, __shfl_xor_sync(FULL, run, o));
      if (lane_id == 0) s_tab[g * nwarps + warp] = run;
    }
    __syncthreads();
    // the table's exclusive prefixes in lane order, in place, and the
    // CTA's min
    if (warp == 0) {
      int carry = NEUTRAL;
      for (int e0 = 0; e0 < groups * nwarps; e0 += 32) {
        const int e = e0 + lane_id;
        const bool in = e < groups * nwarps;
        int xs = in ? s_tab[e] : NEUTRAL;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(FULL, xs, o);
          if (lane_id >= o) xs = min(xs, u);
        }
        const int ex = __shfl_up_sync(FULL, xs, 1);
        if (in) s_tab[e] = lane_id == 0 ? carry : min(carry, ex);
        carry = min(carry, __shfl_sync(FULL, xs, 31));
      }
      if (lane_id == 0) s_cta = carry;
    }
    cluster.sync();                      // every CTA's min at x
    int pre_c = NEUTRAL;                 // the lanes of the CTAs below
    for (int r = 0; r < rank; ++r)
      pre_c = min(pre_c, *cluster.map_shared_rank(&s_cta, r));

    // pass 2: the band of x and the codes
    unsigned* word = codes + ((size_t)(x >> 4) * B + b) * w;
    const int sh = 2 * (x & 15);
    for (int g = 0; g < groups; ++g) {
      const int i0 = rank * lanes_cta + g * WG + 4 * tid;
      int dr[4], loc[4];
      int run = NEUTRAL;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dr[k] = 0;
        if (i0 + k < w) run = min(run, cand(i0 + k, dr[k]));
        loc[k] = run;
      }
      int xs = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, xs, o);
        if (lane_id >= o) xs = min(xs, u);
      }
      const int ex = __shfl_up_sync(FULL, xs, 1);
      int pre = min(pre_c, s_tab[g * nwarps + warp]);
      if (lane_id > 0) pre = min(pre, ex);
      // lane 0: BIG below it, reduced
      int left = i0 == 0 ? wsub(BIG, gval(ax)) : pre;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k;
        if (i < w) {
          const int rn = min(pre, loc[k]);
          // gap: M[i] == M[i-1] + gap; at the last position also the
          // flat rule M[i] == M[i-1]
          bool gap_hit = rn == left;
          if (is_last)
            gap_hit = gap_hit
                      || wadd(rn, wsub(gval(ax + i + 1), gval(ax + i)))
                             == left;
          const unsigned code = gap_hit ? 0u : rn == dr[k] ? 1u : 2u;
          left = rn;
          __stcg(cur + i, active ? rn : __ldcg(prev + i));
          word[i] = sh == 0 ? code : word[i] | (code << sh);
        }
      }
    }
    cluster.sync();                      // the band of x is complete
  }
  // the final band (frozen past the row's end)
  const int* fin = bnd + ((L - 1) & 1) * w;
  for (int g = 0; g < groups; ++g)
    for (int k = 0; k < 4; ++k) {
      const int i = rank * lanes_cta + g * WG + 4 * tid + k;
      if (i < w)
        band_out[(size_t)b * w + i] = wadd(__ldcg(fin + i),
                                           gval(a_f + i + 1));
    }
  if (rank == 0 && tid == 0) anf_out[b] = a_f;
}

}  // namespace

// Shared memory of a launch: the caller gives threads a CTA and CTAs a
// row as ops/cuda_exact.py::fill_geometry computes them.
static size_t fill_smem(int threads) {
  const int nwarps = threads / 32;
  const int lc = threads * K;
  const int win = lc + SLACK + 4;
  return (size_t)nwarps * TMAX * 8 + (size_t)2 * lc * 4
         + (size_t)2 * SPAN * 8
         + (size_t)2 * NP * win * 4 + (size_t)2 * (TMAX + 4) * 4
         + (size_t)2 * (TMAX / 4 + 4) * 4 + (size_t)TMAX * 8;
}

static cudaError_t launch_cluster(const void* kern, int grid, int threads,
                                  size_t smem, int cs, void* stream,
                                  void** args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, kern, args);
}

// groups 0: the clustered layout (cs and threads as fill_geometry gives
// them); groups > 0: the wide layout, WCS CTAs of MAX_THREADS threads a
// row, each `groups` groups of WG lanes, with the [B, 2, W] scratch wband
extern "C" int exact_fill_launch(
    const void* counts, const void* rows, const void* seqs, const void* ways,
    const void* lengths, void* planes, void* codes, void* band_out,
    void* anf_out, int B, int C, int L, int ncols, int w, int cs,
    int threads, int cps, void* wband, int groups, void* stream) {
  if (B <= 0) return 0;
  if (L <= 0 || C <= 0 || w <= 0 || cps % 4 || groups < 0)
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&counts, (void*)&rows, (void*)&seqs, (void*)&ways,
                  (void*)&lengths, (void*)&planes, (void*)&codes,
                  (void*)&band_out, (void*)&anf_out, (void*)&B, (void*)&C,
                  (void*)&L, (void*)&ncols, (void*)&w, (void*)&cps,
                  (void*)&groups};
  cudaError_t err;
  if (groups > 0) {
    const long long lc = (long long)groups * WG;
    if (cs != WCS || threads != MAX_THREADS || WCS * lc < w
        || (long long)cps < C + WCS * lc + SLACK + 16 || wband == nullptr)
      return (int)cudaErrorInvalidValue;
    void* wargs[] = {args[0], args[1], args[2], args[3], args[4], args[5],
                     (void*)&wband, args[6], args[7], args[8], args[9],
                     args[10], args[11], args[12], args[13], args[14],
                     args[15]};
    err = launch_cluster((const void*)exact_fill_wide_kernel, B * WCS,
                         MAX_THREADS, (size_t)groups * (MAX_THREADS / 32) * 4,
                         WCS, stream, wargs);
  } else {
    if (threads <= 0 || threads % 32 || threads > MAX_THREADS
        || !(cs == 1 || cs == 2 || cs == 4 || cs == 8)
        || cs * threads * K < w || (cs - 1) * threads * K >= w
        || cps < C + cs * threads * K + SLACK + 16)
      return (int)cudaErrorInvalidValue;
    // up to 256 threads a CTA a thread may hold 255 registers
    const void* kern = threads <= 256 ? (const void*)exact_fill_kernel<256>
                                      : (const void*)exact_fill_kernel<512>;
    err = launch_cluster(kern, B * cs, threads, fill_smem(threads), cs,
                         stream, args);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* exact_fill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
