// Kernel A: the staircase-band realignment DP fill for a block of rows.
//
// Replaces repeatresolver_tpu/ops/pallas_realign.py::_kernel (launched by
// staircase_fill_pallas at pallas_realign.py:358) together with the XLA
// precompute that fed it (_fields, :62-141): this kernel reads the column
// counts and the block's rows directly and computes its own cost windows.
// Its plain version is repeatresolver_tpu_torch/ops/staircase_realign.py::
// staircase_fill; both emit the same bits as the Pallas kernel with
// time_major=True, packed=True.
//
// What bounds it on an H100: integer operations. Every band cell costs a
// dozen dependent-free int32 operations, an SM runs them on 64 lanes a
// cycle, and a block has only 64 rows (the block size is a trajectory
// parameter, not a tuning knob), each a serial chain of up to ~33k
// positions x through a W2-lane prefix-min (W2 <= 4,096, production
// 1,128-3,048). Memory is far from the bound: the codes leave 2-bit
// packed, W2/4 bytes per step and row, and the window costs are loaded
// once per chunk of T steps.
//
// Design:
//   * A row is a pipeline of warps skewed in x. Each thread holds four
//     contiguous band lanes in registers; a step is a thread-local
//     min-scan, a warp shuffle scan and ONE read of the running prefix
//     that the warp below published for the same x, through a ring of
//     64-bit {value, x} slots in shared memory. There is no block-wide
//     barrier inside a chunk: warp k works on step x while warp k-1 is
//     already on x+1. The slot is one 8-byte word, so value and tag
//     arrive together; a tag is the position x itself and never repeats.
//   * A row is split over a cluster of two CTAs, so that a block of 64
//     rows occupies 128 of the 132 SMs: the pipeline runs on across the
//     CTA border, the upper CTA's first warp reading a slot that the
//     lower CTA's last warp writes through distributed shared memory.
//     The cluster meets only at chunk boundaries, where the band shifts:
//     one barrier per chunk of T steps. Four lanes a thread in two CTAs
//     of up to 512 threads hold W2 <= 4,096. (Measured on an H100 at
//     W2 1,128-3,048, PERF.md: one CTA a row and two or eight lanes a
//     thread were slower and are not built.)
//   * The band is kept "reduced": r[j] = M[j] - g[y(j)+1], the value the
//     prefix-min runs over, with the chunk-constant g folded into the
//     cost registers (sub' = sub + g[y], ins' = ins + g[y+1]). All sums
//     wrap modulo 2^32, so every equality test of the plain version
//     (gap: M[j] == M[j-1] + gap; diagonal: M[j] == diag) is the same
//     test on reduced values, and M itself is never materialised:
//     about a dozen operations a cell instead of three dozen.
//   * The four substitution-cost planes live in shared memory and the
//     step's plane is one vector load, chosen by the row's symbol.
//   * What is uniform is decided once per warp and step: a warp whose
//     lanes all lie inside the reference band [lo, lo+W) runs a body
//     with no masks, one that lies outside a body that skips the insert
//     candidate, an edge warp a body with one per-thread bit mask. The
//     first and last position of a row, and chunks that touch the MSA's
//     edges, take a generic body with every test of the plain version.
//   * Positions past a row's length still emit codes from the frozen
//     band, as the plain version does: the band registers are saved once
//     and restored before each such step.
//   * Codes shift into one register word per lane (a funnel shift per
//     step) and are stored once per 16 steps, 16 bytes a thread where
//     the row is aligned, in the time-major layout [Lpad/16, B, W2].
//
// Every DP sum wraps modulo 2^32 (wadd/wsub), as XLA's int32 arithmetic
// does: `BIG + cost` ties decide codes, and signed overflow would be
// undefined behaviour in C++.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wrap_int.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BIG = 1 << 30;
constexpr int LPT = 4;                 // band lanes per thread
constexpr int CS = 2;                  // CTAs per row: one cluster
constexpr int MAX_THREADS = 512;       // so a row holds W2 <= 4,096 lanes
constexpr int LPT0 = 8;                // columns per thread in the g prefix
constexpr unsigned FULL = 0xffffffffu;

// where a warp lies relative to the reference band at a step; MODE_GEN
// is the body with every test of the plain version
enum { MODE_IN = 0, MODE_EDGE = 1, MODE_OUT = 2, MODE_GEN = 3 };

// ns(y): non-space symbols in column y with this row's own cell removed
__device__ __forceinline__ int ns_at(const int* counts, const int8_t* row,
                                     int y) {
  const int* cy = counts + 6 * (size_t)y;
  return cy[0] + cy[1] + cy[2] + cy[3] + cy[4] - (row[y] < 5 ? 1 : 0);
}

// the hand-off slots: one 8-byte {x, value} word, read and written whole
__device__ __forceinline__ unsigned long long ld_slot(unsigned addr) {
  unsigned long long v;
  asm volatile("ld.volatile.shared.u64 %0, [%1];" : "=l"(v) : "r"(addr));
  return v;
}
// (the address may lie in the other CTA of the cluster)
__device__ __forceinline__ void st_slot(unsigned addr, unsigned long long v) {
  asm volatile("st.volatile.shared::cluster.u64 [%0], %1;" ::"r"(addr),
               "l"(v)
               : "memory");
}
// the address of this CTA's shared-memory location `addr` in CTA `rank`
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr),
      "r"(rank));
  return r;
}

__global__ void __launch_bounds__(MAX_THREADS) staircase_fill_kernel(
        const int* __restrict__ counts,      // [C, 6]
        const int8_t* __restrict__ rows,     // [B, C]
        const int8_t* __restrict__ seqs,     // [B, L]
        const int* __restrict__ ways,        // [B, L]
        const int* __restrict__ lengths,     // [B]
        int* __restrict__ gbuf,              // [B*CS, C+1] scratch: g
        unsigned* __restrict__ codes,        // [Lpad/16, B, W2]
        int* __restrict__ band_out,          // [B, W2]
        int B, int C, int L, int ncols, int w, int t, int w2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_wt[32];               // per-warp totals of the g prefix

  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int LC = blockDim.x * LPT;       // band lanes of this CTA
  const int rank = (int)(blockIdx.x % CS);
  const int b = blockIdx.x / CS;
  const int base = (rank * (int)blockDim.x + tid) * LPT;   // first lane
  const int lbase = tid * LPT;                             // within the CTA
  const bool gfirst = base == 0;         // holds the window's lane 0
  const int wb = (rank * (int)blockDim.x + warp * 32) * LPT;
  constexpr int SPAN = 32 * LPT;         // band lanes of a warp

  // dynamic shared memory: hand-off ring, cost planes, band exchange,
  // per-warp step table
  unsigned long long* hand = (unsigned long long*)smem_raw;   // [nwarps][t]
  int* s_scp = (int*)(hand + (size_t)nwarps * t);             // [4][LC]
  int* s_band = s_scp + 4 * LC;                               // [2][LC]
  int* s_tab = s_band + 2 * LC;                               // [nwarps][t]

  const int8_t* row = rows + (size_t)b * C;
  int* g = gbuf + (size_t)blockIdx.x * (C + 1);
  const int8_t* seq = seqs + (size_t)b * L;
  const int* way = ways + (size_t)b * L;
  const int len = lengths[b];
  const int bh = w / 2;

  for (int i = tid; i < nwarps * t; i += blockDim.x) hand[i] = ~0ull;

  // ---- phase 0: gap-cost prefix g[y] = sum of gapcost over columns < y,
  // gapcost = bases in the column minus this row's own base (each CTA of
  // a cluster keeps its own copy)
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
        v[k] = cy[0] + cy[1] + cy[2] + cy[3] - (row[y] < 4 ? 1 : 0);
      }
      sum = wadd(sum, v[k]);
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
      const int y = c0 + tid * LPT0 + k;
      pre = wadd(pre, v[k]);
      if (y < C) g[y + 1] = pre;
    }
    carry = tot;
    __syncthreads();
  }
  // g and the ring tags are visible, and both CTAs of the cluster have
  // started before any remote access
  cg::this_cluster().sync();

  // the slots this warp reads its lower neighbours' prefix from, and the
  // slots it publishes its own into (in the next CTA at the border)
  const unsigned hand_a = (unsigned)__cvta_generic_to_shared(hand);
  const unsigned hin = hand_a + (unsigned)(warp * t) * 8u;
  const bool has_in = rank > 0 || warp > 0;
  bool has_out = true;
  unsigned hout;
  if (warp + 1 < nwarps) {
    hout = map_rank(hand_a + (unsigned)((warp + 1) * t) * 8u,
                    (unsigned)rank);
  } else if (rank + 1 < CS) {
    hout = map_rank(hand_a, (unsigned)(rank + 1));
  } else {
    hout = hand_a;
    has_out = false;
  }
  const bool publisher = has_out && lane_id == 31;
  const int* rband[CS];                  // each CTA's s_band
  for (int r = 0; r < CS; ++r)
    rband[r] = cg::this_cluster().map_shared_rank(s_band, r);
  int* tab = s_tab + warp * t;

  // ---- phase 1: the fill, chunk by chunk
  int rr[LPT], frz[LPT], inswp[LPT], ngy1[LPT];
  unsigned word[LPT];
  unsigned okv = 0, oki = 0;             // per-lane valid / insertable
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    word[k] = 0u;
    frz[k] = 0;
  }
  int rrm1 = 0, frzm1 = 0;               // reduced band at lane base-1
  int gy1m1 = 0;                         // g[a + base]
  int c0r = 0;                           // lane 0: BIG, reduced
  int a_prev = 0;
  const int nc = (L + t - 1) / t;
  for (int ci = 0; ci < nc; ++ci) {
    const int x0 = ci * t;
    const int a = max(0, way[min(x0, L - 1)] - bh);
    int* sb = s_band + (ci & 1) * LC;
    if (ci > 0) {
      if (x0 - 1 >= len) {               // the band is the frozen one
#pragma unroll
        for (int k = 0; k < LPT; ++k) rr[k] = frz[k];
      }
#pragma unroll
      for (int k = 0; k < LPT; ++k) sb[lbase + k] = wsub(rr[k], ngy1[k]);
      // every warp has left the old chunk: the band may shift and the
      // step table may be rewritten
      cg::this_cluster().sync();
    }
    // the chunk's cost window: lane j reads column y = a + j; columns
    // past the array read zero costs and the final gap prefix
    okv = oki = 0u;
    gy1m1 = g[min(a + base, C)];
    {
      int gprev = gy1m1;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int y = a + base + k;
        int insw = 0, sc[4] = {0, 0, 0, 0};
        if (y < C) {
          const int* cy = counts + 6 * (size_t)y;
          const int own = row[y];
          const int ns = ns_at(counts, row, y);
          const int nsp = y > 0 ? ns_at(counts, row, y - 1) : ns;
          insw = max(ns, nsp);
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[i] = ns - cy[i] + (own == i);
        }
        const int gy1 = g[min(y + 1, C)];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s_scp[i * LC + lbase + k] = wadd(sc[i], gprev);
        inswp[k] = wadd(insw, gy1);
        ngy1[k] = wsub(0, gy1);
        gprev = gy1;
        if (y < ncols) okv |= 1u << k;
        if (y > 0 && y < ncols - 1) oki |= 1u << k;
      }
    }
    constexpr unsigned ALL = (1u << LPT) - 1u;
    const bool warp_ok = __all_sync(FULL, okv == ALL && oki == ALL);
    // the warp's step table: symbol, body and reference band start of
    // every position of the chunk
    for (int i = lane_id; i < t; i += 32) {
      const int x = x0 + i;
      const int s = x < L ? (int)seq[x] : 0;
      const int lo = max(0, way[min(x, L - 1)] - bh) - a;
      int mode;
      if (x == 0 || x == len - 1) mode = MODE_GEN;
      else if (wb + SPAN <= lo || wb >= lo + w) mode = MODE_OUT;
      else if (!warp_ok) mode = MODE_GEN;
      else if (lo <= wb && wb + SPAN <= lo + w) mode = MODE_IN;
      else mode = MODE_EDGE;
      tab[i] = (lo << 5) | (x >= len ? 16 : 0) | (mode << 2) | (s & 3);
    }
    c0r = wsub(BIG, gy1m1);
    if (ci > 0) {
      // shift the band left by d, fill lanes past the old top by the
      // jump rule, and carry old lane d-1 as lane 0's diagonal
      // predecessor (the exact band's read at the new window's bottom)
      const int d = min(max(a - a_prev, 0), w2 + 1);
      auto band_read = [&](int j) -> int {
        const int r = j / LC;
        const int* p = r == rank ? sb : rband[r] + (ci & 1) * LC;
        return p[j - r * LC];
      };
      const int lastcol = band_read(w2 - 1);
      const int gtop = g[min(a_prev + w2, C)];
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int j = base + k;
        const int bm = j + d >= w2
                           ? wadd(lastcol, wsub(wsub(0, ngy1[k]), gtop))
                           : band_read(j + d);
        rr[k] = wadd(bm, ngy1[k]);
      }
      int pm;
      if (gfirst) {
        pm = d == 0 ? BIG
             : d - 1 >= w2 ? wadd(lastcol, wsub(g[min(a, C)], gtop))
                           : band_read(d - 1);
      } else {
        const int j = base - 1;
        pm = j + d >= w2 ? wadd(lastcol, wsub(gy1m1, gtop))
                         : band_read(j + d);
      }
      rrm1 = wsub(pm, gy1m1);
    } else {
#pragma unroll
      for (int k = 0; k < LPT; ++k) rr[k] = ngy1[k];      // M = 0
      rrm1 = wsub(0, gy1m1);
    }
    if (!has_in) {
      // the row's first warp has nothing below it: it reads BIG
      for (int i = lane_id; i < t; i += 32)
        hand[warp * t + i] =
            ((unsigned long long)(unsigned)(x0 + i) << 32) | (unsigned)BIG;
    }
    __syncwarp();                        // the warp's table is complete

    // One step of the warp: candidates and thread-local min (by MODE),
    // warp scan, the lower warps' prefix, the new band and the codes.
    auto step = [&](auto mode_tag, int tt, int sl) {
      constexpr int MODE = decltype(mode_tag)::value;
      const int x = x0 + tt;
      // start reading the lower warps' prefix: it is needed after the scan
      unsigned long long hv = ld_slot(hin + (unsigned)tt * 8u);
      int sc[LPT], loc[LPT], dr[LPT];
      {
        const int* sp = s_scp + (sl & 3) * LC + lbase;
        static_assert(LPT % 4 == 0, "the planes are read 16 bytes at a time");
#pragma unroll
        for (int q = 0; q < LPT / 4; ++q) {
          const int4 v = *(const int4*)(sp + 4 * q);
          sc[4 * q] = v.x;
          sc[4 * q + 1] = v.y;
          sc[4 * q + 2] = v.z;
          sc[4 * q + 3] = v.w;
        }
      }
      const bool first = MODE == MODE_GEN && x == 0;
      const bool is_last = MODE == MODE_GEN && x == len - 1;
      int run = BIG;
      if constexpr (MODE == MODE_GEN) {
        const int lo = sl >> 5;
        int gprev = gy1m1;
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          const int j = base + k;
          const int rp = k == 0 ? rrm1 : rr[k - 1];
          const int dpm = first ? 0 : wadd(rp, gprev);
          const int upm = first ? 0 : wsub(rr[k], ngy1[k]);
          const int diag = wadd(dpm, wsub(sc[k], gprev));
          const int insw = wadd(inswp[k], ngy1[k]);
          int av = min(diag, ((oki >> k) & 1u) ? wadd(upm, insw) : BIG);
          if (!(((okv >> k) & 1u) && j >= lo && j < lo + w)) av = BIG;
          dr[k] = wadd(diag, ngy1[k]);
          run = min(run, wadd(av, ngy1[k]));
          loc[k] = run;
          gprev = wsub(0, ngy1[k]);
        }
      } else {
        unsigned inb = 0u;
        if constexpr (MODE == MODE_EDGE) {
          const int lo = sl >> 5;
          const int klo = min(max(lo - base, 0), LPT);
          const int khi = min(max(lo + w - base, 0), LPT);
          inb = ((1u << khi) - 1u) & ~((1u << klo) - 1u);
        }
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          const int diag = wadd(k == 0 ? rrm1 : rr[k - 1], sc[k]);
          dr[k] = wadd(diag, ngy1[k]);
          int av = BIG;
          if constexpr (MODE != MODE_OUT) {
            av = min(diag, wadd(rr[k], inswp[k]));
            if (MODE == MODE_EDGE && !((inb >> k) & 1u)) av = BIG;
          }
          run = min(wadd(av, ngy1[k]), run);
          loc[k] = run;
        }
      }
      // warp-inclusive min-scan of the threads' totals (a thread whose
      // source lane does not exist gets its own value back, which a min
      // absorbs)
      int xs = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1)
        xs = min(xs, __shfl_up_sync(FULL, xs, o));
      // the prefix over every lane below this warp, for this x
      while ((unsigned)(hv >> 32) != (unsigned)x)
        hv = ld_slot(hin + (unsigned)tt * 8u);
      const int pin = (int)(unsigned)hv;
      if (publisher)
        st_slot(hout + (unsigned)tt * 8u,
                    ((unsigned long long)(unsigned)x << 32)
                        | (unsigned)min(pin, xs));
      const int ex = __shfl_up_sync(FULL, xs, 1);
      const int pre = lane_id == 0 ? pin : min(pin, ex);

      // the new reduced band and the codes. Gap: M[j] == M[j-1] +
      // gapcost, which on reduced values is r[j] == r[j-1]; diagonal:
      // M[j] == diag, i.e. r[j] == diag - g
      int left = gfirst ? c0r : pre;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        const int rn = min(pre, loc[k]);
        bool gap_hit = rn == left;
        if constexpr (MODE == MODE_GEN) {
          // flat rule at the last position: M[j] == M[j-1]
          const int gapw = wsub(k == 0 ? wsub(0, gy1m1) : ngy1[k - 1],
                                ngy1[k]);
          gap_hit = gap_hit | (is_last & (wadd(rn, gapw) == left));
        }
        unsigned code = rn == dr[k] ? 1u : 2u;
        code = gap_hit ? 0u : code;
        word[k] = __funnelshift_r(word[k], code, 2);
        left = rn;
        rr[k] = rn;
      }
      rrm1 = gfirst ? c0r : pre;         // below lane 0 lies BIG
      if ((x & 15) == 15) {
        unsigned* out = codes + ((size_t)(x >> 4) * B + b) * w2 + base;
        if ((w2 & 3) == 0 && base + LPT <= w2) {
#pragma unroll
          for (int q = 0; q < LPT / 4; ++q)
            *(uint4*)(out + 4 * q) = make_uint4(
                word[4 * q], word[4 * q + 1], word[4 * q + 2],
                word[4 * q + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < LPT; ++k)
            if (base + k < w2) out[k] = word[k];
        }
      }
    };

#pragma unroll 1
    for (int tt = 0; tt < t; ++tt) {
      const int sl = tab[tt];
      if (sl & 16) {
        // past the row's end the band is frozen, but codes still come
        // out of it: save it once, restore it before each later step
        if (x0 + tt == len || tt == 0) {
#pragma unroll
          for (int k = 0; k < LPT; ++k) frz[k] = rr[k];
          frzm1 = rrm1;
        } else {
#pragma unroll
          for (int k = 0; k < LPT; ++k) rr[k] = frz[k];
          rrm1 = gfirst ? c0r : frzm1;
        }
      }
      switch ((sl >> 2) & 3) {
        case MODE_IN:
          step(std::integral_constant<int, MODE_IN>{}, tt, sl);
          break;
        case MODE_EDGE:
          step(std::integral_constant<int, MODE_EDGE>{}, tt, sl);
          break;
        case MODE_OUT:
          step(std::integral_constant<int, MODE_OUT>{}, tt, sl);
          break;
        default:
          step(std::integral_constant<int, MODE_GEN>{}, tt, sl);
          break;
      }
    }
    a_prev = a;
  }
  if (nc * t - 1 >= len) {
#pragma unroll
    for (int k = 0; k < LPT; ++k) rr[k] = frz[k];
  }
#pragma unroll
  for (int k = 0; k < LPT; ++k)
    if (base + k < w2)
      band_out[(size_t)b * w2 + base + k] = wsub(rr[k], ngy1[k]);
  // a CTA's shared memory must outlive its neighbour's reads
  cg::this_cluster().sync();
}

}  // namespace

// CTAs per row: the caller sizes gbuf as [B * this, C + 1].
extern "C" int staircase_fill_ctas_per_row() { return CS; }

extern "C" int staircase_fill_launch(
    const void* counts, const void* rows, const void* seqs,
    const void* ways, const void* lengths, void* gbuf, void* codes,
    void* band_out, int B, int C, int L, int ncols, int w, int t, int w2,
    void* stream) {
  if (B <= 0) return 0;
  if (t <= 0 || t % 16 != 0 || L <= 0 || w2 <= 0)
    return (int)cudaErrorInvalidValue;
  const int per_cta = (w2 + CS - 1) / CS;
  const int lanes = (per_cta + LPT - 1) / LPT;
  const int threads = ((lanes + 31) / 32) * 32;
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  const int nwarps = threads / 32;
  const int lc = threads * LPT;
  const size_t smem = (size_t)nwarps * t * 8 + (size_t)6 * lc * 4
                      + (size_t)nwarps * t * 4;
  cudaError_t err = cudaFuncSetAttribute(
      staircase_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * CS, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, staircase_fill_kernel, (const int*)counts, (const int8_t*)rows,
      (const int8_t*)seqs, (const int*)ways, (const int*)lengths, (int*)gbuf,
      (unsigned*)codes, (int*)band_out, B, C, L, ncols, w, t, w2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* staircase_fill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
