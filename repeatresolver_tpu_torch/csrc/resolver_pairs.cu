// Kernel H: relative_vars' pair pass over every cluster of a window.
//
// Replaces no Pallas kernel and no XLA code: the JAX package runs this
// loop on the host in numpy (repeatresolver_tpu/models/resolver.py:534-570,
// relative_vars; RepeatResolver.c:2424-2493), a float64 two-sided
// hypergeometric tail for every pair of a cluster's selected groups. Its
// plain version is repeatresolver_tpu_torch/ops/cuda_resolver.py::
// pair_pass_plain, whose module docstring defines the layout.
//
// What it computes: for every tile (k, a0, b0, b1), every a-row a in
// [a0, a0 + TA) of cluster k and every b-row b in [b0, b1) with
// sel[b] >= sel[a] + gap, the intersection s = popcount(mask_a & mask_b)
// over the cluster's packed rows and the entry (s, gidx[b], gidx[a]) of
// the cluster's table. count_mode = 1 sets the entry's occurrence bit
// (BITMAP tables) or inserts its key into the hash (HASHED tables);
// count_mode = 0 reads its decision bit and, if set, marks a and b.
// hstate[0] counts the keys put in; the key past half the hash's slots,
// or a probe that finds no free slot, sets hstate[1], and the caller
// retries with a larger hash. So the flag is set exactly when the keys
// that occur pass half the slots, as in the plain version, however the
// inserts race, and a lookup always meets its key or an empty slot.
//
// What bounds it on an H100: operations. A pair costs words x (a 64-bit
// AND, a 64-bit popcount, an add) and one table test; the popcount runs
// at 16 an SM a clock (two a 64-bit word), a quarter of the int32 rate,
// so the popcount pipe sets the bound. The bytes it must move (masks,
// per-row arrays, tables, marks) are a few MB.
//
// Design: a CTA a tile, 8 warps. Every warp holds the tile's 128 a-rows,
// 4 a lane in registers (mask, the a-part of the entry, sel + gap); the
// b-rows are staged in shared memory NB at a time as 16-byte records
// (mask, the b-part of the entry, sel), and the warps take blocks of 32
// b-rows in turn, so every lane reads the same record (a broadcast) and
// tests it against its 4 a-rows. The entry's word is one multiply-add of
// s on the b-part plus the lane's a-part, in 32 bits. A BITMAP table
// (up to cuda_resolver.SMEM_TABLE_BYTES) lives in shared memory: the
// counting launch sets occurrence bits there (a read first, an atomicOr
// only when the bit is new) and ORs each nonzero word into the global
// bitmap once a CTA; the lookup launch stages the decision bits there.
// Rows of a word differ in s, and an s-row spans an odd count of words,
// so the lanes of a warp read distinct banks. A HASHED table is probed
// in global memory (open addressing, linear probing, 32-bit hash). The
// band check sel[b] >= sel[a] + gap runs only on blocks that start
// before the tile's last a-row's band. Marks: each lane ORs its b-hits
// into a word a block, reduced over the warp and written with one
// atomicOr a block; a-hits are balloted a warp, ORed in shared memory
// and written with one atomicOr a 32 rows at the end. Clusters of one
// word a row (every cluster up to 64 rows) take the specialised path;
// larger ones read their words from global memory.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define AR 4                 // a-rows a lane
#define TA (32 * AR)         // a-rows a tile: cuda_resolver.TILE_A
#define NB 1024              // b-rows staged at a time: cuda_resolver.TILE_B
#define FULL 0xffffffffu

typedef unsigned long long u64;

enum { BITMAP = 0, HASHED = 1, HASHED_WIDE = 2 };

// a staged b-row: its mask (one-word clusters) or its row in the
// cluster (others), the b-part of its entries, its group
struct __align__(16) BRow {
  unsigned lo, hi, part;
  int sel;
};

// the hash's slot of a key: the top log2 bits of a 32-bit product of
// each half (shift = 32 - log2)
__device__ __forceinline__ unsigned hash_slot(u64 key, int shift) {
  return ((unsigned)key * 0x9E3779B1u
          ^ (unsigned)(key >> 32) * 0x85EBCA77u) >> shift;
}

__device__ __forceinline__ void hash_insert(u64* hkeys, u64* hstate,
                                            u64 key, unsigned mask,
                                            int shift) {
  const u64 limit = ((u64)mask + 1) >> 1;
  unsigned i = hash_slot(key, shift);
  for (unsigned probe = 0; probe <= mask; ++probe) {
    u64 cur = __ldcg(hkeys + i);
    if (cur == key) return;
    if (cur == 0ull) {
      if (__ldcg(hstate + 1)) return;
      cur = atomicCAS(hkeys + i, 0ull, key);
      if (cur == 0ull) {
        // a key this thread put in: count it; past half the slots the
        // hash is full
        if (atomicAdd(hstate, 1ull) >= limit) atomicExch(hstate + 1, 1ull);
        return;
      }
      if (cur == key) return;
    }
    i = (i + 1) & mask;
  }
  atomicExch(hstate + 1, 1ull);                 // no free slot left
}

__device__ __forceinline__ unsigned hash_bit(const u64* __restrict__ hkeys,
                                             const unsigned char* __restrict__ hbits,
                                             u64 key, unsigned mask,
                                             int shift) {
  unsigned i = hash_slot(key, shift);
  while (true) {
    const u64 cur = __ldg(hkeys + i);
    if (cur == key) return hbits[i] != 0;
    if (cur == 0ull) return 0u;
    i = (i + 1) & mask;
  }
}

// OR the 32 row bits v (row row0 + i at bit i) into the packed marks
__device__ __forceinline__ void or_rows(unsigned* marked, int row0,
                                        unsigned v) {
  const int w = row0 >> 5, sh = row0 & 31;
  atomicOr(marked + w, v << sh);
  if (sh && (v >> (32 - sh))) atomicOr(marked + w + 1, v >> (32 - sh));
}

struct Tile {
  const u64* masks;              // the cluster's first word
  const int* sel;
  const int* gidx;
  int nw, lo, a0, a1, b0, b1, d, gap;
  unsigned* tab;                 // shared memory: the BITMAP table
  int tw, toff;
  const unsigned* tables;
  unsigned* occ;
  u64 key0;                      // hbase + 1
  u64* hkeys;
  const unsigned char* hbits;
  u64* hstate;
  unsigned hmask;
  int hshift;
  unsigned* marked;
};

// the lane's a-rows, in registers
struct ARows {
  u64 m[AR];                     // the mask (one-word clusters)
  int off[AR];                   // the row's first word (others)
  int sa[AR];                    // sel + gap; INT_MAX past the tile
  unsigned part[AR];             // BITMAP: gidx >> 5; HASHED: gidx
  unsigned bit[AR];              // BITMAP: gidx & 31
};

// b-rows [blk, blk + n) of the staged chunk against the lane's a-rows;
// returns the b-hits of the lane (bit i: row blk + i)
template <int MODE, bool COUNT, bool NW1, bool CHECK>
__device__ __forceinline__ unsigned sweep(const Tile& t, const BRow* bs,
                                          int blk, int n, const ARows& a,
                                          unsigned (&ha)[AR], unsigned S,
                                          unsigned d2) {
  unsigned bw = 0;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const BRow rec = bs[blk + i];
    const u64 mb = ((u64)rec.hi << 32) | rec.lo;
    unsigned hb = 0;
#pragma unroll
    for (int j = 0; j < AR; ++j) {
      unsigned s;
      if (NW1) {
        s = __popcll(a.m[j] & mb);
      } else {
        const u64* pa = t.masks + a.off[j];
        const u64* pb = t.masks + (long long)rec.lo * t.nw;
        s = 0;
        for (int w = 0; w < t.nw; ++w)
          s += __popcll(__ldg(pa + w) & __ldg(pb + w));
      }
      const bool ok = !CHECK || rec.sel >= a.sa[j];
      unsigned hit;
      if (MODE == BITMAP) {
        unsigned* w = t.tab + (s * S + rec.part + a.part[j]);
        if (COUNT) {
          if (ok && !((*w >> a.bit[j]) & 1u)) atomicOr(w, 1u << a.bit[j]);
          continue;
        }
        hit = (*w >> a.bit[j]) & 1u;
      } else {
        if (!ok) continue;
        const u64 key = MODE == HASHED
            ? t.key0 + (s * d2 + rec.part + a.part[j])
            : t.key0 + ((u64)s * (unsigned)t.d + rec.part) * (unsigned)t.d
                  + a.part[j];
        if (COUNT) {
          hash_insert(t.hkeys, t.hstate, key, t.hmask, t.hshift);
          continue;
        }
        hit = hash_bit(t.hkeys, t.hbits, key, t.hmask, t.hshift);
      }
      if (CHECK) hit = ok ? hit : 0u;
      ha[j] |= hit;
      hb |= hit;
    }
    bw |= hb << i;
  }
  return bw;
}

template <int MODE, bool COUNT, bool NW1>
__device__ void tile_pass(const Tile& t, unsigned char* smem) {
  BRow* bs = reinterpret_cast<BRow*>(smem);
  unsigned* amark = reinterpret_cast<unsigned*>(bs + NB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned R = (unsigned)(t.d + 31) >> 5;
  const unsigned S = ((unsigned)t.d * R) | 1u;
  const unsigned d2 = (unsigned)t.d * (unsigned)t.d;

  if (MODE == BITMAP) {
    if (COUNT) {
      for (int i = tid; i < t.tw; i += THREADS) t.tab[i] = 0u;
    } else {
      const uint4* src = reinterpret_cast<const uint4*>(t.tables + t.toff);
      uint4* dst = reinterpret_cast<uint4*>(t.tab);
      for (int i = tid; i < (t.tw >> 2); i += THREADS) dst[i] = __ldg(src + i);
    }
  }
  if (!COUNT && tid < AR) amark[tid] = 0u;

  ARows a;
  unsigned ha[AR];
#pragma unroll
  for (int j = 0; j < AR; ++j) {
    const int r = t.a0 + lane + 32 * j;
    const bool ok = r < t.a1;
    const int g = ok ? t.gidx[r] : 0;
    a.off[j] = ok ? (r - t.lo) * t.nw : 0;
    a.m[j] = (NW1 && ok) ? t.masks[r - t.lo] : 0ull;
    a.sa[j] = ok ? t.sel[r] + t.gap : INT_MAX;
    a.part[j] = MODE == BITMAP ? (unsigned)g >> 5 : (unsigned)g;
    a.bit[j] = (unsigned)g & 31u;
    ha[j] = 0u;
  }
  // blocks whose first b-row lies past every a-row's band need no check
  const int sa_max = t.a1 - t.a0 == TA ? t.sel[t.a1 - 1] + t.gap : INT_MAX;

  for (int c0 = t.b0; c0 < t.b1; c0 += NB) {
    const int nb = min(NB, t.b1 - c0);
    __syncthreads();          // the table's fill, or the last chunk's reads
    for (int i = tid; i < nb; i += THREADS) {
      const int b = c0 + i;
      const unsigned g = (unsigned)t.gidx[b];
      BRow rec;
      if (NW1) {
        const u64 m = t.masks[b - t.lo];
        rec.lo = (unsigned)m;
        rec.hi = (unsigned)(m >> 32);
      } else {
        rec.lo = (unsigned)(b - t.lo);
        rec.hi = 0u;
      }
      rec.part = MODE == BITMAP ? g * R : MODE == HASHED ? g * (unsigned)t.d
                                                         : g;
      rec.sel = t.sel[b];
      bs[i] = rec;
    }
    __syncthreads();
    for (int blk = warp * 32; blk < nb; blk += WARPS * 32) {
      const int n = min(32, nb - blk);
      const unsigned bw =
          bs[blk].sel < sa_max
              ? sweep<MODE, COUNT, NW1, true>(t, bs, blk, n, a, ha, S, d2)
              : sweep<MODE, COUNT, NW1, false>(t, bs, blk, n, a, ha, S, d2);
      if (!COUNT) {
        const unsigned v = __reduce_or_sync(FULL, bw);
        if (lane == 0 && v) or_rows(t.marked, c0 + blk, v);
      }
    }
  }

  if (!COUNT) {
#pragma unroll
    for (int j = 0; j < AR; ++j) {
      const unsigned v = __ballot_sync(FULL, ha[j] != 0u);
      if (lane == 0 && v) atomicOr(amark + j, v);
    }
    __syncthreads();
    if (tid < AR && amark[tid]) or_rows(t.marked, t.a0 + 32 * tid, amark[tid]);
  } else if (MODE == BITMAP) {
    __syncthreads();
    for (int i = tid; i < t.tw; i += THREADS) {
      const unsigned v = t.tab[i];
      if (v) atomicOr(t.occ + t.toff + i, v);
    }
  }
}

template <int MODE, bool COUNT>
__device__ __forceinline__ void tile_words(const Tile& t,
                                           unsigned char* smem) {
  if (t.nw == 1)
    tile_pass<MODE, COUNT, true>(t, smem);
  else
    tile_pass<MODE, COUNT, false>(t, smem);
}

template <bool COUNT>
__device__ __forceinline__ void tile_mode(int mode, const Tile& t,
                                          unsigned char* smem) {
  if (mode == BITMAP)
    tile_words<BITMAP, COUNT>(t, smem);
  else if (mode == HASHED)
    tile_words<HASHED, COUNT>(t, smem);
  else
    tile_words<HASHED_WIDE, COUNT>(t, smem);
}

__global__ void __launch_bounds__(THREADS)
pairs_kernel(const int4* __restrict__ tiles, const u64* __restrict__ masks,
             const int* __restrict__ sel, const int* __restrict__ gidx,
             const int* __restrict__ row_off, const int* __restrict__ word_off,
             const int* __restrict__ words, const int* __restrict__ tab_off,
             const int* __restrict__ tab_words, const int* __restrict__ dims,
             const int* __restrict__ kflag,
             const long long* __restrict__ hbase,
             const unsigned* __restrict__ tables, unsigned* occ, u64* hkeys,
             const unsigned char* __restrict__ hbits, u64* hstate,
             unsigned* marked, int nclusters, int count_mode, int gap,
             int hlog2, int tab_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int4 tl = tiles[blockIdx.x];
  const int k = tl.x;
  if (k < 0 || k >= nclusters) return;          // the whole CTA
  Tile t;
  t.lo = row_off[k];
  const int hi = row_off[k + 1];
  t.a0 = tl.y;
  t.b0 = max(tl.z, t.lo);
  t.b1 = min(tl.w, hi);
  if (t.a0 < t.lo || t.a0 >= hi || t.b0 >= t.b1) return;
  const int mode = kflag[k];
  t.tw = tab_words[k];
  if (mode == BITMAP && t.tw > tab_cap) return;  // the wrapper sizes it
  t.a1 = min(t.a0 + TA, hi);
  t.nw = words[k];
  t.masks = masks + word_off[k];
  t.sel = sel;
  t.gidx = gidx;
  t.d = dims[k];
  t.gap = gap;
  t.tab = reinterpret_cast<unsigned*>(smem + NB * sizeof(BRow) +
                                      AR * sizeof(unsigned));
  t.toff = tab_off[k];
  t.tables = tables;
  t.occ = occ;
  t.key0 = (u64)hbase[k] + 1ull;
  t.hkeys = hkeys;
  t.hbits = hbits;
  t.hstate = hstate;
  t.hmask = (1u << hlog2) - 1u;
  t.hshift = 32 - hlog2;
  t.marked = marked;
  if (count_mode)
    tile_mode<true>(mode, t, smem);
  else
    tile_mode<false>(mode, t, smem);
}

extern "C" int resolver_pairs_launch(
    const void* tiles, const void* masks, const void* sel, const void* gidx,
    const void* row_off, const void* word_off, const void* words,
    const void* tab_off, const void* tab_words, const void* dims,
    const void* kflag, const void* hbase, const void* tables, void* occ,
    void* hkeys, const void* hbits, void* hstate, void* marked, int ntiles,
    int nclusters, int count_mode, int gap, int hlog2, int tab_cap,
    void* stream) {
  if (ntiles < 0 || nclusters < 0 || gap < 0 || hlog2 < 1 || hlog2 > 31 ||
      tab_cap < 0)
    return (int)cudaErrorInvalidValue;
  if (ntiles == 0) return (int)cudaSuccess;
  // the staged b-rows, the a-marks, the largest BITMAP table
  const size_t smem = NB * sizeof(BRow) + AR * sizeof(unsigned) +
                      (size_t)tab_cap * sizeof(unsigned);
  static int optin = -1;
  if (optin < 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(pairs_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e != cudaSuccess) {
      optin = -1;
      return (int)e;
    }
  }
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  pairs_kernel<<<ntiles, THREADS, smem, (cudaStream_t)stream>>>(
      (const int4*)tiles, (const u64*)masks, (const int*)sel,
      (const int*)gidx, (const int*)row_off, (const int*)word_off,
      (const int*)words, (const int*)tab_off, (const int*)tab_words,
      (const int*)dims, (const int*)kflag, (const long long*)hbase,
      (const unsigned*)tables, (unsigned*)occ, (u64*)hkeys,
      (const unsigned char*)hbits, (u64*)hstate, (unsigned*)marked,
      nclusters, count_mode, gap, hlog2, tab_cap);
  return (int)cudaGetLastError();
}

extern "C" const char* resolver_pairs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
