// Kernel H: relative_vars' pair pass over every cluster of a window.
//
// Replaces no Pallas kernel and no XLA code: the JAX package runs this
// loop on the host in numpy (repeatresolver_tpu/models/resolver.py:534-570,
// relative_vars; RepeatResolver.c:2424-2493), a float64 two-sided
// hypergeometric tail for every pair of a cluster's selected groups. Its
// plain version is repeatresolver_tpu_torch/ops/cuda_resolver.py::
// pair_pass_plain, whose module docstring defines the layout.
//
// What it computes: for every selected row r (a group of cluster k) and
// every later row b of the same cluster with sel[b] >= sel[r] + gap, the
// intersection s = popcount(mask_r & mask_b) over the cluster's packed
// rows, and the entry e = (s * D + gidx[b]) * D + gidx[r] of the cluster's
// table. A cluster without kflag reads bit e of its dense table; a
// cluster with kflag reads the bit of key hbase[k] + e + 1 in the hash
// (hkeys, hbits; open addressing, linear probing, hash_slot below).
// count_mode = 0: a set bit marks r and b (marked[] = 1). count_mode = 1:
// for the clusters with kflag set, every key that occurs is inserted into
// the hash instead, so that the host evaluates only the entries that
// occur. hstate[0] counts the keys put in; the key past half the hash's
// slots, or a probe that finds no free slot, sets hstate[1], and the
// caller retries with a larger hash. So the flag is set exactly when the
// keys that occur pass half the slots, as in the plain version, however
// the inserts race, and a lookup always meets its key or an empty slot.
//
// What bounds it on an H100: operations. A pair costs words x (a 64-bit
// AND, a popcount, an add) and one table or hash load; the dense tables
// (at most FULL_TABLE_MAX bits a cluster size) stay in L1, the hash (two
// slots a key that occurs) and the masks (one word a row at paper width)
// in L2. The bytes it must move are the masks, the per-row arrays and the
// marks, a few MB.
//
// Design: a warp a row r, 8 warps a CTA. The warp finds its first b by a
// binary search on the cluster's ascending sel, its lanes stride over b,
// and each lane tests its pairs on its own: no shared memory and no
// barrier. Marks are idempotent byte stores (every writer stores 1); a
// warp's hits for r are combined by a vote. In counting mode a lane reads
// a slot before its atomicCAS and skips the atomic when its key is
// already there, since most pairs of a large cluster share a few keys.
#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 8

typedef unsigned long long u64;

// the hash's slot of a key: two products below 2^62, so that the plain
// version computes the same slot in int64 without overflow
__device__ __forceinline__ unsigned hash_slot(u64 key, unsigned mask) {
  const u64 h = ((key & 0x7FFFFFFFull) * 0x6C8E9CF5ull)
              ^ ((key >> 31) * 0x165667B1ull);
  return (unsigned)(h >> 24) & mask;
}

__device__ __forceinline__ void hash_insert(u64* hkeys, u64* hstate,
                                            u64 key, unsigned mask) {
  const u64 limit = ((u64)mask + 1) >> 1;
  unsigned i = hash_slot(key, mask);
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

__device__ __forceinline__ bool hash_bit(const u64* __restrict__ hkeys,
                                         const unsigned char* __restrict__ hbits,
                                         u64 key, unsigned mask) {
  unsigned i = hash_slot(key, mask);
  while (true) {
    const u64 cur = __ldg(hkeys + i);
    if (cur == key) return hbits[i] != 0;
    if (cur == 0ull) return false;
    i = (i + 1) & mask;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
pairs_kernel(const u64* __restrict__ masks,
             const int* __restrict__ sel, const int* __restrict__ gidx,
             const int* __restrict__ rowk, const int* __restrict__ row_off,
             const int* __restrict__ word_off, const int* __restrict__ words,
             const int* __restrict__ tab_off, const int* __restrict__ dims,
             const int* __restrict__ kflag,
             const long long* __restrict__ hbase,
             const unsigned int* __restrict__ tables, u64* hkeys,
             const unsigned char* __restrict__ hbits, u64* hstate,
             unsigned char* marked, int nrows, int count_mode, int gap,
             unsigned hmask) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= nrows) return;                       // the whole warp
  const int k = rowk[r];
  const bool hashed = kflag[k] != 0;
  if (count_mode && !hashed) return;            // the whole warp
  const int lo = row_off[k], hi = row_off[k + 1];
  const int target = sel[r] + gap;
  // the first b of the cluster past r with sel[b] >= target
  int b0 = r + 1, b1 = hi;
  while (b0 < b1) {
    const int mid = (b0 + b1) >> 1;
    if (sel[mid] < target) b0 = mid + 1; else b1 = mid;
  }
  const int nw = words[k];
  const u64* base = masks + word_off[k];
  const u64* ma = base + (long long)(r - lo) * nw;
  const u64 d = (u64)dims[k];
  const u64 ga = (u64)gidx[r];
  const u64 key0 = (u64)hbase[k] + 1;
  const unsigned int* tab = tables + tab_off[k];
  bool hit_r = false;
  for (int b = b0 + lane; b < hi; b += 32) {
    const u64* mb = base + (long long)(b - lo) * nw;
    u64 s = 0;
    for (int w = 0; w < nw; ++w) s += __popcll(ma[w] & mb[w]);
    const u64 e = (s * d + (u64)gidx[b]) * d + ga;
    bool hit;
    if (count_mode) {
      hash_insert(hkeys, hstate, key0 + e, hmask);
      continue;
    } else if (hashed) {
      hit = hash_bit(hkeys, hbits, key0 + e, hmask);
    } else {
      hit = (__ldg(tab + (e >> 5)) >> (unsigned)(e & 31)) & 1u;
    }
    if (hit) {
      marked[b] = 1;
      hit_r = true;
    }
  }
  if (!count_mode && __any_sync(0xffffffffu, hit_r) && lane == 0)
    marked[r] = 1;
}

extern "C" int resolver_pairs_launch(
    const void* masks, const void* sel, const void* gidx, const void* rowk,
    const void* row_off, const void* word_off, const void* words,
    const void* tab_off, const void* dims, const void* kflag,
    const void* hbase, const void* tables, void* hkeys, const void* hbits,
    void* hstate, void* marked, int nrows, int count_mode, int gap,
    int hlog2, void* stream) {
  if (nrows < 0 || gap < 0 || hlog2 < 1 || hlog2 > 31)
    return (int)cudaErrorInvalidValue;
  if (nrows == 0) return (int)cudaSuccess;
  const int blocks = (nrows + WARPS - 1) / WARPS;
  pairs_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const u64*)masks, (const int*)sel, (const int*)gidx,
      (const int*)rowk, (const int*)row_off, (const int*)word_off,
      (const int*)words, (const int*)tab_off, (const int*)dims,
      (const int*)kflag, (const long long*)hbase,
      (const unsigned int*)tables, (u64*)hkeys,
      (const unsigned char*)hbits, (u64*)hstate, (unsigned char*)marked,
      nrows, count_mode, gap, (1u << hlog2) - 1u);
  return (int)cudaGetLastError();
}

extern "C" const char* resolver_pairs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
