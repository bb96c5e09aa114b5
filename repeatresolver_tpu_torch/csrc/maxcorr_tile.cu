// Kernel E: one tile pair of the MaxCorrs device scan, after its products.
//
// Replaces XLA code, not a Pallas kernel: the body of tile_step in
// repeatresolver_tpu/models/maxcorr.py:303-343 after its jnp.dot products
// (the masks, the coverage break, the per-group maxima) and the float32
// significance it calls, repeatresolver_tpu/ops/hypergeom_device.py:81-159
// (the log-factorial gathers and the while_loop over the tail). Its plain
// version is repeatresolver_tpu_torch/ops/maxcorr_tile.py::tile_pass_plain,
// whose docstring defines the arguments; the products stay torch._int_mm.
//
// What it computes, for seed column i0 + i and partner column j0 + j of a
// tile pair: valid = j0 + j >= i0 + i + gap and j0 + j < ncols; a seed's
// row is cut at its first valid j whose shared coverage is below mincov
// (that j and all later ones are not allowed), alive_next[i] = alive[i]
// and no cut in the row; for every allowed (i, j) and every seed group k
// of i and partner group kk of j that pass their size gates, Z =
// -log10 P[X >= schnitt] of X ~ HG(N = shared, K = gr2, n = gr1), with the
// reference's caps (MaxCorrelation.c:421-434), 0 at or below the mode;
// acc[(i0+i)*5+k] and acc[(j0+j)*5+kk] become the maxima of Z.
//
// What bounds it on an H100: the float32 tail series. A relevant pair
// takes up to 128 dependent steps of about 14 operations (an IEEE
// division among them), while its inputs are 9.4 MB of int32 counts a
// tile pair at tile 256 (2.8 us at 3.35 TB/s).
//
// Design: a CTA a seed column, a thread a partner column (strided when
// the tile is wider than the CTA). A shared-memory atomicMin finds the
// row's first fail, which gives the cut, alive_next and the allowed
// columns at once; a CTA whose seed is not alive, or which holds no
// relevant pair, leaves before it reads the table. Each thread runs the
// tail of its own pairs and stops each at its own STOP (a pair's running
// term only decays, and once it is at most 1e-8 later terms round away
// against a tail >= 1, so the JAX package's batch-wide stop gives the same
// bits). The log-factorial double-float table ((nmax + 1) x 8 bytes,
// 110.7 KB at 13,834 rows) is read from device memory through the caches,
// for any row count. Row maxima are reduced in the CTA,
// column maxima go straight to acc; both by atomicMax on the float's int
// bits, which orders non-negative floats as floats do (acc starts at 0,
// and only Z > 0 is written). Every floating-point step is written with
// the _rn intrinsics in the plain version's order, so that nvcc contracts
// nothing into an FMA: the TwoSum steps depend on it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TERMS = 128;
constexpr float STOP = 1e-8f;
constexpr float LOG10E = 0.4342944819032518f;

__device__ __forceinline__ float mode_of(float n, float k, float nn) {
  return __fdiv_rn(__fmul_rn(__fadd_rn(n, 1.f), __fadd_rn(k, 1.f)),
                   __fadd_rn(nn, 2.f));
}

// s > mode, s >= 1, n > 0, k > 0: the pairs whose Z is not 0
__device__ __forceinline__ bool relevant_of(int si, int ni, int ki,
                                            int nni) {
  const float s = (float)si, n = (float)ni, k = (float)ki;
  return s > mode_of(n, k, (float)nni) && s >= 1.f && n > 0.f && k > 0.f;
}

// TwoSum of acc_hi and sign * F.hi, the error and sign * F.lo into acc_lo
__device__ __forceinline__ void add_term(float& acc_hi, float& acc_lo,
                                         const float2* tab, int idx,
                                         int nmax, float sign) {
  const float2 f = tab[min(max(idx, 0), nmax)];
  const float b = __fmul_rn(sign, f.x);
  const float s = __fadd_rn(acc_hi, b);
  const float bb = __fsub_rn(s, acc_hi);
  const float err = __fadd_rn(__fsub_rn(acc_hi, __fsub_rn(s, bb)),
                              __fsub_rn(b, bb));
  acc_hi = s;
  acc_lo = __fadd_rn(__fadd_rn(acc_lo, err), __fmul_rn(sign, f.y));
}

// Z of one pair (hypergeom_device.positive_significance_f32_each)
__device__ float z_of(int si, int ni, int ki, int nni, int size1,
                      int size2, const float2* tab, int nmax) {
  if (!relevant_of(si, ni, ki, nni)) return 0.f;
  float hi = 0.f, lo = 0.f;
  add_term(hi, lo, tab, ki, nmax, 1.f);
  add_term(hi, lo, tab, nni - ki, nmax, 1.f);
  add_term(hi, lo, tab, ni, nmax, 1.f);
  add_term(hi, lo, tab, nni - ni, nmax, 1.f);
  add_term(hi, lo, tab, si, nmax, -1.f);
  add_term(hi, lo, tab, ki - si, nmax, -1.f);
  add_term(hi, lo, tab, ni - si, nmax, -1.f);
  add_term(hi, lo, tab, nni - ki - ni + si, nmax, -1.f);
  add_term(hi, lo, tab, nni, nmax, -1.f);
  const float logp0 = __fadd_rn(hi, lo);

  const float s = (float)si, k = (float)ki, n = (float)ni;
  const float nn = (float)nni;
  const float rest = __fsub_rn(__fsub_rn(nn, k), n);
  float run = 1.f, tail = 1.f;
  for (int jj = 0; jj < TERMS && run > STOP; ++jj) {
    const float sjv = __fadd_rn(s, (float)jj);
    const float num = __fmul_rn(__fsub_rn(k, sjv), __fsub_rn(n, sjv));
    const float den = __fmul_rn(__fadd_rn(sjv, 1.f),
                                __fadd_rn(__fadd_rn(rest, sjv), 1.f));
    const float ratio = (num > 0.f && den > 0.f)
                            ? __fdiv_rn(num, fmaxf(den, 1.f)) : 0.f;
    run = __fmul_rn(run, ratio);
    tail = __fadd_rn(tail, run);
  }
  float z = __fmul_rn(-__fadd_rn(logp0, logf(tail)), LOG10E);
  z = isfinite(z) ? fminf(z, 99.f) : 99.f;
  if (z > 98.f) {
    const float f1num = __fmul_rn(2.f, s);
    const float f1den = __fadd_rn((float)size1, (float)size2);
    const float f1 = f1num < 0.0001f
                         ? 0.f : __fdiv_rn(f1num, fmaxf(f1den, 1.f));
    z = __fadd_rn(98.f, f1);
  }
  return z;
}

__global__ void __launch_bounds__(THREADS) maxcorr_tile_kernel(
    const int* __restrict__ shared,      // [t, t]
    const int* __restrict__ schnitt,     // [t5, t5]
    const int* __restrict__ gr1,         // [t5, t]
    const int* __restrict__ gr2,         // [t, t5]
    const uint8_t* __restrict__ alive,   // [t]
    uint8_t* __restrict__ alive_next,    // [t]
    const uint8_t* __restrict__ seed_ok,     // [Cp, 5]
    const uint8_t* __restrict__ partner_ok,  // [Cp, 5]
    const int* __restrict__ sizes,       // [Cp * 5]
    const float2* __restrict__ lf,       // [nmax + 1] (hi, lo)
    float* __restrict__ acc,             // [Cp * 5]
    int t, int i0, int j0, int gap, int ncols, int mincov, int nmax) {
  __shared__ int first_fail;
  __shared__ float row_max[WARPS][5];
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int t5 = 5 * t;
  const int gi = i0 + i;
  if (!alive[i]) {
    if (tid == 0) alive_next[i] = 0;
    return;
  }
  if (tid == 0) first_fail = t;
  __syncthreads();
  const int* sh_row = shared + (size_t)i * t;
  const int jlo = max(0, gi + gap - j0);       // first valid j
  const int jhi = min(t, ncols - j0);          // past the last valid j
  for (int j = jlo + tid; j < jhi; j += THREADS)
    if (sh_row[j] < mincov) atomicMin(&first_fail, j);
  __syncthreads();
  const int cut = min(first_fail, jhi);        // allowed: [jlo, cut)
  if (tid == 0) alive_next[i] = first_fail == t ? 1 : 0;

  unsigned sok = 0;
  for (int k = 0; k < 5; ++k)
    if (seed_ok[(size_t)gi * 5 + k]) sok |= 1u << k;
  const int* s_row = schnitt + (size_t)i * 5 * t5;
  const int* g1_row = gr1 + (size_t)i * 5 * t;
  const int* g2_row = gr2 + (size_t)i * t5;

  // leave before the table when no allowed pair is relevant
  bool any = false;
  for (int j = jlo + tid; j < cut && !any; j += THREADS) {
    const int cov = sh_row[j];
    const uint8_t* pok = partner_ok + (size_t)(j0 + j) * 5;
    for (int k = 0; k < 5; ++k) {
      if (!(sok >> k & 1u)) continue;
      for (int kk = 0; kk < 5; ++kk)
        if (pok[kk] && relevant_of(s_row[(size_t)k * t5 + j * 5 + kk],
                                   g1_row[(size_t)k * t + j],
                                   g2_row[j * 5 + kk], cov))
          any = true;
    }
  }
  if (!__syncthreads_or(any)) return;

  float rmax[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = jlo + tid; j < cut; j += THREADS) {
    const int gj = j0 + j;
    const int cov = sh_row[j];
    const uint8_t* pok = partner_ok + (size_t)gj * 5;
    float cmax[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < 5; ++k) {
      if (!(sok >> k & 1u)) continue;
      for (int kk = 0; kk < 5; ++kk) {
        if (!pok[kk]) continue;
        const float z = z_of(s_row[(size_t)k * t5 + j * 5 + kk],
                             g1_row[(size_t)k * t + j], g2_row[j * 5 + kk],
                             cov, sizes[(size_t)gi * 5 + k],
                             sizes[(size_t)gj * 5 + kk], lf, nmax);
        rmax[k] = fmaxf(rmax[k], z);
        cmax[kk] = fmaxf(cmax[kk], z);
      }
    }
    for (int kk = 0; kk < 5; ++kk)
      if (cmax[kk] > 0.f)
        atomicMax((int*)acc + (size_t)gj * 5 + kk, __float_as_int(cmax[kk]));
  }
  const int lane = tid & 31, warp = tid >> 5;
  for (int k = 0; k < 5; ++k) {
    float v = rmax[k];
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) row_max[warp][k] = v;
  }
  __syncthreads();
  if (tid < 5) {
    float v = 0.f;
    for (int w = 0; w < WARPS; ++w) v = fmaxf(v, row_max[w][tid]);
    if (v > 0.f)
      atomicMax((int*)acc + (size_t)gi * 5 + tid, __float_as_int(v));
  }
}

}  // namespace

extern "C" int maxcorr_tile_launch(
    const void* shared, const void* schnitt, const void* gr1,
    const void* gr2, const void* alive, void* alive_next,
    const void* seed_ok, const void* partner_ok, const void* sizes,
    const void* lf, void* acc, int t, int i0, int j0, int gap, int ncols,
    int mincov, int nmax, void* stream) {
  if (t <= 0 || t > 65535 || nmax < 0 || i0 < 0 || j0 < 0)
    return (int)cudaErrorInvalidValue;
  maxcorr_tile_kernel<<<t, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)shared, (const int*)schnitt, (const int*)gr1,
      (const int*)gr2, (const uint8_t*)alive, (uint8_t*)alive_next,
      (const uint8_t*)seed_ok, (const uint8_t*)partner_ok,
      (const int*)sizes, (const float2*)lf, (float*)acc, t, i0, j0, gap,
      ncols, mincov, nmax);
  return (int)cudaGetLastError();
}

extern "C" const char* maxcorr_tile_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
