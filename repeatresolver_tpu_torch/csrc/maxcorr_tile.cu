// Kernel E: a group of tile pairs of the MaxCorrs device scan, after its
// one product.
//
// Replaces XLA code, not a Pallas kernel: the body of tile_step in
// repeatresolver_tpu/models/maxcorr.py:303-343 after its jnp.dot products
// (the masks, the coverage break, the per-group maxima) and the float32
// significance it calls, repeatresolver_tpu/ops/hypergeom_device.py:81-159
// (the log-factorial gathers and the while_loop over the tail). Its plain
// version is repeatresolver_tpu_torch/ops/maxcorr_tile.py::group_pass_plain,
// whose docstring defines the arguments; the product stays torch._int_mm.
//
// What it computes, for seed column i0 + i of a seed tile (t columns) and
// partner column j0 + c of a group of m partner tiles (c < m*t), from
// schnitt [5t, 5mt] alone: the 5 x 5 block of counts at rows 5i.., columns
// 5c.. gives gr1 (its row sums), gr2 (its column sums) and the shared
// coverage (its sum), since coverage is the sum of the five one-hot
// groups. valid = j0 + c >= i0 + i + gap and j0 + c < ncols; a seed's row is
// cut at its first valid c whose shared coverage is below mincov, across
// the m tiles in order (that c and all later ones are not allowed);
// alive_out[q][i] = alive[i] and no cut in tiles 0..q; for every allowed
// (i, c) and every seed group k of i and partner group kk of c that pass
// their size gates, Z = -log10 P[X >= schnitt] of X ~ HG(N = shared,
// K = gr2, n = gr1), with the reference's caps (MaxCorrelation.c:421-434),
// 0 at or below the mode; acc[(i0+i)*5+k] and acc[(j0+c)*5+kk] become the
// maxima of Z.
//
// What bounds it on an H100: the bytes of schnitt (52.4 MB at tile 256 and
// m = 8, about 16 us at 3.35 TB/s) against the float32 tail series of the
// relevant pairs (up to 128 dependent steps of about 14 operations, an
// IEEE division among them). Most of its time goes to the relevant pairs'
// Z, not to reading the product (PERF.md).
//
// Design: two launches a group, each a CTA for a seed column and a chunk
// of 256 partner columns (a thread a column): 2,048 CTAs of 8 warps at
// tile 256 and m = 8. Pass 1 sums each valid column's block into its
// shared coverage and writes the chunk's first fail. Pass 2 takes the
// row's first fail over all chunks (the cut, and alive_out), sums its
// allowed columns' blocks into gr1, gr2 and the coverage in shared
// memory, and compacts the relevant (column, k, kk) items of the chunk
// into a list in shared memory (a prefix sum over the CTA); then each
// thread evaluates items of the list, so that every lane of a warp works
// on a relevant pair. Each item's tail stops at its own STOP (a pair's
// running term only decays, and once it is at most 1e-8 later terms round
// away against a tail >= 1, so the JAX package's batch-wide stop gives the
// same bits); its ratios do not depend on the running term, so AHEAD of
// them are computed before the chain applies them in order, each step
// behind the stop test. The log-factorial
// double-float table ((nmax + 1) x 8 bytes, 110.7 KB at 13,834 rows) is
// read from device memory through the caches (staged in shared memory by
// every CTA it was slower: bench_maxcorr's variant probe). Column maxima go
// through shared memory, row maxima through the warps, then to acc; all
// by atomicMax on the float's int bits, which orders non-negative floats
// as floats do (acc starts at 0, and only Z > 0 is written). Every
// floating-point step is written with the _rn intrinsics in the plain
// version's order, so that nvcc contracts nothing into an FMA: the TwoSum
// steps depend on it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;            // partner columns a CTA (a chunk)
constexpr int WARPS = THREADS / 32;
constexpr int TERMS = 128;
constexpr int AHEAD = 8;                // tail ratios computed ahead
constexpr float STOP = 1e-8f;
static_assert(TERMS % AHEAD == 0, "a tail ends at a batch's end");
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

// the pmf ratio p(s + jj + 1) / p(s + jj), 0 past the support
__device__ __forceinline__ float ratio_at(float s, float k, float n,
                                          float rest, int jj) {
  const float sjv = __fadd_rn(s, (float)jj);
  const float num = __fmul_rn(__fsub_rn(k, sjv), __fsub_rn(n, sjv));
  const float den = __fmul_rn(__fadd_rn(sjv, 1.f),
                              __fadd_rn(__fadd_rn(rest, sjv), 1.f));
  return (num > 0.f && den > 0.f) ? __fdiv_rn(num, fmaxf(den, 1.f)) : 0.f;
}

// Z of one relevant pair (hypergeom_device.positive_significance_f32_each);
// sizes[g1] and sizes[g2] are the two groups' sizes, read for the cap only
__device__ float z_relevant(int si, int ni, int ki, int nni,
                            const int* sizes, size_t g1, size_t g2,
                            const float2* tab, int nmax) {
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
  const float rest = __fsub_rn(__fsub_rn((float)nni, k), n);
  // the loop `for (jj = 0; jj < TERMS && run > STOP; ++jj) { run *= r_jj;
  // tail += run; }` in batches of AHEAD steps: the ratios first, then the
  // chain, each step only while no earlier step of the batch stopped
  float run = 1.f, tail = 1.f;
  for (int jj0 = 0; jj0 < TERMS && run > STOP; jj0 += AHEAD) {
    float r[AHEAD];
#pragma unroll
    for (int b = 0; b < AHEAD; ++b) r[b] = ratio_at(s, k, n, rest, jj0 + b);
    bool live = true;
#pragma unroll
    for (int b = 0; b < AHEAD; ++b) {
      live = live && run > STOP;
      if (live) {
        run = __fmul_rn(run, r[b]);
        tail = __fadd_rn(tail, run);
      }
    }
  }
  float z = __fmul_rn(-__fadd_rn(logp0, logf(tail)), LOG10E);
  z = isfinite(z) ? fminf(z, 99.f) : 99.f;
  if (z > 98.f) {
    const float f1num = __fmul_rn(2.f, s);
    const float f1den = __fadd_rn((float)sizes[g1], (float)sizes[g2]);
    const float f1 = f1num < 0.0001f
                         ? 0.f : __fdiv_rn(f1num, fmaxf(f1den, 1.f));
    z = __fadd_rn(98.f, f1);
  }
  return z;
}

// the 5 x 5 block of seed column i and partner column c
__device__ __forceinline__ const int* block_of(const int* schnitt, int i,
                                               int c, int nc) {
  return schnitt + (size_t)5 * i * (size_t)(5 * nc) + (size_t)5 * c;
}

// Pass 1: fails[i][ch] = the first valid column of chunk ch of seed i's
// row whose shared coverage is below mincov, nc if none (dead seeds: not
// written, and not read)
__global__ void __launch_bounds__(THREADS) group_cut_kernel(
    const int* __restrict__ schnitt,     // [5t, 5nc]
    const uint8_t* __restrict__ alive,   // [t]
    int* __restrict__ fails,             // [t, nchunks]
    int nc, int i0, int j0, int gap, int ncols, int mincov) {
  __shared__ int first;
  const int i = blockIdx.y, ch = blockIdx.x, tid = threadIdx.x;
  if (!alive[i]) return;
  if (tid == 0) first = nc;
  __syncthreads();
  const int c = ch * THREADS + tid;
  const int clo = max(0, i0 + i + gap - j0);
  const int chi = min(nc, ncols - j0);
  if (c >= clo && c < chi) {
    const int* p = block_of(schnitt, i, c, nc);
    const size_t ld = (size_t)5 * nc;
    int cov = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k)
#pragma unroll
      for (int kk = 0; kk < 5; ++kk) cov += p[k * ld + kk];
    if (cov < mincov) atomicMin(&first, c);
  }
  __syncthreads();
  if (tid == 0) fails[(size_t)i * gridDim.x + ch] = first;
}

// Pass 2: the cut, alive_out, the relevant items of the chunk's allowed
// columns compacted, their Z and the maxima
__global__ void __launch_bounds__(THREADS) group_z_kernel(
    const int* __restrict__ schnitt,         // [5t, 5nc]
    const uint8_t* __restrict__ alive,       // [t]
    uint8_t* __restrict__ alive_out,         // [m, t]
    const uint8_t* __restrict__ seed_ok,     // [Cp, 5]
    const uint8_t* __restrict__ partner_ok,  // [Cp, 5]
    const int* __restrict__ sizes,           // [Cp * 5]
    const float2* __restrict__ lf,           // [nmax + 1] (hi, lo)
    float* __restrict__ acc,                 // [Cp * 5]
    const int* __restrict__ fails,           // [t, nchunks]
    int t, int m, int nc, int i0, int j0, int gap, int ncols, int nmax) {
  __shared__ int s_cov[THREADS];
  __shared__ int s_g1[5][THREADS];
  __shared__ int s_g2[5][THREADS];
  __shared__ int s_colmax[5][THREADS];
  // an item: its column in the chunk (bits 0-7) and 5k + kk (bits 8-12)
  __shared__ uint16_t s_item[25 * THREADS];
  __shared__ int s_warp[WARPS];
  __shared__ int s_rowmax[5];
  const int i = blockIdx.y, ch = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gi = i0 + i;
  int first = nc;
  if (alive[i])
    for (int x = 0; x < (int)gridDim.x; ++x)
      first = min(first, fails[(size_t)i * gridDim.x + x]);
  if (ch == 0)
    for (int q = tid; q < m; q += THREADS)
      alive_out[(size_t)q * t + i] = alive[i] && first >= (q + 1) * t;
  if (!alive[i]) return;
  // allowed: [clo, cut), of which this chunk holds [lo, hi)
  const int clo = max(0, gi + gap - j0);
  const int cut = min(min(nc, ncols - j0), first);
  const int lo = max(clo, ch * THREADS);
  const int hi = min(cut, ch * THREADS + THREADS);
  unsigned sok = 0;
  for (int k = 0; k < 5; ++k)
    if (seed_ok[(size_t)gi * 5 + k]) sok |= 1u << k;
  if (lo >= hi || sok == 0) return;

  const int c = ch * THREADS + tid;
  const size_t ld = (size_t)5 * nc;
  unsigned rel = 0;                      // bit 5k + kk: a relevant item
  if (c >= lo && c < hi) {
    const int* p = block_of(schnitt, i, c, nc);
    int sv[5][5], g2[5] = {0, 0, 0, 0, 0}, cov = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      int g1 = 0;
#pragma unroll
      for (int kk = 0; kk < 5; ++kk) {
        sv[k][kk] = p[k * ld + kk];
        g1 += sv[k][kk];
        g2[kk] += sv[k][kk];
      }
      s_g1[k][tid] = g1;
      cov += g1;
    }
    const uint8_t* pok = partner_ok + (size_t)(j0 + c) * 5;
#pragma unroll
    for (int kk = 0; kk < 5; ++kk) s_g2[kk][tid] = g2[kk];
    s_cov[tid] = cov;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (!(sok >> k & 1u)) continue;
      const int g1 = s_g1[k][tid];
#pragma unroll
      for (int kk = 0; kk < 5; ++kk)
        if (pok[kk] && relevant_of(sv[k][kk], g1, g2[kk], cov))
          rel |= 1u << (5 * k + kk);
    }
  }
#pragma unroll
  for (int kk = 0; kk < 5; ++kk) s_colmax[kk][tid] = 0;
  if (tid < 5) s_rowmax[tid] = 0;

  // the items' offsets: an exclusive prefix sum of the counts over the CTA
  const int cnt = __popc(rel);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int off = incl - cnt, total = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int v = s_warp[w];
    if (w < warp) off += v;
    total += v;
  }
  for (unsigned r = rel; r; r &= r - 1)
    s_item[off++] = (uint16_t)(tid | (__ffs(r) - 1) << 8);
  __syncthreads();
  if (total == 0) return;
  // the log-factorial table, from device memory through the caches
  const float2* tab = lf;

  float rmax[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int x = tid; x < total; x += THREADS) {
    const int code = s_item[x];
    const int j = code & 0xff, b = code >> 8;
    const int k = b / 5, kk = b - 5 * k;
    const int cc = ch * THREADS + j;
    const int si = schnitt[(size_t)(5 * i + k) * ld + (size_t)5 * cc + kk];
    const float z = z_relevant(si, s_g1[k][j], s_g2[kk][j], s_cov[j],
                               sizes, (size_t)gi * 5 + k,
                               (size_t)(j0 + cc) * 5 + kk, tab, nmax);
#pragma unroll
    for (int kx = 0; kx < 5; ++kx)
      if (kx == k) rmax[kx] = fmaxf(rmax[kx], z);
    if (z > 0.f) atomicMax(&s_colmax[kk][j], __float_as_int(z));
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    float v = rmax[k];
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0 && v > 0.f) atomicMax(&s_rowmax[k], __float_as_int(v));
  }
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < 5; ++kk) {
    const int v = s_colmax[kk][tid];
    if (v > 0) atomicMax((int*)acc + (size_t)(j0 + c) * 5 + kk, v);
  }
  if (tid < 5 && s_rowmax[tid] > 0)
    atomicMax((int*)acc + (size_t)gi * 5 + tid, s_rowmax[tid]);
}

}  // namespace

extern "C" int maxcorr_tile_launch(
    const void* schnitt, const void* alive, void* alive_out,
    const void* seed_ok, const void* partner_ok, const void* sizes,
    const void* lf, void* acc, void* fails, int t, int m, int i0, int j0,
    int gap, int ncols, int mincov, int nmax, void* stream) {
  if (t <= 0 || t > 65535 || m <= 0 || nmax < 0 || i0 < 0 || j0 < 0
      || (long long)m * t > (1 << 26))
    return (int)cudaErrorInvalidValue;
  const int nc = m * t;
  const dim3 grid((nc + THREADS - 1) / THREADS, t);
  const cudaStream_t s = (cudaStream_t)stream;
  group_cut_kernel<<<grid, THREADS, 0, s>>>(
      (const int*)schnitt, (const uint8_t*)alive, (int*)fails, nc, i0, j0,
      gap, ncols, mincov);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_z_kernel<<<grid, THREADS, 0, s>>>(
      (const int*)schnitt, (const uint8_t*)alive, (uint8_t*)alive_out,
      (const uint8_t*)seed_ok, (const uint8_t*)partner_ok,
      (const int*)sizes, (const float2*)lf, (float*)acc,
      (const int*)fails, t, m, nc, i0, j0, gap, ncols, nmax);
  return (int)cudaGetLastError();
}

extern "C" const char* maxcorr_tile_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
