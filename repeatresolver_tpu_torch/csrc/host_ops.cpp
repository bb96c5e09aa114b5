// Native host-side runtime ops of repeatresolver_tpu_torch.
//
// A copy of native/host_ops.cpp (same entry points, same arithmetic),
// kept by the port so that it builds and loads its own library.
//
// The reference implements its whole runtime in C (pthreads + popcount
// loops). The port's compute path is PyTorch on a GPU; these are the
// host-side hot loops whose semantics are inherently sequential /
// order-dependent and therefore stay on the CPU, plus the host engines
// (block realign DP, glocal align, MaxCorrs bitset scan):
//
//  * the Kmeans top-5 "slot machine" + assignment/dissolution loops of
//    RepeatResolver.c:2656-2755 (literal order-dependent simulation;
//    O(n^2) per cluster: too slow in Python at production scale)
//  * per-row edit-script backtracking over DP move codes
//    (InitialAligner.c:359-383 semantics)
//
// Built with g++ at first use and loaded via ctypes by
// repeatresolver_tpu_torch/utils/native.py.
#include <cstdint>
#include <cstring>

extern "C" {

// Top-5 slot machine + centroid construction (RepeatResolver.c:2656-2703).
// scores: [n, n] row-major GrMatch scores (symmetric).
// varsigs: [n, v] 0/1 membership over selected vars.
// centroids out: [n, v] 0/1 (majority >2 of the 5 picks).
void kmeans_top5_centroids(const int64_t* scores, const uint8_t* varsigs,
                           int64_t n, int64_t v, uint8_t* centroids)
{
    for (int64_t i = 0; i < n; i++) {
        int64_t bs[5] = {0, 0, 0, 0, 0};
        int64_t bj[5] = {0, 0, 0, 0, 0};
        const int64_t* row = scores + i * n;
        for (int64_t j = 0; j < n; j++) {
            // ascending selection pass (strict-less swaps)
            for (int k = 0; k < 5; k++) {
                for (int l = k + 1; l < 5; l++) {
                    if (bs[l] < bs[k]) {
                        int64_t t = bs[l]; bs[l] = bs[k]; bs[k] = t;
                        t = bj[l]; bj[l] = bj[k]; bj[k] = t;
                    }
                }
            }
            if (row[j] > bs[0]) { bs[0] = row[j]; bj[0] = j; }
        }
        uint8_t* cent = centroids + i * v;
        for (int64_t jv = 0; jv < v; jv++) {
            int s = 0;
            for (int k = 0; k < 5; k++)
                s += varsigs[bj[k] * v + jv];
            cent[jv] = (s > 2) ? 1 : 0;
        }
    }
}

// Assignment + dissolution (RepeatResolver.c:2706-2755).
// cent_scores: [n, n] row-major; cent_scores[j*n + i] = GrMatch of
// centroid j vs varsig i (matches the reference's loop order).
void kmeans_assign_dissolve(const int64_t* cent_scores, int64_t n,
                            int64_t mingroup, int32_t* clusternumber,
                            int64_t* clustersize)
{
    for (int64_t j = 0; j < n; j++) clustersize[j] = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t best_s = 0, best_j = 0;
        for (int64_t j = 0; j < n; j++) {
            int64_t sc = cent_scores[j * n + i];
            if (sc > best_s && i != j) { best_s = sc; best_j = j; }
        }
        clusternumber[i] = (int32_t)best_j;
        clustersize[best_j]++;
    }
    for (int64_t mn = 2; mn < mingroup; mn++) {
        for (int64_t i = 0; i < n; i++) {
            if (clustersize[clusternumber[i]] <= mn) {
                int64_t best_s = 0, best_j = 0;
                for (int64_t j = 0; j < n; j++) {
                    if (clustersize[j] >= mn && clusternumber[i] != j) {
                        int64_t sc = cent_scores[j * n + i];
                        if (sc > best_s && i != j) {
                            best_s = sc; best_j = j;
                        }
                    }
                }
                clustersize[clusternumber[i]]--;
                clusternumber[i] = (int32_t)best_j;
                clustersize[best_j]++;
            }
        }
    }
}

// Edit-script backtracking over DP move codes for a batch of rows
// (InitialAligner.c semantics: codes 0/3 diagonal, 1 consume target,
// 2 consume query). alignments out: [b, lq] target col per query base
// or -1. codes: [b, lq, lt] row-major.
void editdp_backtrack(const int8_t* codes, const int32_t* qlens,
                      const int64_t* entries, int64_t b, int64_t lq,
                      int64_t lt, int32_t* alignments)
{
    for (int64_t r = 0; r < b; r++) {
        const int8_t* cr = codes + r * lq * lt;
        int32_t* out = alignments + r * lq;
        for (int64_t i = 0; i < lq; i++) out[i] = -1;
        int64_t x = (int64_t)qlens[r] - 1;
        int64_t y = entries[r];
        while (x > -1 && y > -1) {
            int8_t code = cr[x * lt + y];
            if (code == 0 || code == 3) {      // diagonal
                out[x] = (int32_t)y;
                x--; y--;
            } else if (code == 1) {            // consume target
                y--;
            } else {                           // consume query
                x--;
            }
        }
    }
}

// Realignment backtracking over banded move codes for one row
// (PW_ReAligner Backtracker semantics; see ops/banded_realign.py).
// codes: [l, w]; anf derived from ways. Returns number of inserts.
// out_row: [c] preset to 5 by the caller. ins_y/ins_base: capacity k.
int64_t realign_backtrack(const uint8_t* codes, const int32_t* ways,
                          int64_t l, int64_t w, int64_t c, int64_t bh,
                          const int8_t* seq, int64_t wayin,
                          int8_t* out_row, int32_t* ins_y,
                          int8_t* ins_base, int64_t cap)
{
    int64_t x = l - 1, y = wayin, n = 0;
    while (x > -1 && y > -1) {
        int64_t anf = ways[x] - bh;
        if (anf < 0) anf = 0;
        int64_t top = anf + w - 1;
        int is_last = (x == l - 1);
        if (y > top) {
            if (!is_last) out_row[y] = 4;
            y--;
            continue;
        }
        uint8_t code = codes[x * w + (y - anf)];
        if (code == 0) {
            if (!is_last) out_row[y] = 4;
            y--;
        } else if (code == 1) {
            out_row[y] = seq[x];
            x--; y--;
        } else {
            if (n < cap) { ins_y[n] = (int32_t)y; ins_base[n] = seq[x]; }
            n++;
            x--;
        }
    }
    return n;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Full realignment block: banded DP fill + backtrack per row, fused.
// Exact reference band semantics (same as ops/banded_realign.py):
// per-position band start anf(x) = max(0, way[x] - W/2), jump rule for
// off-band-above reads, backtracker code priority gap > flat-space >
// diagonal > insert, entry scan ties -> largest column.
//
// counts: int32 [C, 6]; rows_old: int8 [B, C]; seqs: int8 [B, L];
// ways: int32 [B, L]; lengths: int32 [B].
// Outputs per row: new_rows int8 [B, C] (caller preset to 5),
// ins_y/ins_base [B, K], ins_n [B], best int64 [B].
// Scratch (caller-allocated, per thread reuse is internal):
// none — each row allocates its own band matrix of L*W int64? too big;
// we keep two band rows + a codes matrix [L, W] uint8 per row.
#include <cstdlib>
#include <limits>
#include <vector>

static inline int64_t imax64(int64_t a, int64_t b) { return a > b ? a : b; }
static inline int64_t imin64(int64_t a, int64_t b) { return a < b ? a : b; }

extern "C" {

void realign_block_native(const int32_t* counts, const int8_t* rows_old,
                          const int8_t* seqs, const int32_t* ways,
                          const int32_t* lengths, int64_t b, int64_t c,
                          int64_t l, int64_t w, int8_t* new_rows,
                          int64_t* best_out, int32_t* ins_y,
                          int8_t* ins_base, int32_t* ins_n,
                          int64_t ins_cap)
{
    const int64_t BIGV = (int64_t)1 << 40;
    const int64_t bh = w / 2;

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int64_t r = 0; r < b; r++) {
        const int8_t* own = rows_old + r * c;
        const int8_t* seq = seqs + r * l;
        const int32_t* way = ways + r * l;
        int64_t len = lengths[r];
        int8_t* out = new_rows + r * c;
        ins_n[r] = 0;
        best_out[r] = 0;
        if (len <= 0) continue;

        // per-row cost arrays (own contribution removed); int32 DP
        // values (max path cost ~6e8 < 2^30 = BIG32) with contiguous
        // per-symbol substitution costs for vectorization. Built only
        // over the union of this row's band windows [lo, hi) — the
        // band path spans ~1/3 of a paper-scale MSA's width; shifted
        // raw pointers keep absolute-y indexing below.
        const int32_t BIG32 = (int32_t)1 << 30;
        int64_t lo = way[0] - bh; if (lo < 0) lo = 0;
        int64_t hi = way[len - 1] - bh; if (hi < 0) hi = 0;
        hi += w; if (hi > c) hi = c;
        const int64_t nwin = hi - lo;
        std::vector<int32_t> gapb(nwin), insb(nwin), gpb(nwin + 1);
        std::vector<int32_t> sub4b((size_t)nwin * 4);  // planar [sym]
        int32_t* gap = gapb.data() - lo;
        int32_t* ins = insb.data() - lo;
        int32_t* gp = gpb.data() - lo;     // gp[lo] = 0 base
        gp[lo] = 0;
        for (int64_t y = lo; y < hi; y++) {
            const int32_t* cy = counts + y * 6;
            int32_t nsy = cy[0] + cy[1] + cy[2] + cy[3] + cy[4]
                          - (own[y] < 5 ? 1 : 0);
            gap[y] = nsy - (cy[4] - (own[y] == 4 ? 1 : 0));
            gp[y + 1] = gp[y] + gap[y];
            for (int sym = 0; sym < 4; sym++)
                sub4b[(size_t)sym * nwin + (y - lo)] =
                    nsy - (cy[sym] - (own[y] == sym ? 1 : 0));
        }
        {
            int32_t ns_prev;
            if (lo == 0) {
                ns_prev = BIG32;  // unused: ins[0] = ns[0]
            } else {
                const int32_t* cp = counts + (lo - 1) * 6;
                ns_prev = cp[0] + cp[1] + cp[2] + cp[3] + cp[4]
                          - (own[lo - 1] < 5 ? 1 : 0);
            }
            for (int64_t y = lo; y < hi; y++) {
                const int32_t* cy = counts + y * 6;
                int32_t nsy = cy[0] + cy[1] + cy[2] + cy[3] + cy[4]
                              - (own[y] < 5 ? 1 : 0);
                ins[y] = (y == 0) ? nsy
                         : (nsy > ns_prev ? nsy : ns_prev);
                ns_prev = nsy;
            }
        }

        std::vector<uint8_t> codes((size_t)(len * w));
        std::vector<int32_t> prev(w + 2, 0), cur(w + 2, 0);
        std::vector<int32_t> diagv(w), av(w), hv(w), Gv(w);
        int64_t prev_anf = 0;

        for (int64_t x = 0; x < len; x++) {
            int64_t anf = way[x] - bh; if (anf < 0) anf = 0;
            int64_t end = imin64(c, anf + w);
            int64_t nw = end - anf;
            int8_t s = seq[x];
            int64_t ptop = prev_anf + w - 1;
            uint8_t* crow = codes.data() + (size_t)(x * w);

            // pass 1: diagonal / insert candidates. The in-band body
            // (no boundary branches) is a separate tight int32 loop
            // the compiler can vectorize; boundaries handled outside.
            int64_t d = anf - prev_anf;  // >= 0
            const int32_t* subs = sub4b.data() + (size_t)s * nwin - lo;
            if (x == 0) {
                for (int64_t t = 0; t < nw; t++) {
                    int64_t y = anf + t;
                    int32_t sub = subs[y];
                    int32_t a = sub;
                    if (y > 0 && y < c - 1 && ins[y] < a) a = ins[y];
                    diagv[t] = sub;
                    av[t] = a;
                }
            } else {
                // t range where all reads are strictly in-band and the
                // insert option is unconditional: jm>=0, j0<w, 0<y<c-1
                int64_t t_lo = (d == 0) ? 1 : 0;
                if (anf == 0 && t_lo == 0) t_lo = 1;  // y>0 for insert
                int64_t t_hi = imin64(nw, w - d);     // j0 < w
                if (anf + t_hi >= c - 1) t_hi = (c - 1) - anf;
                if (t_hi < t_lo) t_hi = t_lo;
                const int32_t* pr = prev.data() + d;
                const int32_t* sb = subs + anf;
                const int32_t* inp = ins + anf;
                for (int64_t t = t_lo; t < t_hi; t++) {
                    int32_t diag = pr[t - 1] + sb[t];
                    int32_t iv = pr[t] + inp[t];
                    diagv[t] = diag;
                    av[t] = iv < diag ? iv : diag;
                }
                // boundaries (head and tail), branchy scalar
                for (int64_t t = 0; t < nw; t++) {
                    if (t >= t_lo && t < t_hi) { t = t_hi - 1; continue; }
                    int64_t y = anf + t;
                    int64_t jm = t + d - 1;
                    int64_t j0 = t + d;
                    int32_t sub = subs[y];
                    int32_t dprev = (jm < 0) ? BIG32
                        : (jm < w ? prev[jm]
                           : prev[w - 1] + (gp[y] - gp[ptop + 1]));
                    int32_t uprev = (j0 < w) ? prev[j0]
                        : prev[w - 1] + (gp[y + 1] - gp[ptop + 1]);
                    int32_t diag = dprev + sub;
                    int32_t a = diag;
                    if (y > 0 && y < c - 1) {
                        int32_t iv = uprev + ins[y];
                        if (iv < a) a = iv;
                    }
                    diagv[t] = diag;
                    av[t] = a;
                }
            }
            // pass 2: left relaxation m[t] = min(av[t], m[t-1]+gap[t])
            // recast as a prefix-min in gap-prefix space: with
            // G[t] = sum(gap[anf..anf+t]) and b[t] = av[t] - G[t],
            // m[t] = h[t] + G[t] where h[t] = min(h[t-1], b[t]).
            // Bit-identical values and code decisions (m == lv  <=>
            // h[t] == h[t-1]); the serial dependence shrinks from the
            // full relax+select chain to one min, and the code/store
            // loop vectorizes.
            int is_last = (x == len - 1);
            const int32_t* gpr = gap + anf;
            {
                int32_t G = 0, carry = BIG32;
                for (int64_t t = 0; t < nw; t++) {
                    G += gpr[t];
                    Gv[t] = G;
                    int32_t bb = av[t] - G;
                    carry = carry < bb ? carry : bb;
                    hv[t] = carry;
                }
            }
            if (nw > 0) {   // t = 0: left = BIG32, lv = BIG32 + G[0]
                int32_t m = hv[0] + Gv[0];
                int32_t lv = BIG32 + Gv[0];
                uint8_t code;
                if (m == lv || (is_last && m == BIG32)) code = 0;
                else if (m == diagv[0]) code = 1;
                else code = 2;
                crow[0] = code;
                cur[0] = m;
            }
            for (int64_t t = 1; t < nw; t++) {
                int32_t m = hv[t] + Gv[t];
                int32_t lv = hv[t - 1] + Gv[t];       // m[t-1] + gap[t]
                int32_t lf = hv[t - 1] + Gv[t - 1];   // m[t-1]
                uint8_t code;
                if (m == lv || (is_last && m == lf)) code = 0;
                else if (m == diagv[t]) code = 1;
                else code = 2;
                crow[t] = code;
                cur[t] = m;
            }
            for (int64_t j = nw; j < w; j++) cur[j] = BIG32;
            std::swap(prev, cur);
            prev_anf = anf;
        }

        // entry scan: min over y in (bound, c-1], ties -> largest y
        int64_t last_anf = way[len - 1] - bh; if (last_anf < 0) last_anf = 0;
        int64_t bound = way[len - 1] - bh; if (bound < -1) bound = -1;
        int64_t ltop = last_anf + w - 1;
        auto read_final = [&](int64_t y) -> int64_t {
            int64_t j = y - last_anf;
            if (j < 0) return BIGV;
            if (j >= w) return prev[w - 1];   // flat (x == len-1)
            return prev[j];
        };
        int64_t wayin = c - 1;
        int64_t best = read_final(c - 1);
        for (int64_t y = c - 1; y > bound; y--) {
            int64_t v = read_final(y);
            if (v < best) { best = v; wayin = y; }
        }
        best_out[r] = best;

        // backtrack
        int64_t x = len - 1, y = wayin, n = 0;
        while (x > -1 && y > -1) {
            int64_t anf = way[x] - bh; if (anf < 0) anf = 0;
            int64_t top = anf + w - 1;
            int is_last = (x == len - 1);
            if (y > top) {
                if (!is_last) out[y] = 4;
                y--;
                continue;
            }
            if (y < anf) break;  // unreachable on valid paths
            uint8_t code = codes[(size_t)(x * w + (y - anf))];
            if (code == 0) {
                if (!is_last) out[y] = 4;
                y--;
            } else if (code == 1) {
                out[y] = seq[x];
                x--; y--;
            } else {
                if (n < ins_cap) {
                    ins_y[r * ins_cap + n] = (int32_t)y;
                    ins_base[r * ins_cap + n] = seq[x];
                }
                n++;
                x--;
            }
        }
        ins_n[r] = (int32_t)n;
    }
}

// Column splice: np.insert(arr, positions, cols, axis=1) for ascending
// pre-insertion positions (ties keep order). One row-major merge pass:
// numpy's per-segment slice assignment walks all R rows per segment
// (one cache line touched per 8 useful bytes at paper-scale insert
// batches); this streams each row once. cols_t is [R, N] (inserted
// values pre-transposed so the per-row walk is sequential).
void splice_cols_native(const int8_t* arr, int64_t r, int64_t c,
                        const int64_t* pos, const int8_t* cols_t,
                        int64_t n, int8_t* out)
{
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t k = 0; k < r; k++) {
        const int8_t* src = arr + k * c;
        const int8_t* cv = cols_t + k * n;
        int8_t* dst = out + k * (c + n);
        int64_t prev = 0;
        for (int64_t i = 0; i < n; i++) {
            int64_t p = pos[i];
            memcpy(dst + prev + i, src + prev, (size_t)(p - prev));
            dst[p + i] = cv[i];
            prev = p;
        }
        memcpy(dst + prev + n, src + prev, (size_t)(c - prev));
    }
}

}  // extern "C"

// ---------------------------------------------------------------------
// Glocal full-DP alignment of sequences to a template with traceback
// (InitialAligner.c IntoAligner semantics: move codes with tie priority
// diagonal > consume-template > consume-query, entry scan over columns
// [1, T-1] descending with strict '<', alignments[i] = template column
// of base i or -1). OpenMP over sequences; per-thread full code matrix.
extern "C" {

void initial_align_native(const int8_t* tmpl, int64_t tlen,
                          const int8_t* seqs, const int32_t* lengths,
                          int64_t b, int64_t lmax,
                          int32_t* alignments /* [b, lmax] */,
                          double* errors /* [b] */)
{
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<int32_t> row((size_t)tlen + 1);
        std::vector<uint8_t> codes;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int64_t r = 0; r < b; r++) {
            const int8_t* q = seqs + r * lmax;
            int32_t* out = alignments + r * lmax;
            int64_t lq = lengths[r];
            for (int64_t i = 0; i < lmax; i++) out[i] = -1;
            if (lq <= 0) {
                errors[r] = std::numeric_limits<double>::quiet_NaN();
                continue;
            }
            codes.resize((size_t)(lq * tlen));
            // row[j] = M[x][j-1]; row[0] = M[x][-1] = x+1
            for (int64_t j = 0; j <= tlen; j++) row[j] = 0;
            for (int64_t x = 0; x < lq; x++) {
                int32_t diagv = (int32_t)x;  // M[x-1][-1]
                row[0] = (int32_t)(x + 1);
                uint8_t* crow = codes.data() + (size_t)(x * tlen);
                int8_t qx = q[x];
                for (int64_t j = 1; j <= tlen; j++) {
                    int m = (qx != tmpl[j - 1]);
                    int32_t e = diagv + m;
                    uint8_t code = m ? 0 : 3;
                    if (row[j - 1] + 1 < e) {       // consume template
                        e = row[j - 1] + 1;
                        code = 1;
                    }
                    if (row[j] + 1 < e) {           // consume query
                        e = row[j] + 1;
                        code = 2;
                    }
                    diagv = row[j];
                    row[j] = e;
                    crow[j - 1] = code;
                }
            }
            // entry scan: columns T-1 .. 1, strict '<' (ties -> largest)
            int64_t entry = tlen - 1;
            int32_t mn = row[tlen];
            // reference scans columns tlen-1 .. 1 (col 0 excluded)
            for (int64_t j = tlen; j > 1; j--) {
                if (row[j] < mn) { mn = row[j]; entry = j - 1; }
            }
            errors[r] = (double)mn / (double)lq;
            // backtrack
            int64_t x = lq - 1, y = entry;
            while (x > -1 && y > -1) {
                uint8_t code = codes[(size_t)(x * tlen + y)];
                if (code == 0 || code == 3) { out[x] = (int32_t)y; x--; y--; }
                else if (code == 1) { y--; }
                else { x--; }
            }
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------
// Banded glocal alignment to the template around a precomputed center
// path (k-mer anchored in Python). Same move semantics as
// initial_align_native (InitialAligner.c IntoAligner); values equal the
// full DP wherever the optimal path stays inside the band. centers is
// int32 [b, lmax], monotone nondecreasing per row, in [1, tlen].
extern "C" {

void initial_align_banded_native(const int8_t* tmpl, int64_t tlen,
                                 const int8_t* seqs,
                                 const int32_t* lengths,
                                 const int32_t* centers, int64_t b,
                                 int64_t lmax, int64_t band,
                                 int32_t* alignments /* [b, lmax] */,
                                 double* errors /* [b] */)
{
    const int32_t BIG = (int32_t)1 << 29;
    const int64_t hb = band / 2;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<int32_t> prev((size_t)band + 2), cur((size_t)band + 2);
        std::vector<int32_t> lo_v, hi_v;
        std::vector<uint8_t> codes;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int64_t r = 0; r < b; r++) {
            const int8_t* q = seqs + r * lmax;
            const int32_t* cen = centers + r * lmax;
            int32_t* out = alignments + r * lmax;
            int64_t lq = lengths[r];
            for (int64_t i = 0; i < lmax; i++) out[i] = -1;
            if (lq <= 0) {
                errors[r] = std::numeric_limits<double>::quiet_NaN();
                continue;
            }
            codes.resize((size_t)(lq * band));
            lo_v.resize(lq); hi_v.resize(lq);
            for (int64_t x = 0; x < lq; x++) {
                int64_t c0 = cen[x];
                int64_t lo = c0 - hb; if (lo < 1) lo = 1;
                int64_t hi = lo + band - 1; if (hi > tlen) hi = tlen;
                if (hi - band + 1 < lo && hi >= band) lo = hi - band + 1;
                lo_v[x] = (int32_t)lo; hi_v[x] = (int32_t)hi;
            }
            int64_t plo = 0;
            for (int64_t x = 0; x < lq; x++) {
                int64_t lo = lo_v[x], hi = hi_v[x];
                uint8_t* crow = codes.data() + (size_t)(x * band);
                int8_t qx = q[x];
                // prev row covers [plo, plo+band-1] (x>0)
                int32_t leftv;  // cur[j-1]
                for (int64_t j = lo; j <= hi; j++) {
                    int32_t diagv, upv;
                    if (x == 0) {
                        diagv = 0;           // M[-1][j-1] = 0
                        upv = BIG;           // no previous row value
                    } else {
                        int64_t t = j - 1 - plo;
                        diagv = (j - 1 == 0) ? (int32_t)x
                            : (t >= 0 && t < band ? prev[t] : BIG);
                        int64_t t0 = j - plo;
                        upv = (t0 >= 0 && t0 < band) ? prev[t0] : BIG;
                    }
                    leftv = (j == lo)
                        ? (j - 1 == 0 ? (int32_t)(x + 1) : BIG)
                        : cur[j - 1 - lo];
                    int m = (qx != tmpl[j - 1]);
                    int32_t e = diagv + m;
                    uint8_t code = m ? 0 : 3;
                    if (leftv + 1 < e) { e = leftv + 1; code = 1; }
                    if (upv + 1 < e) { e = upv + 1; code = 2; }
                    cur[j - lo] = e;
                    crow[j - lo] = code;
                }
                for (int64_t t = hi - lo + 1; t < band; t++)
                    cur[t] = BIG;
                std::swap(prev, cur);
                plo = lo;
            }
            // entry scan (reference: j = tlen .. 2 descending, strict <)
            int64_t llo = lo_v[lq - 1], lhi = hi_v[lq - 1];
            int64_t entry = tlen - 1;
            int32_t mn = BIG;
            if (lhi == tlen) { mn = prev[tlen - llo]; entry = tlen - 1; }
            for (int64_t j = lhi; j > 1; j--) {
                if (j < llo) break;
                if (prev[j - llo] < mn) { mn = prev[j - llo]; entry = j - 1; }
            }
            errors[r] = (double)mn / (double)lq;
            // backtrack within the band
            int64_t x = lq - 1, y = entry;
            while (x > -1 && y > -1) {
                int64_t lo = lo_v[x];
                int64_t t = y + 1 - lo;     // code index of column y+1...
                // codes are indexed by template col j = y+1 (1-based j)
                if (t < 0 || t >= band) break;  // left the band: stop
                uint8_t code = codes[(size_t)(x * band) + t];
                if (code == 0 || code == 3) { out[x] = (int32_t)y; x--; y--; }
                else if (code == 1) { y--; }
                else { x--; }
            }
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------
// Glocal last-DP-row of a template part vs a batch of reads
// (ReadCutter.c Occurrence fill). Rolling row, no traceback.
extern "C" {

void occurrence_rows_native(const int8_t* part, int64_t plen,
                            const int8_t* reads, const int32_t* rlens,
                            int64_t b, int64_t lmax,
                            int32_t* out /* [b, lmax] */)
{
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<int32_t> row((size_t)lmax + 1);
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int64_t r = 0; r < b; r++) {
            const int8_t* t = reads + r * lmax;
            int64_t n = rlens[r];
            int32_t* o = out + r * lmax;
            for (int64_t j = 0; j <= n; j++) row[j] = 0;
            for (int64_t x = 0; x < plen; x++) {
                int32_t diagv = (int32_t)x;
                row[0] = (int32_t)(x + 1);
                int8_t px = part[x];
                for (int64_t j = 1; j <= n; j++) {
                    int32_t e = diagv + (px != t[j - 1]);
                    if (row[j - 1] + 1 < e) e = row[j - 1] + 1;
                    if (row[j] + 1 < e) e = row[j] + 1;
                    diagv = row[j];
                    row[j] = e;
                }
            }
            for (int64_t j = 0; j < n; j++) o[j] = row[j + 1];
            for (int64_t j = n; j < lmax; j++) o[j] = 0;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------
// MaxCorrs bitset scan (MaxCorrelation.c threaded variant semantics,
// Parallel_AllMaxCorrsRechner :744-908).
//
// Re-architecture, not a port: the reference keeps per-(column,symbol)
// row bitsets and popcount loops over ceil(R/64) words. Here rows are
// pre-sorted by coverage start (the caller does this; per-column output
// is row-order invariant), which makes every column's coverage bitset a
// near-contiguous band of rows, so intersections only touch the
// overlap of two word ranges (~10-30 words at paper scale instead of
// ceil(R/64) ~ 217). Significance is the same log-space hypergeometric
// series as ops/hypergeom.py / tests/golden/gsl_shim.c, accelerated by
//   * integer-argument lgamma/log lookup tables (all series arguments
//     are integers <= R+2),
//   * a branch-and-bound max scan: q >= pmf(s) gives an upper bound on
//     Z = -log10 q, so pairs that cannot raise either group's running
//     max are skipped (skips never change the max, so values match the
//     dense-scan path); a Hoeffding/Chernoff lower bound proves Z > 98
//     for strongly-capped pairs, replacing the series by the 98+F1 cap
//     (MaxCorrelation.c:432) directly.
// Gates mirror models/maxcorr.py: seed size in (mincov/4, maxgroup)
// plus majority filter baseno > cov/2 (:798-802); partner size gate
// only (:817); partners at distance >= gap with a hard break at the
// first jj whose shared coverage < mincov (:804-810); sub-mode pairs
// score 0 in fast mode (identical cutoff decisions; ops/hypergeom.py
// positive_significance_fast).
#include <cmath>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace mcx {

struct Tables {
    std::vector<double> lg;   // lg[i] = lgamma(i + 1.0)  (log i!)
    std::vector<double> lnv;  // lnv[i] = log(i)
    explicit Tables(int64_t n) : lg(n + 3), lnv(n + 3) {
        lg[0] = 0.0;
        lnv[0] = -INFINITY;
        for (int64_t i = 1; i < (int64_t)lg.size(); i++) {
            lnv[i] = std::log((double)i);
            lg[i] = lg[i - 1] + lnv[i];
        }
    }
    inline double lbinom(int64_t n, int64_t k) const {
        if (k < 0 || k > n) return -INFINITY;
        return lg[n] - lg[k] - lg[n - k];
    }
    // log pmf of HG(j | K successes of N, n draws)
    inline double logpmf(int64_t j, int64_t K, int64_t n,
                         int64_t N) const {
        return lbinom(K, j) + lbinom(N - K, n - j) - lbinom(N, n);
    }
};

static const double LN10 = 2.302585092994045684;

// log of sum_{j=lo..hi} pmf(j | K, n, N); ratio recurrence with the
// same early exit as ops/hypergeom.py _series_logsum.
static double series_logsum(int64_t lo, int64_t hi, int64_t K,
                            int64_t n, int64_t N, const Tables& T)
{
    if (lo > hi) return -INFINITY;
    double l = T.logpmf(lo, K, n, N);
    double m = l, s = 1.0;
    for (int64_t j = lo; j + 1 <= hi; j++) {
        int64_t j1 = j + 1;
        int64_t d = N - K - n + j1;
        double logr = T.lnv[K - j] + T.lnv[n - j] - T.lnv[j1]
                      - (d >= 1 ? T.lnv[d] : std::log(1e-300));
        double l2 = l + logr;
        if (l2 > m) { s = s * std::exp(m - l2) + 1.0; m = l2; }
        else        { s += std::exp(l2 - m); }
        l = l2;
        if (l2 - m < -40.0 && logr < -1e-12) break;
    }
    return m + std::log(s);
}

// gsl_cdf_hypergeometric_Q(k; n1, n2, t) = P[X > k]
static double hyp_q(int64_t k, int64_t n1, int64_t n2, int64_t t,
                    const Tables& T)
{
    int64_t kmin = t - n2 > 0 ? t - n2 : 0;
    int64_t kmax = n1 < t ? n1 : t;
    int64_t lo = k + 1;
    if (lo <= kmin) return 1.0;
    if (lo > kmax) return 0.0;
    double ls = series_logsum(lo, kmax, n1, t, n1 + n2, T);
    double q = std::exp(ls);
    return q > 1.0 ? 1.0 : q;
}

// F_beta at beta=1 on raw group sizes (MaxCorrelation.c:396-411)
static inline double f1_cap(double s, double s1, double s2)
{
    double z = 2.0 * s;
    double denom = 2.0 * s + (s1 - s) + (s2 - s);
    return z < 0.0001 ? 0.0 : z / denom;
}

// PositiveSignificance (MaxCorrelation.c:421-434): exact value.
static double positive_significance(int64_t s, int64_t gr1, int64_t gr2,
                                    int64_t cov, int64_t size1,
                                    int64_t size2, const Tables& T)
{
    if (gr1 == 0 || gr2 == 0 || s < 1) return 0.0;
    double q = hyp_q(s - 1, gr2, cov - gr2, gr1, T);
    double z = q > 0.0 ? -std::log10(q) : INFINITY;
    if (std::isinf(z) || z > 99.0) z = 99.0;
    if (z > 98.0) z = 98.0 + f1_cap((double)s, (double)size1,
                                    (double)size2);
    return z;
}

static inline int64_t and_popcnt(const uint64_t* a, const uint64_t* b,
                                 int64_t lo, int64_t hi)
{
    int64_t s = 0;
    for (int64_t w = lo; w < hi; w++)
        s += __builtin_popcountll(a[w] & b[w]);
    return s;
}

}  // namespace mcx

extern "C" {

// msaT: [C, R] int8 column-major MSA (symbols 0..3 base, 4 '-', 5 ' '),
// rows pre-sorted by coverage start. Outputs: cov_bits u64[C, W],
// grp_bits u64[C, 5, W], sizes i32[C, 5], covcnt i32[C],
// wlo/whi i32[C] coverage word range. W = (R + 63) / 64.
void maxcorr_build(const int8_t* msaT, int64_t C, int64_t R,
                   uint64_t* cov_bits, uint64_t* grp_bits,
                   int32_t* sizes, int32_t* covcnt,
                   int32_t* wlo, int32_t* whi)
{
    int64_t W = (R + 63) / 64;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (int64_t c = 0; c < C; c++) {
        const int8_t* col = msaT + c * R;
        uint64_t* cv = cov_bits + c * W;
        uint64_t* gp = grp_bits + c * 5 * W;
        int32_t* sz = sizes + c * 5;
        int64_t cnt = 0;
        int64_t lo = W, hi = 0;
        for (int64_t r = 0; r < R; r++) {
            int8_t v = col[r];
            if (v >= 5) continue;
            int64_t w = r >> 6;
            uint64_t bit = 1ULL << (r & 63);
            cv[w] |= bit;
            gp[(int64_t)v * W + w] |= bit;
            sz[v]++;
            cnt++;
            if (w < lo) lo = w;
            if (w + 1 > hi) hi = w + 1;
        }
        covcnt[c] = (int32_t)cnt;
        wlo[c] = (int32_t)(lo < hi ? lo : 0);
        whi[c] = (int32_t)(lo < hi ? hi : 0);
    }
}

// Branch-and-bound max scan over seed columns [s0, s1). maxcorrs
// (f64[C*5]) is in/out: previously accumulated maxes both seed further
// skipping and stay in the running max (resumable chunking).
void maxcorr_scan(const uint64_t* cov_bits, const uint64_t* grp_bits,
                  const int32_t* sizes, const int32_t* covcnt,
                  const int32_t* wlo, const int32_t* whi,
                  int64_t C, int64_t R, int64_t s0, int64_t s1,
                  int64_t mincov, int64_t gap, int64_t maxgroup,
                  int64_t majority, int64_t fastmode, int64_t nthreads,
                  double* maxcorrs)
{
    int64_t W = (R + 63) / 64;
    static mcx::Tables* tables = nullptr;
    static int64_t tables_n = -1;
    if (tables == nullptr || tables_n < R + 2) {
        delete tables;
        tables = new mcx::Tables(R + 2);
        tables_n = R + 2;
    }
    const mcx::Tables& T = *tables;

    // seed/partner gates (models/maxcorr.py compute_maxcorrs)
    std::vector<uint8_t> seed_ok((size_t)C * 5), part_ok((size_t)C * 5);
    std::vector<uint8_t> seed_any((size_t)C);
    for (int64_t c = 0; c < C; c++) {
        int64_t baseno = 0;
        for (int s = 0; s < 4; s++) baseno += sizes[c * 5 + s];
        uint8_t any = 0;
        for (int s = 0; s < 5; s++) {
            int64_t sz = sizes[c * 5 + s];
            uint8_t ok = (sz > mincov / 4) && (sz < maxgroup);
            part_ok[c * 5 + s] = ok;
            uint8_t sd = ok && (!majority || baseno > covcnt[c] / 2);
            seed_ok[c * 5 + s] = sd;
            any |= sd;
        }
        seed_any[c] = any;
    }

#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads((int)nthreads);
#pragma omp parallel
#endif
    {
        std::vector<double> local((size_t)C * 5, 0.0);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 8)
#endif
        for (int64_t ii = s0; ii < s1; ii++) {
            if (!seed_any[ii]) continue;
            const uint64_t* ci = cov_bits + ii * W;
            const uint64_t* gi = grp_bits + ii * 5 * W;
            int64_t ilo = wlo[ii], ihi = whi[ii];
            for (int64_t jj = ii + gap; jj < C; jj++) {
                int64_t lo = ilo > wlo[jj] ? ilo : wlo[jj];
                int64_t hi = ihi < whi[jj] ? ihi : whi[jj];
                const uint64_t* cj = cov_bits + jj * W;
                int64_t cov = lo < hi
                    ? mcx::and_popcnt(ci, cj, lo, hi) : 0;
                if (cov < mincov) break;
                const uint64_t* gj = grp_bits + jj * 5 * W;
                // gr1[k] = |G_ii,k ∩ Cov_jj|, gr2[kk] = |Cov_ii ∩ G_jj,kk|
                int64_t gr1[5], gr2[5];
                for (int k = 0; k < 5; k++) {
                    gr1[k] = seed_ok[ii * 5 + k]
                        ? mcx::and_popcnt(gi + k * W, cj, lo, hi) : 0;
                    gr2[k] = part_ok[jj * 5 + k]
                        ? mcx::and_popcnt(ci, gj + k * W, lo, hi) : 0;
                }
                for (int k = 0; k < 5; k++) {
                    if (!seed_ok[ii * 5 + k]) continue;
                    int64_t g1 = gr1[k];
                    if (g1 == 0) continue;
                    double* mi = &local[ii * 5 + k];
                    double cur_i = maxcorrs[ii * 5 + k] > *mi
                        ? maxcorrs[ii * 5 + k] : *mi;
                    for (int kk = 0; kk < 5; kk++) {
                        if (!part_ok[jj * 5 + kk]) continue;
                        int64_t g2 = gr2[kk];
                        if (g2 == 0) continue;
                        int64_t s = mcx::and_popcnt(gi + k * W,
                                                    gj + kk * W, lo, hi);
                        if (s < 1) continue;
                        if (fastmode) {
                            double mode = (double)(g1 + 1)
                                * (double)(g2 + 1) / (double)(cov + 2);
                            if (!((double)s > mode)) continue;
                        }
                        double* mj = &local[jj * 5 + kk];
                        double cur_j = maxcorrs[jj * 5 + kk] > *mj
                            ? maxcorrs[jj * 5 + kk] : *mj;
                        double cur = cur_i < cur_j ? cur_i : cur_j;
                        int64_t sz1 = sizes[ii * 5 + k];
                        int64_t sz2 = sizes[jj * 5 + kk];
                        // upper bound: q >= pmf(s) -> Z <= -log10 pmf
                        double zub = -T.logpmf(s, g2, g1, cov)
                                     / mcx::LN10;
                        double cap = 98.0
                            + mcx::f1_cap((double)s, (double)sz1,
                                          (double)sz2);
                        double cand = zub > 98.0 ? cap : zub;
                        if (cand <= cur) continue;
                        double z;
                        // Chernoff/Hoeffding: q <= exp(-g1*KL(a||b))
                        // -> Z >= zlb; zlb > 98.5 proves the cap.
                        double a = (double)s / (double)g1;
                        double b = (double)g2 / (double)cov;
                        double zlb = -1.0;
                        if (a > b && b > 0.0) {
                            double kl = a * std::log(a / b)
                                + (a < 1.0
                                   ? (1.0 - a) * std::log((1.0 - a)
                                                          / (1.0 - b))
                                   : 0.0);
                            zlb = (double)g1 * kl / mcx::LN10;
                        }
                        if (zlb > 98.5) z = cap;
                        else z = mcx::positive_significance(
                                s, g1, g2, cov, sz1, sz2, T);
                        if (z > *mi) *mi = z;
                        if (z > *mj) *mj = z;
                        cur_i = maxcorrs[ii * 5 + k] > *mi
                            ? maxcorrs[ii * 5 + k] : *mi;
                    }
                }
            }
        }
#ifdef _OPENMP
#pragma omp critical
#endif
        {
            for (int64_t g = 0; g < C * 5; g++)
                if (local[g] > maxcorrs[g]) maxcorrs[g] = local[g];
        }
    }
}

}  // extern "C"
