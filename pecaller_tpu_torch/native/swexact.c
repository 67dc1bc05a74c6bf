/* Exact affine-gap glocal Smith-Waterman, float64, matching the reference
 * mapper's DP bit-for-bit (recurrences per pemapper.c:1694-1748, boundary
 * conditions per init_penalty_matrices :2050-2095, backtrack semantics per
 * :1752-1965).  This is the parity/oracle engine; the TPU int32 kernel in
 * ops/sw.py is the production path.
 *
 * Written from the algorithm spec, not copied: plane 0 = diagonal,
 * plane 1 = vertical (ref gap / deletion), plane 2 = horizontal
 * (read gap / insertion); score match +1, mismatch -1/3, 'N' matches all,
 * open 2.0, extend 1/36; best cell over the LAST read column only.
 */

#include <stdlib.h>
#include <string.h>
#include <stdint.h>
#include <pthread.h>

#define MAXN 1024

typedef struct {
    const uint8_t *refs; const int32_t *ref_lens; int32_t ref_stride;
    const uint8_t *reads; const int32_t *read_lens; int32_t read_stride;
    int64_t n; int bisulfite;
    double *scores; int32_t *out_k; int32_t *out_i;
    /* backtrack mode */
    int do_backtrack;
    const int32_t *bt_k; const int32_t *bt_i;
    const int64_t *pos0;          /* seq-coord of window row 0, per align */
    uint16_t *pileup;             /* (nthreads, genome_size, 6) slabs */
    int64_t genome_size;
    int32_t *ins_buf;             /* records: (align, gpos, jstart, len) */
    int64_t ins_cap; int64_t *ins_count;
    pthread_mutex_t *lock;
    int nthreads;
} job_t;

typedef struct { job_t *job; int tid; } arg_t;

static double match_score(const job_t *jb, uint8_t r, uint8_t q)
{
    if (r == q) return 1.0;
    if (r == 'N' || r == 'n' || q == 'N' || q == 'n') return 1.0;
    if (jb->bisulfite && (r == 'C' || r == 'c') && (q == 'T' || q == 't'))
        return 1.0;
    return -1.0 / 3.0;
}

static void dp_fill(const job_t *jb, const uint8_t *ref, int nn,
                    const uint8_t *read, int mm,
                    double *S0, double *S1, double *S2, int W)
{
    const double open = 2.0, ext = 1.0 / 36.0;
    int i, j;
    S0[0] = 0.0; S1[0] = 0.0; S2[0] = -open;
    for (j = 1; j <= mm; j++) {
        double b = -(open + (double)(j - 1) * ext);
        S0[j] = b; S1[j] = b; S2[j] = b;
    }
    for (i = 1; i <= nn; i++) {
        double *p0 = S0 + (size_t)(i - 1) * W, *c0 = S0 + (size_t)i * W;
        double *p1 = S1 + (size_t)(i - 1) * W, *c1 = S1 + (size_t)i * W;
        double *p2 = S2 + (size_t)(i - 1) * W, *c2 = S2 + (size_t)i * W;
        c0[0] = 0.0; c1[0] = 0.0; c2[0] = -open;
        uint8_t rb = ref[i - 1];
        for (j = 1; j <= mm; j++) {
            double h = c0[j - 1] - open;
            double h2 = c2[j - 1] - ext;
            c2[j] = h > h2 ? h : h2;
            double v = p0[j] - open;
            double v2 = p1[j] - ext;
            c1[j] = v > v2 ? v : v2;
            double bump = match_score(jb, rb, read[j - 1]);
            double a = p0[j - 1] + bump, b = p1[j - 1] + bump,
                   c = p2[j - 1] + bump;
            double m = a > b ? a : b;
            c0[j] = m > c ? m : c;
        }
    }
}

static void align_one(job_t *jb, int64_t idx, double *S0, double *S1,
                      double *S2, int32_t *local_ins, int64_t *local_ins_n,
                      int64_t local_cap, uint16_t *pile_slab)
{
    int nn = jb->ref_lens[idx], mm = jb->read_lens[idx];
    const uint8_t *ref = jb->refs + (size_t)idx * jb->ref_stride;
    const uint8_t *read = jb->reads + (size_t)idx * jb->read_stride;
    const int W = mm + 1;
    const double open = 2.0, ext = 1.0 / 36.0;
    if (nn < 0) nn = 0;   /* clipped-away window: boundary score, like ref */
    if (nn > MAXN - 1 || mm > MAXN - 1 || mm < 1) {
        if (jb->scores) jb->scores[idx] = -1e300;
        return;
    }
    dp_fill(jb, ref, nn, read, mm, S0, S1, S2, W);

    if (!jb->do_backtrack) {
        /* glocal max over last column, i = 1..nn, plane priority by
         * strict >, seeded with S0[0][mm] (the boundary cell) */
        int maxk = 0, maxi = 0;
        double best = S0[mm];
        for (int i = 1; i <= nn; i++) {
            double v0 = S0[(size_t)i * W + mm];
            if (v0 > best) { best = v0; maxk = 0; maxi = i; }
            double v1 = S1[(size_t)i * W + mm];
            if (v1 > best) { best = v1; maxk = 1; maxi = i; }
            double v2 = S2[(size_t)i * W + mm];
            if (v2 > best) { best = v2; maxk = 2; maxi = i; }
        }
        jb->scores[idx] = best;
        jb->out_k[idx] = maxk;
        jb->out_i[idx] = maxi;
        return;
    }

    /* backtrack from the caller-provided (k, i, mm) */
    int k = jb->bt_k[idx], i = jb->bt_i[idx], j = mm;
    int ins_len = 0;
    int i1 = 0, j1 = 0;
    int64_t p0 = jb->pos0[idx];
    double *P[3] = { S0, S1, S2 };
    while (i > 0 && j > 0) {
        i1 = i - 1; j1 = j - 1;
        int maxk, maxi, maxj;
        if (k == 0) {
            maxi = i1; maxj = j1; maxk = 0;
            double smax = S0[(size_t)maxi * W + maxj];
            if (S1[(size_t)maxi * W + maxj] > smax) {
                maxk = 1; smax = S1[(size_t)maxi * W + maxj];
            }
            if (S2[(size_t)maxi * W + maxj] > smax) maxk = 2;
        } else if (k == 2) {
            maxk = 0; maxi = i; maxj = j1;
            double smax = S0[(size_t)maxi * W + maxj] - open;
            if (S2[(size_t)maxi * W + maxj] - ext > smax) maxk = 2;
        } else {
            maxk = 0; maxi = i1; maxj = j;
            double smax = S0[(size_t)maxi * W + maxj] - open;
            if (S1[(size_t)maxi * W + maxj] - ext > smax) maxk = 1;
        }
        if (maxi != i) {
            int64_t g = p0 + i1;
            if (g >= 0 && g < jb->genome_size) {
                uint16_t *row = pile_slab + (size_t)g * 6;
                if (maxj != j) {
                    uint8_t q = read[j1];
                    if (q == 'A') row[0]++;
                    else if (q == 'T') row[3]++;
                    else if (q == 'G') row[2]++;
                    else if (q == 'C') row[1]++;
                } else {
                    row[4]++;
                }
                if (ins_len > 0) {
                    row[5]++;
                    if (*local_ins_n < local_cap) {
                        int32_t *r = local_ins + (*local_ins_n) * 4;
                        r[0] = (int32_t)idx; r[1] = (int32_t)(uint32_t)g;
                        r[2] = j; r[3] = ins_len;
                        (*local_ins_n)++;
                    }
                }
            }
            ins_len = 0;
        } else {
            ins_len++;
        }
        i = maxi; j = maxj; k = maxk;
    }
    if (ins_len > 0 && i >= 1) {
        int64_t g = p0 + i1;
        if (g >= 0 && g < jb->genome_size) {
            pile_slab[(size_t)g * 6 + 5]++;
            if (*local_ins_n < local_cap) {
                int32_t *r = local_ins + (*local_ins_n) * 4;
                r[0] = (int32_t)idx; r[1] = (int32_t)(uint32_t)g;
                r[2] = j; r[3] = ins_len;
                (*local_ins_n)++;
            }
        }
    }
    (void)P;
}

static void *worker(void *argp)
{
    arg_t *a = (arg_t *)argp;
    job_t *jb = a->job;
    size_t plane = (size_t)MAXN * MAXN;
    double *S0 = malloc(plane * sizeof(double));
    double *S1 = malloc(plane * sizeof(double));
    double *S2 = malloc(plane * sizeof(double));
    int64_t local_cap = 4096, local_n = 0;
    int32_t *local_ins = malloc((size_t)local_cap * 4 * sizeof(int32_t));
    if (!S0 || !S1 || !S2 || !local_ins) return NULL;
    uint16_t *pile_slab = jb->pileup
        ? jb->pileup + (size_t)a->tid * (size_t)jb->genome_size * 6 : NULL;
    for (int64_t idx = a->tid; idx < jb->n; idx += jb->nthreads) {
        align_one(jb, idx, S0, S1, S2, local_ins, &local_n, local_cap,
                  pile_slab);
        if (local_n > local_cap - 64) {
            pthread_mutex_lock(jb->lock);
            int64_t take = local_n;
            if (*jb->ins_count + take > jb->ins_cap)
                take = jb->ins_cap - *jb->ins_count;
            memcpy(jb->ins_buf + *jb->ins_count * 4, local_ins,
                   (size_t)take * 4 * sizeof(int32_t));
            *jb->ins_count += take;
            pthread_mutex_unlock(jb->lock);
            local_n = 0;
        }
    }
    if (jb->do_backtrack && local_n > 0) {
        pthread_mutex_lock(jb->lock);
        int64_t take = local_n;
        if (*jb->ins_count + take > jb->ins_cap)
            take = jb->ins_cap - *jb->ins_count;
        memcpy(jb->ins_buf + *jb->ins_count * 4, local_ins,
               (size_t)take * 4 * sizeof(int32_t));
        *jb->ins_count += take;
        pthread_mutex_unlock(jb->lock);
    }
    free(S0); free(S1); free(S2); free(local_ins);
    return NULL;
}

static void run_job(job_t *jb)
{
    int nt = jb->nthreads;
    if (nt < 1) nt = 1;
    pthread_t th[64];
    arg_t args[64];
    if (nt > 64) nt = 64;
    jb->nthreads = nt;
    for (int t = 0; t < nt; t++) {
        args[t].job = jb; args[t].tid = t;
        pthread_create(&th[t], NULL, worker, &args[t]);
    }
    for (int t = 0; t < nt; t++) pthread_join(th[t], NULL);
}

void sw_align_batch(const uint8_t *refs, const int32_t *ref_lens,
                    int32_t ref_stride, const uint8_t *reads,
                    const int32_t *read_lens, int32_t read_stride,
                    int64_t n, int bisulfite, int nthreads,
                    double *scores, int32_t *out_k, int32_t *out_i)
{
    job_t jb;
    memset(&jb, 0, sizeof(jb));
    jb.refs = refs; jb.ref_lens = ref_lens; jb.ref_stride = ref_stride;
    jb.reads = reads; jb.read_lens = read_lens; jb.read_stride = read_stride;
    jb.n = n; jb.bisulfite = bisulfite; jb.nthreads = nthreads;
    jb.scores = scores; jb.out_k = out_k; jb.out_i = out_i;
    jb.do_backtrack = 0;
    run_job(&jb);
}

void sw_backtrack_batch(const uint8_t *refs, const int32_t *ref_lens,
                        int32_t ref_stride, const uint8_t *reads,
                        const int32_t *read_lens, int32_t read_stride,
                        int64_t n, int bisulfite, int nthreads,
                        const int32_t *bt_k, const int32_t *bt_i,
                        const int64_t *pos0, uint16_t *pileup,
                        int64_t genome_size, int32_t *ins_buf,
                        int64_t ins_cap, int64_t *ins_count)
{
    job_t jb;
    pthread_mutex_t lock = PTHREAD_MUTEX_INITIALIZER;
    memset(&jb, 0, sizeof(jb));
    jb.refs = refs; jb.ref_lens = ref_lens; jb.ref_stride = ref_stride;
    jb.reads = reads; jb.read_lens = read_lens; jb.read_stride = read_stride;
    jb.n = n; jb.bisulfite = bisulfite; jb.nthreads = nthreads;
    jb.do_backtrack = 1;
    jb.bt_k = bt_k; jb.bt_i = bt_i; jb.pos0 = pos0;
    jb.pileup = pileup; jb.genome_size = genome_size;
    jb.ins_buf = ins_buf; jb.ins_cap = ins_cap; jb.ins_count = ins_count;
    jb.lock = &lock;
    *ins_count = 0;
    run_job(&jb);
}
