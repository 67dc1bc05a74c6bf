/* Exact mapping-decision layer: the reference's find_mate_pairs selection
 * logic (pemapper.c:1313-1536) and the single-end best-hit scan
 * (:1084-1174), re-implemented from the spec over precomputed SW scores.
 *
 * Notable reproduced quirks:
 *  - tot_best hysteresis (resets only on > 0.001 improvements);
 *  - slip_count counting on ~equal pairs sharing an end;
 *  - the no-perfect fallback's use of smax2[best1] (reference bug at
 *    pemapper.c:1468) — kept bit-for-bit, with smax arrays padded to
 *    max_hits+1 entries of -1.0 exactly like the reference's dvectors.
 */

#include <stdint.h>
#include <math.h>

/* exit codes (pemapper.c:37-45) */
#define UNIQUE_MATE 0
#define UNIQUE_SLIP 1
#define UNIQUE_SINGLE 2
#define UNIQUE_MIS 3
#define NON_MATE 4
#define NON_MIS 5
#define NON_NO 7
#define NEITHER_MAP 8

/* Single-end scan over one read's hits.  Returns exit code; *best = index,
 * *use = whether to backtrack. */
static int single_scan(const double *smax, int n, double good_score,
                       double len_d, int32_t *best, int32_t *use)
{
    double top_score = -2.0 * len_d;
    int top_count = 0;
    uint32_t bsm = 0;
    for (int i = 0; i < n; i++) {
        double s = smax[i];
        if (s > top_score && s >= good_score) {
            top_score = s;
            top_count = 1;
            bsm = i;
        } else if ((fabs(s - top_score) < 0.0001) && (top_count > 0)) {
            top_count++;
        }
    }
    if (top_count == 0) { *use = 0; *best = 0; return NEITHER_MAP; }
    if (top_count == 1) { *use = 1; *best = (int32_t)bsm; return UNIQUE_SINGLE; }
    *use = 0; *best = 0;
    return NON_NO;
}

/* Paired decision for one read pair.  smax1/smax2 are padded to
 * (max_hits+1) with -1.0 beyond n1/n2. */
static int mate_decide(const double *smax1, const uint32_t *pos1,
                       const int8_t *or1, int n1, double good1,
                       const double *smax2, const uint32_t *pos2,
                       const int8_t *or2, int n2, double good2,
                       int max_dist, int min_dist,
                       int32_t *best1_out, int32_t *best2_out,
                       int32_t *use1, int32_t *use2)
{
    int perfect = 0, slip_count = 0;
    double tot_best = -1e5;
    uint32_t sm1 = 0, sm2 = 0;
    *use1 = *use2 = 0;

    if (n1 > 12000 || n2 > 12000) return NON_MIS;

    for (int w1 = 0; w1 < n1; w1++) {
        if (smax1[w1] < good1) continue;
        for (int w2 = 0; w2 < n2; w2++) {
            if (smax2[w2] < good2) continue;
            long temp_dist = labs((long)pos1[w1] - (long)pos2[w2]);
            int is_perfect = (temp_dist >= min_dist &&
                              temp_dist <= max_dist && or1[w1] != or2[w2]);
            if (!is_perfect) continue;
            double inc = smax1[w1] + smax2[w2] - tot_best;
            if (inc > 0.001) {
                perfect = 1;
                sm1 = w1; sm2 = w2;
                tot_best = smax1[w1] + smax2[w2];
                slip_count = 1;
            } else if (inc > -0.001) {
                if (sm1 == (uint32_t)w1 || sm2 == (uint32_t)w2)
                    slip_count++;
                perfect++;
            }
        }
    }

    if (perfect > 0) {
        *best1_out = (int32_t)sm1;
        *best2_out = (int32_t)sm2;
        if (perfect == 1) { *use1 = *use2 = 1; return UNIQUE_MATE; }
        if (slip_count == perfect) { *use1 = *use2 = 1; return UNIQUE_SLIP; }
        return NON_MATE;
    }

    int best1 = 0, best2 = 0, m1_c = 0, m2_c = 0;
    for (int i = 1; i < n1; i++) {
        if (smax1[i] > smax1[best1]) { best1 = i; m1_c = 1; }
        else if (smax1[i] - smax1[best1] > -0.0001) m1_c++;
    }
    for (int i = 1; i < n2; i++) {
        if (smax2[i] > smax2[best2]) { best2 = i; m2_c = 1; }
        else if (smax2[i] - smax2[best1] > -0.0001) m2_c++;  /* ref quirk */
    }
    *best1_out = best1;
    *best2_out = best2;

    if (smax1[best1] >= good1) {
        if (m1_c < 2) {
            *use1 = 1;
            if (smax2[best2] >= good2 && m2_c < 2) {
                *use2 = 1;
                return UNIQUE_MIS;
            }
            return UNIQUE_SINGLE;
        }
        if (smax2[best2] >= good2 && m2_c < 2) {
            *use2 = 1;
            return UNIQUE_SINGLE;
        }
        return NON_MIS;
    }
    if (smax2[best2] >= good2 && m2_c < 2) {
        *use2 = 1;
        return UNIQUE_SINGLE;
    }
    return NON_MIS;
}

/* Batched drivers -------------------------------------------------------- */

void decide_single_batch(const double *smax, const int32_t *nh,
                         const int32_t *lens, double min_align,
                         int32_t stride, int64_t n_reads,
                         int32_t *code, int32_t *best, int32_t *use)
{
    for (int64_t r = 0; r < n_reads; r++) {
        double len_d = (double)lens[r];
        double good = len_d * min_align * 1.0;
        code[r] = single_scan(smax + r * stride, nh[r], good, len_d,
                              &best[r], &use[r]);
    }
}

void decide_pair_batch(const double *smax1, const uint32_t *pos1,
                       const int8_t *or1, const int32_t *nh1,
                       const int32_t *len1,
                       const double *smax2, const uint32_t *pos2,
                       const int8_t *or2, const int32_t *nh2,
                       const int32_t *len2,
                       double min_align, int max_dist, int min_dist,
                       int32_t stride, int64_t n_reads,
                       int32_t *code, int32_t *best1, int32_t *best2,
                       int32_t *use1, int32_t *use2)
{
    for (int64_t r = 0; r < n_reads; r++) {
        int n1 = nh1[r], n2 = nh2[r];
        int32_t c;
        if (n1 > 0 && n2 == 0) {
            double len_d = (double)len1[r];
            c = single_scan(smax1 + r * stride, n1,
                            len_d * min_align * 1.0, len_d,
                            &best1[r], &use1[r]);
            best2[r] = 0; use2[r] = 0;
        } else if (n2 > 0 && n1 == 0) {
            double len_d = (double)len2[r];
            c = single_scan(smax2 + r * stride, n2,
                            len_d * min_align * 1.0, len_d,
                            &best2[r], &use2[r]);
            best1[r] = 0; use1[r] = 0;
        } else if (n1 > 0 && n2 > 0) {
            double l1 = (double)len1[r], l2 = (double)len2[r];
            c = mate_decide(smax1 + r * stride, pos1 + r * stride,
                            or1 + r * stride, n1, l1 * min_align * 1.0,
                            smax2 + r * stride, pos2 + r * stride,
                            or2 + r * stride, n2, l2 * min_align * 1.0,
                            max_dist, min_dist,
                            &best1[r], &best2[r], &use1[r], &use2[r]);
        } else {
            c = NEITHER_MAP;
            best1[r] = best2[r] = 0;
            use1[r] = use2[r] = 0;
        }
        code[r] = c;
    }
}
