/* Bulk .base.gz row formatter for screen-resolved ("easy") sites.
 *
 * The reference caller prints one .base row per site
 * (pecaller.c:1675-1714 write path; format "\n%s\t%d\t%c" then
 * "\t%c\t%g" per sample).  For sites resolved by the device screen the
 * per-sample posterior is exactly 1.0 (prints as "1"), so rows reduce to
 * fixed fragments + a decimal position + per-sample call characters —
 * formatted here at C speed instead of per-row Python.
 */

#include <stdint.h>
#include <stdio.h>
#include <string.h>

static const char INT_TO_GEN[16] = "ACGTDIMRWSYKEHN?";

/* Write rows for sites [0, n) into out; returns bytes written, or -1 if
 * out_cap would overflow.  calls: (n, indiv) int8 genotype ints (14=N);
 * active: (n, indiv) uint8 (0 -> force "N\t1"). */
int64_t format_base_rows(const char *frag, int64_t frag_len,
                         const int64_t *pos, const uint8_t *refc,
                         const int8_t *calls, const uint8_t *active,
                         int64_t n, int32_t indiv,
                         char *out, int64_t out_cap)
{
    char *p = out;
    char *end = out + out_cap;
    for (int64_t s = 0; s < n; s++) {
        /* worst case: 1 + frag + 1 + 20 + 2 + indiv*4 */
        if (p + 24 + frag_len + (int64_t)indiv * 4 > end)
            return -1;
        *p++ = '\n';
        memcpy(p, frag, frag_len);
        p += frag_len;
        *p++ = '\t';
        {
            char tmp[20];
            int k = 0;
            int64_t v = pos[s];
            if (v <= 0) {
                *p++ = '0';      /* positions are >= 1 in practice */
            } else {
                while (v > 0) { tmp[k++] = (char)('0' + v % 10); v /= 10; }
                while (k > 0) *p++ = tmp[--k];
            }
        }
        *p++ = '\t';
        *p++ = (char)refc[s];
        const int8_t *cr = calls + s * indiv;
        const uint8_t *ar = active + s * indiv;
        for (int32_t i = 0; i < indiv; i++) {
            *p++ = '\t';
            *p++ = ar[i] ? INT_TO_GEN[cr[i] & 15] : 'N';
            *p++ = '\t';
            *p++ = '1';
        }
    }
    return (int64_t)(p - out);
}

/* Format MANY fast runs in one call (the per-window fast rows are
 * fragmented into thousands of runs by interleaved variant sites; one
 * ctypes round-trip per run was the caller write phase's hot spot).
 * frags: concatenated fragment names with frag_off offsets;
 * run_start/run_end index rows of the gathered pos/refc/calls/active
 * arrays; run_out_off (n_runs+1) receives each run's byte offset in
 * out.  Returns total bytes, or -1 on overflow. */
int64_t format_base_runs(const char *frags, const int64_t *frag_off,
                         const int32_t *frag_of_run,
                         const int64_t *run_start, const int64_t *run_end,
                         int64_t n_runs, const int64_t *pos,
                         const uint8_t *refc, const int8_t *calls,
                         const uint8_t *active, int32_t indiv,
                         char *out, int64_t out_cap,
                         int64_t *run_out_off)
{
    int64_t total = 0;
    for (int64_t r = 0; r < n_runs; r++) {
        run_out_off[r] = total;
        int32_t f = frag_of_run[r];
        int64_t flen = frag_off[f + 1] - frag_off[f];
        int64_t a = run_start[r], b = run_end[r];
        int64_t wrote = format_base_rows(
            frags + frag_off[f], flen, pos + a, refc + a,
            calls + a * indiv, active + a * indiv, b - a, indiv,
            out + total, out_cap - total);
        if (wrote < 0)
            return -1;
        total += wrote;
    }
    run_out_off[n_runs] = total;
    return total;
}

static const char *SNP_TYPE_NAME[7] = {
    "", "SNP", "DEL", "INS", "LOW", "MULTIALLELIC", "MESS"};
static const char ALLELE_CHAR[6] = "ACGTDI";

static char *put_i64(char *p, int64_t v)
{
    char tmp[20];
    int k = 0;
    if (v <= 0) {
        if (v == 0) { *p++ = '0'; return p; }
        *p++ = '-';
        v = -v;
    }
    while (v > 0) { tmp[k++] = (char)('0' + v % 10); v /= 10; }
    while (k > 0) *p++ = tmp[--k];
    return p;
}

/* Format the window's slow (variant / non-unit-posterior) rows: the
 * .base row per site plus, for typed sites, the .snp and .piles rows
 * (pecaller.c:1675-1714 write path).  Posteriors print with printf
 * "%g" — the same formatter the reference uses.  base_off (n+1) gives
 * per-row offsets so the caller can interleave base spans with the
 * fast runs.  Returns 0, or -1 if any buffer would overflow. */
int64_t format_slow_rows(const char *frags, const int64_t *frag_off,
                         const int32_t *which, const int64_t *pos,
                         const uint8_t *refc, const uint16_t *data,
                         const int8_t *calls, const double *probs,
                         const uint8_t *types, const int32_t *denovo,
                         const int32_t *acnt, const uint8_t *active,
                         int64_t n, int32_t indiv, int32_t use_ped,
                         char *base_out, int64_t base_cap,
                         int64_t *base_off,
                         char *snp_out, int64_t snp_cap,
                         char *pile_out, int64_t pile_cap,
                         int64_t *out_sizes)
{
    char *bp = base_out, *bend = base_out + base_cap;
    char *sp = snp_out, *send = snp_out + snp_cap;
    char *pp = pile_out, *pend = pile_out + pile_cap;
    for (int64_t s = 0; s < n; s++) {
        base_off[s] = bp - base_out;
        int32_t f = which[s];
        int64_t flen = frag_off[f + 1] - frag_off[f];
        if (bp + flen + 24 + (int64_t)indiv * 16 > bend)
            return -1;
        *bp++ = '\n';
        memcpy(bp, frags + frag_off[f], flen);
        bp += flen;
        *bp++ = '\t';
        bp = put_i64(bp, pos[s]);
        *bp++ = '\t';
        *bp++ = (char)refc[s];
        const int8_t *cr = calls + s * indiv;
        const double *pr = probs + s * indiv;
        const uint8_t *ar = active + s * indiv;
        for (int32_t i = 0; i < indiv; i++) {
            *bp++ = '\t';
            if (ar[i]) {
                *bp++ = INT_TO_GEN[cr[i] & 15];
                *bp++ = '\t';
                bp += snprintf(bp, 32, "%g", pr[i]);
            } else {
                *bp++ = 'N';
                *bp++ = '\t';
                *bp++ = '1';
            }
        }
        int t = types[s];
        if (t != 0) {
            const int32_t *ac = acnt + s * 6;
            if (sp + flen + 160 + (int64_t)indiv * 16 > send ||
                pp + flen + 24 + (int64_t)indiv * 40 > pend)
                return -1;
            *sp++ = '\n';
            memcpy(sp, frags + frag_off[f], flen);
            sp += flen;
            *sp++ = '\t';
            sp = put_i64(sp, pos[s]);
            *sp++ = '\t';
            *sp++ = (char)refc[s];
            *sp++ = '\t';
            int firstc = 1;
            for (int k = 0; k < 6; k++)
                if (ac[k] > 0) {
                    if (!firstc)
                        *sp++ = ',';
                    firstc = 0;
                    *sp++ = ALLELE_CHAR[k];
                }
            *sp++ = '\t';
            firstc = 1;
            for (int k = 0; k < 6; k++)
                if (ac[k] > 0) {
                    if (!firstc)
                        *sp++ = ',';
                    firstc = 0;
                    sp = put_i64(sp, ac[k]);
                }
            *sp++ = '\t';
            if (use_ped && denovo[s] > 0) {
                memcpy(sp, "DENOVO_", 7);
                sp += 7;
            }
            {
                const char *tn = SNP_TYPE_NAME[t];
                size_t tl = strlen(tn);
                memcpy(sp, tn, tl);
                sp += tl;
            }
            *pp++ = '\n';
            memcpy(pp, frags + frag_off[f], flen);
            pp += flen;
            *pp++ = '\t';
            pp = put_i64(pp, pos[s]);
            *pp++ = '\t';
            *pp++ = (char)refc[s];
            const uint16_t *dr = data + s * indiv * 6;
            for (int32_t i = 0; i < indiv; i++) {
                *sp++ = '\t';
                *sp++ = INT_TO_GEN[cr[i] & 15];
                *sp++ = '\t';
                sp += snprintf(sp, 32, "%g", pr[i]);
                for (int k = 0; k < 6; k++) {
                    *pp++ = '\t';
                    pp = put_i64(pp, dr[i * 6 + k]);
                }
            }
        }
    }
    base_off[n] = bp - base_out;
    out_sizes[0] = sp - snp_out;
    out_sizes[1] = pp - pile_out;
    return 0;
}
