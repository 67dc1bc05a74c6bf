/* Exact multi-sample empirical-Bayes base caller: the reference pecaller's
 * per-site model (call_single_base, pecaller.c:1149-1749 and helpers
 * :2076-3214), re-implemented from the spec for bit-identical results.
 *
 * Model per site: Dirichlet-multinomial genotype likelihoods over
 * max_gen in {6,14} genotypes x 6 alleles, joint-configuration beam search
 * across samples (theta / exact-Hardy-Weinberg / de-novo priors, prune at
 * 2.3 log-units, beam 514, forced-homozygote injection), and up to 5 EM
 * passes re-estimating the Dirichlet alpha matrix by method of moments
 * with the reference's sanity clamps.
 *
 * The host (Python) streams merged pileup sites in; this engine returns
 * per-sample calls/posteriors and site classification data.
 */

#include <stdlib.h>
#include <string.h>
#include <stdint.h>
#include <math.h>
#include <pthread.h>

#define NO_ALLELES 6
#define MAX_GEN 14
#define NCALL 14              /* "N" call */
#define MAX_CONFIGS 514
#define POOL_CFG 10240

#define AUTO 0
#define CHRX 1
#define CHRY 2
#define CHRMT 3

/* site types (pecaller.c:110-117) */
#define T_REF 0
#define T_SNP 1
#define T_DEL 2
#define T_INS 3
#define T_LOW 4
#define T_MULTI 5
#define T_MESS 6

/* ---------- shared model tables (built once per run) ---------- */

typedef struct {
    int indiv;
    int haploid_global;       /* global y/n: sets max_gen/min_depth/tables */
    int max_gen;
    int min_depth_needed;
    double ln_theta, ln_denovo, threshold;
    int use_ped;
    double ***ln_HW;          /* [n][asize 0..2n][hets 0..n], n=1..indiv */
    int genotype_order[4][MAX_GEN];
    short allele_counts[4][MAX_GEN][NO_ALLELES];
    short dyad[4][MAX_GEN + 1][MAX_GEN + 1];
    short trio[4][MAX_GEN + 1][MAX_GEN + 1][MAX_GEN + 1];
    const int32_t *dad, *mom, *sex;
    int32_t *kids;            /* flattened kid lists */
    int32_t *kids_start;      /* per sample offsets into kids */
    double *factbl;           /* factln table 0..10000 */
} model_t;

static double m_gammln(double xx)
{
    static const double cof[6] = { 76.18009173, -86.50532033, 24.01409822,
        -1.231739516, 0.120858003e-2, -0.536382e-5 };
    double x = xx - 1.0;
    double tmp = x + 5.5;
    tmp -= (x + 0.5) * log(tmp);
    double ser = 1.0;
    for (int j = 0; j <= 5; j++) {
        x += 1.0;
        ser += cof[j] / x;
    }
    return -tmp + log(2.50662827465 * ser);
}

static double m_exactfactln(int n)
{
    double x = 1.0;
    for (int i = 2; i <= n; i++)
        x *= (double)i;
    return log(x);
}

static double m_factln(const model_t *m, int n)
{
    if (n <= 1) return 0.0;
    if (n <= 10000) return m->factbl[n];
    return m_gammln(n + 1.0);
}

static void get_het_alleles(int i, int *a, int *b, int ref)
{
    static const int ha[8] = { 0, 0, 0, 1, 1, 2, -1, -1 };
    static const int hb[8] = { 1, 2, 3, 2, 3, 3, 4, 5 };
    if (i < NO_ALLELES) { *a = *b = i; }
    else if (i < 12) { *a = ha[i - 6]; *b = hb[i - 6]; }
    else if (i == 12) { *a = ref; *b = 4; }
    else { *a = ref; *b = 5; }
}

static void fill_hardy_weinberg(double **exact_HW, int asize, int n)
{
    double **marg = malloc((asize + 1) * sizeof(double *));
    for (int i = 0; i <= asize; i++) {
        marg[i] = calloc(n + 1, sizeof(double));
        for (int j = 0; j <= n; j++) exact_HW[i][j] = 0.0;
    }
    for (int i = 1; i <= asize; i++) {
        int Na = 2 * n - i, Nb = i;
        double p = (double)i / (double)(Na + Nb);
        int expect = (int)ceil(i * (1.0 - p));
        int start;
        if (i % 2 == 0) start = (expect % 2 == 1) ? expect - 1 : expect;
        else start = (expect % 2 == 1) ? expect : expect - 1;
        double sum = marg[i][start] = 1.0;
        int nbb = (Nb - start) / 2, naa = (Na - start) / 2;
        for (int nab = start + 2; naa > 0 && nbb > 0;
             nab += 2, naa--, nbb--) {
            marg[i][nab] = marg[i][nab - 2] * 4.0 *
                ((double)naa * (double)nbb) /
                ((double)nab * (double)(nab - 1.0));
            sum += marg[i][nab];
        }
        nbb = (Nb - start) / 2; naa = (Na - start) / 2;
        for (int nab = start - 2; nab >= 0; nab -= 2, naa++, nbb++) {
            marg[i][nab] = marg[i][nab + 2] *
                ((double)(nab + 2.0) * (double)(nab + 1.0)) /
                ((double)4.0 * ((double)(naa + 1.0) * (nbb + 1.0)));
            sum += marg[i][nab];
        }
        for (int j = 0; j <= n; j++) marg[i][j] /= sum;
    }
    for (int i = 0; i <= asize; i++) {
        for (int j = 0; j <= n; j++)
            exact_HW[i][j] = (marg[i][j] > 1e-50) ? log(marg[i][j]) : -5000;
        free(marg[i]);
    }
    free(marg);
}

static short add_denovo(const model_t *m, int kid, int dad, int mom, int sex,
                        int chrom, int ref)
{
    if (dad < MAX_GEN) {
        if (mom < MAX_GEN) {
            if (chrom == AUTO) return m->trio[ref][dad][mom][kid];
            if (chrom == CHRX)
                return (sex == 1) ? m->dyad[ref][mom][kid]
                                  : m->trio[ref][dad][mom][kid];
            if (chrom == CHRY)
                return (sex == 1) ? m->dyad[ref][dad][kid] : 0;
            if (chrom == CHRMT) return m->dyad[ref][mom][kid];
            return 0;
        }
        if (chrom == AUTO) return m->dyad[ref][dad][kid];
        if (chrom == CHRX && sex == 2) return m->dyad[ref][dad][kid];
        if (chrom == CHRY && sex == 1) return m->dyad[ref][dad][kid];
        return 0;
    }
    if (mom < MAX_GEN && chrom != CHRY) return m->dyad[ref][mom][kid];
    return 0;
}

model_t *pecall_model_new(int indiv, int haploid, double theta,
                          double denovo_rate, double threshold, int use_ped,
                          const int32_t *dad, const int32_t *mom,
                          const int32_t *sex)
{
    model_t *m = calloc(1, sizeof(model_t));
    m->indiv = indiv;
    m->haploid_global = haploid;
    m->max_gen = haploid ? NO_ALLELES : MAX_GEN;
    m->min_depth_needed = haploid ? 1 : 2;
    m->ln_theta = log(theta);
    m->ln_denovo = use_ped ? log(denovo_rate) : 0.0;
    m->threshold = threshold;
    m->use_ped = use_ped;
    m->dad = dad; m->mom = mom; m->sex = sex;

    m->factbl = malloc(10001 * sizeof(double));
    m->factbl[0] = m->factbl[1] = 0.0;
    for (int n = 2; n <= 40; n++) m->factbl[n] = m_exactfactln(n);
    for (int n = 41; n <= 10000; n++) m->factbl[n] = m_gammln(n + 1.0);

    if (!haploid) {
        m->ln_HW = malloc((indiv + 1) * sizeof(double **));
        for (int i = 1; i <= indiv; i++) {
            int asize = 2 * i;
            m->ln_HW[i] = malloc((asize + 1) * sizeof(double *));
            for (int a = 0; a <= asize; a++)
                m->ln_HW[i][a] = malloc((i + 1) * sizeof(double));
            fill_hardy_weinberg(m->ln_HW[i], asize, i);
        }
    }

    /* genotype preference order per ref (pecaller.c:617-708) */
    static const int dip[4][14] = {
        { 0, 7, 6, 8, 12, 13, 1, 2, 3, 4, 5, 9, 10, 11 },
        { 1, 10, 6, 9, 12, 13, 0, 2, 3, 4, 5, 7, 8, 11 },
        { 2, 7, 9, 11, 12, 13, 0, 1, 3, 4, 5, 6, 8, 10 },
        { 3, 10, 8, 11, 12, 13, 1, 0, 2, 4, 5, 6, 7, 9 } };
    static const int hap[4][6] = {
        { 0, 2, 1, 3, 4, 5 }, { 1, 3, 0, 2, 4, 5 },
        { 2, 0, 1, 3, 4, 5 }, { 3, 1, 0, 2, 4, 5 } };
    for (int r = 0; r < 4; r++)
        for (int g = 0; g < m->max_gen; g++)
            m->genotype_order[r][g] = haploid ? hap[r][g] : dip[r][g];

    for (int i = 0; i < MAX_GEN; i++)
        for (int r = 0; r < 4; r++) {
            int a, b;
            for (int k = 0; k < NO_ALLELES; k++)
                m->allele_counts[r][i][k] = 0;
            get_het_alleles(i, &a, &b, r);
            m->allele_counts[r][i][a]++;
            if (!haploid) m->allele_counts[r][i][b]++;
        }

    memset(m->dyad, 0, sizeof(m->dyad));
    memset(m->trio, 0, sizeof(m->trio));
    if (haploid) {
        for (int r = 0; r < 4; r++)
            for (int i = 0; i < m->max_gen; i++)
                for (int j = 0; j < m->max_gen; j++)
                    if (i != j) m->dyad[r][i][j] = 1;
    } else {
        for (int r = 0; r < 4; r++)
            for (int i = 0; i < m->max_gen; i++) {
                int da, db;
                get_het_alleles(i, &da, &db, r);
                for (int j = 0; j < m->max_gen; j++) {
                    int ka, kb;
                    get_het_alleles(j, &ka, &kb, r);
                    if ((ka != da) && (ka != db) && (kb != da) && (kb != db))
                        m->dyad[r][i][j] = 1;
                    for (int k = 0; k < m->max_gen; k++) {
                        int ma, mb;
                        get_het_alleles(k, &ma, &mb, r);
                        if (((ka == ma) && (kb == da)) ||
                            ((ka == ma) && (kb == db)) ||
                            ((ka == mb) && (kb == da)) ||
                            ((ka == mb) && (kb == db)) ||
                            ((kb == ma) && (ka == da)) ||
                            ((kb == ma) && (ka == db)) ||
                            ((kb == mb) && (ka == da)) ||
                            ((kb == mb) && (ka == db)))
                            m->trio[r][i][k][j] = 0;
                        else if (((ka != ma) && (kb != db)) &&
                                 ((kb != ma) && (ka != db)) &&
                                 ((ka != mb) && (kb != da)) &&
                                 ((kb != mb) && (ka != da)))
                            m->trio[r][i][k][j] = 2;
                        else
                            m->trio[r][i][k][j] = 1;
                    }
                }
            }
    }

    /* kid lists: in ped-scan order == sample index order of the kids */
    int32_t *nk = calloc(indiv, sizeof(int32_t));
    for (int i = 0; i < indiv; i++) {
        if (dad && dad[i] >= 0) nk[dad[i]]++;
        if (mom && mom[i] >= 0) nk[mom[i]]++;
    }
    m->kids_start = malloc((indiv + 1) * sizeof(int32_t));
    m->kids_start[0] = 0;
    for (int i = 0; i < indiv; i++)
        m->kids_start[i + 1] = m->kids_start[i] + nk[i];
    m->kids = malloc((m->kids_start[indiv] + 1) * sizeof(int32_t));
    int32_t *fill = calloc(indiv, sizeof(int32_t));
    for (int i = 0; i < indiv; i++) {
        if (dad && dad[i] >= 0)
            m->kids[m->kids_start[dad[i]] + fill[dad[i]]++] = i;
        if (mom && mom[i] >= 0)
            m->kids[m->kids_start[mom[i]] + fill[mom[i]]++] = i;
    }
    free(nk); free(fill);
    return m;
}

void pecall_model_free(model_t *m)
{
    if (!m) return;
    if (m->ln_HW) {
        for (int i = 1; i <= m->indiv; i++) {
            for (int a = 0; a <= 2 * i; a++) free(m->ln_HW[i][a]);
            free(m->ln_HW[i]);
        }
        free(m->ln_HW);
    }
    free(m->factbl); free(m->kids); free(m->kids_start);
    free(m);
}

/* ---------- per-site working state ---------- */

typedef struct {
    double like[MAX_GEN + 1];
    double post_prob[MAX_GEN + 1];
    double coef, initial_p, final_p;
    int initial_call, final_call;
    int reads[NO_ALLELES];
    double frac[NO_ALLELES];
    int tot;
} samp_t;

typedef struct cfg_s {
    int genotype_count[MAX_GEN];
    double prior, like, post;
    int8_t *calls;
    float avg_depth;
    short no_alleles;
    int allele_count[NO_ALLELES];
    int no_denovo, hets, homs;
    int64_t seq;              /* creation order for stable sorting */
} cfg_t;

typedef struct {
    const model_t *m;
    samp_t *S;
    cfg_t *pool;              /* POOL_CFG nodes */
    int8_t *calls_pool;       /* POOL_CFG * indiv */
    int pool_used;
    cfg_t **cn;
    cfg_t **scratch;          /* merge sort scratch */
    int *order;               /* confidence-ordered sample indices */
    int alpha[MAX_GEN][NO_ALLELES];
    int first_alpha[MAX_GEN][NO_ALLELES];
    double d_mean[MAX_GEN][NO_ALLELES];
    double d_var[MAX_GEN][NO_ALLELES];
    double d_weight[MAX_GEN][NO_ALLELES];
    cfg_t **freelist;
    int free_top;
} work_t;

static work_t *work_new(const model_t *m)
{
    work_t *w = calloc(1, sizeof(work_t));
    w->m = m;
    w->S = calloc(m->indiv, sizeof(samp_t));
    w->pool = calloc(POOL_CFG, sizeof(cfg_t));
    w->calls_pool = malloc((size_t)POOL_CFG * m->indiv);
    w->cn = malloc(POOL_CFG * sizeof(cfg_t *));
    w->scratch = malloc(POOL_CFG * sizeof(cfg_t *));
    w->order = malloc(m->indiv * sizeof(int));
    w->freelist = malloc(POOL_CFG * sizeof(cfg_t *));
    w->free_top = POOL_CFG;
    for (int i = 0; i < POOL_CFG; i++) {
        w->pool[i].calls = w->calls_pool + (size_t)i * m->indiv;
        w->freelist[POOL_CFG - 1 - i] = &w->pool[i];
    }
    return w;
}

static void work_free(work_t *w)
{
    free(w->S); free(w->pool); free(w->calls_pool); free(w->cn);
    free(w->scratch); free(w->order); free(w->freelist);
    free(w);
}

static cfg_t *cfg_alloc(work_t *w, int dom, int is_haploid, int64_t *seqctr)
{
    const model_t *m = w->m;
    cfg_t *c = w->freelist[--w->free_top];
    memset(c->genotype_count, 0, sizeof(c->genotype_count));
    memset(c->allele_count, 0, sizeof(c->allele_count));
    c->homs = 0; c->no_alleles = 0;
    for (int i = 0; i < m->indiv; i++) {
        if (w->S[i].tot > m->min_depth_needed) {
            c->calls[i] = (int8_t)dom;
            c->genotype_count[dom]++;
            c->allele_count[dom] += is_haploid ? 1 : 2;
            c->homs++;
            c->no_alleles = 1;
        } else {
            c->calls[i] = NCALL;
        }
    }
    c->like = 0; c->prior = 0; c->post = 1;
    c->no_denovo = 0; c->hets = 0;
    c->seq = (*seqctr)++;
    return c;
}

static void cfg_free(work_t *w, cfg_t *c)
{
    w->freelist[w->free_top++] = c;
}

/* stable merge sort of cn[0..n) by post desc (ties keep order) */
static void sort_cfgs(work_t *w, cfg_t **cn, int n)
{
    if (n < 2) return;
    cfg_t **tmp = w->scratch;
    for (int width = 1; width < n; width *= 2) {
        for (int lo = 0; lo < n; lo += 2 * width) {
            int mid = lo + width < n ? lo + width : n;
            int hi = lo + 2 * width < n ? lo + 2 * width : n;
            int i = lo, j = mid, k = lo;
            while (i < mid && j < hi)
                tmp[k++] = (cn[j]->post > cn[i]->post) ? cn[j++] : cn[i++];
            while (i < mid) tmp[k++] = cn[i++];
            while (j < hi) tmp[k++] = cn[j++];
            memcpy(cn + lo, tmp + lo, (hi - lo) * sizeof(cfg_t *));
        }
    }
}

static void fill_config_like(const model_t *m, cfg_t *c, samp_t *S)
{
    c->like = 0;
    for (int i = 0; i < m->indiv; i++)
        if (S[i].tot > m->min_depth_needed)
            c->like += S[i].like[(int)c->calls[i]];
    c->post = c->like + c->prior;
}

static int clean_config_probs(work_t *w, int n, int ref, int is_haploid,
                              double ct, int64_t *seqctr)
{
    const model_t *m = w->m;
    cfg_t **cn = w->cn;
    sort_cfgs(w, cn, n);
    int max = MAX_CONFIGS < n ? MAX_CONFIGS : n;
    for (int i = 1; i < max; i++)
        if (cn[0]->post > cn[i]->post + ct) max = i;
    for (int i = max; i < n; i++) cfg_free(w, cn[i]);

    int found_hom = 0;
    for (int i = 0; i < max; i++)
        if (cn[i]->no_alleles == 1) { found_hom = 1; break; }
    if (!found_hom) {
        int best_hom = 0;
        for (int i = 1; i < NO_ALLELES; i++)
            if (cn[0]->allele_count[i] > cn[0]->allele_count[best_hom])
                best_hom = i;
        if (best_hom > 3) best_hom = ref;
        cfg_t *c = cfg_alloc(w, best_hom, is_haploid, seqctr);
        c->prior = 0.0;
        fill_config_like(m, c, w->S);
        c->post = c->like;
        cn[max] = c;
        if (c->post > cn[max - 1]->post) sort_cfgs(w, cn, max + 1);
        max++;
    }
    return max;
}

static void fill_sample_like(work_t *w, double norm)
{
    const model_t *m = w->m;
    for (int i = 0; i < m->indiv; i++) {
        samp_t *sn = &w->S[i];
        w->order[i] = i;
        double max = -1e100;
        int best = NCALL;
        int t100 = sn->tot < 100 ? sn->tot : 100;
        double scale = t100 * norm;
        if (scale < 10) scale = 10;
        if (scale > 1000) scale = 1000;
        if (sn->tot > m->min_depth_needed) {
            for (int j = 0; j < m->max_gen; j++) {
                int tot_a = 0, tot_tot = 0;
                sn->like[j] = 0.0;
                double coef = sn->coef;
                for (int ii = 0; ii < NO_ALLELES; ii++) {
                    int ta = (int)ceil(scale * w->d_mean[j][ii]);
                    if (ta < 1) ta = 1;
                    tot_a += ta;
                    tot_tot += ta + sn->reads[ii];
                    coef -= m_factln(m, ta - 1);
                    sn->like[j] += m_factln(m, ta + sn->reads[ii] - 1);
                }
                coef += m_factln(m, tot_a - 1);
                sn->like[j] += coef;
                sn->like[j] -= m_factln(m, tot_tot - 1);
                if (sn->like[j] > max) { best = j; max = sn->like[j]; }
            }
            sn->initial_p = 1e100;
            sn->initial_call = best;
            for (int j = 0; j < m->max_gen; j++)
                if (j != best && max - sn->like[j] < sn->initial_p)
                    sn->initial_p = max - sn->like[j];
        } else {
            sn->initial_p = 0.0;
            sn->initial_call = NCALL;
        }
    }
    /* stable sort order[] by initial_p desc */
    for (int width = 1; width < m->indiv; width *= 2) {
        static int tmp_static[1]; (void)tmp_static;
        int n = m->indiv;
        int *tmp = malloc(n * sizeof(int));
        for (int lo = 0; lo < n; lo += 2 * width) {
            int mid = lo + width < n ? lo + width : n;
            int hi = lo + 2 * width < n ? lo + 2 * width : n;
            int a = lo, b = mid, k = lo;
            while (a < mid && b < hi)
                tmp[k++] = (w->S[w->order[b]].initial_p >
                            w->S[w->order[a]].initial_p)
                           ? w->order[b++] : w->order[a++];
            while (a < mid) tmp[k++] = w->order[a++];
            while (b < hi) tmp[k++] = w->order[b++];
        }
        memcpy(w->order, tmp, n * sizeof(int));
        free(tmp);
    }
}

static int fill_config_probs(work_t *w, int n, int s, int ref, int chrom,
                             int is_haploid, double thres, int64_t *seqctr)
{
    const model_t *m = w->m;
    cfg_t **cn = w->cn;
    samp_t *sn = &w->S[s];
    double best_post = cn[0]->post;
    double best_like = cn[0]->like;
    cfg_t **newlist = malloc((size_t)(m->max_gen + 1) * (n + 1) *
                             sizeof(cfg_t *));
    int newcount = 0;

    for (int i = 0; i < n; i++) {
        int done_it = 0;
        for (int ii = 0; ii < i && !done_it; ii++) {
            int same = 1;
            for (int jj = 0; jj < m->indiv && same; jj++)
                if (jj != s && cn[i]->calls[jj] != cn[ii]->calls[jj])
                    same = 0;
            if (same) done_it = 1;
        }
        if (done_it) continue;

        cfg_t *old = cn[i];
        int j_old = old->calls[s];
        if (j_old < MAX_GEN) {
            for (int k = 0; k < NO_ALLELES; k++)
                old->allele_count[k] -= m->allele_counts[ref][j_old][k];
            if (j_old >= NO_ALLELES) old->hets--; else old->homs--;
            if (m->dad[s] >= 0) {
                if (m->mom[s] >= 0)
                    old->no_denovo -= add_denovo(m, j_old,
                        old->calls[m->dad[s]], old->calls[m->mom[s]],
                        m->sex[s], chrom, ref);
                else
                    old->no_denovo -= add_denovo(m, j_old,
                        old->calls[m->dad[s]], MAX_GEN, m->sex[s], chrom,
                        ref);
            } else if (m->mom[s] >= 0) {
                old->no_denovo -= add_denovo(m, j_old, MAX_GEN,
                    old->calls[m->mom[s]], m->sex[s], chrom, ref);
            }
            int nk = m->kids_start[s + 1] - m->kids_start[s];
            if (nk > 0) {
                int kg = MAX_GEN, dg = MAX_GEN, mg = MAX_GEN;
                for (int k = 0; k < nk; k++) {
                    int kid = m->kids[m->kids_start[s] + k];
                    kg = old->calls[kid];
                    if (m->dad[kid] >= 0) dg = old->calls[m->dad[kid]];
                    if (m->mom[kid] >= 0) mg = old->calls[m->mom[kid]];
                    old->no_denovo -= add_denovo(m, kg, dg, mg,
                                                 m->sex[kid], chrom, ref);
                }
            }
            old->like -= sn->like[j_old];
            old->genotype_count[j_old]--;
        }

        for (int jj = 0; jj < m->max_gen; jj++) {
            int j = m->genotype_order[ref][jj];
            double templ = old->like + sn->like[j];
            if ((j == 4 || j == 12) && sn->reads[4] < 3) templ -= 1e10;
            if ((j == 13 || j == 5) && sn->reads[5] < 3) templ -= 1e10;
            if (!((templ + thres > best_post) || (templ + 0.01 > best_like)))
                continue;
            cfg_t *t = cfg_alloc(w, ref, is_haploid, seqctr);
            memcpy(t->genotype_count, old->genotype_count,
                   sizeof(old->genotype_count));
            t->like = templ;
            memcpy(t->calls, old->calls, m->indiv);
            t->genotype_count[j]++;
            t->calls[s] = (int8_t)j;
            t->prior = 0.0;
            t->hets = old->hets;
            t->homs = old->homs;
            memcpy(t->allele_count, old->allele_count,
                   sizeof(old->allele_count));
            t->no_denovo = old->no_denovo;
            if (j >= NO_ALLELES) t->hets++; else t->homs++;
            for (int k = 0; k < NO_ALLELES; k++)
                t->allele_count[k] += m->allele_counts[ref][j][k];
            if (m->dad[s] >= 0) {
                if (m->mom[s] >= 0)
                    t->no_denovo += add_denovo(m, j, t->calls[m->dad[s]],
                        t->calls[m->mom[s]], m->sex[s], chrom, ref);
                else
                    t->no_denovo += add_denovo(m, j, t->calls[m->dad[s]],
                        MAX_GEN, m->sex[s], chrom, ref);
            } else if (m->mom[s] >= 0) {
                t->no_denovo += add_denovo(m, j, MAX_GEN,
                    t->calls[m->mom[s]], m->sex[s], chrom, ref);
            }
            int nk = m->kids_start[s + 1] - m->kids_start[s];
            if (nk > 0) {
                int kg = MAX_GEN, dg = MAX_GEN, mg = MAX_GEN;
                for (int k = 0; k < nk; k++) {
                    int kid = m->kids[m->kids_start[s] + k];
                    kg = t->calls[kid];
                    if (m->dad[kid] >= 0) dg = t->calls[m->dad[kid]];
                    if (m->mom[kid] >= 0) mg = t->calls[m->mom[kid]];
                    t->no_denovo += add_denovo(m, kg, dg, mg, m->sex[kid],
                                               chrom, ref);
                }
            }
            t->no_alleles = 0;
            for (int k = 0; k < NO_ALLELES; k++)
                if (t->allele_count[k] > 0) t->no_alleles++;
            t->prior = 0;
            if (t->no_alleles > 1)
                t->prior = (t->no_alleles - 1) * m->ln_theta;
            if (t->no_denovo > 0)
                t->prior += t->no_denovo * m->ln_denovo;
            if (!is_haploid && t->no_alleles > 1) {
                int major = 0, minor = 0;
                for (int k = 1; k < NO_ALLELES; k++)
                    if (t->allele_count[k] > t->allele_count[major])
                        major = k;
                for (int k = 0; k < NO_ALLELES; k++)
                    if (k != major) minor += t->allele_count[k];
                major = t->allele_count[major];
                if (minor > major) { int tt = major; major = minor; minor = tt; }
                int hets = minor < t->hets ? minor : t->hets;
                int tot_n = (minor + major) / 2;
                if ((minor - hets) % 2 == 1) { minor++; major++; }
                t->prior += m->ln_HW[tot_n][minor][hets];
            }
            t->post = t->prior + t->like;
            if (t->like > best_like) best_like = t->like;
            if (t->post > best_post) best_post = t->post;
            if (t->post + thres > best_post) {
                newlist[newcount++] = t;
            } else {
                cfg_free(w, t);
            }
        }
    }
    for (int i = 0; i < n; i++) cfg_free(w, cn[i]);
    for (int i = 0; i < newcount; i++) cn[i] = newlist[i];
    free(newlist);
    return newcount;
}

static void fill_alpha_prior(work_t *w, int hom, int het, int ref)
{
    const model_t *m = w->m;
    int hom_err = hom / 300; if (hom_err < 1) hom_err = 1;
    int err = (2 * het) / 300; if (err < 1) err = 1;
    int (*al)[NO_ALLELES] = w->alpha;
    for (int i = 0; i < m->max_gen; i++) {
        if (i < NO_ALLELES - 2) {
            for (int j = 0; j < NO_ALLELES; j++)
                al[i][j] = (i == j) ? hom : hom_err;
        } else {
            int j = i;
            if (j == NO_ALLELES - 2) {
                for (int k = 0; k < 4; k++)
                    al[j][k] = (k == ref) ? hom / 5 : err;
                al[j][4] = (4 * hom) / 5;
                al[j][5] = err;
            } else if (j == NO_ALLELES - 1) {
                for (int k = 0; k < 4; k++)
                    al[j][k] = (k == ref) ? hom : err;
                al[j][4] = err;
                al[j][5] = (4 * hom) / 5;
            } else if (j < NO_ALLELES + 6) {
                int a, b;
                get_het_alleles(j, &a, &b, ref);
                if (a == ref) {
                    al[j][a] = (51 * het) / 50;
                    al[j][b] = (49 * het) / 50;
                    al[j][4] = het / 20 > 1 ? het / 20 : 1;
                    al[j][5] = err;
                    for (int k = 0; k < 4; k++)
                        if (k != a && k != b) al[j][k] = err;
                } else if (b == ref) {
                    al[j][b] = (51 * het) / 50;
                    al[j][a] = (49 * het) / 50;
                    al[j][4] = het / 20 > 1 ? het / 20 : 1;
                    al[j][5] = err;
                    for (int k = 0; k < 4; k++)
                        if (k != a && k != b) al[j][k] = err;
                } else {
                    al[j][a] = het;
                    al[j][b] = het;
                    for (int k = 0; k < NO_ALLELES; k++)
                        if (k != a && k != b) al[j][k] = err;
                }
            } else if (j == NO_ALLELES + 6) {
                al[j][4] = (4 * het) / 5;
                al[j][ref] = (6 * het) / 5;
                for (int k = 0; k < 4; k++)
                    if (k != ref) al[j][k] = err;
                al[j][5] = err;
            } else {
                al[j][5] = (2 * het) / 5;
                al[j][ref] = (8 * het) / 5;
                for (int k = 0; k < 5; k++)
                    if (k != ref) al[j][k] = err;
            }
        }
    }
}

static void check_alpha_sanity(work_t *w, int ref, int normal_factor)
{
    const model_t *m = w->m;
    int (*al)[NO_ALLELES] = w->alpha;
    int (*fa)[NO_ALLELES] = w->first_alpha;
    double frac[MAX_GEN][NO_ALLELES];
    for (int i = 0; i < m->max_gen; i++) {
        int tot = al[i][0];
        for (int j = 1; j < NO_ALLELES; j++) tot += al[i][j];
        for (int j = 0; j < NO_ALLELES; j++)
            frac[i][j] = (double)al[i][j] / (double)tot;
    }
    for (int i = 0; i < 4; i++) {
        int max = 0;
        for (int j = 1; j < NO_ALLELES; j++)
            if (al[i][j] > al[i][max]) max = j;
        int bad = 0;
        if (max != i) bad = 1;
        else
            for (int j = 0; j < NO_ALLELES; j++)
                if (j != i && frac[i][j] > 0.3) bad = 1;
        if (bad)
            for (int j = 0; j < NO_ALLELES; j++) al[i][j] = fa[i][j];
    }
    {
        int i = 4;
        if (frac[i][i] - frac[ref][i] < 0.5)
            for (int j = 0; j < NO_ALLELES; j++) al[i][j] = fa[i][j];
        i = 5;
        if (frac[i][i] - frac[ref][i] < -0.1)
            for (int j = 0; j < NO_ALLELES; j++) al[i][j] = fa[i][j];
    }
    for (int i = NO_ALLELES; i < m->max_gen; i++) {
        int a, b;
        get_het_alleles(i, &a, &b, ref);
        if (b == ref) { int t = a; a = b; b = t; }
        if (frac[i][b] - frac[ref][b] < 0.25) {
            for (int j = 0; j < NO_ALLELES; j++) al[i][j] = fa[i][j];
        } else {
            int bad = 0;
            if (ref == a) frac[i][a] -= 0.05;
            else frac[i][a] -= (frac[ref][a] > 0.05 ? frac[ref][a] : 0.05);
            frac[i][b] -= (0.05 > frac[ref][b] ? 0.05 : frac[ref][b]);
            for (int j = 0; j < NO_ALLELES; j++)
                if (j != a && j != b &&
                    (frac[i][j] > frac[i][a] || frac[i][j] > frac[i][b])) {
                    bad = 1;
                    break;
                }
            if (bad)
                for (int j = 0; j < NO_ALLELES; j++) al[i][j] = fa[i][j];
        }
    }
    for (int i = 0; i < m->max_gen; i++) {
        double scale = al[i][0];
        for (int j = 1; j < NO_ALLELES; j++) scale += al[i][j];
        scale = (double)normal_factor / scale;
        for (int j = 0; j < NO_ALLELES; j++)
            if (al[i][j] > 1) {
                int v = (int)ceil(scale * (double)al[i][j]);
                al[i][j] = v > 1 ? v : 1;
            }
    }
}

/* ---------- the per-site entry ---------- */

static void call_one_site(work_t *w, const uint16_t *reads, int dom_int,
                          int chrom, int site_haploid,
                          int8_t *out_call, double *out_prob,
                          uint8_t *out_type, int32_t *out_denovo,
                          int32_t *out_acnt, uint8_t *out_active)
{
    const model_t *m = w->m;
    samp_t *S = w->S;
    int indiv = m->indiv;
    int last_pass = 5;
    int bad_base = 0;
    int64_t seqctr = 0;

    for (int i = 0; i < indiv; i++) {
        samp_t *sn = &S[i];
        for (int j = 0; j < NO_ALLELES; j++)
            sn->reads[j] = reads[(size_t)i * 6 + j];
        sn->tot = sn->reads[0];
        for (int j = 1; j < NO_ALLELES - 1; j++) sn->tot += sn->reads[j];
        if (sn->tot > 0)
            for (int j = 0; j < NO_ALLELES; j++)
                sn->frac[j] = (double)sn->reads[j] / (double)sn->tot;
        for (int j = 0; j < m->max_gen; j++) sn->post_prob[j] = 0.0;
        sn->coef = m_factln(m, sn->tot);
        for (int j = 0; j < NO_ALLELES; j++)
            sn->coef -= m_factln(m, sn->reads[j]);
        if (sn->tot > m->min_depth_needed) {
            sn->initial_call = dom_int;
            sn->final_call = dom_int;
        } else {
            sn->initial_call = NCALL;
            sn->final_call = NCALL;
        }
        sn->final_p = 1.0;
        sn->like[NCALL] = 0.0;
        sn->post_prob[NCALL] = 0.0;
    }
    if (dom_int >= NO_ALLELES) bad_base = 1;

    double average_depth = 0;
    for (int i = 0; i < indiv; i++) average_depth += S[i].tot;
    average_depth /= (double)indiv;
    if (average_depth < 8) bad_base = 1;

    int sample_count = 0;
    for (int i = 0; i < indiv; i++)
        if (S[i].tot >= 8) sample_count++;
    if ((sample_count < (double)0.5 * indiv) && (chrom != CHRY))
        bad_base = 1;

    int normal_factor = 300;
    int calls_changed = 1;
    int pass = 0;
    w->cn[0] = cfg_alloc(w, dom_int, site_haploid, &seqctr);
    int total_configs = 1;
    if (!bad_base) {
        fill_alpha_prior(w, normal_factor, normal_factor / 2, dom_int);
        w->cn[0]->prior = 0.0;
    } else {
        for (int i = 0; i < indiv; i++) S[i].tot = 0;
        calls_changed = 0;
    }

    double new_norm[6];
    new_norm[0] = new_norm[1] = 1;
    for (int i = 2; i <= last_pass; i++) new_norm[i] = new_norm[i - 1] * 2.5;

    while (calls_changed && pass < last_pass) {
        pass++;
        double ct = 2.3;
        for (int ii = 0; ii < m->max_gen; ii++) {
            int myt = 0;
            for (int jj = 0; jj < NO_ALLELES; jj++) {
                myt += w->alpha[ii][jj];
                w->first_alpha[ii][jj] = w->alpha[ii][jj];
            }
            for (int jj = 0; jj < NO_ALLELES; jj++)
                w->d_mean[ii][jj] = (double)w->alpha[ii][jj] / (double)myt;
        }
        fill_sample_like(w, new_norm[pass]);
        for (int i = 0; i < total_configs; i++)
            fill_config_like(m, w->cn[i], S);
        total_configs = clean_config_probs(w, total_configs, dom_int,
                                           site_haploid, ct, &seqctr);

        for (int iind = 0; iind < indiv; iind++) {
            int ind = w->order[iind];
            if (S[ind].tot > m->min_depth_needed) {
                total_configs = fill_config_probs(w, total_configs, ind,
                                                  dom_int, chrom,
                                                  site_haploid, ct, &seqctr);
                total_configs = clean_config_probs(w, total_configs, dom_int,
                                                   site_haploid, ct, &seqctr);
            } else {
                S[ind].final_call = NCALL;
                for (int i = 0; i < m->max_gen; i++)
                    S[ind].post_prob[i] = 0.0;
                S[ind].post_prob[NCALL] = 1.0;
                for (int i = 0; i < total_configs; i++)
                    w->cn[i]->calls[ind] = NCALL;
                S[ind].final_p = 1.0;
            }
        }

        double max_post = w->cn[0]->post;
        double tot_post = 0;
        for (int i = 0; i < total_configs; i++) {
            w->cn[i]->post -= max_post;
            w->cn[i]->post = (w->cn[i]->post > -40)
                             ? exp(w->cn[i]->post) : 0;
            tot_post += w->cn[i]->post;
        }
        for (int i = 0; i < total_configs; i++)
            w->cn[i]->post /= tot_post;

        for (int ind = 0; ind < indiv; ind++)
            for (int i = 0; i < m->max_gen; i++)
                S[ind].post_prob[i] = 0;
        for (int ind = 0; ind < indiv; ind++)
            if (S[ind].tot > m->min_depth_needed)
                for (int i = 0; i < total_configs; i++)
                    S[ind].post_prob[(int)w->cn[i]->calls[ind]] +=
                        w->cn[i]->post;

        calls_changed = 0;
        for (int ind = 0; ind < indiv; ind++)
            if (S[ind].tot > m->min_depth_needed) {
                int besti = 0;
                for (int i = 1; i < m->max_gen; i++)
                    if (S[ind].post_prob[i] > S[ind].post_prob[besti])
                        besti = i;
                S[ind].final_p = S[ind].post_prob[besti];
                S[ind].final_call = besti;
                if (S[ind].final_call != S[ind].initial_call ||
                    S[ind].final_p < m->threshold)
                    calls_changed = 1;
            }

        if (indiv < 4 || pass == last_pass) calls_changed = 0;

        if (calls_changed) {
            for (int ii = 0; ii < m->max_gen; ii++)
                for (int jj = 0; jj < NO_ALLELES; jj++)
                    w->d_weight[ii][jj] = w->d_mean[ii][jj] =
                        w->d_var[ii][jj] = 0.0;
            for (int i = 0; i < total_configs; i++)
                for (int ind = 0; ind < indiv; ind++)
                    if (S[ind].tot > m->min_depth_needed)
                        for (int j = 0; j < NO_ALLELES; j++) {
                            int c = (int)w->cn[i]->calls[ind];
                            w->d_mean[c][j] += S[ind].frac[j] *
                                w->cn[i]->post;
                            w->d_var[c][j] += (S[ind].frac[j] *
                                S[ind].frac[j]) * w->cn[i]->post;
                            w->d_weight[c][j] += w->cn[i]->post;
                        }
            for (int ii = 0; ii < m->max_gen; ii++)
                for (int jj = 0; jj < NO_ALLELES; jj++)
                    if (w->d_weight[ii][jj] > 1e-9) {
                        w->d_mean[ii][jj] /= w->d_weight[ii][jj];
                        w->d_var[ii][jj] /= w->d_weight[ii][jj];
                        w->d_var[ii][jj] -= w->d_mean[ii][jj] *
                            w->d_mean[ii][jj];
                    }
            double var_eps = 1e-6;
            for (int ii = 0; ii < m->max_gen; ii++) {
                int non_zero_var = 0, this_min = 0, little_up = 0;
                for (int jj = 1; jj < NO_ALLELES; jj++)
                    if (w->d_mean[ii][jj] > w->d_mean[ii][little_up])
                        little_up = jj;
                for (int jj = 0; jj < NO_ALLELES; jj++) {
                    if (w->d_weight[ii][jj] >= 1.5 &&
                        w->d_var[ii][jj] > var_eps * w->d_mean[ii][jj])
                        non_zero_var++;
                    if (w->d_mean[ii][jj] < w->d_mean[ii][this_min])
                        this_min = jj;
                    if (w->d_mean[ii][jj] > var_eps &&
                        w->d_mean[ii][jj] < w->d_mean[ii][little_up])
                        little_up = jj;
                }
                if (non_zero_var > 1) {
                    double s0 = 1.0;
                    for (int jj = 0; jj < NO_ALLELES; jj++)
                        if (jj != this_min &&
                            w->d_var[ii][jj] > var_eps * w->d_mean[ii][jj])
                            s0 *= w->d_mean[ii][jj] *
                                (1.0 - w->d_mean[ii][jj]) /
                                w->d_var[ii][jj];
                    s0 = pow(s0 - 1.0,
                             (double)1.0 / (double)(non_zero_var - 1.0));
                    double lim = 1.0 / w->d_mean[ii][little_up];
                    if (s0 < lim) s0 = lim;
                    if (s0 > 3.0) {
                        for (int jj = 0; jj < NO_ALLELES; jj++) {
                            int v = (int)ceil(w->d_mean[ii][jj] * s0);
                            w->alpha[ii][jj] = v > 1 ? v : 1;
                        }
                    } else {
                        for (int jj = 0; jj < NO_ALLELES; jj++)
                            w->alpha[ii][jj] = w->first_alpha[ii][jj];
                    }
                } else {
                    for (int jj = 0; jj < NO_ALLELES; jj++)
                        w->alpha[ii][jj] = w->first_alpha[ii][jj];
                }
            }
            check_alpha_sanity(w, dom_int, normal_factor);
        }
        for (int ind = 0; ind < indiv; ind++)
            S[ind].initial_call = S[ind].final_call;
    }

    for (int i = 0; i < total_configs; i++) cfg_free(w, w->cn[i]);

    /* classification (pecaller.c:1564-1671) */
    int issnp = T_REF;
    int not_low = 0;
    int this_ac[NO_ALLELES] = { 0, 0, 0, 0, 0, 0 };
    double LOW_BASE = 0.4 * average_depth;
    if (LOW_BASE < 8) LOW_BASE = 8;
    int on_target = 0, off_target = 0;
    for (int ind = 0; ind < indiv; ind++) {
        if (S[ind].tot > m->min_depth_needed) {
            out_active[ind] = 1;
            if (S[ind].final_p >= m->threshold) {
                int fc = S[ind].final_call;
                for (int i = 0; i < NO_ALLELES; i++) {
                    if (dom_int < 4 && m->allele_counts[dom_int][fc][i]) {
                        this_ac[i] += m->allele_counts[dom_int][fc][i];
                        on_target += S[ind].reads[i];
                    } else {
                        if ((i != dom_int) || (fc != NO_ALLELES - 1))
                            off_target += S[ind].reads[i];
                    }
                }
                if ((S[ind].tot > LOW_BASE) && (S[ind].final_call != dom_int))
                    not_low++;
            }
        } else {
            out_active[ind] = 0;
            S[ind].final_call = NCALL;
            S[ind].final_p = 1.0;
        }
        out_call[ind] = (int8_t)S[ind].final_call;
        out_prob[ind] = S[ind].final_p;
    }
    int this_no_alleles = 0, isdel = 0, isins = 0;
    for (int i = 0; i < NO_ALLELES; i++)
        if (this_ac[i] > 0) {
            this_no_alleles++;
            if (i == 4) isdel = 1;
            else if (i == 5) isins = 1;
            else if (i != dom_int) issnp = T_SNP;
        }
    if (this_no_alleles > 1 ||
        (this_no_alleles > 0 && this_ac[dom_int] < 1)) {
        if ((double)off_target / (double)(on_target + off_target) > 0.15)
            issnp = T_MESS;
        else if (this_no_alleles > 2)
            issnp = T_MULTI;
        else if (not_low > 0) {
            if (isdel) issnp = T_DEL;
            else if (isins) issnp = T_INS;
            else issnp = T_SNP;
        } else
            issnp = T_LOW;
    }

    int d_count = 0;
    if (issnp && m->use_ped) {
        for (int i = 0; i < indiv; i++)
            if (S[i].final_p >= m->threshold) {
                int dad_called = MAX_GEN, mom_called = MAX_GEN;
                int kid_called = S[i].final_call;
                if (m->dad[i] >= 0 &&
                    S[m->dad[i]].final_p >= m->threshold)
                    dad_called = S[m->dad[i]].final_call;
                if (m->mom[i] >= 0 &&
                    S[m->mom[i]].final_p >= m->threshold)
                    mom_called = S[m->mom[i]].final_call;
                d_count += add_denovo(m, kid_called, dad_called, mom_called,
                                      m->sex[i], chrom, dom_int);
            }
    }
    *out_type = (uint8_t)issnp;
    *out_denovo = d_count;
    for (int i = 0; i < NO_ALLELES; i++) out_acnt[i] = this_ac[i];
}

/* ---------- batch entry with threads ---------- */

typedef struct {
    const model_t *m;
    const uint16_t *reads;
    const uint8_t *ref_int, *chrom, *haploid;
    int64_t n_sites;
    int8_t *calls; double *probs; uint8_t *types;
    int32_t *denovo; int32_t *acnt; uint8_t *active;
    int nthreads;
} bjob_t;

typedef struct { bjob_t *jb; int tid; } barg_t;

static void *bworker(void *argp)
{
    barg_t *a = (barg_t *)argp;
    bjob_t *jb = a->jb;
    const model_t *m = jb->m;
    work_t *w = work_new(m);
    int iv = m->indiv;
    for (int64_t s = a->tid; s < jb->n_sites; s += jb->nthreads) {
        call_one_site(w, jb->reads + (size_t)s * iv * 6, jb->ref_int[s],
                      jb->chrom[s], jb->haploid[s],
                      jb->calls + (size_t)s * iv,
                      jb->probs + (size_t)s * iv,
                      jb->types + s, jb->denovo + s,
                      jb->acnt + (size_t)s * 6,
                      jb->active + (size_t)s * iv);
    }
    work_free(w);
    return NULL;
}

void pecall_sites_batch(const void *model, const uint16_t *reads,
                        const uint8_t *ref_int, const uint8_t *chrom,
                        const uint8_t *haploid, int64_t n_sites,
                        int nthreads, int8_t *calls, double *probs,
                        uint8_t *types, int32_t *denovo, int32_t *acnt,
                        uint8_t *active)
{
    bjob_t jb;
    jb.m = (const model_t *)model;
    jb.reads = reads; jb.ref_int = ref_int; jb.chrom = chrom;
    jb.haploid = haploid; jb.n_sites = n_sites;
    jb.calls = calls; jb.probs = probs; jb.types = types;
    jb.denovo = denovo; jb.acnt = acnt; jb.active = active;
    jb.nthreads = nthreads;
    if (jb.nthreads < 1) jb.nthreads = 1;
    if (jb.nthreads > 64) jb.nthreads = 64;
    pthread_t th[64];
    barg_t args[64];
    for (int t = 0; t < jb.nthreads; t++) {
        args[t].jb = &jb; args[t].tid = t;
        pthread_create(&th[t], NULL, bworker, &args[t]);
    }
    for (int t = 0; t < jb.nthreads; t++) pthread_join(th[t], NULL);
}

void *pecall_model_create(int indiv, int haploid, double theta,
                          double denovo_rate, double threshold, int use_ped,
                          const int32_t *dad, const int32_t *mom,
                          const int32_t *sex)
{
    return pecall_model_new(indiv, haploid, theta, denovo_rate, threshold,
                            use_ped, dad, mom, sex);
}

void pecall_model_destroy(void *m) { pecall_model_free((model_t *)m); }
