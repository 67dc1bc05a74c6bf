/* Exact co-linear chaining: the reference's find_matches state machine
 * (pemapper.c:2188-2289) plus the fwd/rev orchestration of initial_map
 * (:1642-1669), written fresh from the spec.
 *
 * Semantics reproduced exactly:
 *  - per-orientation min_spots gate (which CLEARS the running hit list,
 *    including forward hits when the reverse call trips it);
 *  - the min_match ratchet (shared across both orientations via pointer);
 *  - the dynamic loop bound  loop <= 1 + max_depth - min_match;
 *  - strict-improvement reset / equal-append with diagonal dedup;
 *  - the hard max_hits cap that aborts the whole call when an equal-score
 *    candidate arrives on a full list.
 */

#include <stdint.h>
#include <stdlib.h>
#include <pthread.h>

#define MAX_SEGS 20

typedef struct {
    const uint32_t *flat_pos;
    const int64_t *seg_start;   /* [read][orient][seg] -> offset */
    const int32_t *seg_count;   /* same indexing */
    const int32_t *offsets;     /* [read][seg] */
    const int32_t *n_segs;      /* per read: total_cuts+1 */
    const int32_t *min_match0;  /* per read */
    const uint8_t *skip;        /* per read: 1 = no initial_map (N filter) */
    int64_t n_reads;
    int32_t max_hits, idepth;
    uint32_t *hits;             /* [read][max_hits] */
    int32_t *hits_off;
    int8_t *orient;
    int32_t *tot_hits;          /* per read */
    int nthreads;
} cjob_t;

typedef struct { cjob_t *jb; int tid; } carg_t;

/* one find_matches call for one (read, orientation) */
static void find_matches_one(const cjob_t *jb, int64_t r, int orient,
                             int *min_match, uint32_t *hits,
                             int32_t *hits_off, int8_t *orients,
                             int32_t *tot)
{
    int max_depth = jb->n_segs[r] - 1;   /* == total_cuts */
    const int32_t *offs = jb->offsets + r * MAX_SEGS;
    int64_t base = (r * 2 + orient) * MAX_SEGS;
    int32_t max_off = jb->idepth - 4;
    if (max_off < 2) max_off = 2;

    uint32_t min_spots = 4294967295u;
    for (int s = 0; s <= max_depth; s++) {
        uint32_t c = (uint32_t)jb->seg_count[base + s];
        if (c < min_spots) min_spots = c;
    }
    if (min_spots > (uint32_t)jb->max_hits) {
        *tot = 0;
        return;
    }

    uint32_t mer_pos[MAX_SEGS];
    for (int loop = 0; loop <= 1 + max_depth - *min_match; loop++) {
        const uint32_t *alist = jb->flat_pos + jb->seg_start[base + loop];
        int acount = jb->seg_count[base + loop];
        int64_t start = -((int64_t)offs[loop] + max_off);
        int64_t end = max_off;
        for (int j = loop + 1; j <= max_depth; j++) {
            int64_t e = (int64_t)max_off + offs[j] - offs[loop];
            if (e > end) end = e;
        }
        for (int s = loop; s <= max_depth; s++) mer_pos[s] = 0;

        for (int i = 0; i < acount; i++) {
            uint32_t a = alist[i];
            int64_t this_start = (int64_t)a + start;
            int64_t this_end = (int64_t)a + end;
            if (this_start < 0) this_start = 0;
            if (this_end < 0) this_end = 0;
            for (int j = loop + 1; j <= max_depth; j++) {
                const uint32_t *jl = jb->flat_pos + jb->seg_start[base + j];
                int jc = jb->seg_count[base + j];
                while ((int)mer_pos[j] < jc - 1 &&
                       (int64_t)jl[mer_pos[j]] < this_start)
                    mer_pos[j]++;
            }
            int tot_found = 1;
            for (int j = loop + 1; j <= max_depth; j++) {
                const uint32_t *jl = jb->flat_pos + jb->seg_start[base + j];
                int jc = jb->seg_count[base + j];
                for (int k = mer_pos[j];
                     k < jc && (int64_t)jl[k] <= this_end; k++) {
                    int32_t d = (int32_t)((a - jl[k]) -
                                          (uint32_t)(offs[loop] - offs[j]));
                    if (abs(d) < max_off) {
                        tot_found++;
                        break;
                    }
                }
            }
            if (tot_found > *min_match) {
                *min_match = tot_found;
                *tot = 0;
                hits[*tot] = a;
                hits_off[*tot] = offs[loop];
                orients[*tot] = (int8_t)orient;
                (*tot)++;
            } else if (tot_found == *min_match) {
                if (*tot < jb->max_hits) {
                    int isnew = 1;
                    for (int k = 0; k < *tot; k++)
                        if (hits[k] - (uint32_t)hits_off[k] ==
                            a - (uint32_t)offs[loop]) {
                            isnew = 0;
                            break;
                        }
                    if (isnew) {
                        hits[*tot] = a;
                        hits_off[*tot] = offs[loop];
                        orients[*tot] = (int8_t)orient;
                        (*tot)++;
                    }
                } else {
                    return;
                }
            }
        }
    }
}

static void *cworker(void *argp)
{
    carg_t *a = (carg_t *)argp;
    cjob_t *jb = a->jb;
    for (int64_t r = a->tid; r < jb->n_reads; r += jb->nthreads) {
        uint32_t *hits = jb->hits + r * jb->max_hits;
        int32_t *hoff = jb->hits_off + r * jb->max_hits;
        int8_t *hor = jb->orient + r * jb->max_hits;
        int32_t tot = 0;
        jb->tot_hits[r] = 0;
        if (jb->skip[r]) continue;
        int min_match = jb->min_match0[r];
        find_matches_one(jb, r, 0, &min_match, hits, hoff, hor, &tot);
        if (tot < jb->max_hits)
            find_matches_one(jb, r, 1, &min_match, hits, hoff, hor, &tot);
        jb->tot_hits[r] = tot;
    }
    return NULL;
}

void find_matches_batch(const uint32_t *flat_pos, const int64_t *seg_start,
                        const int32_t *seg_count, const int32_t *offsets,
                        const int32_t *n_segs, const int32_t *min_match0,
                        const uint8_t *skip, int64_t n_reads,
                        int32_t max_hits, int32_t idepth, int nthreads,
                        uint32_t *hits, int32_t *hits_off, int8_t *orient,
                        int32_t *tot_hits)
{
    cjob_t jb = { flat_pos, seg_start, seg_count, offsets, n_segs,
                  min_match0, skip, n_reads, max_hits, idepth,
                  hits, hits_off, orient, tot_hits, nthreads };
    if (jb.nthreads < 1) jb.nthreads = 1;
    if (jb.nthreads > 64) jb.nthreads = 64;
    pthread_t th[64];
    carg_t args[64];
    for (int t = 0; t < jb.nthreads; t++) {
        args[t].jb = &jb; args[t].tid = t;
        pthread_create(&th[t], NULL, cworker, &args[t]);
    }
    for (int t = 0; t < jb.nthreads; t++) pthread_join(th[t], NULL);
}
