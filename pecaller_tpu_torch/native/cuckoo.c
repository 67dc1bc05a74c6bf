/* Two-table cuckoo rank table placement (index/nbr.py cuckoo_place).
 *
 * The same rounds as the reference's vectorized numpy build
 * (pecaller_tpu/index/nbr.py build_cuckoo), one key after the other:
 * each round every pending key reads the occupant of its slot in its
 * table (all reads before any write), the first pending key of each
 * slot writes it, and the keys that lost their slot, then the occupants
 * their winners displaced (each in pending order), pend again on the
 * other table.  The tables, and so every lookup, equal the reference's
 * bit for bit.  A slot's tag, value and key sit together in one work
 * table (one cache line a random access), split into tagt / valt at
 * the end.
 */
#include <stdint.h>
#include <stdlib.h>
#include <sys/mman.h>

typedef struct {
    uint32_t tag, val, key;
} slot_t;

#define PF 32           /* prefetch distance of the random slot walks */

/* Work buffers from anonymous maps advised as huge pages: this host
 * zeroes fresh 4 KiB pages at tens of MB/s (utils/hugemem.py).  Zeroed. */
static void *huge_alloc(size_t nbytes)
{
    void *p = mmap(NULL, nbytes + 1, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED)
        return NULL;
    madvise(p, nbytes + 1, MADV_HUGEPAGE);
    return p;
}

static void huge_free(void *p, size_t nbytes)
{
    if (p)
        munmap(p, nbytes + 1);
}

static inline uint32_t mix1(uint32_t x)
{
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

static inline uint32_t mix2(uint32_t x)
{
    x ^= x >> 17;
    x *= 0xED5AD4BBu;
    x ^= x >> 11;
    x *= 0xAC4C1B51u;
    x ^= x >> 15;
    x *= 0x31848BABu;
    x ^= x >> 14;
    return x;
}

/* Place n unique keys with their value words ``start`` and tag bits
 * ``tagbits`` (abundant << 30 | count << 22) into tagt / valt (2 << tb
 * words each).  A slot's tag word is 1 << 31 | tagbits | (mix >> tb),
 * an empty slot's 0.  Returns 0 when every key is placed, 1 when
 * max_rounds did not suffice, -1 when memory ran out. */
int cuckoo_place(const uint32_t *keys, const uint32_t *start,
                 const uint32_t *tagbits, int64_t n, int tb,
                 int max_rounds, uint32_t *tagt, uint32_t *valt)
{
    const uint64_t T = 1ull << tb;
    const size_t nw = 2 * T * sizeof(slot_t);
    const size_t n4 = (size_t)n * sizeof(uint32_t);
    int rc = -1;
    slot_t *w = huge_alloc(nw);
    /* pending keys, two buffers of (key, value, tag bits, table) */
    uint32_t *pk[2], *pv[2], *pb[2];
    uint8_t *pt[2];
    uint64_t *slot = huge_alloc(2 * n4);
    slot_t *occ = huge_alloc((size_t)n * sizeof(slot_t));
    uint8_t *ev = huge_alloc((size_t)n);
    for (int b = 0; b < 2; b++) {
        pk[b] = huge_alloc(n4);
        pv[b] = huge_alloc(n4);
        pb[b] = huge_alloc(n4);
        pt[b] = huge_alloc((size_t)n);
    }
    if (!w || !slot || !occ || !ev || !pk[0] || !pk[1] || !pv[0] || !pv[1]
        || !pb[0] || !pb[1] || !pt[0] || !pt[1])
        goto out;
    for (int64_t i = 0; i < n; i++) {
        pk[0][i] = keys[i];
        pv[0][i] = start[i];
        pb[0][i] = tagbits[i];
        pt[0][i] = 0;
    }
    int cur = 0;
    int64_t m = n;
    for (int r = 0; r < max_rounds && m > 0; r++) {
        uint32_t *k = pk[cur], *v = pv[cur], *bits = pb[cur];
        uint8_t *tab = pt[cur];
        for (int64_t i = 0; i < m; i++) {
            uint32_t h = tab[i] ? mix2(k[i]) : mix1(k[i]);
            slot[i] = (uint64_t)tab[i] * T + (h & (uint32_t)(T - 1));
        }
        /* random slots: prefetch PF keys ahead */
        for (int64_t i = 0; i < m; i++) {
            if (i + PF < m)
                __builtin_prefetch(&w[slot[i + PF]]);
            occ[i] = w[slot[i]];
        }
        /* first-come wins: the lowest pending index writes last */
        for (int64_t i = m - 1; i >= 0; i--) {
            if (i >= PF)
                __builtin_prefetch(&w[slot[i - PF]], 1);
            uint32_t h = tab[i] ? mix2(k[i]) : mix1(k[i]);
            slot_t *e = &w[slot[i]];
            e->tag = (1u << 31) | bits[i] | (uint32_t)(h >> tb);
            e->val = v[i];
            e->key = k[i];
        }
        int nxt = 1 - cur;
        int64_t nn = 0;
        for (int64_t i = 0; i < m; i++) {
            if (i + PF < m)
                __builtin_prefetch(&w[slot[i + PF]]);
            int won = w[slot[i]].key == k[i];
            ev[i] = won && (occ[i].tag >> 31);
            if (!won) {
                pk[nxt][nn] = k[i];
                pv[nxt][nn] = v[i];
                pb[nxt][nn] = bits[i];
                pt[nxt][nn] = 1 - tab[i];
                nn++;
            }
        }
        for (int64_t i = 0; i < m; i++) {
            if (ev[i]) {                            /* displaced */
                pk[nxt][nn] = occ[i].key;
                pv[nxt][nn] = occ[i].val;
                pb[nxt][nn] = occ[i].tag & 0x7FC00000u;
                pt[nxt][nn] = 1 - tab[i];
                nn++;
            }
        }
        cur = nxt;
        m = nn;
    }
    rc = m == 0 ? 0 : 1;
    for (uint64_t s = 0; s < 2 * T; s++) {
        tagt[s] = w[s].tag;
        valt[s] = w[s].val;
    }
out:
    huge_free(w, nw);
    huge_free(slot, 2 * n4);
    huge_free(occ, (size_t)n * sizeof(slot_t));
    huge_free(ev, (size_t)n);
    for (int b = 0; b < 2; b++) {
        huge_free(pk[b], n4);
        huge_free(pv[b], n4);
        huge_free(pb[b], n4);
        huge_free(pt[b], (size_t)n);
    }
    return rc;
}
