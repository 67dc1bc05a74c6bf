/* Hugepage-backed numpy data allocator (NEP 49 PyDataMem_SetHandler).
 *
 * This sandbox VM zeroes fresh 4 KiB anonymous pages at ~30-50 MB/s, so
 * first-touch of every large numpy temporary (np.unique, concatenate,
 * copies — measured 14-38 s per 100-200 MB array) dominates any host
 * pipeline streaming GBs.  2 MiB-aligned MADV_HUGEPAGE mmaps fault ~50x
 * faster (utils/hugemem.py measured the same buffer at 0.3 s vs 34 s).
 * numpy's built-in hugepage madvise does not help here because glibc
 * malloc's mmap regions are not 2 MiB aligned, so THP rarely forms.
 *
 * Allocations >= 2 MiB come from aligned anonymous mmaps with
 * MADV_HUGEPAGE; smaller ones fall through to malloc.  A 64-byte header
 * in front of every allocation records which path owns the pointer (the
 * numpy handler's free() does receive a size, but realloc() does not,
 * so the header carries it).
 */

#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_22_API_VERSION
#define NPY_TARGET_VERSION NPY_1_22_API_VERSION
#define PY_ARRAY_UNIQUE_SYMBOL pecaller_npalloc_ARRAY_API
#include <numpy/arrayobject.h>

#include <string.h>
#include <sys/mman.h>

#define HDR 64
#define THRESH (1ull << 21)
#define ALIGN  (1ull << 21)
#define MAGIC_MMAP   0x50474d4d41ull    /* "AMMGP" */
#define MAGIC_MALLOC 0x434c4c414dull    /* "MALLC" */

typedef struct {
    unsigned long long magic;
    unsigned long long total;           /* bytes incl. header (mmap: map len) */
} hdr_t;

static void *hp_malloc(void *ctx, size_t size)
{
    (void)ctx;
    size_t total = size + HDR;
    if (total >= THRESH) {
        /* THP only forms on 2 MiB-ALIGNED virtual ranges: over-map by
         * ALIGN, trim the unaligned head/tail back to the kernel. */
        size_t asz = (total + ALIGN - 1) & ~(ALIGN - 1);
        void *raw = mmap(NULL, asz + ALIGN, PROT_READ | PROT_WRITE,
                         MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
        if (raw == MAP_FAILED)
            return NULL;
        uintptr_t base = ((uintptr_t)raw + ALIGN - 1) & ~(ALIGN - 1);
        size_t head = base - (uintptr_t)raw;
        if (head)
            munmap(raw, head);
        size_t tail = ALIGN - head;
        if (tail)
            munmap((void *)(base + asz), tail);
        void *p = (void *)base;
        madvise(p, asz, MADV_HUGEPAGE);
        hdr_t *h = (hdr_t *)p;
        h->magic = MAGIC_MMAP;
        h->total = asz;
        return (char *)p + HDR;
    }
    void *p = malloc(total);
    if (!p)
        return NULL;
    hdr_t *h = (hdr_t *)p;
    h->magic = MAGIC_MALLOC;
    h->total = total;
    return (char *)p + HDR;
}

static void *hp_calloc(void *ctx, size_t nelem, size_t elsize)
{
    size_t size;
    if (elsize && nelem > (size_t)-1 / elsize)
        return NULL;
    size = nelem * elsize;
    void *p = hp_malloc(ctx, size);
    if (!p)
        return NULL;
    if (((hdr_t *)((char *)p - HDR))->magic == MAGIC_MALLOC)
        memset(p, 0, size);             /* fresh mmap pages are zero */
    return p;
}

static void hp_free(void *ctx, void *ptr, size_t size)
{
    (void)ctx;
    (void)size;
    if (!ptr)
        return;
    hdr_t *h = (hdr_t *)((char *)ptr - HDR);
    if (h->magic == MAGIC_MMAP)
        munmap(h, h->total);
    else
        free(h);
}

static void *hp_realloc(void *ctx, void *ptr, size_t new_size)
{
    if (!ptr)
        return hp_malloc(ctx, new_size);
    hdr_t *h = (hdr_t *)((char *)ptr - HDR);
    size_t old_data = h->total - HDR;
    if (h->magic == MAGIC_MALLOC && new_size + HDR < THRESH) {
        hdr_t *nh = (hdr_t *)realloc(h, new_size + HDR);
        if (!nh)
            return NULL;
        nh->total = new_size + HDR;
        return (char *)nh + HDR;
    }
    void *np_ = hp_malloc(ctx, new_size);
    if (!np_)
        return NULL;
    memcpy(np_, ptr, old_data < new_size ? old_data : new_size);
    hp_free(ctx, ptr, 0);
    return np_;
}

static PyDataMem_Handler hp_handler = {
    "pecaller_hugepage_allocator",
    1,
    {
        NULL,
        hp_malloc,
        hp_calloc,
        hp_realloc,
        hp_free,
    }
};

static PyObject *install(PyObject *self, PyObject *args)
{
    (void)self;
    (void)args;
    PyObject *cap = PyCapsule_New(&hp_handler, "mem_handler", NULL);
    if (!cap)
        return NULL;
    PyObject *old = PyDataMem_SetHandler(cap);
    Py_DECREF(cap);
    if (!old)
        return NULL;
    Py_DECREF(old);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"install", install, METH_NOARGS,
     "Install the hugepage-backed numpy data allocator."},
    {NULL, NULL, 0, NULL}
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "pecaller_npalloc", NULL, -1, methods,
    NULL, NULL, NULL, NULL
};

PyMODINIT_FUNC PyInit_pecaller_npalloc(void)
{
    import_array();
    return PyModule_Create(&moduledef);
}
