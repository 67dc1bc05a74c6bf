"""Cohort .base.gz merger — pecall_merger equivalent.

Merges per-run .base.gz call matrices at a bed-listed site set, unioning
sample columns by name, with the reference's quality-gated merge rule
(pecall_merger.c:171-188, 427-455): both calls confident (>= 242/255)
must agree else HARD_N; soft-N yields to data; otherwise the higher
quality wins.  Output is a merged .snp-format file (:472-552).
"""

from __future__ import annotations

import gzip
import os

import numpy as np

SOFT_N = 14
HARD_N = 15
INT_TO_CHAR = "ACGTDIMRWSYKEH" + "NN"
CHAR_TO_INT = {}
for _i, _c in enumerate("ACGTDIMRWSYKEH"):
    CHAR_TO_INT[_c] = _i
    CHAR_TO_INT[_c.lower()] = _i
CHAR_TO_INT["N"] = CHAR_TO_INT["n"] = SOFT_N


def _get_het_alleles(i, ref):
    pairs = {6: (0, 1), 7: (0, 2), 8: (0, 3), 9: (1, 2), 10: (1, 3),
             11: (2, 3), 12: (ref, 4), 13: (ref, 5)}
    if i < 6:
        return i, i
    if i in pairs:
        return pairs[i]
    return 14, 14


def _merge_call(old, new):
    if old == SOFT_N:
        return new
    if new == SOFT_N:
        return old
    return old if old == new else HARD_N


def run_merger(bedfile: str, outfile: str, sdxfile: str,
               is_haploid: bool = False, directory: str = ".",
               thres: float = 0.95) -> None:
    with open(sdxfile) as f:
        n = int(f.readline().split()[0])
        contig_names = []
        for _ in range(n):
            contig_names.append(f.readline().split("\t")[1].strip())
    name_to_chrom = {nm: i for i, nm in enumerate(contig_names)}

    # bed -> site list (bed order; one node per base, inclusive range)
    site_chrom, site_pos = [], []
    with open(bedfile) as f:
        for line in f:
            if len(line.strip()) <= 3:
                continue
            tok = line.split()
            c = name_to_chrom[tok[0]]
            start, stop = int(tok[1]), int(tok[2])
            for p in range(start, stop + 1):
                site_chrom.append(c)
                site_pos.append(p)
    site_chrom = np.asarray(site_chrom, dtype=np.int64)
    site_pos = np.asarray(site_pos, dtype=np.int64)
    n_sites = len(site_pos)
    site_key = site_chrom * (1 << 40) + site_pos

    char_thres = int(np.rint(thres * 255))
    sample_names = []
    calls = np.full((n_sites, 0), SOFT_N, dtype=np.int16)
    quals = np.zeros((n_sites, 0), dtype=np.uint8)
    refs = np.zeros(n_sites, dtype=np.uint8)
    known_until = np.zeros(n_sites, dtype=np.int32)  # last_sample at the
    # site's most recent match; later-added samples print as "N 1"
    out_chrom = site_chrom.copy()
    out_pos = site_pos.copy()

    for entry in os.listdir(directory):
        if "base.gz" not in entry:
            continue
        with gzip.open(os.path.join(directory, entry), "rt") as f:
            header = f.readline()
            toks = header.split()
            file_samples = [t for t in toks[3:] if len(t) > 2]
            smap = []
            for s in file_samples:
                if s in sample_names:
                    smap.append(sample_names.index(s))
                else:
                    sample_names.append(s)
                    calls = np.concatenate(
                        [calls, np.full((n_sites, 1), SOFT_N, np.int16)],
                        axis=1)
                    quals = np.concatenate(
                        [quals, np.zeros((n_sites, 1), np.uint8)], axis=1)
                    smap.append(len(sample_names) - 1)
            for line in f:
                if len(line.strip()) <= 10:
                    continue
                tok = line.split()
                c = name_to_chrom.get(tok[0])
                if c is None:
                    raise RuntimeError(f"unknown chromosome {tok[0]}")
                pos = int(tok[1])
                key = c * (1 << 40) + pos
                idx = np.searchsorted(site_key, key)
                if idx >= n_sites or site_key[idx] != key:
                    continue
                refs[idx] = ord(tok[2][0])
                out_chrom[idx] = c
                out_pos[idx] = pos
                known_until[idx] = len(sample_names)
                for si, s_global in enumerate(smap):
                    cal = CHAR_TO_INT.get(tok[3 + 2 * si], HARD_N)
                    q = float(tok[4 + 2 * si])
                    qc = int(np.rint(q * 255))
                    if qc >= char_thres:
                        if quals[idx, s_global] >= char_thres:
                            quals[idx, s_global] = max(quals[idx, s_global],
                                                       qc)
                            calls[idx, s_global] = _merge_call(
                                calls[idx, s_global], cal)
                        else:
                            quals[idx, s_global] = qc
                            calls[idx, s_global] = cal
                    elif qc > quals[idx, s_global]:
                        quals[idx, s_global] = qc
                        calls[idx, s_global] = cal

    n_samp = len(sample_names)
    with open(outfile, "w") as f:
        f.write("Fragment\tPosition\tReference\tAlleles\tAllele_Counts\tType")
        for s in sample_names:
            f.write("\t%s\t" % s)
        for i in range(n_sites):
            ref = CHAR_TO_INT.get(chr(refs[i]), HARD_N) \
                if refs[i] else HARD_N
            this_s = min(n_samp, int(known_until[i]))
            ac = [0] * 6
            if ref < 4:     # reference table only covers ACGT refs
                for j in range(this_s):
                    a, b = _get_het_alleles(int(calls[i, j]), ref)
                    if a < 6:
                        ac[a] += 1
                    if not is_haploid and b < 6:
                        ac[b] += 1
            # reference counts via its allele_counts table: het pairs give
            # one each; homs give 2 (1 haploid); N gives none
            no_alleles = sum(1 for x in ac if x > 0)
            if no_alleles == 0:
                continue
            if no_alleles > 2:
                t = "MULTIALLELIC"
            elif ac[4] > 0:
                t = "DEL"
            elif ac[5] > 0:
                t = "INS"
            else:
                t = "SNP"
            astr = ",".join(INT_TO_CHAR[k] for k in range(6) if ac[k] > 0)
            cstr = ",".join(str(ac[k]) for k in range(6) if ac[k] > 0)
            f.write("\n%s\t%d\t%c\t%s\t%s\t%s" % (
                contig_names[out_chrom[i]], out_pos[i], chr(refs[i]),
                astr, cstr, t))
            for j in range(this_s):
                f.write("\t%c\t%s" % (INT_TO_CHAR[int(calls[i, j])],
                                      "%g" % (quals[i, j] / 255.0)))
            for j in range(this_s, n_samp):
                f.write("\tN\t1")
        f.write("\n")
