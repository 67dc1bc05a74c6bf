"""Good/bad site interval lists — make_snplist_formerge.pl equivalent.

A site is "good" if any .snp file in the directory typed it neither LOW
nor MESS; consecutive positions are run-length merged into bed rows
sorted in sdx contig order (src/make_snplist_formerge.pl).
"""

from __future__ import annotations

import os


def make_snplist(sdx_file: str, outname: str, directory: str = ".") -> None:
    chr_num = {}
    with open(sdx_file) as f:
        n = int(f.readline().split()[0])
        for i in range(n):
            chr_num[f.readline().split("\t")[1].strip()] = i

    snp_count, good_count = {}, {}
    chrs, poss = {}, {}
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".snp"):
            continue
        with open(os.path.join(directory, fname)) as f:
            f.readline()
            for line in f:
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 6:
                    continue
                name = f"{fields[0]}_{fields[1]}"
                chrs[name] = fields[0]
                poss[name] = int(fields[1])
                if fields[5] not in ("LOW", "MESS"):
                    good_count[name] = good_count.get(name, 0) + 1
                snp_count[name] = snp_count.get(name, 0) + 1

    good, bad = [], []
    for k in snp_count:
        (good if good_count.get(k, 0) > 0 else bad).append(k)

    for lst, suffix in ((good, ".good.bed"), (bad, ".bad.bed")):
        lst = sorted(lst, key=lambda k: (chr_num[chrs[k]], poss[k]))
        with open(outname + suffix, "w") as f:
            if not lst:
                # Perl prints an undef-interpolated "\t\t" row for an
                # empty list; reproduce
                f.write("\t\t\n")
                continue
            start = end = lst[0]
            for k in lst[1:]:
                if chrs[k] == chrs[start] and poss[k] - poss[end] == 1:
                    end = k
                else:
                    f.write(f"{chrs[start]}\t{poss[start]}\t{poss[end]}\n")
                    start = end = k
            f.write(f"{chrs[start]}\t{poss[start]}\t{poss[end]}\n")


def make_snplist_restricted(sdx_file: str, outname: str,
                            directory: str = ".") -> None:
    """Restricted variant (make_snplist_formerge_restricted.pl): only
    sites covered by every .bed file in the directory are considered.
    The upstream script self-deprecates ("Do not use"); provided for
    inventory completeness."""
    chr_num = {}
    with open(sdx_file) as f:
        n = int(f.readline().split()[0])
        for i in range(n):
            chr_num[f.readline().split("\t")[1].strip()] = i

    beds = sorted(f for f in os.listdir(directory) if f.endswith(".bed"))
    covered = {}
    for f_count, bf in enumerate(beds):
        with open(os.path.join(directory, bf)) as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 3:
                    continue
                for i in range(int(fields[1]), int(fields[2]) + 1):
                    name = f"{fields[0]}_{i}"
                    if f_count == 0:
                        covered[name] = covered.get(name, 0) + 1
                    elif covered.get(name) == f_count:
                        covered[name] += 1
    covered = {k for k, v in covered.items() if v >= len(beds)}

    snp_count, good_count = {}, {}
    chrs, poss = {}, {}
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".snp"):
            continue
        with open(os.path.join(directory, fname)) as f:
            f.readline()
            for line in f:
                fields = line.rstrip("\n").split("\t")
                if len(fields) < 6:
                    continue
                name = f"{fields[0]}_{fields[1]}"
                if name not in covered:
                    continue
                chrs[name] = fields[0]
                poss[name] = int(fields[1])
                if fields[5] not in ("LOW", "MESS"):
                    good_count[name] = good_count.get(name, 0) + 1
                snp_count[name] = snp_count.get(name, 0) + 1

    good = [k for k in snp_count if good_count.get(k, 0) > 0]
    bad = [k for k in snp_count if good_count.get(k, 0) == 0]
    for lst, suffix in ((good, ".good.bed"), (bad, ".bad.bed")):
        lst = sorted(lst, key=lambda k: (chr_num[chrs[k]], poss[k]))
        with open(outname + suffix, "w") as f:
            if not lst:
                f.write("\t\t\n")
                continue
            start = end = lst[0]
            for k in lst[1:]:
                if chrs[k] == chrs[start] and poss[k] - poss[end] == 1:
                    end = k
                else:
                    f.write(f"{chrs[start]}\t{poss[start]}\t{poss[end]}\n")
                    start = end = k
            f.write(f"{chrs[start]}\t{poss[start]}\t{poss[end]}\n")
