"""Indel consensus substitution — merge_indel_snp.pl equivalent.

Post-processes a .snp file: builds a majority-vote consensus insertion
sequence per INS site from each sample's mapper .indel.txt.gz, rewrites
allele strings I -> +SEQ and D -> -LEN (LEN = run length of contiguous
DEL rows, which collapse to one row), and sorts rows by contig order then
position (src/merge_indel_snp.pl).

Tie-breaking on equal consensus counts: the Perl reference iterates a
hash (order randomized per run unless PERL_HASH_SEED is pinned); we pick
the first-seen string among the tied maxima, which is deterministic.
"""

from __future__ import annotations

import gzip
import os

TYPE_SNP, TYPE_DEL, TYPE_INS = 0, 1, 2


def merge_indel_snp(sdx_file: str, snp_file: str, indel_dir: str,
                    outname: str) -> None:
    chr_num = {}
    with open(sdx_file) as f:
        n = int(f.readline().split()[0])
        for i in range(n):
            chr_num[f.readline().split("\t")[1].strip()] = i

    with open(snp_file) as f:
        header = f.readline().rstrip("\n")
        hfields = header.split("\t")
        sample_names = [hfields[i] for i in range(6, len(hfields), 2)]
        lines, chrs, poss, types = [], [], [], []
        ins_needed = set()
        for raw in f:
            line = raw.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            lines.append(line)
            chrs.append(fields[0])
            poss.append(int(fields[1]))
            t = TYPE_SNP
            name = f"{fields[0]}_{fields[1]}"
            if fields[5] in ("INS", "DENOVO_INS"):
                t = TYPE_INS
                ins_needed.add(name)
            elif fields[5] in ("DEL", "DENOVO_DEL"):
                t = TYPE_DEL
            elif fields[5] in ("MULTIALLELIC", "DENOVO_MULTIALLELIC"):
                for a in fields[3].split(","):
                    if a == "I":
                        if t != TYPE_DEL:
                            t = TYPE_INS
                        ins_needed.add(name)
                    elif a == "D":
                        t = TYPE_DEL
            types.append(t)

    ins_counts = {}           # name -> {seq: (count, first_seen_rank)}
    rank = 0
    for s in sample_names:
        path = os.path.join(indel_dir, f"{s}.indel.txt.gz")
        with gzip.open(path, "rt") as f:
            rows = f.read().split("\n")
        for row in rows[1:]:
            if not row:
                continue
            fields = row.split("\t")
            name = f"{fields[0]}_{fields[1]}"
            if name not in ins_needed:
                continue
            d = ins_counts.setdefault(name, {})
            for seq in fields[7:]:
                if seq in d:
                    c, r = d[seq]
                    d[seq] = (c + 1, r)
                else:
                    d[seq] = (1, rank)
                    rank += 1

    ins_consensus = {}
    for name in ins_needed:
        if name not in ins_counts:
            continue
        best = max(ins_counts[name].items(),
                   key=lambda kv: (kv[1][0], -kv[1][1]))
        ins_consensus[name] = best[0]

    order = sorted(range(len(lines)),
                   key=lambda i: (chr_num[chrs[i]], poss[i]))

    with open(outname, "w") as f:
        f.write(header + "\n")
        i = 0
        while i < len(order):
            j = order[i]
            if types[j] == TYPE_DEL:
                fields = lines[j].split("\t")
                name = f"{fields[0]}_{fields[1]}"
                allele = 1
                k = i + 1
                while (k < len(order) and
                       poss[order[k]] - poss[order[k - 1]] == 1 and
                       types[order[k]] == TYPE_DEL):
                    allele += 1
                    k += 1
                old_3 = fields[3]
                f3 = fields[3].replace("D", f"-{allele}", 1)
                if name in ins_consensus:
                    f3 = f3.replace("I", f"+{ins_consensus[name]}", 1)
                f.write(lines[j].replace(old_3, f3, 1) + "\n")
                i = k
            elif types[j] == TYPE_INS:
                fields = lines[j].split("\t")
                name = f"{fields[0]}_{fields[1]}"
                old_3 = fields[3]
                f3 = fields[3]
                if name in ins_consensus:
                    f3 = f3.replace("I", f"+{ins_consensus[name]}", 1)
                f.write(lines[j].replace(old_3, f3, 1) + "\n")
                i += 1
            else:
                f.write(lines[j] + "\n")
                i += 1
