"""VCF 4.0 export — snp_to_vcf equivalent (src/snp_to_vcf.c:72-520).

Converts a (merged, indel-substituted) .snp file to VCF on a stream.
Reproduces the reference's output byte-for-byte, including its header
quirks (##phasing=none lacks a newline; fileDate is %d%d%d unpadded),
per-type REF/ALT construction, IUPAC het call maps, and the genome-anchor
lookups for deletions.
"""

from __future__ import annotations

import gzip
import time

import numpy as np

from ..formats.sdx import read_sdx, read_seq

HET_MAP = {}
for _pair, _code in (("AC", "M"), ("AG", "R"), ("AT", "W"), ("AD", "E"),
                     ("AI", "H"), ("CG", "S"), ("CT", "Y"), ("CD", "E"),
                     ("CI", "H"), ("GT", "K"), ("GD", "E"), ("GI", "H"),
                     ("TD", "E"), ("TI", "H"), ("DI", "E"), ("ID", "H")):
    HET_MAP[(_pair[0], _pair[1])] = _code
    if _pair[0] in "ACGT" and _pair[1] in "ACGT":
        HET_MAP[(_pair[1], _pair[0])] = _code
HET_MAP[("D", "A")] = HET_MAP[("D", "C")] = HET_MAP[("D", "G")] = \
    HET_MAP[("D", "T")] = "E"
HET_MAP[("I", "A")] = HET_MAP[("I", "C")] = HET_MAP[("I", "G")] = \
    HET_MAP[("I", "T")] = "H"


def snp_to_vcf(sdx_path: str, snp_path: str, out,
               min_prob: float = 0.0, now=None) -> None:
    """Write VCF to the text stream ``out``."""
    sdx = read_sdx(sdx_path)
    base = sdx_path[:sdx_path.rfind(".")] if ".sdx" in sdx_path else sdx_path
    genome = read_seq(base + ".seq", sdx.genome_size)
    sstarts = sdx.sstarts
    name_to_chrom = {nm: i for i, nm in enumerate(sdx.names)}

    tm = time.localtime(now) if now is not None else time.localtime()
    out.write("##fileformat=VCFv4.0\n")
    out.write("##fileDate=%d%d%d\n" % (tm.tm_year, tm.tm_mon, tm.tm_mday))
    out.write("##reference=%s\n" % sdx_path)
    out.write("##phasing=none")      # reference omits the newline here
    out.write("##INFO=<ID=NS,Number=1,Type=Integer,"
              "Description=\"Number of Samples With Data\">\n")
    out.write("##FORMAT=<ID=GQ,Number=1,Type=Integer,"
              "Description=\"Genotype Quality\">\n")
    out.write("##FORMAT=<ID=GT,Number=1,Type=String,"
              "Description=\"Genotype\">\n")
    out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT")

    op = gzip.open if _is_gz(snp_path) else open
    with op(snp_path, "rt") as f:
        header = f.readline()
        toks = header.split()
        samples = toks[6:]
        for s in samples:
            out.write("\t%s" % s)
        tot_samples = len(samples)

        # call_map persists across rows like the reference's static table:
        # only the standard keys are re-initialized per row, so exotic
        # assignments (e.g. to 'N' via an unknown het pair) linger
        call_map = {c: "./." for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ"}
        for line in f:
            if len(line.rstrip("\n")) <= 5:
                continue
            tok = line.split()
            chrom, pos, ref = tok[0], int(tok[1]), tok[2][0]
            alt_a_temp = tok[3]
            typ = tok[5]
            if typ in ("LOW", "MESS"):
                continue
            for c in "ACGTID":
                call_map[c] = "1/1"
            for c in "YRSWKMEH":
                call_map[c] = "0/1"
            call_map[ref] = "0/0"
            slabel = "PASS"
            ref_string = ref
            allele_char = {0: ref}

            if typ in ("SNP", "DENOVO_SNP"):
                if alt_a_temp[0] == ref:
                    alt = alt_a_temp[2]
                else:
                    alt = alt_a_temp[0]
                alt_a_final = alt
                call_map[alt] = "1/1"
                allele_char[1] = alt
            elif typ in ("MULTIALLELIC", "DENOVO_MULTIALLELIC"):
                this_a = 1
                p = 0
                has_del = False
                alt_a_final = ""
                stop = len(alt_a_temp)
                while p < stop:
                    ch = alt_a_temp[p]
                    if ch == ref:
                        p += 2
                    elif ch == "+":
                        allele_char[this_a] = "I"
                        call_map["I"] = "%d/%d" % (this_a, this_a)
                        call_map["H"] = "0/%d" % this_a
                        if not has_del:
                            if this_a == 1:
                                alt_a_final = ref
                            else:
                                alt_a_final = "%s,%c" % (alt_a_final, ref)
                        else:
                            alt_a_final = "%s,%s" % (alt_a_final, ref_string)
                        p += 1
                        while p < stop and alt_a_temp[p] != ",":
                            if alt_a_temp[p].isalpha():
                                alt_a_final += alt_a_temp[p]
                            p += 1
                        p += 1
                        this_a += 1
                        slabel = "."
                    elif ch == "-":
                        allele_char[this_a] = "D"
                        call_map["D"] = "%d/%d" % (this_a, this_a)
                        call_map["E"] = "0/%d" % this_a
                        which = name_to_chrom[chrom]
                        pos -= 1
                        off = pos + sstarts[which] - 1
                        has_del = True
                        ref = chr(genome[off])
                        p += 1
                        sn = ""
                        while p < stop and alt_a_temp[p] != ",":
                            sn += alt_a_temp[p]
                            p += 1
                        del_len = int(sn) + 1
                        gb = genome[off:off + del_len].tobytes().decode()
                        ref_string = gb
                        slabel = "."
                        if this_a == 1:
                            alt_a_final = ref
                        else:
                            prev = alt_a_final
                            sn2 = list(ref_string)
                            sn2[1] = prev[0]
                            alt_a_final = "".join(sn2)
                            jj = 2
                            for i2 in range(2, this_a):
                                sn2 = list(ref_string)
                                sn2[1] = prev[jj]
                                alt_a_final = "%s,%s" % (alt_a_final,
                                                         "".join(sn2))
                                jj += 2
                            alt_a_final = "%s,%c" % (alt_a_final, ref)
                        p += 1
                        this_a += 1
                        slabel = "."
                    else:
                        allele_char[this_a] = ch
                        call_map[ch] = "%d/%d" % (this_a, this_a)
                        for i2 in range(this_a + 1):
                            for j2 in range(i2 + 1, this_a + 1):
                                hm = HET_MAP.get((allele_char[i2],
                                                  allele_char[j2]), "N")
                                call_map[hm] = "%d/%d" % (i2, j2)
                        if this_a == 1:
                            alt_a_final = ch
                        else:
                            alt_a_final = "%s,%c" % (alt_a_final, ch)
                        this_a += 1
                        p += 2
            elif typ in ("INS", "DENOVO_INS"):
                mono = "," not in alt_a_temp[1:]
                if not mono:
                    alt_a_final = "%c%s" % (ref, alt_a_temp[3:])
                else:
                    alt_a_final = "%c%s" % (ref, alt_a_temp[1:])
                slabel = "."
            else:   # DEL / DENOVO_DEL
                which = name_to_chrom[chrom]
                pos -= 1
                off = pos + sstarts[which] - 1
                ref = chr(genome[off])
                mono = "," not in alt_a_temp[1:]
                sn = alt_a_temp[3:] if not mono else alt_a_temp[1:]
                del_len = int(sn) + 1
                ref_string = genome[off:off + del_len].tobytes().decode()
                slabel = "."
                alt_a_final = ref
            out.write("\n%s\t%d\t.\t%s\t%s\t.\t%s\tNS=%d\tGT:GQ" % (
                chrom, pos, ref_string, alt_a_final, slabel, tot_samples))
            for i in range(tot_samples):
                call = tok[6 + 2 * i]
                prob = tok[7 + 2 * i]
                if float(prob) >= min_prob:
                    out.write("\t%s" % call_map.get(call[0], "./."))
                else:
                    out.write("\t./.")
                out.write(":%s" % prob)
    out.write("\n")


def _is_gz(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"
