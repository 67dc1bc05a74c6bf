"""QC reports — snp_tran_counter.pl / snp_tran_silent_rep.pl equivalents.

Ts/Tv counts and ratios per site type (and per sample), and the
dbSNP-fraction report stratified by annotation class.  Numbers are
formatted with %.15g to match Perl's default number stringification.
"""

from __future__ import annotations


def _fmt(x) -> str:
    if isinstance(x, int):
        return str(x)
    if x == int(x):
        return str(int(x))
    return "%.15g" % x


_TRAN = {"AG", "GA", "CT", "TC"}


def _is_trans(ref: str, alleles: str) -> bool:
    if alleles in ("A,G", "C,T", "G,A", "T,C"):
        return True
    return (ref + alleles) in _TRAN


def snp_tran_counter(snp_path: str, out) -> None:
    with open(snp_path) as f:
        header = f.readline().rstrip("\n").split("\t")
        samples = [header[j] for j in range(6, len(header), 2)]
        transition, transver = {}, {}
        ts, tv = {}, {}
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 6:
                continue
            it = _is_trans(fields[2], fields[3])
            t = fields[5]
            if it:
                transition[t] = transition.get(t, 0) + 1
            else:
                transver[t] = transver.get(t, 0) + 1
            for i, j in enumerate(range(6, len(fields), 2)):
                if fields[j] != fields[2] and fields[j] != "N":
                    d = ts if it else tv
                    d.setdefault(t, {})
                    d[t][i] = d[t].get(i, 0) + 1
    types = sorted(transver.keys())
    out.write("Category")
    for t in types:
        out.write(f"\t{t}_Transitions\t{t}_Transversion\t{t}_ratio")
    out.write("\nALL")
    for t in types:
        a = transition.get(t, 0)
        b = transver.get(t, 0)
        r = a / b if b > 0 else 1
        out.write("\t%s\t%s\t%s" % (_fmt(a), _fmt(b), _fmt(r)))
    for i, s in enumerate(samples):
        out.write("\n%s" % s)
        for t in types:
            a = ts.get(t, {}).get(i, 0)
            b = tv.get(t, {}).get(i, 0)
            r = a / b if b > 0 else 1
            out.write("\t%s\t%s\t%s" % (_fmt(a), _fmt(b), _fmt(r)))
    out.write("\n")


def snp_tran_silent_rep(snp_path: str, annot_path: str, type_filter: str,
                        out) -> None:
    type_filter = type_filter.upper()
    snp_type, rs_type = {}, {}
    with open(annot_path) as f:
        # Perl quirk: the header line is NOT chomped before matching, so
        # a wanted column name in the LAST position keeps its newline and
        # never matches; the undef index then reads field 0
        # (snp_tran_silent_rep.pl:36-45)
        header = f.readline().split("\t")
        site_code = header.index("annotation_type") \
            if "annotation_type" in header else 0
        snp_id = header.index("snp_id") if "snp_id" in header else 0
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if len(fields) <= max(site_code, snp_id):
                continue
            key = f"{fields[0]}_{fields[1]}"
            classes = sorted(set(fields[site_code].split(";")))
            snp_type[key] = ";".join(classes)
            rs_type[key] = 1 if fields[snp_id].startswith("rs") else 0

    with open(snp_path) as f:
        header = f.readline().rstrip("\n").split("\t")
        samples = ["ALL"] + [header[j] for j in range(6, len(header), 2)]
        ts, tv, rs = {}, {}, {}
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 6:
                continue
            if type_filter not in fields[5].upper():
                continue
            key = f"{fields[0]}_{fields[1]}"
            if key not in snp_type:
                continue
            tt = snp_type[key]
            it = _is_trans(fields[2], fields[3])
            is_rs = rs_type[key]
            rs.setdefault(tt, {})
            rs[tt][0] = rs[tt].get(0, 0) + is_rs
            d = ts if it else tv
            d.setdefault(tt, {})
            d[tt][0] = d[tt].get(0, 0) + 1
            for i, j in enumerate(range(6, len(fields), 2), start=1):
                if fields[j] != fields[2] and fields[j] != "N":
                    rs.setdefault(tt, {})
                    rs[tt][i] = rs[tt].get(i, 0) + is_rs
                    d = ts if it else tv
                    d.setdefault(tt, {})
                    d[tt][i] = d[tt].get(i, 0) + 1
    types = sorted(tv.keys())
    out.write("\nSample")
    for t in types:
        out.write("\t%s_transistions\t%s_transversions\t%s_ratio"
                  "\t%s_in_dbsnp\t%s_dbsnp_ratio" % (t, t, t, t, t))
    for i, s in enumerate(samples):
        out.write("\n%s" % s)
        for t in types:
            a = ts.get(t, {}).get(i, 0)
            b = tv.get(t, {}).get(i, 0)
            tot = a + b
            rr = rs.get(t, {}).get(i, 0) / tot if tot > 0 else 0
            ratio = a / b if b > 0 else 1.0
            out.write("\t%s\t%s\t%s\t%s\t%s" % (
                _fmt(a), _fmt(b), _fmt(ratio),
                _fmt(rs.get(t, {}).get(i, 0)), _fmt(rr)))
    out.write("\n")
