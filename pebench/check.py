"""What decides ``correct``: the timed path's answers against the plain
reference (``reference/mapper.py``) on a sample drawn from the seed.

The sample is every pair whose fragment lies near one of a few genome
regions drawn from the seed.  On a genome of random bases a read can only
be placed within a few bases of where it was drawn (a second placement
would need ~85 matching bases by chance), so every read that adds to a
region's pileup is in the sample, and the region's pileup is the sum of
the sample's walks, each counted as often as the window resolved its
batch.  Compared, each with the limit 0 (the program claims the
reference's answers exactly):

* ``answers_wrong``: read ends of the sample, over every resolve of their
  batch, whose class or .mfile value differs from the reference's (or
  that the program never returned);
* ``pileup_cells_wrong``: (position, column) cells of the regions' pileup
  that differ;
* ``insertions_wrong``: insertion records (read, end, position, bases) in
  the regions, as a multiset, that are not in both;
* ``summary_wrong``: the summary's counts against the sum of the answers
  the program returned (class counts, mapped reads and bases, insert
  distances).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .reference import mapper as ref

LIMITS = {"answers_wrong": 0, "pileup_cells_wrong": 0,
          "insertions_wrong": 0, "summary_wrong": 0}
MARGIN = 50          # bases past a region whose fragments join the sample


def sample(truth: dict, genome_len: int, check: dict, seed: int) -> dict:
    """Regions (start, end) drawn from the seed, one in each of
    ``check["regions"]`` equal slices of the genome, sized so that about
    ``check["pairs"]`` pairs fall near them, and those pairs' indices."""
    rng = np.random.default_rng([seed, 7])
    n_pairs = len(truth["start"])
    n_reg = check["regions"]
    density = n_pairs / genome_len
    span = check["pairs"] / n_reg / density
    length = int(max(span - 2 * MARGIN - truth["insert"].mean(), 100))
    slice_len = genome_len // n_reg
    if length + 2 * MARGIN >= slice_len:
        raise ValueError("the check's regions do not fit the genome")
    regions = []
    for r in range(n_reg):
        lo = r * slice_len + MARGIN
        s = int(rng.integers(lo, lo + slice_len - length - 2 * MARGIN))
        regions.append((s, s + length))
    f0 = truth["start"]
    f1 = f0 + truth["insert"]
    near = np.zeros(n_pairs, bool)
    for s, e in regions:
        near |= (f1 > s - MARGIN) & (f0 < e + MARGIN)
    return dict(regions=regions, pairs=np.nonzero(near)[0])


class Answers:
    """The per-pair answers of the sample's pairs, collected at every
    resolve, and the summary the answers add up to."""

    def __init__(self, smp: dict, batch_pairs: int, n_batches: int,
                 max_dist: int):
        self.batch_pairs = batch_pairs
        self.max_dist = max_dist
        ids = smp["pairs"]
        self.local = [ids[(ids // batch_pairs) == b] - b * batch_pairs
                      for b in range(n_batches)]
        self.resolves = np.zeros(n_batches, np.int64)
        self.seen = []                      # (batch, m1, m2, code, n)
        self.summary = dict(mate_counts=np.zeros(9, np.int64),
                            total_reads=0, total_bases=0, total_dist=0,
                            no_dists=0)

    def add(self, b, m1, m2, code, l1, l2):
        self.resolves[b] += 1
        loc = self.local[b]
        ok = loc < len(code)
        self.seen.append((b, np.asarray(m1)[loc[ok]], np.asarray(m2)[loc[ok]],
                          np.asarray(code)[loc[ok]], int(ok.sum())))
        n = len(code)
        sm = self.summary
        sm["mate_counts"] += np.bincount(np.asarray(code, np.int64),
                                         minlength=9)[:9]
        h1, h2 = np.asarray(m1) != 0, np.asarray(m2) != 0
        sm["total_reads"] += int(h1.sum() + h2.sum())
        sm["total_bases"] += int(l1[:n][h1].sum() + l2[:n][h2].sum())
        both = h1 & h2
        d = (np.asarray(m1, np.int64)[both]
             - np.asarray(m2, np.int64)[both]) % (1 << 32)
        ok_d = d < self.max_dist * 4
        sm["total_dist"] += int(d[ok_d].sum())
        sm["no_dists"] += int(ok_d.sum())


def program_outputs(eng, regions) -> dict:
    """The engine's pileup over the regions and its insertion records in
    them (read number, end, position, bases), as a multiset."""
    pile = eng.final_pileup()
    piles = [np.array(pile[s:e]) for s, e in regions]
    ins = Counter()
    for (rn, end), g, s in eng.ins_records:
        if any(a <= g < b for a, b in regions):
            ins[(int(rn), int(end), int(g), s)] += 1
    st = eng.stats
    summary = dict(mate_counts=np.asarray(st.mate_counts, np.int64),
                   total_reads=int(st.total_reads),
                   total_bases=int(st.total_bases),
                   total_dist=int(st.total_dist), no_dists=int(st.no_dists))
    return dict(piles=piles, ins=ins, summary=summary)


def reference(genome, pairs: dict, smp: dict, settings, device,
              dtype=torch.float64) -> dict:
    """The reference's answers, walks and insertions for the sample."""
    ids = smp["pairs"]
    table = ref.KmerTable(genome, device)
    out = ref.map_pairs(genome, table, pairs["r1"][ids], pairs["l1"][ids],
                        pairs["r2"][ids], pairs["l2"][ids], settings, dtype,
                        device)
    out["ids"] = ids
    return out


def compare(want: dict, answers: Answers, got: dict, smp: dict) -> dict:
    """The numbers compared, each with its limit."""
    row = {int(p): n for n, p in enumerate(want["ids"])}
    wrong = 0
    for b, m1, m2, code, n_ok in answers.seen:
        loc = answers.local[b]
        wrong += 2 * (len(loc) - n_ok)
        pair_ids = loc[:n_ok] + b * answers.batch_pairs
        k = np.asarray([row[int(p)] for p in pair_ids], np.int64)
        bad_c = code != want["codes"][k]
        wrong += int((bad_c | (m1 != want["m1"][k])).sum()
                     + (bad_c | (m2 != want["m2"][k])).sum())
    times = answers.resolves[want["ids"] // answers.batch_pairs]
    ev = want["events"]
    cells = 0
    for (s, e), pile in zip(smp["regions"], got["piles"]):
        exp = np.zeros((e - s, 6), np.int64)
        sel = (ev[:, 1] >= s) & (ev[:, 1] < e)
        np.add.at(exp, (ev[sel, 1] - s, ev[sel, 2]), times[ev[sel, 0]])
        cells += int(((exp % 65536) != pile.astype(np.int64)).sum())
    exp_ins = Counter()
    for p, end, g, seq in want["insertions"]:
        if any(a <= g < b for a, b in smp["regions"]) and times[p]:
            exp_ins[(int(want["ids"][p]), end, g, seq)] += int(times[p])
    ins = sum(((exp_ins - got["ins"]) + (got["ins"] - exp_ins)).values())
    summ = 0
    if got.get("summary") is not None:
        a, b = got["summary"], answers.summary
        summ = int(np.abs(a["mate_counts"] - b["mate_counts"]).sum()) + sum(
            abs(a[k] - b[k]) for k in ("total_reads", "total_bases",
                                       "total_dist", "no_dists"))
    got_n = {"answers_wrong": wrong, "pileup_cells_wrong": cells,
             "insertions_wrong": ins, "summary_wrong": summ}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in got_n.items()}


def verdict(numbers: dict) -> bool:
    return all(x["value"] <= x["limit"] for x in numbers.values())
