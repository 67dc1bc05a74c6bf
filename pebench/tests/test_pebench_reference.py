"""The plain reference against the port's exact host engine (the f64 C
oracle, ``MapperEngine``) on a small genome: classes, .mfile values,
pileup and insertion records equal."""

import numpy as np
import pytest

from pebench.reference import mapper as ref
from pebench.traffic import gen


@pytest.mark.parametrize("err,mut,indel,n", [(0.02, 0.001, 0.15, 1500),
                                             (0.03, 0.02, 0.5, 800)],
                         ids=["cell-rates", "tie-heavy"])
def test_reference_equals_host_oracle(tiny_index, err, mut, indel, n):
    from pecaller_tpu_torch.formats.index_files import load_index
    from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
    from pecaller_tpu_torch.mapper.engine import MapperEngine
    d, seq = tiny_index
    sdx = read_sdx(d + "/g.sdx")
    eng = MapperEngine(sdx, read_seq(d + "/g.seq", sdx.genome_size),
                       load_index(d + "/g"), min_align=0.85, max_dist=500,
                       min_dist=0, paired=True, nthreads=2)
    t = dict(read_len=100, outer_mean=500, outer_sd=50, err_rate=err,
             mut_rate=mut, indel_frac=indel, indel_extend=0.3, max_ins=4,
             hom_frac=0.333333, draw_seed=11)
    pr = gen.pairs(seq, n, t)
    W = 300
    s1 = np.zeros((n, W), np.uint8)
    s1[:, :pr["r1"].shape[1]] = pr["r1"]
    s2 = np.zeros((n, W), np.uint8)
    s2[:, :pr["r2"].shape[1]] = pr["r2"]
    m1, m2, code = eng.map_batch(s1, pr["l1"], s2, pr["l2"],
                                 read_nos=np.arange(n))
    out = ref.map_pairs(seq, ref.KmerTable(seq), pr["r1"], pr["l1"],
                        pr["r2"], pr["l2"], ref.Settings(0.85, 500, 0))
    assert (out["codes"] == code).all()
    assert (out["m1"] == m1).all() and (out["m2"] == m2).all()
    pile = np.zeros((len(seq), 6), np.int64)
    ev = out["events"]
    np.add.at(pile, (ev[:, 1], ev[:, 2]), 1)
    assert (pile == eng.final_pileup()).all()
    want = sorted((p, e, g, s) for p, e, g, s in out["insertions"])
    got = sorted((k[0], k[1], g, s) for k, g, s in eng.ins_records)
    assert want == got and len(got) > 0


def test_skewed_dp_matches_row_by_row():
    """The anti-diagonal DP against a row-by-row float64 fill of the same
    recurrence, on random lanes with N and mismatches."""
    rng = np.random.default_rng(3)
    H, N, M = 7, 40, 30
    refs = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (H, N))
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), (H, M))
    import torch
    S = ref.dp_planes(torch.as_tensor(refs), torch.full((H,), N),
                      torch.as_tensor(reads), torch.full((H,), M),
                      torch.float64)
    for h in range(H):
        P = np.zeros((3, N + 1, M + 1))
        P[2, 0, 0] = -ref.OPEN
        for j in range(1, M + 1):
            P[:, 0, j] = -(ref.OPEN + (j - 1) * ref.EXT)
        for i in range(1, N + 1):
            P[:, i, 0] = (0, 0, -ref.OPEN)
            for j in range(1, M + 1):
                P[2, i, j] = max(P[0, i, j - 1] - ref.OPEN,
                                 P[2, i, j - 1] - ref.EXT)
                P[1, i, j] = max(P[0, i - 1, j] - ref.OPEN,
                                 P[1, i - 1, j] - ref.EXT)
                eq = refs[h, i - 1] == reads[h, j - 1] or \
                    refs[h, i - 1] == ord("N")
                b = 1.0 if eq else ref.MISMATCH
                P[0, i, j] = max(P[0, i - 1, j - 1] + b,
                                 P[1, i - 1, j - 1] + b,
                                 P[2, i - 1, j - 1] + b)
        for k in range(3):
            got = np.array([[float(ref.cell(S[k], h, i, j))
                             for j in range(M + 1)] for i in range(N + 1)])
            assert (got == P[k]).all()
