"""The rest of a run, on the CPU at a test size, with the look for a card
skipped: a sound engine comes out correct; each fault of the timed path
(an answer altered where it is produced, half of each batch left out,
the pileup state left unchanged by a step) and the control (the plain
reference in float32 put in the program's place) come out not correct.

The test traffic's genome carries ten times wgsim's mutations, half of
them indels (the cells' have 0.1%, 15% indels), so that the float32
control meets enough exact-score ties at this size."""

import time

import numpy as np
import pytest
import torch

from pebench import check, harness
from pebench.control import reference_in_place

CFG = {"config": dict(name="tiny", genome_length=150_000, genome_seed=5,
                      route="nbr", max_dist=500, min_dist=0, bisulfite=False,
                      min_align=0.85, threads=3, max_reads=200_000_000,
                      sample_pairs=3000),
       "traffic": dict(name="tiny.wgsim", read_len=100, outer_mean=500,
                       outer_sd=50, err_rate=0.02, mut_rate=0.01,
                       indel_frac=0.5, indel_extend=0.3, max_ins=4,
                       hom_frac=0.333333, batch_pairs=1000, draw_seed=21,
                       check={"regions": 2, "pairs": 2400})}


def _run(tiny_index, hook=None, seed=20260101, trace=False):
    d, _ = tiny_index
    return harness.run(CFG, seed, 0.5, trace, time.time(),
                       devices=[torch.device("cpu")], cache=d,
                       engine_hook=hook)


def test_sound_run_is_correct(tiny_index):
    rec = _run(tiny_index, trace=True)
    assert rec["correct"], rec["compared"]
    assert rec["answers_compared"] > 1000
    assert rec["engine"]["n_tiefix"] > 0
    assert set(rec["lanes"]) == {"k1", "k2"}
    from pebench import cells
    for name in ("fastq_ms_per_batch", "index_load_s",
                 "enqueue_ms_per_batch", "resolve_ms_per_batch"):
        assert cells.reader(name)(rec) > 0
    for name in ("replay_ms_per_batch", "sw_align_x_roofline",
                 "device_idle_pct"):
        assert cells.reader(name)(rec) is None     # device numbers only


def _altered(eng, smp):
    orig = eng.resolve

    def resolve(h):
        m1, m2, code = orig(h)
        m1 = np.where(m1 != 0, m1 + 1, 0).astype(m1.dtype)
        return m1, m2, code
    eng.resolve = resolve


def _half_left_out(eng, smp):
    orig = eng.map_batch_async

    def map_batch_async(s1, l1, s2, l2, read_nos=None):
        h = len(l1) // 2
        return orig(s1[:h], l1[:h], s2[:h], l2[:h], read_nos=read_nos[:h])
    eng.map_batch_async = map_batch_async


def _state_unchanged(eng, smp):
    orig = eng.resolve

    def resolve(h):
        before = [st.dev_counts.clone() for st in eng.states]
        host = eng.pileup.copy()
        out = orig(h)
        for st, b in zip(eng.states, before):
            st.dev_counts.copy_(b)
        eng.pileup[:] = host
        return out
    eng.resolve = resolve


@pytest.mark.parametrize("fault", [_altered, _half_left_out,
                                   _state_unchanged],
                         ids=["answer-altered", "half-left-out",
                              "state-unchanged"])
def test_fault_is_not_correct(tiny_index, fault):
    rec = _run(tiny_index, fault)
    assert not rec["correct"], rec["compared"]


def test_reference_in_place_is_correct(tiny_index):
    rec = _run(tiny_index, reference_in_place(torch.float64, tiny_index[1]))
    assert rec["correct"], rec["compared"]


def test_control_on_the_sample_alone_is_correct(tiny_index):
    """The control's own way: the sample's pairs alone through the
    reference, the window asked for every batch."""
    rec = harness.run(CFG, 20260102, 0.0, False, time.time(),
                      devices=[torch.device("cpu")], cache=tiny_index[0],
                      engine_hook=reference_in_place(
                          torch.float64, tiny_index[1], only_sample=True),
                      min_batches=3)
    assert rec["correct"], rec["compared"]
    assert rec["answers_compared"] >= 2 * rec["sample_pairs"]


def test_float32_control_is_not_correct(tiny_index):
    rec = _run(tiny_index, reference_in_place(torch.float32, tiny_index[1]))
    assert not rec["correct"], rec["compared"]
    assert rec["compared"]["pileup_cells_wrong"]["value"] > 0


def test_sample_covers_every_read_near_the_regions():
    truth = {"start": np.array([0, 900, 1000, 5000, 9800]),
             "insert": np.array([300, 160, 449, 200, 190])}
    smp = check.sample(truth, 10_000, {"regions": 2, "pairs": 1}, 1)
    for r, (s, e) in enumerate(smp["regions"]):
        assert r * 5000 <= s < e <= (r + 1) * 5000
    f0, f1 = truth["start"], truth["start"] + truth["insert"]
    near = [any(b > s - check.MARGIN and a < e + check.MARGIN
                for s, e in smp["regions"]) for a, b in zip(f0, f1)]
    assert list(np.nonzero(near)[0]) == list(smp["pairs"])
