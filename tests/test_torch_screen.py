"""The port's caller screen (pecaller_tpu_torch/caller/device_screen.py)
against the JAX package's (pecaller_tpu/caller/device_screen.py, XLA on
the CPU) and the native phase 0 (native/screen.c), on chip_smoke's
screen_fuzz counts: test_screen.py's kinds, a margin sweep, depths
around TMAX and DEPTH_GATE, counts of 32768 and more, argmax ties,
references of 4 and 5 and chrY sites.

Tolerance: the tables and the phase-0 codes bitwise.  Phase-1 codes to
the screen's contract (chip_smoke.screen_contract): no site EASY whose
float64 margins fail the exact criterion, and the codes equal JAX's
except at sites whose float64 margin lies within 0.15 (the f32 error
the screen's band allows for) of a threshold."""

import numpy as np
import pytest
import torch

import chip_smoke
import torch_util  # noqa: F401  (one torch thread a worker)
from pecaller_tpu.caller import device_screen as jds
from pecaller_tpu.caller.native import host_screen_stats as jax_stats
from pecaller_tpu_torch.caller import device_screen as tds
from pecaller_tpu_torch.caller.native import host_screen_stats

# (samples, haploid) of the fuzzed chunks
COHORTS = [(3, False), (5, False), (2, True), (64, False)]


def _fuzz(indiv, n=None, seed=3):
    n = n or max(64, 12000 // indiv)
    return chip_smoke.screen_fuzz(np.random.default_rng(seed + indiv), n,
                                  indiv)


def _torch_codes(fn, reads, ref_int, ctype, **kw):
    return fn(torch.from_numpy(reads.view(np.int16)),
              torch.from_numpy(ref_int), torch.from_numpy(ctype),
              **kw).numpy()


def _native_phase0(reads, ref_int, ctype, indiv, haploid, stats):
    return stats(reads, np.ones(reads.shape[:2], np.uint8), ref_int, ctype,
                 tds._phase0_tables(haploid), indiv, haploid, 2,
                 np.zeros((indiv, 501), np.int64), np.zeros(indiv, np.int64),
                 np.zeros(indiv, np.int64), np.zeros(indiv, np.int64))[0]


@pytest.mark.parametrize("haploid", [False, True])
def test_tables_equal_jax(haploid):
    for a, b in zip(tds._tables(haploid), jds._tables(haploid)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    a, b = tds._phase0_tables(haploid), jds._phase0_tables(haploid)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(tds._SCALES, jds._SCALES)
    assert np.array_equal(tds._factln_table(300), jds._factln_table(300))
    for name in ("HARD", "EASY", "BAD", "UNRES", "BAND", "DEPTH_GATE",
                 "TMAX", "CMAX", "P0_EPS", "NO_ALLELES", "MAX_GEN"):
        assert getattr(tds, name) == getattr(jds, name), name


def test_fuzz_reaches_the_edges():
    reads, ref_int, ctype = _fuzz(3, 4000)
    r = reads.astype(np.int64)
    tot = r[..., :5].sum(-1)
    assert (reads >= 32768).any()
    assert ((tot > tds.DEPTH_GATE) & (tot <= tds.DEPTH_GATE + 3)).any()
    assert (tot == tds.DEPTH_GATE).any()
    assert ((tot > tds.TMAX) & (tot <= tds.TMAX + 2)).any()
    assert (ref_int == 4).any() and (ref_int == 5).any()
    assert (ctype == 2).any()
    alt = np.where(np.arange(4) == np.minimum(ref_int, 3)[:, None, None],
                   -1, r[..., :4])
    top = np.sort(alt, -1)
    assert ((top[..., -1] == top[..., -2]) & (top[..., -1] > 0)).any()
    assert (top[..., -1] == 0).any()


@pytest.mark.parametrize("indiv,haploid", COHORTS)
def test_phase0_equals_jax_and_native(indiv, haploid):
    reads, ref_int, ctype = _fuzz(indiv)
    ptab = tds._phase0_tables(haploid)
    got = _torch_codes(tds._phase0_chunk, reads, ref_int, ctype,
                       haploid=haploid, indiv=indiv,
                       ptab=torch.from_numpy(ptab))
    want = np.asarray(jds._phase0_chunk(reads, ref_int, ctype,
                                        haploid=haploid, indiv=indiv,
                                        ptab=ptab))
    assert np.array_equal(got, want)
    for stats in (host_screen_stats, jax_stats):
        assert np.array_equal(
            got, _native_phase0(reads, ref_int, ctype, indiv, haploid, stats))
    assert set(np.unique(got)) == {tds.HARD, tds.EASY, tds.BAD, tds.UNRES}


@pytest.mark.parametrize("indiv,haploid", COHORTS)
def test_phase1_holds_the_contract_against_jax(indiv, haploid):
    reads, ref_int, ctype = _fuzz(indiv)
    ta, tota, a1 = tds._tables(haploid)
    n_sc, _, G, _ = ta.shape
    got = _torch_codes(
        tds._screen_chunk, reads, ref_int, ctype, haploid=haploid,
        ta=torch.from_numpy(ta.reshape(n_sc * 4, G, 6)),
        tota=torch.from_numpy(tota.reshape(n_sc * 4, G)),
        a1=torch.from_numpy(a1.reshape(n_sc * 4, G)))
    want = np.asarray(jds._screen_chunk(reads, ref_int, ctype,
                                        haploid=haploid, ta=ta, tota=tota,
                                        a1=a1))
    chip_smoke.screen_contract(got, want, reads, ref_int, ctype, haploid)
    assert (got[ref_int >= 4] == tds.HARD).all()
    assert (got == tds.EASY).any() and (got == tds.BAD).any()
    deep = ((reads[..., :6].astype(np.int64).sum(-1)
             > tds.DEPTH_GATE).any(-1))
    assert (got[deep] != tds.EASY).all() and deep.any()


def test_counts_past_32767_stay_counts():
    """int16 bits of uint16 counts widen to the counts: a site of 40,000
    reference reads is as deep as it is (phase 0: over TMAX, UNRES;
    phase 1: past DEPTH_GATE, HARD), not negative (under 8x: BAD)."""
    reads = np.zeros((2, 3, 6), np.uint16)
    reads[0, :, 0] = 40000
    reads[1, :, 1] = 65535
    ref_int = np.array([0, 1], np.uint8)
    ctype = np.zeros(2, np.uint8)
    assert np.array_equal(tds._counts(torch.from_numpy(
        reads.view(np.int16))).numpy(), reads.astype(np.int32))
    scr = tds.CallerScreen(3, False, device="cpu")
    assert scr.phase0(reads, ref_int, ctype).tolist() == \
        [tds.UNRES] * 2
    assert scr.phase1(reads, ref_int, ctype).tolist() == [tds.HARD] * 2


def test_argmax_ties_take_the_first_column():
    """No alternate read (c = 0) and equal alternate counts: the table
    row is that of the first maximal column, as jnp.argmax picks it."""
    rows = [[30, 0, 0, 0, 0, 0], [30, 1, 1, 0, 0, 0], [0, 30, 2, 0, 2, 0],
            [3, 0, 0, 30, 0, 0], [20, 0, 3, 3, 0, 0], [9, 1, 0, 1, 1, 0]]
    reads = np.array([[r] * 4 for r in rows], np.uint16)
    ref_int = np.array([0, 0, 1, 3, 0, 0], np.uint8)
    ctype = np.zeros(len(rows), np.uint8)
    ptab = tds._phase0_tables(False)
    got = _torch_codes(tds._phase0_chunk, reads, ref_int, ctype,
                       haploid=False, indiv=4, ptab=torch.from_numpy(ptab))
    want = np.asarray(jds._phase0_chunk(reads, ref_int, ctype,
                                        haploid=False, indiv=4, ptab=ptab))
    assert np.array_equal(got, want)
    assert got[0] == tds.EASY


def test_caller_screen_chunks_match_jax():
    """CallerScreen.__call__ (phase 0, then phase 1 on UNRES) over
    several chunks against the JAX CallerScreen, to the contract."""
    reads, ref_int, ctype = _fuzz(3, 40000, seed=9)
    port = tds.CallerScreen(3, False, chunk=16384, device="cpu")
    got = port(reads, ref_int, ctype)
    want = jds.CallerScreen(3, False, chunk=16384)(reads, ref_int, ctype)
    chip_smoke.screen_contract(got, want, reads, ref_int, ctype, False)
    n_un = int((port.phase0(reads, ref_int, ctype) == tds.UNRES).sum())
    assert port.sites == {"phase0": 2 * 40000, "phase1": n_un}
    assert tds.CallerScreen(3, False, device="cpu").chunk == 1 << 18
    assert tds.CallerScreen(64, False, device="cpu").chunk == 1 << 15


def test_cuda_asked_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tds.CallerScreen(3, False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tds.CallerScreen(3, False, device="cuda:0")
    from pecaller_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tds.CallerScreen(3, False, mesh=make_mesh(2, 1, ["cuda:0"] * 2))
    screen = tds.CallerScreen(3, False, mesh=make_mesh(2, 1, ["cpu"] * 2))
    assert screen.devices == [torch.device("cpu")] * 2
    # the device beam (run_caller's device_beam=True) is no exception
    from pecaller_tpu_torch.caller.device_beam import DeviceBeam
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceBeam(3, False, 0.001, 0.95)


@pytest.mark.cuda
def test_screen_on_the_card_holds_the_contract():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for indiv in (3, 64):
        reads, ref_int, ctype = _fuzz(indiv, 20000)
        gpu = tds.CallerScreen(indiv, False)
        cpu = tds.CallerScreen(indiv, False, device="cpu")
        assert np.array_equal(gpu.phase0(reads, ref_int, ctype),
                              cpu.phase0(reads, ref_int, ctype))
        chip_smoke.screen_contract(gpu.phase1(reads, ref_int, ctype),
                                   cpu.phase1(reads, ref_int, ctype),
                                   reads, ref_int, ctype, False)
