"""The port's joint-configuration beam (pecaller_tpu_torch/caller/
device_beam.py) against the JAX package's and the exact native engine.

- The host half (flag bits, bands, allele-count and genotype-order
  tables, Hardy-Weinberg, the NR factln) and ``finish_f64`` equal JAX's
  bitwise; both finishers get the same JAX beam outputs.
- tests/test_beam.py's fuzz (its _fuzz_sites) at (3, diploid), (5,
  diploid) and (2, haploid), 8,000 sites each (the card runs 40,000 in
  chip_smoke.py phase 12): on every site the port's beam (on the CPU)
  leaves unflagged, the port's finisher equals the port's native
  pecall_sites_batch bitwise (calls, probs, types, acnt, active:
  chip_smoke.beam_contract); each flag rate under JAX's limits (0.45,
  0.80 at 4 samples and more) and within 1 percentage point of the JAX
  beam's on the same sites; where both beams leave a site unflagged,
  equal n_cfg and config sets equal as sets of rows
  (chip_smoke.beam_sets_agree).
- The chrY gate and the F_DEEP flag, as tests/test_beam.py.
- On the card (marked ``cuda``): the beam on cuda:0 against the beam on
  the CPU, under the same unflagged-sites contract.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import torch_util  # noqa: F401  (one torch thread a worker)
from pecaller_tpu.caller import device_beam as jb
from pecaller_tpu_torch.caller import device_beam as tb
from test_beam import _fuzz_sites
from torch_util import cuda_device  # noqa: F401  (fixture)

FUZZ_SITES = 8000
CPU = torch.device("cpu")


def test_host_tables_match_jax():
    for name in ("NO_ALLELES", "MAX_GEN", "THRES", "BAND", "ORDER_BAND",
                 "F_BOUNDARY", "F_OVERFLOW", "F_ORDER", "F_EM", "F_EXP",
                 "F_REF", "F_TIE", "F_DEEP", "T_REF", "T_SNP", "T_DEL",
                 "T_INS", "T_LOW", "T_MULTI", "T_MESS"):
        assert getattr(tb, name) == getattr(jb, name), name
    for hap in (False, True):
        assert np.array_equal(tb.allele_counts_tab(hap),
                              jb.allele_counts_tab(hap))
    assert np.array_equal(tb._DIP_ORDER, jb._DIP_ORDER)
    assert np.array_equal(tb._HAP_ORDER, jb._HAP_ORDER)
    for g in range(tb.MAX_GEN):
        for r in range(4):
            assert tb._get_het(g, r) == jb._get_het(g, r)
    for n in (1, 2, 3, 5, 8, 17, 40):
        assert np.array_equal(tb.fill_hardy_weinberg_np(n),
                              jb.fill_hardy_weinberg_np(n))
    for indiv in (1, 3, 32):
        for a, b in zip(tb.hw_flat(indiv), jb.hw_flat(indiv)):
            assert np.array_equal(a, b)
    assert np.array_equal(tb.factln_tbl(), jb.factln_tbl())
    n = np.array([0, 1, 2, 39, 40, 41, 9999, 10000, 10001, 65535, 393210])
    assert np.array_equal(tb.factln_np(n), jb.factln_np(n))
    for x in (1.5, 41.0, 1e4 + 2.0, 3.9e5):
        assert tb._gammln_scalar(x) == jb._gammln_scalar(x)


@pytest.mark.parametrize("indiv,haploid", [(3, False), (5, False),
                                           (2, True)])
def test_finisher_matches_jax(indiv, haploid):
    """Both finishers on the JAX beam's unflagged sites, with and
    without chrY ctypes: every output bitwise."""
    rng = np.random.default_rng(31 + indiv)
    reads, ref = _fuzz_sites(rng, 1500, indiv)
    ctype = rng.integers(0, 4, len(ref)).astype(np.uint8)
    n_cfg, cfgs, flags, _, _, hrank, hval = jb.DeviceBeam(
        indiv, haploid, 0.001, 0.95)(reads, ref)
    ok = flags == 0
    assert ok.sum() > 300
    for ct in (None, ctype[ok]):
        args = (reads[ok], ref[ok], n_cfg[ok], cfgs[ok], hrank[ok],
                hval[ok])
        kw = dict(indiv=indiv, haploid=haploid, theta=0.001,
                  threshold=0.95, ctype=ct)
        for got, want in zip(tb.finish_f64(*args, **kw),
                             jb.finish_f64(*args, **kw)):
            assert got.dtype == want.dtype
            assert np.array_equal(got, want)


def test_beam_fuzz_is_test_beams():
    """chip_smoke.beam_fuzz (the card's fuzz) draws test_beam's sites."""
    for indiv in (2, 5):
        a = chip_smoke.beam_fuzz(np.random.default_rng(indiv), 300, indiv)
        b = _fuzz_sites(np.random.default_rng(indiv), 300, indiv)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("indiv,haploid", [(3, False), (5, False),
                                           (2, True)])
def test_beam_matches_native_and_jax_fuzz(indiv, haploid):
    rng = np.random.default_rng(999 + indiv)
    reads, ref = _fuzz_sites(rng, FUZZ_SITES, indiv)
    want = chip_smoke.native_calls(reads, ref, indiv, haploid)
    port = tb.DeviceBeam(indiv, haploid, 0.001, 0.95, device="cpu")
    out = port(reads, ref)
    assert out[1].shape == (FUZZ_SITES, port.c_cap, indiv)
    assert [x.dtype for x in out] == [np.int32, np.int8, np.int32, np.int8,
                                      np.float32, np.int16, np.int8]
    rate = chip_smoke.beam_contract(reads, ref, out, want, indiv, haploid)
    jout = jb.DeviceBeam(indiv, haploid, 0.001, 0.95)(reads, ref)
    jrate = float(1.0 - (jout[2] == 0).mean())
    print(f"flag rate at ({indiv}, {haploid}): port {rate:.4f}, "
          f"jax {jrate:.4f}")
    assert rate < (0.45 if indiv < 4 else 0.80)
    assert abs(rate - jrate) <= 0.01
    assert chip_smoke.beam_sets_agree(out, jout) > FUZZ_SITES // 10


def test_beam_finisher_chry_gate():
    """chrY sites are exempt from the <50%-of-samples-at-8x bad gate
    (pecaller.c:1303-1304): the finisher honours ctype."""
    indiv = 3
    rng = np.random.default_rng(4242)
    n = 256
    reads, ref = _fuzz_sites(rng, n, indiv)
    # avg depth >= 8 but only 1 of 3 samples at >= 8x: BAD on
    # autosomes, called on chrY
    for k in range(n):
        rc = int(ref[k])
        reads[k] = 0
        reads[k, 0, rc] = 30 + int(rng.integers(0, 20))
        reads[k, 1, rc] = int(rng.integers(3, 8))
        reads[k, 2, rc] = int(rng.integers(3, 8))
    ct = np.full(n, 2, np.uint8)                     # CHRY
    want = chip_smoke.native_calls(reads, ref, indiv, False, ctype=ct)
    assert (want[5].sum(1) > 0).any()               # the exemption fires
    out = tb.DeviceBeam(indiv, False, 0.001, 0.95, device="cpu")(reads, ref)
    assert (out[2] == 0).any()
    chip_smoke.beam_contract(reads, ref, out, want, indiv, False, ctype=ct)


def test_beam_deep_sites_flagged():
    """Sites past DEPTH_GATE are flagged off the f32 beam."""
    from pecaller_tpu_torch.caller.device_screen import DEPTH_GATE
    indiv, n = 3, 64
    reads = np.zeros((n, indiv, 6), np.uint16)
    ref = np.zeros(n, np.uint8)
    reads[:, :, 0] = 50
    reads[::2, 0, 0] = DEPTH_GATE + 100             # deep sample
    flags = tb.DeviceBeam(indiv, False, 0.001, 0.95,
                          device="cpu")(reads, ref)[2]
    assert (flags[::2] & tb.F_DEEP).all()
    assert not (flags[1::2] & tb.F_DEEP).any()


def test_beam_on_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.DeviceBeam(3, False, 0.001, 0.95)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.DeviceBeam(3, False, 0.001, 0.95, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("indiv,haploid", [(3, False), (5, False),
                                           (2, True), (32, False)])
def test_beam_on_the_card_matches_cpu(cuda_device, indiv, haploid):
    rng = np.random.default_rng(77 + indiv)
    reads, ref = _fuzz_sites(rng, 2048, indiv)
    want = chip_smoke.native_calls(reads, ref, indiv, haploid)
    outs = [tb.DeviceBeam(indiv, haploid, 0.001, 0.95, device=d)(reads, ref)
            for d in (cuda_device, CPU)]
    for out in outs:
        chip_smoke.beam_contract(reads, ref, out, want, indiv, haploid)
    chip_smoke.beam_sets_agree(*outs)
    rates = [float((o[2] != 0).mean()) for o in outs]
    assert abs(rates[0] - rates[1]) <= 0.01
