"""The caller's device programs: CallerScreen's (phase, bucket) steps
with up to three chunks in flight, DeviceBeam's chunk, site_program
(site_likelihoods and site_posteriors_flat) and sharded_call_step, each
a mapper.program.StepProgram, against the same code run eagerly
(graph=False) and against the JAX package's jitted functions.

On the CPU a program runs its step on its input slots at every call and
copies the result into one static output, so these tests reach the
programs' slots, buckets, padding, staging ring and mesh parts here; the
tests marked cuda run the same comparisons with CUDA graphs on the card.

Tolerance: a program's output equals the eager one bitwise.  Phase-0
codes equal JAX's bitwise; phase-1 codes meet the screen's contract
against JAX's (chip_smoke.screen_contract: no site EASY whose float64
margins fail the exact criterion, and equal codes but within 0.15 of a
threshold).  The likelihoods as programs hold test_torch_mesh's bound
against a float64 scipy evaluation: the port's largest absolute error is
at most twice JAX's own plus 1e-3 (plus 1e-4 for the posteriors)."""

import numpy as np
import pytest
import torch

import chip_smoke
import torch_util  # noqa: F401  (one torch thread a worker)
from pecaller_tpu.caller import device_model as jdmod
from pecaller_tpu.caller import device_screen as jds
from pecaller_tpu.parallel import mesh as jmesh
from pecaller_tpu_torch.caller import device_beam as tb
from pecaller_tpu_torch.caller import device_model as tdmod
from pecaller_tpu_torch.caller import device_screen as tds
from pecaller_tpu_torch.parallel import mesh as tmesh
from test_beam import _fuzz_sites
from test_torch_mesh import _like_f64, _like_inputs, _port
from torch_util import cuda_device  # noqa: F401  (fixture)

CPU = torch.device("cpu")
CHUNK = 16384                       # buckets 2^10 .. 2^14: five a phase
SIZES = [1, 1023, 1024, 1025, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 5]


def _fuzz(indiv, n, seed):
    return chip_smoke.screen_fuzz(np.random.default_rng(seed), n, indiv)


def _phases(scr, reads, ref_int, ctype):
    return (scr.phase0(reads, ref_int, ctype),
            scr.phase1(reads, ref_int, ctype))


@pytest.mark.parametrize("indiv,haploid", [(3, False), (5, False),
                                           (2, True)])
def test_screen_programs_match_eager_and_jax(indiv, haploid):
    """Each size pads into its bucket (the tail of a longer call too):
    both phases as programs bitwise to graph=False, phase 0 bitwise to
    JAX's _phase0_chunk, phase 1 to the contract against JAX's jitted
    CallerScreen.phase1 on the same buckets."""
    prog = tds.CallerScreen(indiv, haploid, chunk=CHUNK, device="cpu")
    eager = tds.CallerScreen(indiv, haploid, chunk=CHUNK, device="cpu",
                             graph=False)
    jscr = jds.CallerScreen(indiv, haploid, chunk=CHUNK)
    ptab = jds._phase0_tables(haploid)
    for k, n in enumerate(SIZES):
        reads, ref_int, ctype = _fuzz(indiv, n, 100 * indiv + k)
        c0, c1 = _phases(prog, reads, ref_int, ctype)
        e0, e1 = _phases(eager, reads, ref_int, ctype)
        assert c0.shape == c1.shape == (n,)
        assert np.array_equal(c0, e0) and np.array_equal(c1, e1)
        j0 = np.asarray(jds._phase0_chunk(reads, ref_int, ctype,
                                          haploid=haploid, indiv=indiv,
                                          ptab=ptab))
        assert np.array_equal(c0, j0)
        chip_smoke.screen_contract(c1, jscr.phase1(reads, ref_int, ctype),
                                   reads, ref_int, ctype, haploid)
    buckets = {k[1] for k in prog.programs}
    assert buckets == {1 << 10, 1 << 11, CHUNK}
    assert all(p.graph for parts in prog.programs.values()
               for p, _, _ in parts)
    assert not any(p.graph for parts in eager.programs.values()
                   for p, _, _ in parts)
    # the full chunk's programs ran more than once: their static outputs
    # were reused
    assert max(p.calls for parts in prog.programs.values()
               for p, _, _ in parts) > 2


def test_screen_programs_stay_within_the_buckets():
    """20 phase1 calls of random sizes, as the runner's windows make
    them: at most one program a bucket, each reused."""
    rng = np.random.default_rng(5)
    scr = tds.CallerScreen(3, False, chunk=CHUNK, device="cpu")
    reads, ref_int, ctype = _fuzz(3, 3 * CHUNK, 6)
    n_buckets = CHUNK.bit_length() - 10
    for n in rng.integers(1, 3 * CHUNK, 20):
        got = scr.phase1(reads[:n], ref_int[:n], ctype[:n])
        assert got.shape == (n,)
    keys = [k for k in scr.programs if k[0] == "phase1"]
    assert 0 < len(keys) <= n_buckets
    assert all(k[1] in [1 << b for b in range(10, 15)] for k in keys)
    calls = sum(p.calls for k in keys for p, _, _ in scr.programs[k])
    assert calls > len(keys)
    assert scr.program_stats()["programs"] == len(keys)


def test_three_chunks_in_flight_equal_one_at_a_time():
    reads, ref_int, ctype = _fuzz(3, 5 * CHUNK + 17, 7)
    three = tds.CallerScreen(3, False, chunk=CHUNK, device="cpu")
    one = tds.CallerScreen(3, False, chunk=CHUNK, device="cpu")
    one.MAX_PEND = 1
    assert three.MAX_PEND == 3
    assert np.array_equal(three(reads, ref_int, ctype),
                          one(reads, ref_int, ctype))
    assert len(three._ring) == 3 and len(one._ring) == 1
    assert three.sites == one.sites


@pytest.mark.parametrize("devices", [[CPU, CPU], [CPU, torch.device("cpu", 0)]],
                         ids=["one-device", "two-devices"])
def test_screen_mesh_of_two_equals_one_device(devices):
    """A 2-part mesh: with both parts on one device one program a key
    holds both parts; on two devices (cpu and cpu:0 stand for two cards)
    each part is a program of its own.  The codes equal one device's."""
    reads, ref_int, ctype = _fuzz(3, 2 * CHUNK + 1500, 8)
    mesh = tmesh.make_mesh(2, 1, devices)
    two = tds.CallerScreen(3, False, chunk=CHUNK, mesh=mesh)
    one = tds.CallerScreen(3, False, chunk=CHUNK, device="cpu")
    assert np.array_equal(two(reads, ref_int, ctype),
                          one(reads, ref_int, ctype))
    parts = {len(v) for v in two.programs.values()}
    assert parts == {1 if len(set(devices)) == 1 else 2}


@pytest.mark.parametrize("indiv,haploid", [(3, False), (2, True)])
def test_beam_program_matches_eager(indiv, haploid):
    """DeviceBeam's chunk as a program against graph=False on the fuzz
    of tests/test_beam.py, three chunks and a padded tail, called twice:
    all seven outputs bitwise."""
    rng = np.random.default_rng(55 + indiv)
    reads, ref = _fuzz_sites(rng, 3 * 256 + 37, indiv)
    prog = tb.DeviceBeam(indiv, haploid, 0.001, 0.95, chunk=256,
                         device="cpu")
    eager = tb.DeviceBeam(indiv, haploid, 0.001, 0.95, chunk=256,
                          device="cpu", graph=False)
    want = eager(reads, ref)
    for _ in range(2):
        got = prog(reads, ref)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert prog.program.graph and not eager.program.graph
    assert prog.program.calls == 8 and prog.program.out is not None
    assert (want[2] == 0).any() and (want[0] > 1).any()


def test_site_programs_match_jax_and_f64():
    reads, ref_int = _like_inputs(seed=23)
    f64 = _like_f64(reads, ref_int)
    like = tdmod.site_program(tdmod.site_likelihoods, "cpu")
    eager = tdmod.site_likelihoods(_port(reads), _port(ref_int))
    for _ in range(3):
        got = like(reads, _port(ref_int))
        assert torch.equal(got, eager)
    assert [p.calls for p in like.programs.values()] == [3]
    e_port = float(np.abs(got.numpy() - f64).max())
    e_jax = float(np.abs(np.asarray(jdmod.site_likelihoods(
        reads, ref_int)) - f64).max())
    assert e_port <= 2 * e_jax + 1e-3

    ln_theta = float(np.log(0.001))
    post = tdmod.site_program(tdmod.site_posteriors_flat, "cpu",
                              ln_theta=ln_theta)
    got = post(reads, _port(ref_int))
    assert torch.equal(got, tdmod.site_posteriors_flat(
        _port(reads), _port(ref_int), ln_theta))
    want = np.asarray(jdmod.site_posteriors_flat(reads, ref_int, ln_theta))
    post_f64 = f64 + np.where(
        np.arange(14)[None, None, :] == ref_int[:, None, None], 0.0,
        ln_theta)
    post_f64 = np.exp(post_f64 - post_f64.max(-1, keepdims=True))
    post_f64 /= post_f64.sum(-1, keepdims=True)
    assert float(np.abs(got.numpy() - post_f64).max()) <= \
        2 * float(np.abs(want - post_f64).max()) + 1e-4


@pytest.mark.parametrize("devices", [[CPU] * 8,
                                     [CPU, torch.device("cpu", 0)] * 4],
                         ids=["one-device", "two-devices"])
def test_sharded_call_step_program_matches_eager_and_jax(devices):
    """sharded_call_step on a (4, 2) mesh as programs: one a shape where
    every shard is on one device, one a shard and shape otherwise;
    bitwise to graph=False over three calls, and to JAX's within the
    bound."""
    reads, ref_int = _like_inputs(seed=24)
    f64 = _like_f64(reads, ref_int)
    mesh = tmesh.make_mesh(4, 2, devices)
    step = tmesh.sharded_call_step(mesh, 3)
    eager = tmesh.sharded_call_step(mesh, 3, graph=False)(_port(reads),
                                                          _port(ref_int))
    for _ in range(3):
        got = step(_port(reads), _port(ref_int))
        assert torch.equal(got, eager)
    n_prog = 1 if len(set(devices)) == 1 else 8
    assert len(step.programs) == n_prog
    assert all(p.calls == 3 for p in step.programs.values())
    want = np.asarray(jmesh.sharded_call_step(jmesh.make_mesh(4, 2), 3)(
        reads, ref_int))
    assert float(np.abs(got.numpy() - f64).max()) <= \
        2 * float(np.abs(want - f64).max()) + 1e-3


# ---- on the card: CUDA graphs against the eager steps

@pytest.mark.cuda
def test_screen_programs_on_the_card(cuda_device):
    """Both phases at two buckets (a 1,500-site tail and a full chunk),
    three calls each so that the graphs are captured and replayed:
    bitwise to graph=False on the card."""
    prog = tds.CallerScreen(3, False, chunk=CHUNK, device=cuda_device)
    eager = tds.CallerScreen(3, False, chunk=CHUNK, device=cuda_device,
                             graph=False)
    reads, ref_int, ctype = _fuzz(3, 3 * CHUNK + 1500, 9)
    for _ in range(3):
        for n in (1500, CHUNK, 3 * CHUNK + 1500):
            args = (reads[:n], ref_int[:n], ctype[:n])
            for a, b in zip(_phases(prog, *args), _phases(eager, *args)):
                assert np.array_equal(a, b)
    stats = prog.program_stats()
    assert stats["graphs"] == stats["programs"] == 4
    assert stats["pool_bytes"] > 0


@pytest.mark.cuda
def test_beam_program_on_the_card(cuda_device):
    rng = np.random.default_rng(58)
    reads, ref = _fuzz_sites(rng, 3 * 1024 + 37, 3)
    prog = tb.DeviceBeam(3, False, 0.001, 0.95, device=cuda_device)
    eager = tb.DeviceBeam(3, False, 0.001, 0.95, device=cuda_device,
                          graph=False)
    want = eager(reads, ref)
    for _ in range(2):
        for a, b in zip(prog(reads, ref), want):
            assert np.array_equal(a, b)
    assert prog.program.capture_s is not None


@pytest.mark.cuda
def test_sharded_call_step_on_the_card(cuda_device):
    """Two shards of cuda:0, one program a shape: three calls bitwise to
    graph=False and to site_likelihoods on one device."""
    reads, ref_int = _like_inputs(S=4096, seed=25)
    mesh = tmesh.make_mesh(2, 1, [cuda_device] * 2)
    x = (_port(reads).to(cuda_device), _port(ref_int).to(cuda_device))
    step = tmesh.sharded_call_step(mesh, 3)
    want = tmesh.sharded_call_step(mesh, 3, graph=False)(*x)
    assert torch.equal(want, tdmod.site_likelihoods(*x))
    for _ in range(3):
        assert torch.equal(step(*x), want)
    prog, = step.programs.values()
    assert prog.capture_s is not None
