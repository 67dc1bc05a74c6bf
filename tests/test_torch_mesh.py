"""The port's reads-axis mesh (parallel/mesh.py, the mesh path of
FusedMapperEngine2 and run_mapper's mesh_shards) and the caller screen
on a device mesh, against the JAX package's.

Meshes of CPU devices stand in for cards (a device may repeat).  Data:
torch_util's step cases (tests/test_fused2.py's genome, seed 43) and the
caller cohorts of tests/test_screen.py.  Tolerance: bitwise (shard_units
arrays, each shard's packed output and pileup partial, byte-equal
artifacts, equal phase-0 codes); the JAX mesh screen's phase-1 codes to
the screen's contract (chip_smoke.screen_contract), as the unsharded
screen is held.

sharded_map_step on a (4, 2) mesh of CPU devices against the JAX step
on 8 virtual devices (__graft_entry__._example_batch, bisulfite off and
on): score, bk, bi and the concatenated pileup blocks read as uint16,
bitwise; its reduce-scatter over 2 and 4 shards on alternating device
entries (cpu, cpu:0) against JAX's psum_scatter step.  The MeshProgram
(mapper/program.py) on a fake step against lockstep: bitwise.
site_likelihoods, site_posteriors_flat and sharded_call_step against
JAX's and against a float64 scipy.special.gammaln evaluation of
the same formula (alpha as the formula rounds it in float32): the port's
largest absolute error is at most twice JAX's own plus 1e-3 (plus 1e-4
for the posteriors, which lie in [0, 1])."""

import copy
import dataclasses
import gzip
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
import chip_smoke
from pecaller_tpu.caller import CallerConfig as JaxConfig
from pecaller_tpu.caller import device_model as jdmod
from pecaller_tpu.caller import device_screen as jds
from pecaller_tpu.caller import run_caller as jax_run_caller
from pecaller_tpu.formats.pileup import write_pileup
from pecaller_tpu.parallel import mesh as jmesh
from pecaller_tpu_torch.caller import CallerConfig, run_caller
from pecaller_tpu_torch.caller import device_model as tdmod
from pecaller_tpu_torch.caller import device_screen as tds
from pecaller_tpu_torch.mapper import device_map2 as tdm
from pecaller_tpu_torch.mapper.program import MeshProgram
from pecaller_tpu_torch.mapper.runner import MapperConfig, run_mapper
from pecaller_tpu_torch.parallel import mesh as tmesh
from pecaller_tpu_torch.utils.log import spans, spans_since
from test_screen import _fuzz_counts, _mk_sdx
from torch_util import cuda_device  # noqa: F401  (fixture)
from torch_util import CASES, CPU, StepCase, make_fused2_data

ARTIFACTS = (".snp", ".dist", ".base.gz", ".piles.gz")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_fused2_data(tmp_path_factory.mktemp("torch_mesh"))


@pytest.mark.parametrize("paired", [True, False])
def test_shard_units_matches_jax(paired):
    rng = np.random.default_rng(5)
    B, n = 64, 4
    for shape in ((2 * B if paired else B, 7), (2 * B if paired else B,)):
        x = rng.integers(0, 1000, shape).astype(np.int32)
        got = tmesh.shard_units(x, n, B, paired)
        assert np.array_equal(got, jmesh.shard_units(x, n, B, paired))
        assert got.shape[:2] == (n, (2 if paired else 1) * B // n)


@pytest.mark.parametrize("name", ["paired", "single"])
def test_reads_axis_step_matches_jax(data, name):
    """The port's reads-axis step over 4 CPU shards against JAX's
    sharded_fused_step2 over 4 virtual devices: each shard's packed
    output block and pileup partial (below every cap, as
    tests/test_mesh.py's data)."""
    c = StepCase(data, *CASES[name], seed=11)
    B, n = c.shape["B"], 4
    kw = dict(c.kw, B=B, M=c.shape["M"], N=c.shape["N"],
              s_max=c.shape["s_max"], max_rlen=c.shape["max_rlen"])
    paired = kw["paired"]
    sh_ins = [tmesh.shard_units(np.asarray(x), n, B, paired) for x in c.ins]
    rng = np.random.default_rng(3)
    n_counts = c.counts.shape[0]
    counts = rng.integers(0, 7, (n, n_counts)).astype(np.uint32)

    jstep, jn = jmesh.sharded_fused_step2(jmesh.make_mesh(n, 1), c.jd,
                                          genome_size=0, **kw)
    dc_j, out_j = jstep(jnp.asarray(counts), *c.jd.args, *c.jfixed,
                        *sh_ins)
    mesh = tmesh.make_mesh(n, 1, [CPU] * n)
    states = tmesh.shard_states(mesh, {CPU: c.state}, n_counts)
    for s, st in enumerate(states):
        st.dev_counts.copy_(torch.from_numpy(counts[s].view(np.int32)))
        assert st.dnbr is c.state.dnbr              # one index a device
    step, tn = tmesh.sharded_fused_step2(mesh, states, **kw)
    outs = step(sh_ins)
    out_j, dc_j = np.asarray(out_j), np.asarray(dc_j)
    assert tn == jn == n
    bl = B // n
    for s in range(n):
        assert np.array_equal(outs[s].numpy(), out_j[s])
        assert np.array_equal(states[s].dev_counts.numpy().view(np.uint32),
                              dc_j[s])
        assert int(out_j[s, bl + tdm.INS_CAP, 0]) < tdm.INS_CAP
    assert (out_j[:, :bl, 2] != 8).any()


def _artifacts(base, d):
    got = {}
    for ext in (".pileup.gz", ".indel.txt.gz"):
        with gzip.open(base + ext, "rb") as f:
            got[ext] = f.read()
    with open(base + ".summary.txt", "rb") as f:
        got[".summary.txt"] = f.read()
    for r in ("r1.fastq", "r2.fastq"):
        got[r] = (d / (r + ".mfile")).read_bytes()
    return got


def test_run_mapper_mesh_matches_single(data, tmp_path):
    """run_mapper with mesh_shards=4 (four CPU shards) writes the
    single-device run's artifacts byte for byte."""
    outs, engs, done = {}, {}, {}
    for shards in (1, 4):
        d = tmp_path / f"sh{shards}"
        d.mkdir()
        for r in ("r1.fastq", "r2.fastq"):
            shutil.copy(data / r, d / r)
        cfg = MapperConfig(out_base=str(d / "out"),
                           sdx_path=str(data / "g.sdx"), paired=True,
                           files1=[str(d / "r1.fastq")],
                           files2=[str(d / "r2.fastq")], max_dist=500,
                           min_dist=0, batch_size=600, device=True,
                           mesh_shards=shards, nthreads=2)
        before = spans()
        engs[shards] = run_mapper(cfg, device=[CPU] * 4)
        done[shards] = spans_since(before)
        outs[shards] = _artifacts(str(d / "out"), d)
    assert engs[4]._n_sh == 4 and engs[1]._n_sh == 1
    assert len(engs[4].states) == 4
    # the mesh path's two batches, each staged and dispatched over the
    # shards and waited for once
    assert done[4]["engine.enqueue.dispatch"][0] == 2
    assert done[4]["engine.resolve.wait"][0] == 2
    assert "engine.enqueue.dispatch" not in done[1]
    assert outs[1][".summary.txt"].count(b"\n") > 5
    assert outs[4] == outs[1]


@pytest.mark.parametrize("n_dev,n_sh", [(4, 4), (3, 2)])
def test_run_mapper_default_mesh_divides_every_batch(data, tmp_path,
                                                     monkeypatch, n_dev,
                                                     n_sh):
    """``pemapper ... --batch-size 600`` through run_mapper over n_dev
    CPU devices with the default reads mesh (``mesh_shards`` None):
    batches of 600 and 300 pairs, padded to 1024 and 512.  One shard a
    device where that count divides every padded batch (4), else the
    most that do (3 devices: 2 shards, said in an ``engine`` event;
    nothing raises); the artifacts byte-equal to one device's run."""
    from pecaller_tpu_torch.cli import parse_pemapper
    from pecaller_tpu_torch.mapper import runner
    assert [runner.default_shards(n) for n in range(1, 10)] == \
        [1, 2, 2, 4, 4, 4, 4, 8, 8]
    events = []
    monkeypatch.setattr(runner, "event",
                        lambda log, kind, **kw: events.append((kind, kw)))
    outs = {}
    for devs in ([CPU], [CPU] * n_dev):
        d = tmp_path / f"dev{len(devs)}"
        d.mkdir()
        for r in ("r1.fastq", "r2.fastq"):
            shutil.copy(data / r, d / r)
        cfg = parse_pemapper([str(d / "out"), str(data / "g.sdx"), "p",
                              str(d / "r1.fastq"), str(d / "r2.fastq"),
                              "500", "0", "n", "0.9", "3", "2000000000",
                              "--batch-size", "600"])
        assert cfg.device and cfg.mesh_shards is None
        before = spans()
        eng = run_mapper(cfg, device=devs)
        done = spans_since(before)
        outs[len(devs)] = _artifacts(str(d / "out"), d)
    assert eng._n_sh == n_sh and len(eng.states) == n_sh
    assert done["engine.enqueue.dispatch"][0] == 2
    assert done["engine.resolve.wait"][0] == 2
    shrunk = [(kw["mesh_shards"], kw["devices"]) for kind, kw in events
              if kind == "engine" and "mesh_shards" in kw]
    assert shrunk == ([] if n_sh == n_dev else [(n_sh, n_dev)])
    assert outs[1][".summary.txt"].count(b"\n") > 5
    assert outs[n_dev] == outs[1]


def test_screen_mesh_matches_single_and_jax():
    """CallerScreen over a 2-device mesh: the same codes as the unsharded
    screen (sites split into contiguous parts, one a device), and the
    JAX mesh screen's to the contract."""
    reads, ref_int, ctype = chip_smoke.screen_fuzz(
        np.random.default_rng(8), 40000, 3)
    mesh = tmesh.make_mesh(2, 1, [CPU, CPU])
    port = tds.CallerScreen(3, False, chunk=16384, mesh=mesh)
    one = tds.CallerScreen(3, False, chunk=16384, device="cpu")
    assert port.devices == [CPU, CPU] and len(port._tabs) == 1
    got = port(reads, ref_int, ctype)
    assert np.array_equal(got, one(reads, ref_int, ctype))
    assert port.sites == one.sites
    want = jds.CallerScreen(3, False, chunk=16384,
                            mesh=jmesh.make_mesh(2, 1))(reads, ref_int, ctype)
    chip_smoke.screen_contract(got, want, reads, ref_int, ctype, False)


def _read(path):
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw) if path.endswith(".gz") else raw


def test_run_caller_mesh_matches_single_and_jax(tmp_path):
    """run_caller with a 2-device mesh (both screen phases on the
    devices) against the unsharded port and the JAX run_caller with its
    2-device mesh: every artifact byte-equal."""
    rng = np.random.default_rng(45)
    d = str(tmp_path / "work")
    os.makedirs(d)
    g = _mk_sdx(d, rng)
    pos, cnt = _fuzz_counts(rng, g, 3, 600)
    for i in range(3):
        write_pileup(os.path.join(d, f"s{i}.pileup.gz"), pos, cnt[i])
    args = dict(pileup_ext="pileup", sdx_path=os.path.join(d, "g.sdx"),
                prob_to_call=0.95, theta=0.001, directory=d, nthreads=2,
                host_screen=False)
    bases = {k: str(tmp_path / k) for k in ("mesh", "one", "jax")}
    res = run_caller(CallerConfig(
        out_base=bases["mesh"], mesh=tmesh.make_mesh(2, 1, [CPU, CPU]),
        **args))
    run_caller(CallerConfig(out_base=bases["one"], device="cpu", **args))
    jax_run_caller(JaxConfig(out_base=bases["jax"],
                             mesh=jmesh.make_mesh(2, 1), **args))
    for ext in ARTIFACTS:
        want = _read(bases["one"] + ext)
        assert _read(bases["mesh"] + ext) == want, ext
        assert _read(bases["jax"] + ext) == want, ext
    assert res["screen_sites"]["phase0"] == 600
    assert res["screen_sites"]["phase1"] > 0


def _state_on(state, dev):
    """A DeviceState's tensors copied to ``dev``."""
    dn = copy.copy(state.dnbr)
    dn.device = dev
    dn.args = tuple(a.to(dev) for a in dn.args)
    return dataclasses.replace(
        state, dnbr=dn, gcode=state.gcode.to(dev), gmask=state.gmask.to(dev),
        ist=state.ist.to(dev), st_pad=state.st_pad.to(dev),
        dev_counts=state.dev_counts.to(dev))


@pytest.mark.cuda
def test_reads_axis_step_on_the_card(data, cuda_device):
    """Two reads shards on cuda:0 (K1 and K2 on the card) against two on
    the CPU: each shard's output block and pileup partial bitwise."""
    c = StepCase(data, *CASES["paired"], seed=11)
    B, n = c.shape["B"], 2
    kw = dict(c.kw, B=B, M=c.shape["M"], N=c.shape["N"],
              s_max=c.shape["s_max"], max_rlen=c.shape["max_rlen"])
    sh_ins = [tmesh.shard_units(np.asarray(x), n, B, True) for x in c.ins]
    got = {}
    for dev in (CPU, cuda_device):
        mesh = tmesh.make_mesh(n, 1, [dev] * n)
        states = tmesh.shard_states(mesh, {dev: _state_on(c.state, dev)},
                                    c.counts.shape[0])
        step, _ = tmesh.sharded_fused_step2(mesh, states, **kw)
        got[dev.type] = ([o.cpu().numpy() for o in step(sh_ins)],
                         [st.dev_counts.cpu().numpy() for st in states])
    for a, b in zip(*got.values()):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


def test_lockstep_reduces_in_shard_order():
    """lockstep's collectives: pmax and psum elementwise (psum in the
    operand's dtype, as the reference's int32 psum), all_gather a
    shard-major concatenation; shards at different collectives raise."""
    def shard(g, n=3):
        comm = tmesh.ShardComm(g, n)
        x = yield from comm.pmax(torch.tensor([g, -g]))
        y = yield from comm.psum(torch.tensor([g + 1], dtype=torch.int32))
        z = yield from comm.all_gather(torch.tensor([[10 * g, 10 * g + 1]]),
                                       1)
        return x, y, z
    for x, y, z in tmesh.lockstep([shard(g) for g in range(3)]):
        assert x.tolist() == [2, 0]
        assert y.dtype == torch.int32 and y.tolist() == [6]
        assert z.tolist() == [[0, 1, 10, 11, 20, 21]]

    def odd(g):
        comm = tmesh.ShardComm(g, 2)
        if g:
            yield from comm.psum(torch.zeros(1))
        yield from comm.pmax(torch.zeros(1))
    with pytest.raises(RuntimeError, match="different collectives"):
        tmesh.lockstep([odd(0), odd(1)])


def _fake_shard(g, n):
    """A step of shard g of n meeting each kind of collective."""
    comm = tmesh.ShardComm(g, n)
    x = yield from comm.pmax(torch.tensor([g, -g]))
    y = yield from comm.psum(torch.tensor([g + 1], dtype=torch.int32))
    z = yield from comm.all_gather(torch.tensor([[10 * g, 10 * g + 1]]), 1)
    return torch.cat([x, y, z[0]]), None


def test_mesh_program_reduces_like_lockstep():
    """MeshProgram over three shards on two device entries: every
    shard's collectives equal lockstep's (graphed on the CPU: static
    outputs, two calls); a reduce-scatter hands shard s row block s of
    the shard-order sum, in the operand's dtype (int16 wraps); shards at
    different collectives raise as in lockstep."""
    devs = [CPU, torch.device("cpu", 0), CPU]
    want = [r[0] for r in tmesh.lockstep([_fake_shard(g, 3)
                                          for g in range(3)])]
    prog = MeshProgram([lambda g=g: _fake_shard(g, 3) for g in range(3)],
                       devs, torch.stack)
    for _ in range(2):
        got, local = prog([])
        assert torch.equal(got, torch.stack(want)) and local == [None] * 3
    assert prog.collectives == ["pmax", "psum", "all_gather"]
    assert prog.segments == 4 and prog.calls == 2
    assert prog.by_device == {CPU: [0, 2], devs[1]: [1]}

    def scatter(g):
        x = torch.full((6, 2), 20000, dtype=torch.int16)
        x[:, 1] = torch.arange(6) * (g + 1)
        blk = yield from tmesh.ShardComm(g, 3).psum_scatter(x)
        return blk[:1, 1], blk
    prog = MeshProgram([lambda g=g: scatter(g) for g in range(3)], devs,
                       torch.cat, graph=False)
    firsts, blocks = prog([])
    total = (np.full(6, 60000) & 0xFFFF).astype(np.uint16).view(np.int16)
    for s, blk in enumerate(blocks):
        assert blk.dtype == torch.int16 and blk.shape == (2, 2)
        assert blk[:, 0].tolist() == total[2 * s:2 * s + 2].tolist()
        assert blk[:, 1].tolist() == [6 * (2 * s), 6 * (2 * s + 1)]
    assert firsts.tolist() == [0, 12, 24]

    def odd(g):
        comm = tmesh.ShardComm(g, 2)
        if g:
            yield from comm.psum(torch.zeros(1))
        yield from comm.pmax(torch.zeros(1))
        return torch.zeros(1), None
    with pytest.raises(RuntimeError, match="different collectives"):
        MeshProgram([lambda g=g: odd(g) for g in range(2)], [CPU, CPU],
                    torch.stack)([])


def _map_batch():
    return __graft_entry__._example_batch(B=64, N=64, M=48, seed=3)


@pytest.mark.parametrize("bisulfite", [False, True])
def test_sharded_map_step_matches_jax(bisulfite):
    gs = 2048
    batch = _map_batch()
    js = jmesh.sharded_map_step(jmesh.make_mesh(4, 2), gs,
                                bisulfite=bisulfite)
    want = [np.asarray(x) for x in js(*batch)]
    mesh = tmesh.make_mesh(4, 2, [CPU] * 8)
    score, bk, bi, blocks = tmesh.sharded_map_step(
        mesh, gs, bisulfite=bisulfite)(*batch)
    assert len(blocks) == 8 and blocks[0].shape == (gs // 8, 6)
    got = [score.numpy(), bk.numpy(), bi.numpy(),
           torch.cat(blocks).numpy().view(np.uint16)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert want[3].sum() > 0
    with pytest.raises(ValueError, match="divide"):
        tmesh.sharded_map_step(mesh, gs)(*(x[:60] for x in batch))


@pytest.mark.parametrize("bisulfite", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_map_step_reduce_scatter_matches_jax(n, bisulfite):
    """The reduce-scatter over n shards on alternating device entries
    (each entry sums its shards' row blocks of every partial) against
    JAX's psum_scatter step over n virtual devices: score, bk, bi and
    the blocks, bitwise; one psum_scatter, two segments a shard."""
    gs = 2048
    batch = _map_batch()
    want = [np.asarray(x) for x in jmesh.sharded_map_step(
        jmesh.make_mesh(n, 1), gs, bisulfite=bisulfite)(*batch)]
    devs = [CPU, torch.device("cpu", 0)] * (n // 2)
    step = tmesh.sharded_map_step(tmesh.make_mesh(n, 1, devs), gs,
                                  bisulfite=bisulfite)
    score, bk, bi, blocks = step(*batch)
    assert len(blocks) == n and blocks[0].shape == (gs // n, 6)
    got = [score.numpy(), bk.numpy(), bi.numpy(),
           torch.cat(blocks).numpy().view(np.uint16)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert want[3].sum() > 0
    prog, = step.programs.values()
    assert prog.collectives == ["psum_scatter"] and prog.segments == 2
    assert list(prog.by_device) == devs[:2]


def _map_outputs(out):
    """score, bk, bi and the blocks (each on its shard's device) as host
    arrays."""
    score, bk, bi, blocks = out
    return [x.cpu().numpy().copy() for x in (score, bk, bi)] + [
        torch.cat([b.cpu() for b in blocks]).numpy()]


@pytest.mark.parametrize("bisulfite", [False, True])
def test_sharded_map_step_program_matches_eager(bisulfite):
    """graph=True (the whole step of an input shape as one program; on
    the CPU its slots and static outputs) against graph=False on a
    (4, 2) mesh of one device, three calls on three batches: bitwise.
    A mesh over two device entries takes graph=True too, and equals the
    one-device step."""
    gs = 2048
    mesh = tmesh.make_mesh(4, 2, [CPU] * 8)
    prog = tmesh.sharded_map_step(mesh, gs, bisulfite=bisulfite)
    eager = tmesh.sharded_map_step(mesh, gs, bisulfite=bisulfite,
                                   graph=False)
    for seed in (3, 4, 5):
        batch = __graft_entry__._example_batch(B=64, N=64, M=48, seed=seed)
        got, want = _map_outputs(prog(*batch)), _map_outputs(eager(*batch))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert want[3].any()
    assert [p.calls for p in prog.programs.values()] == [3]
    two = tmesh.Mesh([CPU, torch.device("cpu", 0)] * 4, 4, 2)
    got = _map_outputs(tmesh.sharded_map_step(two, gs, bisulfite=bisulfite)(
        *batch))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def _like_inputs(S=256, indiv=3, seed=21):
    """Counts from shallow to past the screen's depth gate, random refs."""
    rng = np.random.default_rng(seed)
    depth = rng.choice([3, 30, 300, 3000, 12000], size=(S, indiv, 1))
    frac = rng.dirichlet(np.ones(6) * 0.3, size=(S, indiv))
    reads = np.floor(frac * depth).astype(np.uint16)
    return reads, rng.integers(0, 4, S).astype(np.int32)


def _like_f64(reads, ref_int, norm=1.0):
    """The formula of site_likelihoods in float64 (scipy gammaln), alpha
    rounded in float32 as the formula's ceil(scale * mean) is."""
    from scipy.special import gammaln
    r = reads.astype(np.float64)
    tot = r[..., :5].sum(-1)
    scale = np.clip(np.minimum(tot, 100.0).astype(np.float32)
                    * np.float32(norm), 10.0, 1000.0).astype(np.float32)
    mean = tdmod._ALPHA_MEAN.astype(np.float32)[ref_int]
    alpha = np.maximum(np.ceil(scale[:, :, None, None]
                               * mean[:, None, :, :]), 1.0).astype(
        np.float64)
    rr = r[:, :, None, :]
    return (gammaln(alpha + rr).sum(-1) - gammaln(alpha).sum(-1)
            + gammaln(alpha.sum(-1)) - gammaln((alpha + rr).sum(-1))
            + gammaln(tot[:, :, None] + 1.0) - gammaln(rr + 1.0).sum(-1))


def _port(x):
    return torch.from_numpy(x.view(np.int16) if x.dtype == np.uint16
                            else x)


def test_site_likelihoods_match_jax_and_f64():
    reads, ref_int = _like_inputs()
    f64 = _like_f64(reads, ref_int)
    got = tdmod.site_likelihoods(_port(reads), _port(ref_int))
    assert got.dtype == torch.float32 and got.shape == (256, 3, 14)
    want = np.asarray(jdmod.site_likelihoods(reads, ref_int))
    e_port = float(np.abs(got.numpy() - f64).max())
    e_jax = float(np.abs(want - f64).max())
    print(f"site_likelihoods max abs err vs f64: port {e_port}, jax {e_jax}")
    assert e_port <= 2 * e_jax + 1e-3

    ln_theta = float(np.log(0.001))
    post_f64 = f64 + np.where(
        np.arange(14)[None, None, :] == ref_int[:, None, None], 0.0,
        ln_theta)
    post_f64 = np.exp(post_f64 - post_f64.max(-1, keepdims=True))
    post_f64 /= post_f64.sum(-1, keepdims=True)
    got = tdmod.site_posteriors_flat(_port(reads), _port(ref_int),
                                     ln_theta).numpy()
    want = np.asarray(jdmod.site_posteriors_flat(reads, ref_int, ln_theta))
    e_port = float(np.abs(got - post_f64).max())
    e_jax = float(np.abs(want - post_f64).max())
    print(f"site_posteriors_flat max abs err vs f64: port {e_port}, "
          f"jax {e_jax}")
    assert e_port <= 2 * e_jax + 1e-4


def test_sharded_call_step_matches_jax_and_f64():
    reads, ref_int = _like_inputs(seed=22)
    f64 = _like_f64(reads, ref_int)
    mesh = tmesh.make_mesh(4, 2, [CPU] * 8)
    got = tmesh.sharded_call_step(mesh, 3)(_port(reads), _port(ref_int))
    assert torch.equal(got, tdmod.site_likelihoods(_port(reads),
                                                   _port(ref_int)))
    want = np.asarray(jmesh.sharded_call_step(jmesh.make_mesh(4, 2), 3)(
        reads, ref_int))
    e_port = float(np.abs(got.numpy() - f64).max())
    e_jax = float(np.abs(want - f64).max())
    print(f"sharded_call_step max abs err vs f64: port {e_port}, "
          f"jax {e_jax}")
    assert e_port <= 2 * e_jax + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("bisulfite", [False, True])
def test_sharded_map_step_on_the_card(cuda_device, bisulfite):
    """Two shards on cuda:0 (K3 on each) against the one-device plain
    path on the CPU, bitwise."""
    from pecaller_tpu_torch.ops import sw, sw_cuda
    gs = 4096
    batch = [torch.from_numpy(x) for x in chip_smoke.mk_lanes(
        np.random.default_rng(40 + bisulfite), 2048, 160, 112, 90, 101,
        raw=True)]
    k0 = sw_cuda.LAUNCHES["sw_align"]
    score, bk, bi, blocks = tmesh.sharded_map_step(
        tmesh.make_mesh(2, 1, [cuda_device] * 2), gs,
        bisulfite=bisulfite)(*(x.to(cuda_device) for x in batch))
    assert sw_cuda.LAUNCHES["sw_align"] - k0 == 2
    ps, pk, pi = sw.sw_align_device(*batch, bisulfite=bisulfite)
    ev_pos, ev_kind, ins_j, _ = sw.sw_traceback_device(
        *batch, pk, pi, bisulfite=bisulfite)
    plain = sw.pileup_scatter(ev_pos.reshape(-1).long(), ev_kind.reshape(-1),
                              (ins_j >= 0).reshape(-1),
                              torch.zeros((gs, 6), dtype=torch.int16))
    for a, b in ((score, ps), (bk, pk), (bi, pi),
                 (torch.cat(blocks), plain)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("bisulfite", [False, True])
def test_sharded_map_step_graph_on_the_card(cuda_device, bisulfite):
    """Two shards on cuda:0, the step graphed (first call eager, second
    captured and replayed, third replayed) against graph=False on three
    batches: bitwise, and the same K3 launch counts."""
    from pecaller_tpu_torch.ops import sw_cuda
    mesh = tmesh.make_mesh(2, 1, [cuda_device] * 2)
    steps = {g: tmesh.sharded_map_step(mesh, 4096, bisulfite=bisulfite,
                                       graph=g) for g in (True, False)}
    got, counts = {}, {}
    for g, step in steps.items():
        k0 = sw_cuda.LAUNCHES["sw_align"]
        got[g] = [_map_outputs(step(*(torch.from_numpy(x).to(cuda_device)
                                      for x in chip_smoke.mk_lanes(
                                          np.random.default_rng(60 + i),
                                          2048, 160, 112, 90, 101,
                                          raw=True))))
                  for i in range(3)]
        counts[g] = sw_cuda.LAUNCHES["sw_align"] - k0
    for a, b in zip(got[True], got[False]):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert counts[True] == counts[False] == 6
    prog, = steps[True].programs.values()
    assert prog.calls == 3 and prog.capture_s is not None


@pytest.mark.cuda
@pytest.mark.parametrize("bisulfite", [False, True])
def test_sharded_map_step_on_two_cards(cuda_device, bisulfite):
    """Two shards on cuda:0 and cuda:1 (skipped with fewer than two
    cards), graphed (eager, captured, replayed) and with graph=False,
    against both shards on cuda:0: bitwise; each block on its card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    lanes = [[torch.from_numpy(x).to(cuda_device) for x in chip_smoke.mk_lanes(
        np.random.default_rng(70 + i), 2048, 160, 112, 90, 101, raw=True)]
        for i in range(3)]
    got = {}
    for name, devs, graph in (("one", [cuda_device] * 2, True),
                              ("two", cards, True), ("eager", cards, False)):
        step = tmesh.sharded_map_step(tmesh.make_mesh(2, 1, devs), 4096,
                                      bisulfite=bisulfite, graph=graph)
        outs = [step(*x) for x in lanes]
        if name != "one":
            assert [b.device for b in outs[-1][3]] == cards
        got[name] = [_map_outputs(step(*x)) for x in lanes]
    for name in ("two", "eager"):
        for a, b in zip(got["one"], got[name]):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
