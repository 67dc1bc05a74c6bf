"""The port's FusedMapperEngine2 (on the CPU, with the plain versions of
its kernels) against the exact host engine MapperEngine and the JAX
package's FusedMapperEngine2, on the tests/test_fused2.py
configurations: paired, single-end and bisulfite.

Tolerance: exact equality of codes, .mfile values, pileup, insertion
records and statistics."""

import numpy as np
import pytest
import torch

from pecaller_tpu.mapper.device_map2 import FusedMapperEngine2 as JaxEngine
from pecaller_tpu.mapper.engine import MapperEngine
from pecaller_tpu_torch.mapper.device_map2 import FusedMapperEngine2
from torch_util import (PAIRED, SINGLE, batches, load_genome,
                        make_bisulfite_data, make_fused2_data, shared_nbr)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_engine")
    make_fused2_data(d)
    make_bisulfite_data(d)
    return d


def _engines(d, base, kw):
    sdx, genome, index = load_genome(d, base)
    nbr = shared_nbr(d, base, index, binsearch=False)
    return (MapperEngine(sdx, genome, index, **kw),
            JaxEngine(sdx, genome, index, nbr=nbr, **kw),
            FusedMapperEngine2(sdx, genome, index, nbr=nbr,
                               device=torch.device("cpu"), **kw))


def _run_all(engines, bl, paired):
    for s1, l1, s2, l2, nos in bl:
        outs = [e.map_batch(s1, l1, s2, l2, read_nos=nos) if paired
                else e.map_batch(s1, l1, read_nos=nos) for e in engines]
        for o in outs[1:]:
            for a, b in zip(outs[0], o):
                assert np.array_equal(a, b)


def _assert_same_state(ref, eng):
    assert np.array_equal(ref.stats.mate_counts, eng.stats.mate_counts)
    assert ref.stats.total_dist == eng.stats.total_dist
    assert ref.stats.no_dists == eng.stats.no_dists
    assert ref.stats.total_bases == eng.stats.total_bases
    assert np.array_equal(ref.final_pileup(), eng.final_pileup())
    assert sorted(ref.ins_records) == sorted(eng.ins_records)


@pytest.mark.parametrize("name", ["paired", "single", "bisulfite"])
def test_engine_matches_host_and_jax(data, name):
    base, f1, f2, kw, bs = {
        "paired": ("g", "r1.fastq", "r2.fastq", PAIRED, 900),
        "single": ("g", "r1.fastq", None, SINGLE, 512),
        "bisulfite": ("b", "b1.fastq", "b2.fastq",
                      dict(PAIRED, bisulfite=True), 400),
    }[name]
    engines = _engines(data, base, kw)
    _run_all(engines, batches(data, f1, f2, bs), kw["paired"])
    host, jax_eng, port = engines
    _assert_same_state(host, port)
    _assert_same_state(jax_eng, port)
    assert port.final_pileup().any() and port.ins_records
    if name == "paired":
        assert port.n_tiefix > 0          # tied windows re-walked on host


def test_segments_of_matches_segment_offsets():
    from pecaller_tpu_torch.mapper.host_prep import segments_of
    from pecaller_tpu_torch.mapper.seeds import segment_offsets
    lens = np.arange(0, 321)
    n_segs, _ = segment_offsets(lens)
    assert [segments_of(int(x)) for x in lens] == n_segs.tolist()


def test_last_segment_reads_match_host(data):
    """Single-end 100 bp reads whose chain needs their last seed segment
    (offset 84): two mismatches in each of the segments at 32, 48 and 64
    leave seeds in 4 of the 7 segments, and min_match is 4.  The port's
    engine sizes its segment axis by the reads' 7 segments and maps them
    as the host oracle does.  The JAX engine sizes it by 100 // 16 = 6,
    never sees the segment at 84 and leaves them unmapped (a fault of the
    reference, ROADMAP queue 3)."""
    sdx, genome, index = load_genome(data, "g")
    rng = np.random.default_rng(8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    while len(reads) < 48:
        st = int(rng.integers(6000, 29000))
        r = genome[st:st + 100].copy()
        if not np.isin(r, acgt).all():
            continue
        for p in (36, 42, 52, 58, 68, 74):
            r[p] = acgt[(np.searchsorted(acgt, r[p]) + 1) % 4]
        reads.append(r)
    reads = np.stack(reads)
    lens = np.full(len(reads), 100, np.int64)
    host, jax_eng, port = _engines(data, "g", SINGLE)
    nos = np.arange(len(reads))
    want, jgot, got = (e.map_batch(reads, lens, read_nos=nos)
                       for e in (host, jax_eng, port))
    for a, b in zip(want, got):
        assert np.array_equal(a, b)
    assert (want[2] == 2).sum() >= 40                 # the host maps them
    assert ((jgot[2] != want[2]).sum() >= 40)         # the reference not
    assert np.array_equal(host.final_pileup(), port.final_pileup())
