"""The port's own copies of the reference package's JAX-free host code
against the originals: the index builder writes the same files, the nbr
index loader gives the same arrays, the native cuckoo placement the
numpy build's tables, and the host oracle MapperEngine
maps the same (codes, .mfile positions, pileup, stats, insertion
records) on tests/test_fused.py's data.

Tolerance: byte and array equality (gzip files compared decompressed:
their headers carry a file name and a time)."""

import gzip
import os

import numpy as np
import pytest

from pecaller_tpu.formats.fastq import FastqBatcher as JaxBatcher
from pecaller_tpu.index import build_index as jax_build_index
from pecaller_tpu.index.nbr import build_cuckoo as jax_build_cuckoo
from pecaller_tpu.index.nbr import load_nbr_index as jax_load_nbr
from pecaller_tpu.mapper.engine import MapperEngine as JaxEngine
from pecaller_tpu_torch.formats.fastq import FastqBatcher
from pecaller_tpu_torch.formats.index_files import load_index
from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
from pecaller_tpu_torch.index import build_index
from pecaller_tpu_torch.index.nbr import build_cuckoo, load_nbr_index
from pecaller_tpu_torch.mapper.engine import MapperEngine
from torch_util import load_genome, make_fused_data
from util import make_genome, write_fasta


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_fused_data(tmp_path_factory.mktemp("torch_host"))


def _contents(path):
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw) if raw[:2] == b"\x1f\x8b" else raw


@pytest.mark.parametrize("bisulfite", [False, True])
def test_build_index_writes_the_same_files(tmp_path, bisulfite):
    rng = np.random.default_rng(7)
    names, seqs = make_genome(rng, [9000, 4000, 700],
                              n_blocks=[(1, 100, 40)])
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, names, seqs)
    for d, build in (("jax", jax_build_index), ("port", build_index)):
        os.makedirs(tmp_path / d)
        # (the dense .idx takes minutes to write: left out)
        build(fa, str(tmp_path / d / "g"), bisulfite=bisulfite,
              write_idx=False)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert {"g.sdx", "g.seq", "g.mdx"} <= set(files)
    for f in files:
        assert _contents(tmp_path / "jax" / f) == \
            _contents(tmp_path / "port" / f), f


def test_load_nbr_index_gives_the_same_arrays(data):
    _, _, index = load_genome(data)
    ref = jax_load_nbr(str(data / "g"), index, cache=False)
    port = load_nbr_index(str(data / "g"), load_index(str(data / "g")),
                          cache=False)
    for name in ("nkeys", "val_start", "positions", "hi_table", "hash_tag",
                 "hash_val"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a is not None and np.array_equal(np.asarray(a),
                                                np.asarray(b)), name


@pytest.mark.parametrize("n,min_tb", [(0, None), (1, None), (5000, 10),
                                      (300_000, None), (300_000, 13)])
def test_cuckoo_tables_match_jax(n, min_tb):
    """build_cuckoo (native placement, native/cuckoo.c) against the
    reference's vectorized rounds: the same tag and value words and tb,
    with abundant flags, counts past 255 and a forced small table
    (displacement chains)."""
    rng = np.random.default_rng(n + (min_tb or 0))
    keys = np.unique(rng.integers(0, 2 ** 32, 2 * n + 1, dtype=np.uint64)
                     .astype(np.uint32))[:n]
    vs = np.zeros(len(keys) + 1, np.uint32)
    vs[1:] = np.cumsum(rng.integers(0, 400, len(keys))).astype(np.uint32)
    vs[:-1] |= (rng.random(len(keys)) < 0.1).astype(np.uint32) << 31
    want = jax_build_cuckoo(keys, vs, min_tb=min_tb)
    got = build_cuckoo(keys, vs, min_tb=min_tb)
    assert got[2] == want[2]
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    assert ((got[0] >> 31) != 0).sum() == len(keys)


def test_host_engine_maps_the_same(data):
    kw = dict(paired=True, min_align=0.9, min_dist=0, max_dist=500,
              nthreads=2)
    sdx = read_sdx(str(data / "g.sdx"))
    genome = read_seq(str(data / "g.seq"), sdx.genome_size)
    port = MapperEngine(sdx, genome, load_index(str(data / "g")), **kw)
    ref = JaxEngine(*load_genome(data), **kw)
    got = [port.map_batch(s1, l1, s2, l2, read_nos=nos)
           for s1, l1, s2, l2, nos in FastqBatcher(
               str(data / "r1.fastq"), str(data / "r2.fastq"),
               batch_size=400).batches()]
    want = [ref.map_batch(s1, l1, s2, l2, read_nos=nos)
            for s1, l1, s2, l2, nos in JaxBatcher(
                str(data / "r1.fastq"), str(data / "r2.fastq"),
                batch_size=400).batches()]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)
    assert np.array_equal(port.final_pileup(), ref.final_pileup())
    assert port.ins_records == ref.ins_records
    for f in ("mate_counts", "total_reads", "total_bases", "total_dist",
              "no_dists"):
        assert np.array_equal(getattr(port.stats, f),
                              getattr(ref.stats, f)), f
    assert (got[0][2] != 8).sum() > 300
