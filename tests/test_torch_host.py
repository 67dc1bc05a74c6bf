"""The port's own copies of the reference package's JAX-free host code
against the originals: the index builder writes the same files, the nbr
index loader gives the same arrays, and the host oracle MapperEngine
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
from pecaller_tpu.index.nbr import load_nbr_index as jax_load_nbr
from pecaller_tpu.mapper.engine import MapperEngine as JaxEngine
from pecaller_tpu_torch.formats.fastq import FastqBatcher
from pecaller_tpu_torch.formats.index_files import load_index
from pecaller_tpu_torch.formats.sdx import read_sdx, read_seq
from pecaller_tpu_torch.index import build_index
from pecaller_tpu_torch.index.nbr import load_nbr_index
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
