import os

import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture(scope="session")
def tiny_index(tmp_path_factory):
    """A 150 kb single-contig genome, its FASTA and the port's index."""
    from pebench.traffic import gen
    from pecaller_tpu_torch.index import build_index
    d = tmp_path_factory.mktemp("tiny")
    cfg = dict(name="tiny", genome_length=150_000, genome_seed=5)
    seq = gen.genome(cfg)
    gen.write_fasta(str(d / "g.fa"), "tiny", seq)
    build_index(str(d / "g.fa"), str(d / "g"), write_idx=False)
    open(os.path.join(d, "ready"), "w").close()
    return str(d), seq
