"""The bulk generator draws wgsim's model: the haplotypes' mutations on
a hand-worked genome, and over a large draw the outer lengths, the
swap of the ends, the read errors and the mutations' rates; the FASTQ it
writes parses back through the port's FastqBatcher to the same reads."""

import numpy as np

from pebench.traffic import gen

T = dict(name="t", read_len=100, outer_mean=500, outer_sd=50, err_rate=0.02,
         mut_rate=0.001, indel_frac=0.15, indel_extend=0.3, max_ins=4,
         hom_frac=0.333333, draw_seed=9)


def test_haplotype_by_hand():
    seq = np.frombuffer(b"CGTTAATTACTCCTCCGGAA", np.uint8)
    m = dict(sub=(np.array([2]), np.frombuffer(b"A", np.uint8)),
             dele=(np.array([5, 6]), np.array([2, 3])),
             ins=(np.array([0, 6, 12]), np.array([2, 1, 3]),
                  np.frombuffer(b"CCCCGGGGTTTT", np.uint8).reshape(3, 4)))
    hap, first, ends = gen.haplotype(seq, m)
    # C+CC G A(sub) T A [A T T A deleted; the insertion at 6 with them]
    # C T C C+TTT T C C G G A A
    assert hap.tobytes() == b"CCCGATACTCCTTTTCCGGAA"
    assert list(first[:6]) == [0, 3, 4, 5, 6, 7]
    assert list(ends[4:10]) == [7, 7, 7, 7, 7, 8]
    assert list(ends[11:14]) == [10, 14, 15]


def test_mutation_rates():
    seq = gen.genome(dict(genome_seed=1, genome_length=10_000_000))
    haps = gen.mutations(np.random.default_rng(3), seq, T)
    n = 10_000_000 * T["mut_rate"]
    on_one = n * (T["hom_frac"] + (1 - T["hom_frac"]) / 2)
    for h in haps:
        subs, dels, ins = (len(h["sub"][0]), len(h["dele"][0]),
                           len(h["ins"][0]))
        total = subs + dels + ins
        assert abs(total / on_one - 1) < 0.05
        assert abs((dels + ins) / total - T["indel_frac"]) < 0.015
        assert (seq[h["sub"][0]] != h["sub"][1]).all()
        assert abs(h["dele"][1].mean() - 1 / 0.7) < 0.1
        assert 1 <= h["ins"][1].min() and h["ins"][1].max() <= 4
    shared = np.intersect1d(haps[0]["sub"][0], haps[1]["sub"][0])
    assert abs(len(shared) / (n * 0.85) - T["hom_frac"]) < 0.05


def test_pairs_follow_the_model():
    seq = gen.genome(dict(genome_seed=1, genome_length=400_000))
    n = 60_000
    p = gen.pairs(seq, n, T)
    q = gen.pairs(seq, n, T)
    assert all((p[k] == q[k]).all() for k in p)         # from draw_seed
    assert abs(p["insert"].mean() - 500) < 1.5
    assert abs(p["insert"].std() - 50) < 1.5
    assert abs(p["swapped"].mean() - 0.5) < 0.01
    assert (p["l1"] == 100).all() and (p["l2"] == 100).all()
    assert p["r1"].shape == (n, 100)
    fwd = np.where(p["swapped"][:, None], p["r2"], p["r1"])
    at = p["start"][:, None] + np.arange(100)[None, :]
    # errors and the haplotype's substitutions; an indel shifts a few
    mism = (fwd != seq[at]).mean(1)
    assert abs(np.median(mism) - 0.02) <= 0.01
    assert abs(mism[mism < 0.2].mean() - 0.0205) < 0.0015
    rev = np.where(p["swapped"][:, None], p["r1"], p["r2"])
    end = p["start"] + p["insert"]
    at = end[:, None] - 1 - np.arange(100)[None, :]
    comp = gen._COMP[rev]
    mism2 = (comp != seq[at]).mean(1)
    assert abs(mism2[mism2 < 0.2].mean() - 0.0205) < 0.0015
    assert gen.quality(0.02) == ord("2")


def test_fastq_round_trip(tmp_path):
    from pecaller_tpu_torch.formats.fastq import FastqBatcher
    seq = gen.genome(dict(genome_seed=4, genome_length=50_000))
    p = gen.pairs(seq, 2500, T)
    f1, f2 = str(tmp_path / "r1.fastq.gz"), str(tmp_path / "r2.fastq.gz")
    gen.write_fastq_gz((f1, f2), (p["r1"], p["r2"]), (p["l1"], p["l2"]),
                       gen.quality(T["err_rate"]))
    got = list(FastqBatcher(f1, f2, batch_size=1000).batches())
    assert [len(b[1]) for b in got] == [1000, 1000, 500]
    s1 = np.concatenate([b[0] for b in got])
    l1 = np.concatenate([b[1] for b in got])
    s2 = np.concatenate([b[2] for b in got])
    assert (l1 == p["l1"]).all()
    assert (s1[:, :p["r1"].shape[1]] == p["r1"]).all()
    assert (s2[:, :p["r2"].shape[1]] == p["r2"]).all()
    assert (np.concatenate([b[4] for b in got]) == np.arange(2500)).all()


def test_fasta_round_trip(tmp_path):
    for n in (139, 140, 141):
        seq = gen.genome(dict(genome_seed=n, genome_length=n))
        gen.write_fasta(str(tmp_path / "g.fa"), "c", seq)
        lines = open(tmp_path / "g.fa").read().split("\n")
        assert lines[0] == ">c" and lines[-1] == ""
        assert "".join(lines[1:]).encode() == seq.tobytes()
        assert all(len(x) == 70 for x in lines[1:-2])
