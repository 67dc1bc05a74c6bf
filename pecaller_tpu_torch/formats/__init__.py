from .sdx import SdxInfo, read_sdx, write_sdx
from .index_files import read_idx, read_mdx, write_index_files, load_index
from .pileup import read_pileup, write_pileup
from .fastq import FastqBatcher, iter_fastq_seqs

__all__ = [
    "SdxInfo", "read_sdx", "write_sdx",
    "read_idx", "read_mdx", "write_index_files", "load_index",
    "read_pileup", "write_pileup",
    "FastqBatcher", "iter_fastq_seqs",
]
