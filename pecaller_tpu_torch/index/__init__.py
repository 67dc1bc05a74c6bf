from .builder import build_index, index_genome_cli

__all__ = ["build_index", "index_genome_cli"]
