"""Seconds from the process's start to the first timed batch: imports,
the sample's FASTQ parse, the index load and upload, the engine, one
batch of each shape and each shape key's three calls (eager, capture,
replay).  A checkout's first run leaves out what it builds for every
later run (the index and its caches, the mix's reads, the kernels)."""


def read(rec):
    return rec["setup_s"]
