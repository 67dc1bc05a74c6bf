"""Seconds of loading the cached index parts (``read_sdx``, ``read_seq``,
``load_index``) and building the engine with its index upload."""


def read(rec):
    return rec["index_load_s"]
