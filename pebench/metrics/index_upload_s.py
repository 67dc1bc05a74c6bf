"""Host seconds of the engine's upload in set-up: packing the genome and
moving the index to the device (``FusedMapperEngine2.__init__``): the
program's span ``engine.upload``, its total in this process.  The
upload's last copies may finish after it, inside ``index_load_s``."""

from .program_spans import total_s


def read(rec):
    return total_s("engine.upload")
