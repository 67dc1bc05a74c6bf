"""Seconds the seed index's loaders took in set-up, as ``device_route``
calls them (``load_nbr_index`` or ``load_quarter_index``): the program's
span ``engine.seed_index``, its total in this process."""

from .program_spans import total_s


def read(rec):
    return total_s("engine.seed_index")
