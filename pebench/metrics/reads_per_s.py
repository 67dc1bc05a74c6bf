"""Reads resolved in the window over the window's seconds, on one card."""

from pebench.traffic.loop import rate


def read(rec):
    return rate(rec["reads"], rec["window_s"])
