"""The program's own span totals (``pecaller_tpu_torch.utils.log``) in
this process, for the readers of set-up spans.  Not a metric.  The
record does not hold these spans, so a reader reads the process's
totals: ``pebench.run`` runs one cell a process, whose set-up is then
the only one they hold.  A program without the spans, or without the
span asked for, gives None."""


def total_s(name: str):
    """Total seconds of the span ``name`` so far, or None."""
    try:
        from pecaller_tpu_torch.utils.log import spans
    except ImportError:
        return None
    got = spans().get(name)
    return got[1] if got else None
