"""Host ms a batch in ``resolve`` over the window's batches."""


def read(rec):
    s = rec["spans"]["resolve"]
    return 1e3 * sum(s) / len(s) if s else None
