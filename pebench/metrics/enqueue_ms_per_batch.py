"""Host ms a batch in ``map_batch_async`` over the window's batches."""


def read(rec):
    s = rec["spans"]["enqueue"]
    return 1e3 * sum(s) / len(s) if s else None
