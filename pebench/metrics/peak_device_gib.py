"""``max_memory_allocated`` over set-up and window on the fullest card,
in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec["peak_bytes"] else None
