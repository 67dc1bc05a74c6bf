"""Share of the traced stretch of the window in which no kernel, copy or
set ran on the card, in %."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("n_device_events"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
