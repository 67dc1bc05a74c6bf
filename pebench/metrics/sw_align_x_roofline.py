"""K1's (``csrc/sw_align_x.cu``) share of its roofline, in %."""

from pebench.metrics import roofline


def read(rec):
    k = rec.get("kernels", {}).get("k1")
    if not k or "k1" not in rec.get("lanes", {}):
        return None
    return roofline.share(roofline.work("k1", rec["lanes"]["k1"]), k["ms"])[0]
