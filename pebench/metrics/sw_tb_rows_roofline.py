"""K2's (``csrc/sw_tb_rows.cu``) share of its roofline, in %."""

from pebench.metrics import roofline


def read(rec):
    k = rec.get("kernels", {}).get("k2")
    if not k or "k2" not in rec.get("lanes", {}):
        return None
    return roofline.share(roofline.work("k2", rec["lanes"]["k2"]), k["ms"])[0]
