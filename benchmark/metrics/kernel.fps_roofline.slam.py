"""K1's (`csrc/fps.cu`) share (%) of its roofline over the traced SLAM
window: the least time of the frozen count of its calls (five levels a
frame's extraction) over its device time by kernel name."""

NAMES = ("fps_kernel",)


def read(rec):
    c, tr = rec.get("counts"), rec.get("trace")
    if rec.get("driver") != "slam" or not c or not tr \
            or not rec.get("peaks_known"):
        return None
    t = sum(v for k, v in tr["kernel_s"].items()
            if any(n in k for n in NAMES))
    return 100.0 * c["fps_bound_s"] / t if t > 0 else None
