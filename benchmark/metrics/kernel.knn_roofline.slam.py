"""K2's (`csrc/knn.cu`) share (%) of its roofline over the traced SLAM
window: the least time of the frozen count of its calls (the filters'
sweep, the encoder's groupings and level graphs, the 3-NN upsampling, the
odometry's information matrix) over the device time of its kernels by
name. Scan-to-map and loop registrations' information matrices are not
counted: a lower bound."""

NAMES = ("knn_kernel", "wide_kernel", "pack_kernel")


def read(rec):
    c, tr = rec.get("counts"), rec.get("trace")
    if rec.get("driver") != "slam" or not c or not tr \
            or not rec.get("peaks_known"):
        return None
    t = sum(v for k, v in tr["kernel_s"].items()
            if any(n in k for n in NAMES))
    return 100.0 * c["knn_bound_s"] / t if t > 0 else None
