"""Device kernels launched a frame (`slam/engine.py` and all it calls):
the kernels in the traced window's device timeline over the window's
frames."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("driver") != "slam" or not tr or not rec.get("frames"):
        return None
    return tr["launches"] / rec["frames"]
