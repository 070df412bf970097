"""Host ms a frame in the SLAM host layer's mapping stage (`slam/modules`
mapping via `slam/system`): the ResultLogger's `mapping` records of the
window's frames, summed, over the window's frames (wall time: a stage
that waits on the device also absorbs the device work queued before
it)."""


def read(rec):
    if rec.get("driver") != "slam" or not rec.get("frames"):
        return None
    return 1e3 * rec["stage_s"].get("mapping", 0.0) / rec["frames"]
