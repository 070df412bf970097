"""Host ms a frame in loop closure (`slam/modules` LoopClosureModule via
`slam/system`): the ResultLogger's `loop_closure` records of the window's
frames, summed, over the window's frames."""


def read(rec):
    if rec.get("driver") != "slam" or not rec.get("frames"):
        return None
    return 1e3 * rec["stage_s"].get("loop_closure", 0.0) / rec["frames"]
