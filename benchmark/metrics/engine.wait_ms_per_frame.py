"""Host ms a frame blocked on a device event at the engine's result
fetches (`slam/engine` `_start_fetch`'s wait, `_fetch_later`'s thunk):
the program's `engine.wait` span, summed over the window's frames, over
the window's frames. Small against `slam.odometry_ms_per_frame`, it says
that the host spends the odometry stage launching, not waiting."""

from benchmark.lib.spans import frame_ms


def read(rec):
    return frame_ms(rec, "engine.wait")
