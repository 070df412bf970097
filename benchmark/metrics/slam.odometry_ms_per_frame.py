"""Host ms a frame in the odometry stage (`slam/system` SlamSystem.step:
the fused engine call from launch to resolved result, the new scan and its
edge, the extra candidates): the program's `slam.odometry` span, summed
over the window's frames, over the window's frames. Includes the waits
and solves inside it (`engine.wait_ms_per_frame`,
`engine.solve_ms_per_frame`)."""

from benchmark.lib.spans import frame_ms


def read(rec):
    return frame_ms(rec, "slam.odometry")
