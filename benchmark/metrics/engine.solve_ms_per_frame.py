"""Host ms a frame in the weighted Kabsch solves (`ops/kabsch._solve_rt`:
the SVD and the determinant, with the host syncs they make on the card),
of every registration a frame runs: the program's `kabsch.solve` span,
summed over the window's frames, over the window's frames."""

from benchmark.lib.spans import frame_ms


def read(rec):
    return frame_ms(rec, "kabsch.solve")
