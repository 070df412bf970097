"""The whole frame's share (%) of the card's peak: the window's frames
times the frozen count (benchmark/counts) of one extraction and, but for
a session's first frame, one odometry registration with its information
matrix, at the peak of each operation's precision, over the window.
Scan-to-map and loop work is not counted: a lower bound."""


def read(rec):
    c = rec.get("counts")
    if rec.get("driver") != "slam" or not c or not rec.get("peaks_known"):
        return None
    return 100.0 * c["ops_s"] / rec["window_s"]
