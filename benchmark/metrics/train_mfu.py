"""The whole step's share (%) of the cards' peak: the window's steps times
the frozen count (benchmark/counts) of a stage-1 step on its batch (the
dense layers and the loss's products 3x forward, FPS and kNN once), at the
peak of each operation's precision, over the window."""


def read(rec):
    c = rec.get("counts")
    if rec.get("driver") != "train" or not c or not rec.get("peaks_known") \
            or not rec.get("steps"):
        return None
    return 100.0 * c["ops_s"] / rec["window_s"]
