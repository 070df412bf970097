"""Host ms a step reading scans (`data/dataset.SlamDatasets._map_query`:
`ds[offset + o]`): the program's `train.read` span from the Trainer's
steps file, mean over the window's steps."""

from benchmark.lib.spans import step_ms


def read(rec):
    return step_ms(rec, "train.read")
