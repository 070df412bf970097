"""Host ms a step in the training transforms on the host
(`data/dataset.SlamDatasets._map_query`: `data_transforms`): the program's
`train.transform` span from the Trainer's steps file, mean over the
window's steps."""

from benchmark.lib.spans import step_ms


def read(rec):
    return step_ms(rec, "train.transform")
