"""Host ms a step blocked in the step's one host sync
(`parallel/train_step.TrainStep.__call__`: the metrics' `.tolist()`), the
device time the host does not overlap: the program's `train.sync` span
from the Trainer's steps file, mean over the window's steps. What batch
prefetch could hide a step."""

from benchmark.lib.spans import step_ms


def read(rec):
    return step_ms(rec, "train.sync")
