"""Host ms a step assembling the batch (`pipeline/trainer._iter_batches`:
`pipeline/batching.build_registration_batch` and the concatenation): the
program's `train.assemble` span from the Trainer's steps file, mean over
the window's steps."""

from benchmark.lib.spans import step_ms


def read(rec):
    return step_ms(rec, "train.assemble")
