"""Host ms a step spent building the batch (`pipeline/trainer`
`_iter_batches`, `pipeline/batching`, `data/dataset.SlamDatasets`): the
Trainer's own steps file, `batch_s`, mean over the window's steps."""


def read(rec):
    if rec.get("driver") != "train" or not rec.get("batch_s"):
        return None
    return 1e3 * sum(rec["batch_s"]) / len(rec["batch_s"])
