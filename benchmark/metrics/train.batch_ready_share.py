"""Share of the training window's steps whose batch was already waiting
when the loop asked for it (`pipeline/trainer`: with `num_workers` a
producer process builds batches ahead of the step), in %: the steps
file's `batch_ready`. None where the window's rows lack it (a commit
without the producer), never a false 0."""

from benchmark.lib.spans import window_rows


def read(rec):
    rows = window_rows(rec)
    if not rows or any("batch_ready" not in r for r in rows):
        return None
    return 100.0 * sum(bool(r["batch_ready"]) for r in rows) / len(rows)
