"""The program's own spans (`deeppointmap_tpu_torch/utils/timer.py`) as
the per-layer readers find them after a run.

SLAM: `SlamSystem.step` records each span's total of a frame through its
ResultLogger under the span's name, and the driver sums the window's
records by name into `rec["stage_s"]`. Training: the Trainer writes each
step's totals into its steps.jsonl row under `spans`; the driver hands on
only the window's `batch_s`, so the window's rows are the run of rows in
the Trainer's own steps file (`<cache>/train_out/steps.jsonl`, the
driver's out directory) whose `batch_s` equal `rec["batch_s"]`, in order.

Each reading is None where the program records no such span (a commit
before the spans), never a false 0.
"""

from __future__ import annotations

import json
import os

from benchmark.lib import scans


def frame_ms(rec: dict, name: str):
    """Host ms a frame in span `name` over the SLAM window's frames."""
    if rec.get("driver") != "slam" or not rec.get("frames"):
        return None
    seconds = rec.get("stage_s", {}).get(name)
    return None if seconds is None else 1e3 * seconds / rec["frames"]


def steps_file() -> str:
    return os.path.join(scans.CACHE, "train_out", "steps.jsonl")


def window_rows(rec: dict):
    """The steps file's rows of the training window, or None."""
    want = rec.get("batch_s")
    if rec.get("driver") != "train" or not want \
            or not os.path.exists(steps_file()):
        return None
    with open(steps_file()) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    have = [r.get("batch_s") for r in rows]
    n = len(want)
    for i in range(len(rows) - n + 1):
        if have[i:i + n] == want:
            return rows[i:i + n]
    return None


def step_ms(rec: dict, name: str):
    """Host ms a step in span `name`, mean over the training window's
    steps (a step without it reads 0 there)."""
    rows = window_rows(rec)
    if not rows or not any(name in r.get("spans", {}) for r in rows):
        return None
    return 1e3 * sum(r["spans"].get(name, 0.0) for r in rows) / len(rows)
