"""bench_torch.py's accuracy and scale blocks on the CPU at tiny sizes
(the full-size block at two frames a lap, the demo block at four; the scale
block at six frames): their keys, finite ATEs, and the full-size recipe's
module settings restored after the accuracy block."""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch as bt  # noqa: E402
from deeppointmap_tpu_torch.pipeline import full_size  # noqa: E402

torch.set_num_threads(2)


def test_accuracy_block(tmp_path):
    before = {k: dict(getattr(full_size, k))
              for k in ("WORLD", "RENDER", "EVAL_WORLD")}
    res = bt.accuracy("cpu", str(tmp_path), frames_per_lap=2,
                      demo_frames_per_lap=4)
    assert set(res) == {"ate_m", "ate_no_loop_m", "loop_edges", "model",
                        "demo"}
    assert res["model"] == "full_size_B"
    assert set(res["demo"]) == {"ate_m", "ate_no_loop_m", "loop_edges"}
    for blk in (res, res["demo"]):
        assert np.isfinite(blk["ate_m"]) and np.isfinite(blk["ate_no_loop_m"])
        assert blk["loop_edges"] >= 0
    assert before == {k: dict(getattr(full_size, k)) for k in before}


def test_scale_block(tmp_path):
    res = bt.scale("cpu", str(tmp_path), frames=6, block=3)
    assert set(res) == {"frames", "ate_m", "loop_edges", "loop_floor_ok",
                        "keyframes", "scans_per_sec_first_block",
                        "scans_per_sec_last_block", "rss_growth_mb",
                        "device_growth_mb", "device_max_mb"}
    assert res["frames"] == 6 and res["device_growth_mb"] is None
