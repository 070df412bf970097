"""A small copy of the benchmark for the CPU tests: the cells of
BENCHMARK.json over the demo-width model (the port's pipeline/demo trees,
artifacts/synthetic_demo's weights for SLAM, seeded weights for
training), 2048-point scans of a small world, short drives and two
ten-frame training scenes. Written into a directory of its own; the
harness reads it through `run.main(..., root=, bench=)`."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.lib.spec import BENCH, REPO


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _dump(obj, *parts):
    with open(os.path.join(*parts), "w") as f:
        json.dump(obj, f, indent=1)


def build(dst: str) -> str:
    """-> the bench directory of a small benchmark under `dst`."""
    from deeppointmap_tpu_torch.pipeline.demo import demo_args

    bench = os.path.join(dst, "benchmark")
    for d in ("configs", "traffic"):
        os.makedirs(os.path.join(bench, d), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"),
                    os.path.join(bench, "metrics"), dirs_exist_ok=True)
    demo = json.loads(json.dumps(demo_args("", "")))
    small = dict(world={"seed": 0, "n_clusters": 60, "extent": 30.0,
                        "pts_per_cluster": 400},
                 render={"sensor_range": 35.0, "max_points": 2048,
                         "occlusion_bins": 0}, render_workers=2)
    spec = _load(REPO, "BENCHMARK.json")
    for c in spec["configs"]:
        conf = _load(REPO, c["file"])
        model = conf["model"]
        model["encoder"], model["decoder"] = demo["encoder"], demo["decoder"]
        model["tpu"].update(encoder_points=2048,
                            reg_buckets=[128, 256, 512, 1024],
                            loop_batch_buckets=[1, 4, 16, 64])
        if "train" in model:
            model["train"]["registration"]["max_pairs"] = 256
        if "weights" in conf:
            conf["weights"] = "artifacts/synthetic_demo/weights_final.msgpack"
            # the demo model does not track the small world under the
            # occluded world's gates: open them, so that every
            # registration is an accepted answer the check compares
            model["slam_system"].update(
                edge_confidence_drop=0.0, edge_rmse_drop=100.0,
                loop_detection_confidence_acpt_threshold=0.0)
        _dump(conf, bench, "configs", f"{c['name']}.json")
    for w in spec["workloads"]:
        traf = _load(BENCH, "traffic", f"{w['traffic']}.json")
        traf.update(small)
        if traf["driver"] == "slam":
            traf.update(trajectory={"radius": 15.0, "frames_per_lap": 8,
                                    "laps": 2}, warm_frames=3)
        else:
            traf["scenes"] = [
                {"world_seed": 1, "radius": 12.0, "direction": 1,
                 "frames": 10},
                {"world_seed": 2, "radius": 14.0, "direction": 1,
                 "frames": 10}]
        _dump(traf, bench, "traffic", f"{w['traffic']}.json")
    _dump(spec, dst, "BENCHMARK.json")
    return bench
