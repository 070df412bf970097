"""Long-stream scale run on the PyTorch/CUDA port: stream many frames of a
drifting multi-lap world through the whole pipelined SLAM system (loops on)
and report, block by block, scans/s, stage ms, host RSS and the card's
allocated memory (the port's counterpart of scripts/scale_run.py; the run
lives in deeppointmap_tpu_torch/pipeline/scale.py).

Usage: python scripts/scale_run_torch.py [--frames 1200] [--block 100]
           [--retain_pcd] [--json_out summary.json] [--device cpu]
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deeppointmap_tpu_torch.pipeline.scale import run_scale  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=1200)
    ap.add_argument("--block", type=int, default=100)
    ap.add_argument("--root",
                    default=os.path.join(REPO, "log_infer/scale/world"))
    ap.add_argument("--out", default=os.path.join(REPO, "log_infer/scale/out"))
    ap.add_argument("--retain_pcd", action="store_true",
                    help="keep non-keyframe full_pcd (reference parity "
                         "mode; the default drops it to bound memory)")
    ap.add_argument("--json_out", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = ap.parse_args(argv)

    summary = run_scale(frames=ns.frames, block=ns.block, root=ns.root,
                        out=ns.out, retain_pcd=ns.retain_pcd,
                        device=ns.device)
    if ns.json_out:
        with open(ns.json_out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
