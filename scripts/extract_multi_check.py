#!/usr/bin/env python3
"""Offline batch extraction over every visible GPU against one GPU
(deeppointmap_tpu_torch/parallel/sharded_extract.py), at DeepPointMap-B
full width.

    python3 scripts/extract_multi_check.py [--scans 32] [--per 1 4 8] \
        [--out OUT_DIR]

Renders the first `--scans` scans of chip_smoke.py's world (voxelized at
0.3 m, padded to 16384 points), loads artifacts/full_size_occ_v2, and runs
extract_sequence with configs/infer/sample.yaml's device preprocessing
over every visible card and over cuda:0 alone, at 1, 4 and 8 scans a card
(`--per`; at 8, four cards take the 32 scans in one call).
Checks: descriptors of every card against one card within 1e-6 relative
(max |a - b| / max |b|), validity identical. Reports the seconds
make_sharded_extract takes to build the replicas, and scans/s of the
built extractor's `sequence` on the scans (the median of three timed
calls after extract_sequence's, each ending in the results on the
host). Prints every card's nvidia-smi line and one JSON line; with --out,
also writes it to OUT/extract_multi_check.json. Exits 1 if a check fails
or fewer than two cards are visible.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

TIMED_CALLS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=32)
    ap.add_argument("--per", type=int, nargs="+", default=[1, 4, 8],
                    help="scans a card")
    ap.add_argument("--out", default="")
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("extract_multi_check: needs two or more CUDA devices",
              file=sys.stderr)
        return 1
    from deeppointmap_tpu_torch.config import config_from_dict
    from deeppointmap_tpu_torch.data import synthetic as syn
    from deeppointmap_tpu_torch.data.preprocess import PreprocessConfig
    from deeppointmap_tpu_torch.models.encoder import Encoder
    from deeppointmap_tpu_torch.models.weights import load_msgpack_weights
    from deeppointmap_tpu_torch.parallel.sharded_extract import (
        extract_sequence, make_sharded_extract)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    pts, valid, _ = syn.pad_stream(syn.render_stream(opt.scans), opt.scans,
                                   cs.N_PAD)
    cfg = copy.deepcopy(cs.CONFIG)
    cfg["tpu"]["upload_quant"] = "none"
    args = config_from_dict(cfg, multi_thread=False)
    pre = PreprocessConfig.from_transforms(args.transforms)
    enc_sd, _ = load_msgpack_weights(os.path.join(REPO, cs.WEIGHTS))
    encoder = Encoder.from_config(args)
    coor_scale = float(args.slam_system.coor_scale)
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]

    runs, outs = {}, {}
    for name, devices in (("one", cards[:1]), ("all", cards)):
        for per in opt.per:
            outs[(name, per)] = extract_sequence(
                encoder, enc_sd, devices, coor_scale, pts, valid,
                preprocess_cfg=pre, batch_per_device=per)
            t0 = time.perf_counter()
            extract = make_sharded_extract(encoder, enc_sd, devices,
                                           coor_scale, pre)
            build_s = time.perf_counter() - t0
            secs = []
            for _ in range(TIMED_CALLS):
                t0 = time.perf_counter()
                extract.sequence(pts, valid, per)
                secs.append(time.perf_counter() - t0)
            wall = float(np.median(secs))
            runs[f"{name}_b{per}"] = dict(cards=len(devices),
                                          batch_per_device=per,
                                          build_s=build_s, wall_s=wall,
                                          walls_s=secs,
                                          scans_per_s=opt.scans / wall)
    checks, ok = {}, True
    for per in opt.per:
        (d1, dv1, pv1), (dn, dvn, pvn) = outs[("one", per)], outs[("all",
                                                                   per)]
        rel = float(np.abs(dn - d1).max() / max(np.abs(d1).max(), 1e-30))
        same = bool(np.array_equal(dvn, dv1) and np.array_equal(pvn, pv1))
        finite = bool(np.isfinite(dn).all())
        checks[f"b{per}"] = dict(desc_relerr=rel, validity_equal=same,
                                 finite=finite)
        ok &= rel <= 1e-6 and same and finite
    for per in opt.per:
        runs[f"speedup_b{per}"] = (runs[f"all_b{per}"]["scans_per_s"]
                                   / runs[f"one_b{per}"]["scans_per_s"])
    line = dict(check="extract_multi", ok=ok, cards=len(cards),
                names=[torch.cuda.get_device_name(i)
                       for i in range(len(cards))],
                nvidia_smi=smi, scans=opt.scans,
                config="configs/infer/sample.yaml (DeepPointMap-B), device "
                "preprocessing, artifacts/full_size_occ_v2",
                checks=checks, runs=runs)
    for row in smi:
        print(row)
    print(json.dumps(line), flush=True)
    if opt.out:
        os.makedirs(opt.out, exist_ok=True)
        with open(os.path.join(opt.out, "extract_multi_check.json"),
                  "w") as f:
            json.dump(line, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
