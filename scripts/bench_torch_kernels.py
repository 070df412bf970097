#!/usr/bin/env python3
"""Time the kernels of the PyTorch/CUDA port (K1 FPS, K2 kNN + moments,
K3 radius moments, K4 fused sweep, K5 Kabsch solve) at the shapes of the
main path, on one NVIDIA GPU, and compare source trees.

    python3 scripts/bench_torch_kernels.py [--out DIR]
    python3 scripts/bench_torch_kernels.py --root A --root B --root B --root A

Without `--root` the kernels of this checkout are built, held against their
plain versions (K1: identical indices; K2 and K4: identical indices and
distances; K3: cnt identical; K5: within `chip_smoke.KABSCH_TOL` of the
plain solve in float64; `--no-check` skips it) and timed: a run of
launches between one pair of CUDA events (`chip_smoke.timed`),
milliseconds a launch and the wrapper's host microseconds. K2's wide
rows (k 42-512 and the threshold's neighbours, which no path runs) are
timed on both of its routes (`route`), beside `torch.cdist` + `topk`
(`library_ms`). With `--root` the same measurement runs once per given
directory, in order, each in a process of its own on the same card: a root
is a directory that holds a `deeppointmap_tpu_torch/` package (this
checkout is `.`; another commit is unpacked with `git archive`), so two
versions of a kernel are compared inside one call, in turns. Every line
names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np


REPO = Path(__file__).resolve().parent.parent

#: (B, N, k) of K1: the encoder's five stages and the extract chunk
FPS_SHAPES = [(1, 16384, 4096), (4, 16384, 4096), (1, 4096, 1024),
              (1, 1024, 256), (1, 256, 64), (1, 64, 16)]
#: (N, S, k, radius) of K2: the preprocess sweep with and without moments,
#: the sweep at the reuse width, the encoder's queries, the info matrix
KNN_SHAPES = [(16384, 16384, 17, 0.5), (16384, 16384, 17, 0.0),
              (16384, 16384, 41, 0.5), (16384, 4096, 32, 0.0),
              (4096, 4096, 32, 0.0), (1024, 1024, 32, 0.0),
              (256, 256, 32, 0.0), (16384, 4096, 1, 0.0)]
#: k of K2's wide rows, each timed on both routes (no path runs them: the
#: widest k a path asks for is 41); `wide_shapes` adds the threshold's
#: neighbours
WIDE_K = (44, 46, 48, 50, 56, 65, 96, 128, 256, 512)
#: (k, radius) of K4 on the preprocess sweep's scan (`slam_a` runs k = 41
#: with moments; the other rows split its time: k = 1 is the distance pass
#: and the sort with one selection round), and the radius of K3 there
#: (`slam_b`)
SWEEP_SHAPES = [(41, 0.5), (17, 0.5), (41, 0.0), (1, 0.0)]
MOMENTS_RADIUS = 0.5
#: (B, K) of K5: the RANSAC hypotheses, then the refine solves of the
#: 256-token odometry pair and of the 1024-, 2048- and 4096-token tiles
#: against 256 tokens (2 x num_pairs pairs)
KABSCH_SHAPES = [(1024, 3), (1, 256), (1, 640), (1, 1152), (1, 2176)]


def wide_shapes(k_wide: int) -> list:
    """(N, S, k, radius) of the wide rows: the wide-k check's subset of a
    scan without moments, the whole scan with moments at 0.5 m, and the
    whole scan without them at k = 128."""
    ks = sorted({*WIDE_K, k_wide - 1, k_wide, k_wide + 1})
    return ([(4096, 1024, k, 0.0) for k in ks]
            + [(16384, 16384, k, 0.5) for k in ks]
            + [(16384, 16384, 128, 0.0)])


def measure(check: bool) -> dict:
    """Build, check and time the kernels of the package on sys.path."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_kernels: no CUDA device")
    sys.path.append(str(REPO))          # chip_smoke's helpers, after the root
    import importlib.util

    import chip_smoke as cs
    from deeppointmap_tpu_torch import kernels
    from deeppointmap_tpu_torch.ops import neighbors, sampling, sweep

    # this checkout's stream module, whatever the root (an older root may
    # predate it; the draws are the same)
    spec = importlib.util.spec_from_file_location(
        "stream_synthetic", REPO / "deeppointmap_tpu_torch/data/synthetic.py")
    syn = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(syn)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels.build_all()
    pts, valid, _ = syn.pad_stream(syn.render_stream(4), 4, cs.N_PAD)
    rows = []
    for b, n, k in FPS_SHAPES:
        if n == cs.N_PAD:
            x = torch.from_numpy(pts[:b] / 60.0).float().to(dev)
            v = torch.from_numpy(valid[:b]).to(dev)
        else:
            x = torch.randn(b, n, 3, device=dev) * 0.3
            v = torch.ones(b, n, dtype=torch.bool, device=dev)
        if check:
            idx, sel = sampling.batched_fps(x, v, k)
            ref = sampling.farthest_point_sampling_plain(x, v, k)
            if not torch.equal(idx[sel], ref[sel]):
                raise AssertionError(f"K1 differs at {(b, n, k)}")
        ms, host = cs.timed(torch, lambda: sampling.fps_cuda(x, v, k), 20)
        rows.append(dict(kernel="fps", shape=[b, n, k], ms=ms, host_us=host))
    for j, (n, s, k, radius) in enumerate(KNN_SHAPES):
        p, v, c = cs.knn_inputs(torch, dev, pts[0], valid[0], n, s, radius, j)
        if check:
            got = neighbors.knn_cuda(p, c, k, v, radius)
            ref = neighbors.knn_plain(p, c, k, v, radius)
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1],
                                                                ref[1])):
                raise AssertionError(f"K2 differs at {(n, s, k, radius)}")
        ms, host = cs.timed(torch, lambda: neighbors.knn_cuda(p, c, k, v,
                                                              radius), 20)
        rows.append(dict(kernel="knn", shape=[1, n, s, k, radius], ms=ms,
                         host_us=host))
    # the wide rows on each route (a root that predates the wide route has
    # one), with torch.cdist + topk beside them
    by_route = getattr(neighbors, "knn_cuda_route", None)
    routes = ("narrow", "wide") if by_route else ("auto",)
    k_wide = getattr(neighbors, "KNN_WIDE_K", neighbors.KNN_MAX_K + 1)
    for j, (n, s, k, radius) in enumerate(wide_shapes(k_wide)):
        p, v, c = cs.knn_inputs(torch, dev, pts[0], valid[0], n, s, radius,
                                50 + j)
        reps = 20 if n * s <= 1 << 24 else 3
        lib_ms = cs.timed_ms(torch, lambda: torch.topk(
            torch.cdist(c, p).masked_fill(~v[:, None, :], float("inf")), k,
            dim=-1, largest=False), reps)
        ref = neighbors.knn_plain(p, c, k, v, radius) if check else None
        for route in routes:
            run = (lambda: by_route(p, c, k, v, radius, route)) if by_route \
                else (lambda: neighbors.knn_cuda(p, c, k, v, radius))
            if check:
                got = run()
                if not all(torch.equal(a, r) for a, r in zip(got[:3],
                                                             ref[:3])):
                    raise AssertionError(f"K2 {route} differs at "
                                         f"{(n, s, k, radius)}")
            ms, host = cs.timed(torch, run, reps)
            rows.append(dict(kernel="knn", shape=[1, n, s, k, radius],
                             route=route, ms=ms, host_us=host,
                             library_ms=lib_ms))
    # K3 and K4 on the preprocess sweep's inputs: the scan in raw meters
    # under the distance crop (chip_smoke's k3 / k4 phases)
    dist = np.linalg.norm(pts[0], axis=1)
    crop = valid[0] & (dist >= 1.0) & (dist <= 60.0)
    scan = torch.from_numpy(pts[:1]).to(dev)
    scan_v = torch.from_numpy(crop[None]).to(dev)
    if check:
        got = sweep.radius_moments_cuda(scan, scan_v, MOMENTS_RADIUS)
        ref = sweep.radius_moments_plain(scan, scan_v, MOMENTS_RADIUS)
        if not torch.equal(got[0], ref[0]):
            raise AssertionError("K3 differs from its plain version")
    ms, host = cs.timed(torch, lambda: sweep.radius_moments_cuda(
        scan, scan_v, MOMENTS_RADIUS), 20)
    rows.append(dict(kernel="moments", shape=[1, cs.N_PAD, MOMENTS_RADIUS],
                     ms=ms, host_us=host))
    for k, radius in SWEEP_SHAPES:
        if check:
            got = sweep.fused_sweep_cuda(scan, scan_v, k, radius)
            ref = sweep.fused_sweep_plain(scan, scan_v, k, radius)
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1],
                                                                ref[1])):
                raise AssertionError(f"K4 differs at {(k, radius)}")
        ms, host = cs.timed(torch, lambda: sweep.fused_sweep_cuda(
            scan, scan_v, k, radius), 20)
        rows.append(dict(kernel="sweep", shape=[1, cs.N_PAD, k, radius],
                         ms=ms, host_us=host))
    if getattr(kernels, "KABSCH", None) is not None:  # a root may predate K5
        from deeppointmap_tpu_torch.ops import kabsch

        for j, (b, k) in enumerate(KABSCH_SHAPES):
            if check:
                en = cs.check_kabsch(torch, kabsch, b, k, j)
                rows.append(dict(kernel="kabsch", **{
                    key: en[key] for key in ("shape", "ms", "host_us",
                                             "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}))
                continue
            src, dst, w = cs.kabsch_inputs(torch, b, k, j)
            ms, host = cs.timed(torch, lambda: kabsch.solve_rt_cuda(
                src, dst, w), 20)
            rows.append(dict(kernel="kabsch", shape=[b, k], ms=ms,
                             host_us=host))
    return dict(card=smi, build_log="\n".join(
        line for kern in kernels.ALL
        for line in kern.build_log.splitlines() if "registers" in line
        or "spill" in line or "Compiling" in line), rows=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", default=[],
                    help="directory holding a deeppointmap_tpu_torch/ "
                         "package; repeat to run several in turns")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the comparison with the plain versions")
    ap.add_argument("--out", default="", help="directory for "
                    "bench_torch_kernels.json")
    args = ap.parse_args()
    if not args.root:
        sys.path.insert(0, os.getcwd())
        result = measure(not args.no_check)
        print(json.dumps(result), flush=True)
        runs = [dict(root=".", **result)]
    else:
        runs = []
        for root in args.root:
            root = str(Path(root).resolve())
            cmd = [sys.executable, str(Path(__file__).resolve())]
            if args.no_check or root != str(REPO):
                cmd.append("--no-check")   # another tree's plain versions
            proc = subprocess.run(cmd, cwd=root, capture_output=True,
                                  text=True, env=dict(os.environ,
                                                      PYTHONPATH=root))
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-8000:], flush=True)
                return proc.returncode
            runs.append(dict(root=root, **json.loads(
                proc.stdout.strip().splitlines()[-1])))
        for run in runs:
            for row in run["rows"]:
                print(json.dumps(dict(root=run["root"], card=run["card"],
                                      **row)), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "bench_torch_kernels.json"),
                  "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
