#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deeppointmap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [OUT_DIR]

Phases, in order, each printing one JSON line:
  device  the card (nvidia-smi name and power limit); fails without CUDA.
  build   nvcc builds both kernels from csrc/, all at once.
  k1      K1 (FPS) against its plain version at the encoder's five stage
          shapes (B=1) and at 16384 -> 4096 with B=4: identical indices.
  k2      K2 (kNN + radius moments) against its plain version at every
          shape the main path gives it: identical neighbour sets, dist2
          and moments within the stated tolerances.
  main    the inference engine at full width (DeepPointMap-B,
          configs/infer/sample.yaml, trained weights from
          artifacts/full_size_occ_v2) on 8 synthetic scans: extract,
          odometry frame to frame, register_with_info, loop_scores; every
          kernel of the path must have launched.
  cpu     frames 0-2 again through the same engine on the CPU (the plain
          versions), held to the GPU results.
Then one JSON line with every kernel's numbers, the nvidia-smi line, and
the last line {"ok": true, "device": {...}}; with OUT_DIR, the kernel
entries also go to OUT_DIR/chip_smoke.json. Any failure raises and the
script exits non-zero. TF32 is off throughout: distances at +-60 m need
full f32. Times are medians of CUDA events after a warm-up.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_PAD = 16384
N_FRAMES = 8
CPU_FRAMES = 3
WEIGHTS = "artifacts/full_size_occ_v2/weights_final.msgpack"
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
REPLACES = {"fps": "deeppointmap_tpu/ops/pallas_fps.py:111",
            "knn": "deeppointmap_tpu/ops/pallas_knn.py:192"}
SOURCES = {"fps": "deeppointmap_tpu_torch/csrc/fps.cu",
           "knn": "deeppointmap_tpu_torch/csrc/knn.cu"}

#: configs/infer/sample.yaml (the DeepPointMap-B model) as a dict; the
#: `tpu:` tree is laid over TPU_DEFAULTS by config_from_dict
CONFIG = dict(
    transforms={
        "VoxelSample": {"voxel_size": 0.3, "retention": "first"},
        "DistanceSample": {"min_dis": 1.0, "max_dis": 60.0},
        "OutlierFilter": {"nb_neighbors": 10, "std_ratio": 3.0},
        "LowPassFilter": {"normals_radius": 0.5, "normals_num": 16,
                          "filter_std": 2.0, "flux": 4, "max_remain": -1},
        "CoordinatesNormalization": {"ratio": 60.0},
    },
    encoder=dict(npoint=[4096, 1024, 256, 64, 16],
                 radius_list=[[0.05, 0.1], [0.1, 0.2], [0.2, 0.4, 0.4],
                              [0.4, 0.8], [0.8, 1.6]],
                 nsample_list=[[32, 32], [32, 32], [32, 32, 32], [32, 32],
                               [16, 16]],
                 in_channel=3, out_channel=128, width=16, expansion=4,
                 upsample_layers=2, sample=[{"type": "fps"}] * 5, norm="LN",
                 bias=True),
    decoder=dict(in_channel=128, model_channel=256, attention_layers=3),
    loss=dict(tau=0.1, eps_offset=2.0),
    slam_system=dict(coor_scale=60),
    tpu=dict(encoder_points=N_PAD, reg_buckets=[256, 512, 1024, 2048, 4096],
             loop_batch_buckets=[1, 2, 4, 8, 16, 32, 64], bf16=True),
)
#: artifacts/full_size_occ_v2/render_meta.json
WORLD = dict(n_clusters=1200, extent=120.0, pts_per_cluster=800)
RENDER = dict(sensor_range=45.0, max_points=16384, occlusion_bins=512)
TRAJ = dict(radius=50.0, frames_per_lap=96)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def relerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def rotation_deg(A, B) -> float:
    chord = np.linalg.norm(np.asarray(A, np.float64) - np.asarray(B,
                                                                   np.float64))
    return float(np.degrees(2 * np.arcsin(min(1.0, chord / (2 * np.sqrt(2))))))


def timed_ms(torch, fn, reps: int) -> float:
    """Median of CUDA-event times over `reps` calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def render_scans(syn, voxel_idx):
    """N_FRAMES raw-meter scans (N_FRAMES, N_PAD, 3), validity and the
    ground-truth poses."""
    rng = np.random.default_rng(SEED)
    world = syn.make_world(rng, **WORLD)
    poses = syn.circle_trajectory(TRAJ["frames_per_lap"], TRAJ["radius"])
    pts = np.zeros((N_FRAMES, N_PAD, 3), np.float32)
    valid = np.zeros((N_FRAMES, N_PAD), bool)
    for i in range(N_FRAMES):
        xyz = syn.render_scan(world, poses[i], rng=rng, **RENDER)
        xyz = xyz[voxel_idx(xyz, 0.3, "first")][:N_PAD]
        pts[i, :len(xyz)] = xyz
        valid[i, :len(xyz)] = True
    return pts, valid, poses[:N_FRAMES]


# ------------------------------------------------------------------- K1
def check_fps(torch, sampling, xyz, valid, k):
    """One K1 shape against the plain version; returns its entry."""
    b, n, _ = xyz.shape
    idx, sel = sampling.batched_fps(xyz, valid, k)
    ref = sampling.farthest_point_sampling_plain(xyz, valid, k)
    torch.cuda.synchronize()
    err = int((idx[sel] - ref[sel]).abs().max()) if bool(sel.any()) else 0
    if err != 0:
        raise AssertionError(f"K1 differs from its plain version at "
                             f"B={b} N={n} k={k}")
    ms = timed_ms(torch, lambda: sampling.fps_cuda(xyz, valid, k), 10)
    plain_ms = timed_ms(
        torch, lambda: sampling.farthest_point_sampling_plain(xyz, valid, k),
        2)
    # each of the k-1 steps: 3 sub, 3 mul, 2 add, 1 min per point
    bound_ms, by = bound(b * n * 13 + b * k * 8, 9.0 * b * n * (k - 1))
    return dict(name="fps", shape=list(sampling.fps_shape(b, n, k)),
                route="cuda", source=SOURCES["fps"], replaces=REPLACES["fps"],
                max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, library_ms=None)


# ------------------------------------------------------------------- K2
def check_knn(torch, nb, points, valid, centers, k, radius):
    """One K2 shape against the plain version; returns its entry.
    Tolerances: identical neighbour sets but for exact ties, dist2 relerr
    <= 1e-5, moments relerr <= 1e-4 (the two are built to give the same
    bits; max_abs_err reports what they gave)."""
    b, n, _ = points.shape
    s = centers.shape[1]
    got = nb.knn_cuda(points, centers, k, valid, radius)
    ref = nb.knn_plain(points, centers, k, valid, radius)
    torch.cuda.synchronize()
    got = [x.cpu().numpy() for x in got]
    ref = [x.cpu().numpy() for x in ref]
    same = np.all(np.sort(got[0], -1) == np.sort(ref[0], -1), -1)
    for r in zip(*np.nonzero(~same)):
        kth = ref[1][r][-1]
        diff = set(got[0][r]) ^ set(ref[0][r])
        d = dict(zip(got[0][r], got[1][r])) | dict(zip(ref[0][r], ref[1][r]))
        if any(d[i] != kth for i in diff):
            raise AssertionError(f"K2 neighbour sets differ at {r}")
    if relerr(got[1], ref[1]) > 1e-5:
        raise AssertionError("K2 dist2 differs from its plain version")
    for a, c in zip(got[2:], ref[2:]):
        if relerr(a, c) > 1e-4:
            raise AssertionError("K2 moments differ from its plain version")
    err = max(float(np.max(np.abs(a.astype(np.float64) - c)))
              for a, c in zip(got, ref))
    ms = timed_ms(torch, lambda: nb.knn_cuda(points, centers, k, valid,
                                             radius), 20)
    plain_ms = timed_ms(torch, lambda: nb.knn_plain(points, centers, k,
                                                    valid, radius), 2)

    def library():
        d = torch.cdist(centers, points)
        d = d.masked_fill(~valid[:, None, :], float("inf"))
        return torch.topk(d, k, dim=-1, largest=False)

    library_ms = timed_ms(torch, library, 10)
    # 8 FLOPs a pair for |c|^2 - 2 c.p + |p|^2; with moments 16 more for
    # each in-radius pair (this run's counts)
    flops = 8.0 * b * s * n
    nbytes = b * n * 13 + b * s * 12 + b * s * k * 12
    if radius > 0:
        flops += 16.0 * float(got[2].sum())
        nbytes += b * s * 40
    bound_ms, by = bound(nbytes, flops)
    return dict(name="knn", shape=list(nb.knn_shape(b, n, s, k, radius)),
                route="cuda", source=SOURCES["knn"], replaces=REPLACES["knn"],
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=library_ms)


def knn_inputs(torch, dev, scan_pts, scan_valid, n, s, radius, seed):
    """Inputs at one K2 shape: a real scan in raw meters where the shape
    carries moments or is the scan itself; else normalized subsets."""
    g = np.random.default_rng(seed)
    if n == N_PAD:
        pts, valid = scan_pts, scan_valid
    else:
        keep = g.choice(np.nonzero(scan_valid)[0], n, replace=False)
        pts, valid = scan_pts[keep] / 60.0, np.ones(n, bool)
    if s == n:
        centers = pts
    else:
        ci = g.choice(np.nonzero(valid)[0], s, replace=s > valid.sum())
        centers = pts[ci] + g.normal(0, 0.05 if n == N_PAD else 0.002,
                                     (s, 3))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)[None]).to(dev)
    return (t(pts.astype(np.float32)), t(valid),
            t(np.asarray(centers, np.float32)))


def drive_main_path(engine, pts, valid, poses) -> dict:
    """extract on frame 0, odometry_step frame to frame, register_with_info
    (frame 0 -> 2) and loop_scores (each frame against the next), through
    the engine's public entry points; checks the outputs' ranges."""
    frames = []
    t0 = time.perf_counter()
    d, dv, pv = engine.extract(pts[:1], valid[:1])
    extract_ms = (time.perf_counter() - t0) * 1e3
    frames.append((d, dv, pv, None))
    frame_ms, pose_err = [], []
    for i in range(1, len(pts)):
        pd, pdv, ppv, _ = frames[-1]
        t0 = time.perf_counter()
        out = engine.odometry_step(pts[i:i + 1], valid[i:i + 1], pd[0],
                                   pdv[0], pts[i - 1], ppv[0])
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        frames.append((out[0], out[1], out[2], out[3:]))
        gt = np.linalg.inv(poses[i]) @ poses[i - 1]    # new = gt @ cand
        pose_err.append(dict(
            frame=i, rot_deg=rotation_deg(out[3][:3, :3], gt[:3, :3]),
            trans_m=float(np.linalg.norm(out[3][:3, 3] - gt[:3, 3])),
            conf=out[4], rmse=out[5]))
    f0, f2 = frames[0], frames[2]
    reg = engine.register_with_info(f0[0][0], f0[1][0], f2[0][0], f2[1][0],
                                    pts[0], f0[2][0], pts[2], f2[2][0])
    descs = np.concatenate([f[0] for f in frames])
    dvs = np.concatenate([f[1] for f in frames])
    loop = engine.loop_scores(descs[:-1], descs[1:], dvs[:-1], dvs[1:])

    infos = [f[3][3] for f in frames[1:]] + [reg[3]]
    confs = [f[3][1] for f in frames[1:]] + [reg[1]]
    finite = bool(np.isfinite(descs).all()) and all(
        np.isfinite(i).all() for i in infos)
    asym = max(relerr(i, i.T) for i in infos)
    if not finite or not all(0.0 <= c <= 1.0 for c in confs) or asym > 1e-6:
        raise AssertionError(f"main path output out of range: finite="
                             f"{finite} conf={confs} info asym={asym}")
    width = engine.args.encoder.out_channel + 3
    if descs.shape[1:] != (engine.n_tokens, width) or not (
            np.isfinite(loop).all() and ((loop >= 0) & (loop <= 1)).all()):
        raise AssertionError(f"bad shapes or loop scores: {descs.shape} "
                             f"{loop}")
    later = frame_ms[1:] or frame_ms
    return dict(frames=frames, summary=dict(
        frames=len(pts), extract_first_ms=extract_ms,
        frame_ms_median=float(np.median(later)), frame_ms=frame_ms,
        scans_per_s=1e3 / float(np.median(later)), pose_err=pose_err,
        register_conf=reg[1], loop_scores=[float(p) for p in loop],
        survivors=[int(f[2].sum()) for f in frames],
        valid_points=[int(v.sum()) for v in valid]))


def compare_cpu(cpu, pts, valid, frames) -> list:
    """Frames 0 .. CPU_FRAMES-1 through `cpu` on the inputs the GPU run
    was given; raises unless rotation <= 0.05 deg, translation <= 1 cm,
    descriptor relerr <= 1e-3 and info relerr <= 1e-2 (near-tie 1-NN
    correspondences and the summation order)."""
    out0 = cpu.extract(pts[:1], valid[:1])
    cmp = [dict(frame=0, desc_relerr=relerr(out0[0], frames[0][0]),
                survivors_diff=int(np.sum(out0[2] != frames[0][2])))]
    for i in range(1, CPU_FRAMES):
        pd, pdv, ppv, _ = frames[i - 1]
        out = cpu.odometry_step(pts[i:i + 1], valid[i:i + 1], pd[0], pdv[0],
                                pts[i - 1], ppv[0])
        g = frames[i]
        cmp.append(dict(
            frame=i, desc_relerr=relerr(out[0], g[0]),
            survivors_diff=int(np.sum(out[2] != g[2])),
            rot_deg=rotation_deg(out[3][:3, :3], g[3][0][:3, :3]),
            trans_m=float(np.linalg.norm(out[3][:3, 3] - g[3][0][:3, 3])),
            info_relerr=relerr(out[6], g[3][3])))
    for c in cmp:
        if c["desc_relerr"] > 1e-3 or c.get("rot_deg", 0) > 0.05 or \
                c.get("trans_m", 0) > 0.01 or c.get("info_relerr", 0) > 1e-2:
            raise AssertionError(f"GPU and CPU disagree: {c}")
    return cmp


def main(out_dir: str = "") -> int:
    """Run every phase; with `out_dir`, also write the kernel entries
    there as chip_smoke.json."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from deeppointmap_tpu_torch import kernels
    from deeppointmap_tpu_torch.config import config_from_dict
    from deeppointmap_tpu_torch.data import synthetic as syn
    from deeppointmap_tpu_torch.data.preprocess import PreprocessConfig
    from deeppointmap_tpu_torch.data.voxel import voxel_downsample_indices
    from deeppointmap_tpu_torch.models.weights import load_msgpack_weights
    from deeppointmap_tpu_torch.ops import neighbors, sampling
    from deeppointmap_tpu_torch.slam.engine import InferenceEngine

    # full f32 everywhere: TF32 would round distances at +-60 m
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = dict(name=torch.cuda.get_device_name(0), nvidia_smi=smi,
                count=torch.cuda.device_count())
    emit(dict(phase="device", torch=torch.__version__,
              cuda=torch.version.cuda, **card))

    t0 = time.perf_counter()
    kernels.build_all()
    ptxas = "\n".join(k.build_log for k in kernels.ALL)
    emit(dict(phase="build", seconds=time.perf_counter() - t0, card=smi,
              max_registers=max(map(int, re.findall(r"Used (\d+) registers",
                                                     ptxas)), default=None),
              max_spill_store_bytes=max(map(int, re.findall(
                  r"(\d+) bytes spill stores", ptxas)), default=None)))

    args = config_from_dict(CONFIG)
    pts, valid, poses = render_scans(syn, voxel_downsample_indices)
    pre = PreprocessConfig.from_transforms(args.transforms)

    # ---------------------------------------------------------- K1, K2
    entries = []
    npoint = args.encoder.npoint
    x = torch.from_numpy(pts[:1] / 60.0).float().to(dev)
    v = torch.from_numpy(valid[:1]).to(dev)
    n_in = [N_PAD] + list(npoint[:-1])
    for n, k in zip(n_in, npoint):
        xs = x[:, :n].contiguous() if n == N_PAD else \
            torch.randn(1, n, 3, device=dev) * 0.3
        vs = v if n == N_PAD else torch.ones(1, n, dtype=torch.bool,
                                             device=dev)
        entries.append(check_fps(torch, sampling, xs, vs, k))
    x4 = torch.from_numpy(pts[:4] / 60.0).float().to(dev)
    v4 = torch.from_numpy(valid[:4]).to(dev)
    entries.append(check_fps(torch, sampling, x4, v4, npoint[0]))
    emit(dict(phase="k1", card=smi, shapes=[
        {key: e[key] for key in ("shape", "max_abs_err", "ms", "plain_ms")}
        for e in entries]))

    # every K2 shape of the main path (models/encoder.py, data/
    # preprocess.py, ops/infomat.py at this config)
    e, n_lv = args.encoder, len(npoint)
    knn_shapes = [(N_PAD, N_PAD, pre.normals_num + 1, pre.normals_radius),
                  (N_PAD, npoint[0], e.nsample_list[0][0], 0.0)]
    for i in range(n_lv):
        own = max(e.nsample_list[i][1:], default=0)
        nxt = e.nsample_list[i + 1][0] if i + 1 < n_lv else 0
        knn_shapes.append((npoint[i], npoint[i], max(own, nxt), 0.0))
    for i in range(e.upsample_layers):
        knn_shapes.append((npoint[n_lv - 1 - i], npoint[n_lv - 2 - i], 3,
                           0.0))
    stride = int(args.tpu.infomat_stride)
    knn_shapes.append((N_PAD, -(-N_PAD // stride), 1, 0.0))
    k2 = []
    for j, (n, s, k, radius) in enumerate(knn_shapes):
        inputs = knn_inputs(torch, dev, pts[0], valid[0], n, s, radius, j)
        k2.append(check_knn(torch, neighbors, inputs[0], inputs[1],
                            inputs[2], k, radius))
    emit(dict(phase="k2", card=smi, shapes=[
        {key: e[key] for key in ("shape", "max_abs_err", "ms", "plain_ms",
                                 "library_ms")} for e in k2]))
    entries += k2

    # -------------------------------------------------------- main path
    enc_sd, dec_sd = load_msgpack_weights(WEIGHTS)
    engine = InferenceEngine(args, enc_sd, dec_sd, preprocess_cfg=pre,
                             device="cuda")
    kernels.reset_launches()
    main_out = drive_main_path(engine, pts, valid, poses)
    launches = {"fps": kernels.FPS.launches, "knn": kernels.KNN.launches}
    by_shape = {"fps": dict(kernels.FPS.shapes),
                "knn": dict(kernels.KNN.shapes)}
    checked = {(en["name"], tuple(en["shape"])) for en in entries}
    for name, shapes in by_shape.items():
        missing = [sh for sh in shapes if (name, sh) not in checked]
        if missing:
            raise AssertionError(f"{name} ran at unchecked shapes {missing}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    emit(dict(phase="main", card=smi, **main_out["summary"],
              launches=launches, launches_by_shape={
                  k: {str(list(sh)): c for sh, c in v_.items()}
                  for k, v_ in by_shape.items()}))

    # -------------------------------------------------- CPU comparison
    cpu = InferenceEngine(args, enc_sd, dec_sd, preprocess_cfg=pre,
                          device="cpu")
    emit(dict(phase="cpu", card=smi,
              frames=compare_cpu(cpu, pts, valid, main_out["frames"])))

    for en in entries:
        en["launches"] = by_shape[en["name"]].get(tuple(en["shape"]), 0)
    kernels_line = dict(kernels=[en for en in entries if en["launches"] > 0])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=card, entries=entries), f, indent=1)
    emit(kernels_line)
    print(smi, flush=True)
    emit(dict(ok=True, device=dict(platform="gpu", kind=card["name"],
                                   count=card["count"])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else ""))
