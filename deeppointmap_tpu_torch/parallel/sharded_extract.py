"""Batch descriptor extraction over several devices (port of
deeppointmap_tpu/parallel/sharded_extract.py).

Data-parallel twin of `slam/engine.InferenceEngine.extract` for offline
work: building loop-closure descriptor databases, or re-extracting a whole
sequence after a model update. A list of devices takes the place of the
JAX package's 1-D mesh: one encoder replica per entry, the weights copied
to it once when the extractor is built. A batch splits into equal
contiguous shares in device order, and each share runs the per-scan
pipeline (optional device preprocessing, the encoder, the descriptor
concat; reference: system/modules/odometry.py:36-54) on its replica. No
collectives: the results come back to host NumPy in input order.

The calling thread launches every share before it fetches any, so each
device runs its share while the host launches the next one's; the
results are copied back behind each share's last kernel into pinned
memory. The pipeline waits for the device only where the normals build
their +z constant (two syncs a share, ops/normals.py), and by then the
host, which takes longer to launch a share's ~1000 kernels than the
device takes to run them, has left the device little to finish. A worker
thread per device was measured first and lost: four threads launching at
once on four H100s gave 0.35x one card's scans/s (they contend for the
interpreter lock; PERF.md).

Online SLAM stays on one device (one scan at a time); this path is for the
embarrassingly parallel batch case. Inputs are float32, as in the JAX
package: no int16 upload quantization.

Each replica takes the `tpu.bf16` rule for its own device
(utils/precision.py): `tpu_cfg` is the config's `tpu:` tree (None = the
defaults, bf16 on), so a card's replica runs "bfloat16" and a CPU replica
"unchanged".
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from deeppointmap_tpu_torch import kernels
from deeppointmap_tpu_torch.data.preprocess import preprocess
from deeppointmap_tpu_torch.utils import precision


def _devices(devices: Optional[Sequence]) -> list:
    """The extractor's devices; None = every visible CUDA device."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device visible: pass the devices, "
                               "e.g. [torch.device('cpu')]")
        return [torch.device("cuda", i) for i in range(n)]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("no devices given")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in out]


class ShardedExtract:
    """`extract(points (B, P, 3), valid (B, P)) -> (desc (B, K, C + 3),
    desc_valid (B, K), pts_valid (B, P))` as host NumPy, B split over the
    devices. Points are normalized, or raw meters with `preprocess_cfg`."""

    def __init__(self, encoder, enc_state, devices, coor_scale: float,
                 preprocess_cfg=None, tpu_cfg=None):
        self.devices = _devices(devices)
        if any(d.type == "cuda" for d in self.devices):
            kernels.strict_matmuls()
        self.coor_scale = float(coor_scale)
        self.preprocess_cfg = preprocess_cfg
        self.replicas = []
        for dev in self.devices:
            rep = copy.deepcopy(encoder).to(dev)
            rep.load_state_dict(enc_state)
            precision.set_policy(
                rep, precision.apply_matmul_precision(tpu_cfg, dev))
            self.replicas.append(rep.eval())

    def _launch(self, i: int, points: np.ndarray, valid: np.ndarray):
        """Enqueue one share on device i -> a function that waits for its
        results and returns them as NumPy."""
        dev = self.devices[i]
        cuda = dev.type == "cuda"
        with kernels.device_guard(dev if cuda else None), \
                torch.inference_mode():
            pts, val = (torch.from_numpy(x) for x in (points, valid))
            if cuda:
                pts, val = (x.pin_memory().to(dev, non_blocking=True)
                            for x in (pts, val))
            sweep = None
            if self.preprocess_cfg is not None:
                out = preprocess(pts, val, self.preprocess_cfg)
                pts, val = out[:2]
                sweep = out[2] if len(out) == 3 else None
            coor, fea, out_valid = self.replicas[i](pts, val, sweep=sweep)
            outs = (torch.cat([fea, coor * self.coor_scale], dim=-1),
                    out_valid, val)
            if not cuda:
                return lambda: tuple(x.numpy() for x in outs)
            hosts = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                     for x in outs]
            for h, x in zip(hosts, outs):
                h.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))

        def fetch():
            done.synchronize()
            return tuple(h.numpy() for h in hosts)
        return fetch

    def __call__(self, points: np.ndarray, valid: np.ndarray):
        n = len(self.devices)
        if points.shape[0] % n != 0:
            raise ValueError(f"batch {points.shape[0]} not divisible by "
                             f"mesh size {n}; pad with invalid scans")
        points = np.ascontiguousarray(points, dtype=np.float32)
        valid = np.ascontiguousarray(valid, dtype=bool)
        per = points.shape[0] // n
        pending = [self._launch(i, points[i * per:(i + 1) * per],
                                valid[i * per:(i + 1) * per])
                   for i in range(n)]
        parts = [fetch() for fetch in pending]
        return tuple(np.concatenate(p, 0) for p in zip(*parts))

    def sequence(self, scans: np.ndarray, valids: np.ndarray,
                 batch_per_device: int = 1):
        """A whole sequence of padded scans, scans (N, P, 3) / valids
        (N, P), in batches of `batch_per_device` scans a device, the tail
        padded with invalid scans. -> (desc (N, K, C+3), desc_valid (N, K),
        pts_valid (N, P))."""
        step = len(self.devices) * batch_per_device
        n = scans.shape[0]
        descs, dvs, pvs = [], [], []
        for start in range(0, n, step):
            pc = scans[start:start + step]
            va = valids[start:start + step]
            nb = pc.shape[0]
            if nb < step:
                pc = np.concatenate(
                    [pc, np.zeros((step - nb, *pc.shape[1:]), pc.dtype)], 0)
                va = np.concatenate(
                    [va, np.zeros((step - nb, va.shape[1]), bool)], 0)
            d, dv, pv = self(pc, va)
            descs.append(d[:nb])
            dvs.append(dv[:nb])
            pvs.append(pv[:nb])
        return (np.concatenate(descs, 0), np.concatenate(dvs, 0),
                np.concatenate(pvs, 0))


def make_sharded_extract(encoder, enc_state, devices, coor_scale: float,
                         preprocess_cfg=None,
                         tpu_cfg=None) -> ShardedExtract:
    """Build `extract(points (B, P, 3), valid (B, P)) -> (desc, desc_valid,
    pts_valid)` with B split over `devices` (a list of torch devices; None
    = every visible CUDA device). `encoder`: a models.encoder.Encoder of
    the architecture, `enc_state`: its state dict. B must be a multiple of
    the device count (pad with invalid scans otherwise). `tpu_cfg`: the
    `tpu:` tree whose `bf16` sets each replica's matrix-product policy
    (module docstring)."""
    return ShardedExtract(encoder, enc_state, devices, coor_scale,
                          preprocess_cfg, tpu_cfg)


def extract_sequence(encoder, enc_state, devices, coor_scale: float,
                     scans, valids, preprocess_cfg=None,
                     batch_per_device: int = 1, tpu_cfg=None):
    """Descriptors for a whole sequence of padded scans: an extractor
    built as make_sharded_extract builds it, then `ShardedExtract.sequence`.

    scans (N, P, 3) / valids (N, P) NumPy; runs batches of
    `batch_per_device` scans a device, padding the tail with invalid
    scans. -> (desc (N, K, C+3), desc_valid (N, K), pts_valid (N, P))."""
    return make_sharded_extract(encoder, enc_state, devices, coor_scale,
                                preprocess_cfg, tpu_cfg).sequence(
                                    scans, valids, batch_per_device)
