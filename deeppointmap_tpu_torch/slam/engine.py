"""Inference engine: the host <-> device boundary of the SLAM system (port of
deeppointmap_tpu/slam/engine.py).

NumPy in, NumPy out. The engine owns the encoder and decoder on one torch
device (`cuda` unless the caller passes another) and exposes the entry
points the SLAM host layer calls: descriptor extraction, the fused
odometry step (extract + register against a candidate + information
matrix), registration with the information matrix against one candidate,
several candidates or device-assembled map tiles, loop scoring and the
information matrix alone. Token counts are padded up to `reg_buckets`, and
map tiles to `tile_member_buckets`, as in the JAX package, so registration
sees the same shapes and pair counts. Where the JAX package compiles one
program per bucket, the port calls plain functions.

Per-scan arrays (padded descriptors, their validity, the point cloud and
its validity) are kept on the device in a byte-budgeted LRU cache keyed by
(scan token, name), shared by every caller under one lock: a scan that was
extracted, or used once as a candidate, is never uploaded again.

Host -> device: every upload goes through pinned memory on the engine's
own upload stream, and the stream of the calling thread waits for it by an
event, so an upload never waits for the kernels queued before it (a
pageable copy would synchronise the whole stream).

Device -> host: an `*_async` method launches its work on the current CUDA
stream, enqueues the copies of its results into pinned host memory right
behind it and records an event; its zero-argument resolver waits for that
event only, not for what other threads have queued on the stream since.
A lazy descriptor thunk copies nothing until it is called, and then copies
on the engine's fetch stream behind the same event.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict

import numpy as np
import torch

from deeppointmap_tpu_torch import kernels
from deeppointmap_tpu_torch.data.preprocess import preprocess
from deeppointmap_tpu_torch.models.decoder import Decoder, num_pairs_for
from deeppointmap_tpu_torch.models.encoder import Encoder
from deeppointmap_tpu_torch.ops.infomat import information_matrix
from deeppointmap_tpu_torch.ops.neighbors import f32
from deeppointmap_tpu_torch.utils import precision, timer

logger = logging.getLogger(__name__)

DEFAULT_REG_BUCKETS = (256, 512, 1024, 2048, 4096)
DEFAULT_BATCH_BUCKETS = (1, 4, 16, 64)
#: candidate-count buckets of the JAX engine's multi-candidate program; the
#: port compiles nothing, and keeps them only for the cache order (see
#: register_with_info_multi_async)
DEFAULT_CAND_BUCKETS = (2, 4, 8)
#: member-count buckets for device-assembled map tiles (the reference bounds
#: tiles to <= 16 keyframes via graph level 5 + 20 m radius)
DEFAULT_TILE_MEMBER_BUCKETS = (4, 8, 16)
#: extraction batches larger than one are run in chunks of this size
DEFAULT_EXTRACT_CHUNK = 4
_QUANT_SENTINEL = -32768
#: names under which a scan's arrays sit in the device cache
_SCAN_KEYS = ("kp_pad", "kv_pad", "pcd", "pv")
#: the host blocked on a device event (utils/timer.py)
_WAIT = timer.span("engine.wait")


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _se3(R, t) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = np.asarray(R, np.float64)
    out[:3, 3] = np.asarray(t, np.float64)
    return out


def _materialize(x) -> np.ndarray:
    return np.asarray(x() if callable(x) else x)


def _key(token, name):
    return None if token is None else (token, name)


class InferenceEngine:
    """Owns the models on one device. NumPy in, NumPy out.

    enc_state / dec_state: state dicts of models.encoder.Encoder and
    models.decoder.Decoder (models/weights.py turns a JAX checkpoint into
    them). preprocess_cfg: when set, extract/odometry take RAW-METER padded
    points and the filter chain runs on the device (data/preprocess.py);
    when None, inputs are already normalized. matmul_policy: the models'
    `tpu.bf16` policy (utils/precision.py); None takes the rule's for
    args.tpu on `device` ("bfloat16" on a card under every shipped
    config, "unchanged" on the CPU), a policy forces it."""

    def __init__(self, args, enc_state, dec_state, preprocess_cfg=None,
                 device="cuda", matmul_policy=None):
        self.device = torch.device(device)
        self._upload_stream = self._fetch_stream = None
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            kernels.strict_matmuls()
            self._upload_stream = torch.cuda.Stream(self.device)
            self._fetch_stream = torch.cuda.Stream(self.device)
        self.args = args
        self.preprocess_cfg = preprocess_cfg
        self.coor_scale = float(args.slam_system.coor_scale)
        tpu = args.get("tpu") or {}
        self.reg_buckets = tuple(tpu.get("reg_buckets", DEFAULT_REG_BUCKETS))
        self.batch_buckets = tuple(
            tpu.get("loop_batch_buckets", DEFAULT_BATCH_BUCKETS))
        self.tile_member_buckets = tuple(
            tpu.get("tile_member_buckets", DEFAULT_TILE_MEMBER_BUCKETS))
        self.cand_buckets = tuple(
            tpu.get("cand_buckets", DEFAULT_CAND_BUCKETS))
        self.extract_chunk = int(tpu.get("extract_chunk",
                                         DEFAULT_EXTRACT_CHUNK))
        # int16 fixed-point scan upload with a sentinel-coded validity
        # (engine.py:221-252 of the JAX package): LSB 2 mm in meters, or
        # its /coor_scale equivalent for normalized inputs; +-65.5 m range,
        # safe only behind a distance crop that removes clipped points
        self.upload_quant = str(tpu.get("upload_quant", "int16"))
        lsb = float(tpu.get("upload_quant_lsb", 0.002))
        self.quant_scale = lsb if preprocess_cfg is not None \
            else lsb / self.coor_scale
        if self.upload_quant == "int16":
            qmax = 32767.0 * lsb
            t = dict(args.get("transforms") or {})
            max_dis = float(t.get("DistanceSample", {}).get("max_dis",
                                                            float("inf")))
            if max_dis > qmax:
                logger.warning(
                    "int16 upload disabled: DistanceSample.max_dis=%s "
                    "exceeds the +-%.1f m quantization range", max_dis, qmax)
                self.upload_quant = "none"
        self.infomat_stride = int(tpu.get("infomat_stride", 1))
        self.matmul_policy = precision.resolve(matmul_policy, tpu,
                                               self.device)
        self.encoder = Encoder.from_config(args, self.matmul_policy)
        self.decoder = Decoder.from_config(args, self.matmul_policy)
        self.encoder.load_state_dict(enc_state)
        self.decoder.load_state_dict(dec_state)
        self.encoder.to(self.device).eval()
        self.decoder.to(self.device).eval()
        e = args.encoder
        self.n_tokens = int(e.npoint[len(e.npoint) - 1 - e.upsample_layers])
        # device cache of per-scan tensors, least recently used first; the
        # budget is in bytes (`tpu.device_cache_mb`) because one cache holds
        # ~134 KB descriptor sets and ~196 KB point clouds
        self._dcache: "OrderedDict" = OrderedDict()
        self._dcache_budget = int(
            float(tpu.get("device_cache_mb", 512)) * 2 ** 20)
        self._dcache_bytes = 0
        self._dcache_lock = threading.Lock()

    # ------------------------------------------------- host <-> device
    def _put(self, x) -> torch.Tensor:
        """`x` on the device. On a GPU it is staged in pinned memory and
        copied on the upload stream; the calling thread's stream waits for
        the copy's event, and the tensor is recorded as used there, so
        that the allocator does not hand its memory out before that
        stream is done with it."""
        arr = np.asarray(x)
        if self._upload_stream is None:
            return torch.tensor(arr, device=self.device)
        host = torch.from_numpy(np.require(arr, requirements="C")).pin_memory()
        with torch.cuda.stream(self._upload_stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._upload_stream)
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(ready)
        dev.record_stream(consumer)
        return dev

    def _start_fetch(self, *tensors):
        """Enqueue copies of `tensors` into pinned host memory on the
        current stream, behind the work that makes them, and record an
        event after them. -> (a function that waits for that event and
        returns the NumPy arrays, the event; None on the CPU). The wait is
        the `engine.wait` span."""
        if self.device.type != "cuda":
            def wait_host():
                with _WAIT:
                    return tuple(t.numpy() for t in tensors)
            return wait_host, None
        hosts = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            hosts.append(h)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))

        def wait():
            with _WAIT:
                done.synchronize()
            return tuple(h.numpy() for h in hosts)
        return wait, done

    def _fetch(self, *tensors):
        """`tensors` as NumPy arrays, waiting for them and nothing else."""
        return self._start_fetch(*tensors)[0]()

    def _fetch_later(self, t: torch.Tensor, after):
        """A thunk that copies `t` to the host when called: on the fetch
        stream behind the event `after` (recorded where `t` was made), so
        it waits for that work only; the wait is the `engine.wait`
        span."""
        if after is None:
            return t.numpy
        stream = self._fetch_stream

        def thunk():
            with torch.cuda.stream(stream):
                stream.wait_event(after)
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            with _WAIT:
                done.synchronize()
            return h.numpy()
        return thunk

    # ------------------------------------------------------ device cache
    @staticmethod
    def _nbytes(t: torch.Tensor) -> int:
        return t.element_size() * t.nelement()

    def _dev(self, arr, key=None) -> torch.Tensor:
        """`arr` (an array, or a thunk that makes one) on the device; with
        a key, through the cache. A thunk is called only on a miss."""
        if key is not None:
            with self._dcache_lock:
                hit = self._dcache.get(key)
                if hit is not None and (callable(arr) or
                                        tuple(hit.shape) == np.shape(arr)):
                    self._dcache.move_to_end(key)
                    return hit
        dev = self._put(_materialize(arr))  # upload outside the lock
        if key is not None:
            self._dcache_put(key, dev)
        return dev

    def _dcache_put(self, key, dev: torch.Tensor) -> None:
        with self._dcache_lock:
            old = self._dcache.pop(key, None)
            if old is not None:
                self._dcache_bytes -= self._nbytes(old)
            self._dcache[key] = dev
            self._dcache_bytes += self._nbytes(dev)
            while self._dcache_bytes > self._dcache_budget \
                    and len(self._dcache) > 1:
                _, ev = self._dcache.popitem(last=False)
                self._dcache_bytes -= self._nbytes(ev)

    def _dcache_probe(self, token, names):
        """The cached tensors of one scan, all or nothing: None when any
        is missing."""
        if token is None:
            return None
        with self._dcache_lock:
            out = [self._dcache.get((token, name)) for name in names]
            if any(hit is None for hit in out):
                return None
            for name in names:
                self._dcache.move_to_end((token, name))
        return out

    def invalidate_device_cache(self, token=None) -> None:
        """Drop one scan's cached tensors, or all of them."""
        with self._dcache_lock:
            if token is None:
                self._dcache.clear()
                self._dcache_bytes = 0
                return
            for k in [k for k in self._dcache if k[0] == token]:
                self._dcache_bytes -= self._nbytes(self._dcache.pop(k))

    # ------------------------------------------------------------ upload
    def encode_points(self, points: np.ndarray, valid: np.ndarray
                      ) -> np.ndarray:
        """fp32 points + validity -> int16 fixed point, invalid rows coded
        as the sentinel."""
        q = np.clip(np.round(np.asarray(points, np.float32)
                             / self.quant_scale), -32767, 32767)
        q = q.astype(np.int16)
        q[~np.asarray(valid, bool)] = np.int16(_QUANT_SENTINEL)
        return q

    def _encode_host(self, points, valid):
        """-> (array to upload, validity or None when coded inside)."""
        if self.upload_quant == "int16" and points.dtype != np.int16:
            return self.encode_points(points, valid), None
        return points, valid

    def upload_scan(self, points, valid):
        """A scan's points and validity on the device -> (points, validity
        or None when the int16 code carries it). Tensors already on the
        device (the pipelined mode uploads on a thread of its own) pass
        through."""
        if isinstance(points, torch.Tensor):
            return points, valid
        pts, v = self._encode_host(np.asarray(points), valid)
        return self._put(pts), None if v is None else self._put(
            np.asarray(v, bool))

    def _dequant_input(self, points, valid):
        if points.dtype == torch.int16:
            v = points[..., 0] != _QUANT_SENTINEL
            pts = points.float() * f32(self.quant_scale)
            return pts, (v if valid is None else v & valid)
        if valid is None:
            valid = torch.ones(points.shape[:-1], dtype=torch.bool,
                               device=points.device)
        return points, valid

    # ----------------------------------------------------------- extract
    def _maybe_preprocess(self, points, valid):
        """The device filter chain (nothing for host-preprocessed inputs)
        -> (normalized points, filtered validity, sweep or None); sweep is
        the widened candidate graph when preprocess_cfg.sweep_k > 0."""
        if self.preprocess_cfg is None:
            return points, valid, None
        out = preprocess(points, valid, self.preprocess_cfg)
        return out if len(out) == 3 else (*out, None)

    def _extract_impl(self, points, valid):
        """-> (descriptors (B, K, C+3) with xyz in meters, descriptor
        validity (B, K), filtered point validity (B, P))."""
        points, valid, sweep = self._maybe_preprocess(points, valid)
        coor, fea, out_valid = self.encoder(points, valid, sweep=sweep)
        desc = torch.cat([fea, coor * self.coor_scale], dim=-1)
        return desc, out_valid, valid

    @torch.inference_mode()
    def extract(self, points: np.ndarray, valid: np.ndarray):
        """points (B, P, 3) -> (descriptors (B, K, C+3), descriptor validity
        (B, K), filtered point validity (B, P)) as NumPy. Inputs are
        normalized, or raw meters with device preprocessing. Batches above
        one run in chunks of `extract_chunk`, the last padded."""
        b = points.shape[0]
        if b == 1:
            return self._fetch(*self._extract_impl(
                *self._dequant_input(*self.upload_scan(points, valid))))
        chunk = self.extract_chunk
        outs = []
        for start in range(0, b, chunk):
            pc = points[start:start + chunk]
            vc = valid[start:start + chunk]
            nb = pc.shape[0]
            if nb < chunk:
                pc = np.concatenate(
                    [pc, np.zeros((chunk - nb, *pc.shape[1:]), pc.dtype)], 0)
                vc = np.concatenate(
                    [vc, np.zeros((chunk - nb, vc.shape[1]), bool)], 0)
            out = self._extract_impl(
                *self._dequant_input(*self.upload_scan(pc, vc)))
            outs.append([x[:nb] for x in out])
        return self._fetch(*(torch.cat(parts, 0) for parts in zip(*outs)))

    # ---------------------------------------------------------- register
    def _pad_tokens(self, desc: np.ndarray, valid: np.ndarray):
        """Pad a descriptor set to its bucket; an oversized set keeps the
        tokens nearest its center. -> (desc, valid, bucket)."""
        n = desc.shape[0]
        b = _bucket(n, self.reg_buckets)
        if n > b:
            d = np.linalg.norm(desc[:, -3:], axis=1)
            d[~valid] = np.inf
            keep = np.argsort(d)[:b]
            return desc[keep], valid[keep], b
        if n < b:
            desc = np.concatenate(
                [desc, np.zeros((b - n, desc.shape[1]), desc.dtype)], 0)
            valid = np.concatenate([valid, np.zeros(b - n, bool)], 0)
        return desc, valid, b

    def _pairs(self, src_desc, src_valid, dst_desc, dst_valid, num_sample):
        """Bucketed device copies and the (static, actual) pair counts."""
        src_valid = np.asarray(src_valid, bool)
        dst_valid = np.asarray(dst_valid, bool)
        m_real, n_real = int(src_valid.sum()), int(dst_valid.sum())
        src, sv, mb = self._pad_tokens(np.asarray(src_desc, np.float32),
                                       src_valid)
        dst, dv, nb = self._pad_tokens(np.asarray(dst_desc, np.float32),
                                       dst_valid)
        k_static = num_pairs_for(mb, nb, num_sample)
        k_actual = num_pairs_for(min(m_real, mb), min(n_real, nb),
                                 num_sample)
        return (self._put(src), self._put(sv), self._put(dst), self._put(dv),
                k_static, k_actual)

    @torch.inference_mode()
    def register(self, src_desc, src_valid, dst_desc, dst_valid,
                 num_sample=0.5):
        """-> (SE3 (4, 4) float64 with dst = SE3 @ src, confidence, rmse):
        solves dst ~= R @ src + t over offset-corrected top-k pairs
        (reference: decoder.py:91-127)."""
        src, sv, dst, dv, k_static, k_actual = self._pairs(
            src_desc, src_valid, dst_desc, dst_valid, num_sample)
        R, t, conf, rmse, _ = self.decoder.registration(
            src, dst, sv, dv, k_static, k_actual)
        R, t, conf, rmse = self._fetch(R, t, conf, rmse)
        return _se3(R, t), float(conf), float(rmse)

    def _register_info(self, src, sv, dst, dv, src_pcd, spv, dst_pcd, dpv,
                       num_pairs, num_pairs_actual):
        R, t, conf, rmse, _ = self.decoder.registration(
            src, dst, sv, dv, num_pairs, num_pairs_actual)
        info = information_matrix(src_pcd, spv, dst_pcd, dpv, R, t,
                                  stride=self.infomat_stride)
        return R, t, conf, rmse, info

    def _se3_resolver(self, R, t, conf, rmse, info):
        fetch = self._start_fetch(R, t, conf, rmse, info)[0]

        def resolve():
            R_h, t_h, c_h, r_h, i_h = fetch()
            return _se3(R_h, t_h), float(c_h), float(r_h), \
                np.asarray(i_h, np.float64)
        return resolve

    def _pcd_dev(self, pcd, pvalid, token):
        """A scan's point cloud and validity on the device (cached under
        its token)."""
        return (self._dev(pcd, _key(token, "pcd")).float(),
                self._dev(pvalid, _key(token, "pv")).bool())

    @torch.inference_mode()
    def register_with_info_async(self, src_desc, src_valid, dst_desc,
                                 dst_valid, src_pcd, src_pvalid, dst_pcd,
                                 dst_pvalid, num_sample=0.5, src_token=None,
                                 dst_token=None):
        """Launch registration + information matrix; returns a resolver ->
        (SE3 (4, 4) with dst = SE3 @ src, confidence, rmse, info (6, 6)).
        With src_token / dst_token the scans' point clouds come from, and
        go into, the device cache."""
        src, sv, dst, dv, k_static, k_actual = self._pairs(
            src_desc, src_valid, dst_desc, dst_valid, num_sample)
        out = self._register_info(
            src, sv, dst, dv, *self._pcd_dev(src_pcd, src_pvalid, src_token),
            *self._pcd_dev(dst_pcd, dst_pvalid, dst_token), k_static,
            k_actual)
        return self._se3_resolver(*out)

    def register_with_info(self, src_desc, src_valid, dst_desc, dst_valid,
                           src_pcd, src_pvalid, dst_pcd, dst_pvalid,
                           num_sample=0.5, src_token=None, dst_token=None):
        """Registration + 6x6 information matrix (the reference computes
        them back to back at odometry.py:108-115, mapping.py:152-159,
        loop_closure.py:240-247)."""
        return self.register_with_info_async(
            src_desc, src_valid, dst_desc, dst_valid, src_pcd, src_pvalid,
            dst_pcd, dst_pvalid, num_sample, src_token, dst_token)()

    def _scan_dev(self, desc, kvalid, pcd, pvalid, token):
        """A scan's four cached tensors (padded descriptors, their
        validity, point cloud, point validity) and its token bucket; a
        cached scan costs no upload and calls no thunk."""
        hit = self._dcache_probe(token, _SCAN_KEYS)
        if hit is not None:
            return (*hit, hit[0].shape[0])
        src, sv, mb = self._pad_tokens(
            np.asarray(_materialize(desc), np.float32),
            np.asarray(kvalid, bool))
        return (self._dev(src, _key(token, "kp_pad")),
                self._dev(sv, _key(token, "kv_pad")),
                *self._pcd_dev(pcd, pvalid, token), mb)

    def _retouch_scan(self, token, tensors) -> None:
        """What a second `_scan_dev` of a scan just used does to the cache,
        without an upload: its four entries become the most recently used,
        and one that the budget has evicted meanwhile goes back in."""
        if token is None or self._dcache_probe(token, _SCAN_KEYS) is not None:
            return
        for name, dev in zip(_SCAN_KEYS, tensors):
            with self._dcache_lock:
                hit = (token, name) in self._dcache
                if hit:
                    self._dcache.move_to_end((token, name))
            if not hit:
                self._dcache_put((token, name), dev)

    @torch.inference_mode()
    def register_with_info_multi_async(self, cands, dst_desc, dst_valid,
                                       dst_pcd, dst_pvalid, num_sample=0.5,
                                       dst_token=None):
        """Registration of several candidates against ONE new scan,
        launched back to back before any result is read.

        cands: list of (desc, kvalid, pcd, pvalid, token), where desc, pcd
        and pvalid may be zero-argument callables, called only when the
        scan is not in the device cache. Returns one resolver per
        candidate. The JAX package pads the candidate count to a compile
        bucket (`tpu.cand_buckets`) by repeating the first candidate, which
        touches that scan's cache entries once more per padded slot, after
        the real ones; the port launches nothing for the padding and
        touches the entries the same way, so that both evict in one
        order."""
        if not cands:
            raise ValueError("register_with_info_multi_async with no "
                             "candidates")
        scans = [self._scan_dev(*cand) for cand in cands]
        for _ in range(_bucket(len(cands), self.cand_buckets) - len(cands)):
            self._retouch_scan(cands[0][4], scans[0][:4])
        buckets = {scan[4] for scan in scans}
        if len(buckets) != 1:
            raise ValueError("candidate token buckets diverge within one "
                             f"batch: {sorted(buckets)}")
        mb = buckets.pop()
        n_real = int(np.asarray(dst_valid).sum())
        dstp, dvp, nb = self._pad_tokens(
            np.asarray(_materialize(dst_desc), np.float32),
            np.asarray(dst_valid, bool))
        dst, dv = self._put(dstp), self._put(dvp)
        dpc, dpv = self._pcd_dev(dst_pcd, dst_pvalid, dst_token)
        k_static = num_pairs_for(mb, nb, num_sample)
        resolvers = []
        for (kp, kv, pc, pv, _), cand in zip(scans, cands):
            m_real = int(np.asarray(cand[1]).sum())
            resolvers.append(self._se3_resolver(*self._register_info(
                kp, kv, dst, dv, pc, pv, dpc, dpv, k_static,
                num_pairs_for(min(m_real, mb), min(n_real, nb),
                              num_sample))))
        return resolvers

    # ---------------------------------------- device-assembled map tiles
    @staticmethod
    def _tile(descs, kvs, poses, mvalid):
        """S member descriptor sets (K, C+3) on the device + relative poses
        (S, 4, 4) -> tile (S*K, C+3), tile validity (S*K,). The host
        uploads only the poses; member descriptors come from the cache."""
        d = torch.stack(descs)                          # (S, K, C+3)
        kv = torch.stack(kvs)                           # (S, K)
        R, t = poses[:, :3, :3], poses[:, :3, 3]
        moved = torch.einsum("sij,skj->ski", R, d[..., -3:]) + t[:, None, :]
        tile = torch.cat([d[..., :-3], moved], dim=-1)
        return tile.flatten(0, 1), (kv & mvalid[:, None]).flatten()

    def _members_dev(self, members):
        """members: [(token, key_points_ref, key_valid, ...)] -> (desc
        device tensors, validity device tensors, total valid tokens)."""
        descs, kvs, m_real = [], [], 0
        for token, kp_ref, kv, *_ in members:
            hit = self._dcache_probe(token, _SCAN_KEYS[:2])
            if hit is None:
                hit = (self._dev(np.asarray(_materialize(kp_ref),
                                            np.float32), (token, "kp_pad")),
                       self._dev(np.asarray(kv, bool), (token, "kv_pad")))
            if hit[0].shape[0] != self.n_tokens:
                raise ValueError(f"tile member {token} has "
                                 f"{hit[0].shape[0]} tokens, not "
                                 f"{self.n_tokens}")
            descs.append(hit[0])
            kvs.append(hit[1])
            m_real += int(np.asarray(kv).sum())
        return descs, kvs, m_real

    def _pad_members(self, members, centering_SE3):
        """Bucket the member list; an oversized list keeps the members
        nearest the tile center. -> (members, relative poses (S, 4, 4)
        f32, member validity (S,))."""
        center = np.asarray(centering_SE3, np.float64)
        inv_c = np.linalg.inv(center)
        if len(members) > self.tile_member_buckets[-1]:
            members = sorted(
                members,
                key=lambda m: np.linalg.norm(m[3][:3, 3] - center[:3, 3])
            )[:self.tile_member_buckets[-1]]
        s = _bucket(len(members), self.tile_member_buckets)
        poses = np.tile(np.eye(4, dtype=np.float32), (s, 1, 1))
        mvalid = np.zeros((s,), bool)
        for i, m in enumerate(members):
            poses[i] = (inv_c @ np.asarray(m[3], np.float64)
                        ).astype(np.float32)
            mvalid[i] = True
        return list(members), poses, mvalid

    def _tile_dev(self, members, centering_SE3):
        """-> (tile (S*K, C+3), validity (S*K,), total valid tokens) on
        the device, S padded to its bucket by repeating the first member
        under an invalid mask."""
        members, poses, mvalid = self._pad_members(members, centering_SE3)
        descs, kvs, m_real = self._members_dev(members)
        pad = len(mvalid) - len(members)
        tile, tvalid = self._tile(descs + descs[:1] * pad,
                                  kvs + kvs[:1] * pad, self._put(poses),
                                  self._put(mvalid))
        return tile, tvalid, m_real

    @torch.inference_mode()
    def register_scan_to_map_with_info_async(
            self, members, centering_SE3, dst_desc_ref, dst_kvalid,
            src_pcd_ref, src_pvalid_ref, dst_pcd_ref, dst_pvalid_ref,
            num_sample=0.5, src_token=None, dst_token=None):
        """Scan-to-map registration with the map tile assembled on the
        device (reference: mapping.py:136-170).

        members: [(token, key_points_ref, key_valid, SE3_pred)] keyframes
        of the local map (key_points_ref may be a thunk). Returns a
        resolver -> (SE3, conf, rmse, info)."""
        tile, tvalid, m_real = self._tile_dev(members, centering_SE3)
        dhit = self._dcache_probe(dst_token, _SCAN_KEYS[:2])
        if dhit is None:
            dhit = (self._dev(np.asarray(_materialize(dst_desc_ref),
                                         np.float32),
                              _key(dst_token, "kp_pad")),
                    self._dev(np.asarray(dst_kvalid, bool),
                              _key(dst_token, "kv_pad")))
        dd, dv = dhit
        n_real = int(np.asarray(dst_kvalid).sum())
        mb = tile.shape[0]
        out = self._register_info(
            tile, tvalid, dd, dv,
            *self._pcd_dev(src_pcd_ref, src_pvalid_ref, src_token),
            *self._pcd_dev(dst_pcd_ref, dst_pvalid_ref, dst_token),
            num_pairs_for(mb, self.n_tokens, num_sample),
            num_pairs_for(min(m_real, mb), min(n_real, self.n_tokens),
                          num_sample))
        return self._se3_resolver(*out)

    @torch.inference_mode()
    def register_map_to_map_with_info_async(
            self, src_members, src_centering, dst_members, dst_centering,
            src_pcd_ref, src_pvalid_ref, dst_pcd_ref, dst_pvalid_ref,
            num_sample=0.5, src_token=None, dst_token=None):
        """Loop registration with BOTH map tiles assembled on the device
        (reference: loop_closure.py:185-258); members as in
        register_scan_to_map_with_info_async."""
        s_tile, s_valid, s_real = self._tile_dev(src_members, src_centering)
        d_tile, d_valid, d_real = self._tile_dev(dst_members, dst_centering)
        mb, nb = s_tile.shape[0], d_tile.shape[0]
        out = self._register_info(
            s_tile, s_valid, d_tile, d_valid,
            *self._pcd_dev(src_pcd_ref, src_pvalid_ref, src_token),
            *self._pcd_dev(dst_pcd_ref, dst_pvalid_ref, dst_token),
            num_pairs_for(mb, nb, num_sample),
            num_pairs_for(min(s_real, mb), min(d_real, nb), num_sample))
        return self._se3_resolver(*out)

    # -------------------------------------------------- fused odometry
    def _odometry_impl(self, points, valid, cand_desc, cand_kvalid,
                       cand_pcd, cand_pvalid, num_pairs, num_pairs_actual):
        points, valid = self._dequant_input(points, valid)
        desc, dvalid, pts_valid = self._extract_impl(points, valid)
        new_pcd = points[0] if self.preprocess_cfg is not None \
            else points[0] * self.coor_scale
        R, t, conf, rmse, info = self._register_info(
            cand_desc, cand_kvalid, desc[0], dvalid[0], cand_pcd,
            cand_pvalid, new_pcd, pts_valid[0], num_pairs, num_pairs_actual)
        return desc, dvalid, pts_valid, R, t, conf, rmse, info, new_pcd

    @torch.inference_mode()
    def odometry_step_async(self, points: np.ndarray, valid: np.ndarray,
                            cand_desc, cand_kvalid, cand_pcd, cand_pvalid,
                            num_sample=0.5, cand_token=None, new_token=None):
        """Launch the fused odometry step; returns a resolver.

        The candidate arrays may be zero-argument callables: when the
        device cache holds the candidate under `cand_token` (it does for
        any scan dispatched with `new_token`), they are never called and
        nothing is uploaded for it.

        With `new_token` the new scan's tensors go into the cache and the
        resolver returns LAZY descriptors: (desc_thunk () -> (K, C+3),
        desc_valid (K,), pts_valid_thunk () -> (P,), SE3, conf, rmse,
        info); the descriptors are copied to the host only if the thunk is
        called. Without it the resolver returns the `odometry_step`
        tuple."""
        kp, kv, pc, pv, mb = self._scan_dev(cand_desc, cand_kvalid, cand_pcd,
                                            cand_pvalid, cand_token)
        m_real = int(np.asarray(cand_kvalid).sum())
        out = self._odometry_impl(
            *self.upload_scan(points, valid), kp, kv, pc, pv,
            num_pairs_for(mb, self.n_tokens, num_sample),
            num_pairs_for(min(m_real, mb), self.n_tokens, num_sample))
        desc, dvalid, pts_valid, R, t, conf, rmse, info, new_pcd = out

        if new_token is not None:
            desc0, dvalid0, pv0 = desc[0], dvalid[0], pts_valid[0]
            for name, x in zip(_SCAN_KEYS, (desc0, dvalid0, new_pcd, pv0)):
                self._dcache_put((new_token, name), x)

            fetch, done = self._start_fetch(dvalid0, R, t, conf, rmse, info)
            desc_thunk = self._fetch_later(desc0, done)
            pv_thunk = self._fetch_later(pv0, done)

            def resolve_lazy():
                dv_h, R_h, t_h, c_h, r_h, i_h = fetch()
                return (desc_thunk, dv_h, pv_thunk, _se3(R_h, t_h),
                        float(c_h), float(r_h), np.asarray(i_h, np.float64))
            return resolve_lazy

        fetch = self._start_fetch(desc, dvalid, pts_valid, R, t, conf, rmse,
                                  info)[0]

        def resolve():
            d_h, dv_h, pv_h, R_h, t_h, c_h, r_h, i_h = fetch()
            return (d_h, dv_h, pv_h, _se3(R_h, t_h), float(c_h),
                    float(r_h), np.asarray(i_h, np.float64))
        return resolve

    def odometry_step(self, points: np.ndarray, valid: np.ndarray,
                      cand_desc, cand_kvalid, cand_pcd, cand_pvalid,
                      num_sample=0.5, cand_token=None):
        """Extraction + registration against the candidate + information
        matrix. points (1, P, 3) (raw meters with device preprocessing);
        candidate arrays unpadded. Returns (descriptors (1, K, C+3),
        descriptor validity (1, K), filtered point validity (1, P), SE3
        (4, 4) with new = SE3 @ cand, confidence, rmse, info (6, 6))."""
        return self.odometry_step_async(points, valid, cand_desc,
                                        cand_kvalid, cand_pcd, cand_pvalid,
                                        num_sample, cand_token)()

    # ------------------------------------------------------ loop scoring
    @torch.inference_mode()
    def loop_scores_by_token(self, members, new_desc_ref, new_kvalid,
                             new_token=None) -> np.ndarray:
        """Loop probabilities for candidate scans referenced by TOKEN:
        cached candidates are not uploaded again. members = [(token,
        key_points_ref, key_valid)]. The candidates are scored in chunks
        of the largest batch bucket, all launched before the first result
        is read."""
        descs, kvs, _ = self._members_dev(members)
        dhit = self._dcache_probe(new_token, _SCAN_KEYS[:2])
        if dhit is None:
            dhit = (self._dev(np.asarray(_materialize(new_desc_ref),
                                         np.float32),
                              _key(new_token, "kp_pad")),
                    self._dev(np.asarray(new_kvalid, bool),
                              _key(new_token, "kv_pad")))
        dd, dv = dhit
        step = self.batch_buckets[-1]
        probs = []
        for off in range(0, len(descs), step):
            src = torch.stack(descs[off:off + step])
            sv = torch.stack(kvs[off:off + step])
            probs.append(self.decoder.loop_detection(
                src, dd[None].expand_as(src), sv, dv[None].expand_as(sv)))
        if not probs:
            return np.zeros((0,))
        return self._fetch(torch.cat(probs))[0]

    @torch.inference_mode()
    def loop_scores(self, src_batch, dst_batch, src_valid, dst_valid
                    ) -> np.ndarray:
        """(B, K, C+3) x2 -> loop probabilities (B,); the batch is padded
        to a bucket (reference: loop_closure.py:166-174)."""
        b = src_batch.shape[0]
        step = self.batch_buckets[-1]
        if b > step:
            return np.concatenate([
                self.loop_scores(src_batch[o:o + step], dst_batch[o:o + step],
                                 src_valid[o:o + step], dst_valid[o:o + step])
                for o in range(0, b, step)])
        bb = _bucket(b, self.batch_buckets)
        src_valid = np.asarray(src_valid, bool)
        dst_valid = np.asarray(dst_valid, bool)
        if bb != b:
            pad = lambda x: np.concatenate(
                [x, np.zeros((bb - b, *x.shape[1:]), x.dtype)], 0)
            src_batch, dst_batch = pad(src_batch), pad(dst_batch)
            src_valid, dst_valid = pad(src_valid), pad(dst_valid)
            # a fully invalid row would NaN the attention softmax
            src_valid[b:, 0] = True
            dst_valid[b:, 0] = True
        probs = self.decoder.loop_detection(
            self._put(np.asarray(src_batch, np.float32)),
            self._put(np.asarray(dst_batch, np.float32)),
            self._put(src_valid), self._put(dst_valid))
        return self._fetch(probs[:b])[0]

    # ------------------------------------------------ information matrix
    @torch.inference_mode()
    def compute_information_matrix(self, src_pcd, src_valid, dst_pcd,
                                   dst_valid, SE3) -> np.ndarray:
        """6x6 Gauss-Newton information matrix (reference: system/modules/
        utils.py:60-113) of padded full point clouds under SE3."""
        SE3 = np.asarray(SE3, np.float32)
        out = information_matrix(
            self._put(np.asarray(src_pcd, np.float32)),
            self._put(np.asarray(src_valid, bool)),
            self._put(np.asarray(dst_pcd, np.float32)),
            self._put(np.asarray(dst_valid, bool)),
            self._put(SE3[:3, :3]), self._put(SE3[:3, 3]),
            stride=self.infomat_stride)
        return self._fetch(out)[0].astype(np.float64)
