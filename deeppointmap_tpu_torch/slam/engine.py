"""Inference engine: the host <-> device boundary of the SLAM system (port of
deeppointmap_tpu/slam/engine.py).

NumPy in, NumPy out. The engine owns the encoder and decoder on one torch
device (`cuda` unless the caller passes another) and exposes the entry
points the SLAM host layer calls: descriptor extraction, the fused
odometry step (extract + register against a candidate + information
matrix), registration with the information matrix, loop scoring and the
information matrix alone. Token counts are padded up to `reg_buckets` as in
the JAX package, so registration sees the same shapes and pair counts.

An `*_async` method launches its work on the current CUDA stream and
returns a zero-argument resolver; the resolver copies the results to the
host, which waits for the stream.

Not ported yet: map tiles, multi-candidate and by-token methods, and the
token-keyed device cache.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from deeppointmap_tpu_torch.data.preprocess import preprocess
from deeppointmap_tpu_torch.models.decoder import Decoder, num_pairs_for
from deeppointmap_tpu_torch.models.encoder import Encoder
from deeppointmap_tpu_torch.ops.infomat import information_matrix
from deeppointmap_tpu_torch.ops.neighbors import f32

logger = logging.getLogger(__name__)

DEFAULT_REG_BUCKETS = (256, 512, 1024, 2048, 4096)
DEFAULT_BATCH_BUCKETS = (1, 4, 16, 64)
#: extraction batches larger than one are run in chunks of this size
DEFAULT_EXTRACT_CHUNK = 4
_QUANT_SENTINEL = -32768


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


def _host(*tensors):
    return tuple(x.cpu().numpy() for x in tensors)


class InferenceEngine:
    """Owns the models on one device. NumPy in, NumPy out.

    enc_state / dec_state: state dicts of models.encoder.Encoder and
    models.decoder.Decoder (models/weights.py turns a JAX checkpoint into
    them). preprocess_cfg: when set, extract/odometry take RAW-METER padded
    points and the filter chain runs on the device (data/preprocess.py);
    when None, inputs are already normalized."""

    def __init__(self, args, enc_state, dec_state, preprocess_cfg=None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # distances at +-60 m need full f32: TF32 would round them
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.args = args
        self.preprocess_cfg = preprocess_cfg
        self.coor_scale = float(args.slam_system.coor_scale)
        tpu = args.get("tpu") or {}
        self.reg_buckets = tuple(tpu.get("reg_buckets", DEFAULT_REG_BUCKETS))
        self.batch_buckets = tuple(
            tpu.get("loop_batch_buckets", DEFAULT_BATCH_BUCKETS))
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
        self.encoder = Encoder.from_config(args)
        self.decoder = Decoder.from_config(args)
        self.encoder.load_state_dict(enc_state)
        self.decoder.load_state_dict(dec_state)
        self.encoder.to(self.device).eval()
        self.decoder.to(self.device).eval()
        e = args.encoder
        self.n_tokens = int(e.npoint[len(e.npoint) - 1 - e.upsample_layers])

    # ------------------------------------------------------------ upload
    def _put(self, x) -> torch.Tensor:
        return torch.tensor(np.asarray(x), device=self.device)

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

    def _upload_scan(self, points, valid):
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
    def _extract_impl(self, points, valid):
        """-> (descriptors (B, K, C+3) with xyz in meters, descriptor
        validity (B, K), filtered point validity (B, P))."""
        if self.preprocess_cfg is not None:
            points, valid = preprocess(points, valid, self.preprocess_cfg)
        coor, fea, out_valid = self.encoder(points, valid)
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
            return _host(*self._extract_impl(
                *self._dequant_input(*self._upload_scan(points, valid))))
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
                *self._dequant_input(*self._upload_scan(pc, vc)))
            outs.append([x[:nb] for x in out])
        return tuple(torch.cat(parts, 0).cpu().numpy()
                     for parts in zip(*outs))

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

    def _register_info(self, src, sv, dst, dv, src_pcd, spv, dst_pcd, dpv,
                       num_pairs, num_pairs_actual):
        R, t, conf, rmse, _ = self.decoder.registration(
            src, dst, sv, dv, num_pairs, num_pairs_actual)
        info = information_matrix(src_pcd, spv, dst_pcd, dpv, R, t,
                                  stride=self.infomat_stride)
        return R, t, conf, rmse, info

    @staticmethod
    def _se3_resolver(R, t, conf, rmse, info):
        def resolve():
            R_h, t_h, c_h, r_h, i_h = _host(R, t, conf, rmse, info)
            return _se3(R_h, t_h), float(c_h), float(r_h), \
                np.asarray(i_h, np.float64)
        return resolve

    @torch.inference_mode()
    def register_with_info_async(self, src_desc, src_valid, dst_desc,
                                 dst_valid, src_pcd, src_pvalid, dst_pcd,
                                 dst_pvalid, num_sample=0.5):
        """Launch registration + information matrix; returns a resolver ->
        (SE3 (4, 4) with dst = SE3 @ src, confidence, rmse, info (6, 6))."""
        src, sv, dst, dv, k_static, k_actual = self._pairs(
            src_desc, src_valid, dst_desc, dst_valid, num_sample)
        out = self._register_info(
            src, sv, dst, dv,
            self._put(np.asarray(src_pcd, np.float32)),
            self._put(np.asarray(src_pvalid, bool)),
            self._put(np.asarray(dst_pcd, np.float32)),
            self._put(np.asarray(dst_pvalid, bool)), k_static, k_actual)
        return self._se3_resolver(*out)

    def register_with_info(self, src_desc, src_valid, dst_desc, dst_valid,
                           src_pcd, src_pvalid, dst_pcd, dst_pvalid,
                           num_sample=0.5):
        """Registration + 6x6 information matrix (the reference computes
        them back to back at odometry.py:108-115, mapping.py:152-159,
        loop_closure.py:240-247)."""
        return self.register_with_info_async(
            src_desc, src_valid, dst_desc, dst_valid, src_pcd, src_pvalid,
            dst_pcd, dst_pvalid, num_sample)()

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
        return desc, dvalid, pts_valid, R, t, conf, rmse, info

    @torch.inference_mode()
    def odometry_step_async(self, points: np.ndarray, valid: np.ndarray,
                            cand_desc, cand_kvalid, cand_pcd, cand_pvalid,
                            num_sample=0.5):
        """Launch the fused odometry step; returns a resolver -> the
        `odometry_step` tuple."""
        cand_kvalid = np.asarray(cand_kvalid, bool)
        m_real = int(cand_kvalid.sum())
        src, sv, mb = self._pad_tokens(np.asarray(cand_desc, np.float32),
                                       cand_kvalid)
        k_static = num_pairs_for(mb, self.n_tokens, num_sample)
        k_actual = num_pairs_for(min(m_real, mb), self.n_tokens, num_sample)
        out = self._odometry_impl(
            *self._upload_scan(points, valid), self._put(src), self._put(sv),
            self._put(np.asarray(cand_pcd, np.float32)),
            self._put(np.asarray(cand_pvalid, bool)), k_static, k_actual)

        def resolve():
            desc, dvalid, pvalid, R, t, conf, rmse, info = _host(*out)
            return (desc, dvalid, pvalid, _se3(R, t), float(conf),
                    float(rmse), np.asarray(info, np.float64))
        return resolve

    def odometry_step(self, points: np.ndarray, valid: np.ndarray,
                      cand_desc, cand_kvalid, cand_pcd, cand_pvalid,
                      num_sample=0.5):
        """Extraction + registration against the candidate + information
        matrix. points (1, P, 3) (raw meters with device preprocessing);
        candidate arrays unpadded. Returns (descriptors (1, K, C+3),
        descriptor validity (1, K), filtered point validity (1, P), SE3
        (4, 4) with new = SE3 @ cand, confidence, rmse, info (6, 6))."""
        return self.odometry_step_async(points, valid, cand_desc,
                                        cand_kvalid, cand_pcd, cand_pvalid,
                                        num_sample)()

    # ------------------------------------------------------ loop scoring
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
        return probs[:b].cpu().numpy()

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
        return out.cpu().numpy().astype(np.float64)
