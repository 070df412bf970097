"""The plain reference of DeepPointMap's serving path, in plain PyTorch over
the Flax parameter tree: the host voxel filter and the int16 upload, the
device filter chain (distance crop, statistical outlier removal, normal
coherence low-pass, normalization), the PointNeXt encoder, the matcher
decoder (correlation, dual-softmax pairing, offsets, the RANSAC or trimmed
Kabsch solve) and the loop head.

It follows the published model (DeepPointMap, configs/infer/
DeepPointMap_B_Main_SemanticKITTI.yaml) and the serving semantics the
port states (invalid points at distance 1e9, neighbours by distance then
index, FPS from the first valid point, the RANSAC solve's fixed noise),
written anew and simpler: every neighbour query is a fresh exact kNN over
|c|^2 - 2 c.p + |p|^2, the normals come from `torch.linalg.eigh` in
float64, the noise from its own threefry. It imports nothing of the
program.

Every matrix product of the network goes through `Ref.mm`, in the
precision `prec`: "f32" (float32, TF32 off: the reference), "bf16"
(operands rounded to bfloat16, float32 sums: the configuration's rule)
or "fp8" (operands rounded to float8 e4m3: the control, the precision
below the rule). Coordinates, distances and the solve stay float32 or
float64 in every precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

BIG = 1e9
LN_EPS = 1e-6
FP8_MAX = 448.0


def f32(x: float) -> float:
    return float(np.float32(x))


def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return x
    if prec == "bf16":
        return x.to(torch.bfloat16).float()
    if prec == "fp8":
        return torch.clamp(x, -FP8_MAX, FP8_MAX).to(
            torch.float8_e4m3fn).float()
    raise ValueError(f"precision {prec!r}: use f32, bf16 or fp8")


# ------------------------------------------------------------ host side
def voxel_first(xyz: np.ndarray, voxel: float) -> np.ndarray:
    """Indices of the first point of every occupied voxel, by ascending
    voxel id (ids from the cloud's minimum corner)."""
    if xyz.shape[0] == 0:
        return np.zeros((0,), np.int64)
    mn = xyz.min(axis=0)
    v = ((xyz - mn) / voxel).astype(np.int64)
    dims = v.max(axis=0) + 1
    vid = v[:, 0] + v[:, 1] * dims[0] + v[:, 2] * dims[0] * dims[1]
    _, first = np.unique(vid, return_index=True)
    return first


def upload_points(xyz: np.ndarray, pad: int, voxel: float,
                  lsb: float = 0.002):
    """A raw scan as the device receives it: voxel-filtered, padded to
    `pad`, quantized to int16 steps of `lsb` m and back -> (points (pad,
    3) float32 m, validity (pad,))."""
    keep = voxel_first(xyz, voxel)
    pts = xyz[keep][:pad]
    q = np.clip(np.round(pts.astype(np.float32) / np.float32(lsb)),
                -32767, 32767).astype(np.int16)
    out = np.zeros((pad, 3), np.float32)
    valid = np.zeros((pad,), bool)
    out[:len(pts)] = q.astype(np.float32) * np.float32(lsb)
    valid[:len(pts)] = True
    return out, valid


# ------------------------------------------------------------ geometry
def dist2(c: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(B, S, 3) x (B, N, 3) -> (B, S, N) = |c|^2 - 2 c.p + |p|^2."""
    def sq(x):
        return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) \
            + x[..., 2] * x[..., 2]
    cc, pp = c[:, :, None, :], p[:, None, :, :]
    cross = (cc[..., 0] * pp[..., 0] + cc[..., 1] * pp[..., 1]) \
        + cc[..., 2] * pp[..., 2]
    return sq(c)[:, :, None] - 2.0 * cross + sq(p)[:, None, :]


def knn(points, centers, k: int, valid, radius: float = 0.0,
        chunk: int = 512):
    """Exact k nearest valid points a center (invalid at 1e9; ties to the
    lower index) -> idx (B, S, k), d2 (B, S, k); with radius > 0 also the
    float64 moments [cnt, s (3), S6 (6)] over valid points within it."""
    outs, moms = [], []
    if radius > 0:
        x, y, z = (points[..., i].double() for i in range(3))
        feats = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y,
                             x * z, y * y, y * z, z * z], -1)
    for c0 in range(0, centers.shape[1], chunk):
        d = dist2(centers[:, c0:c0 + chunk].float(), points.float())
        if radius > 0:
            w = (d <= f32(radius * radius)) & valid[:, None, :]
            moms.append(w.double() @ feats)
        d = torch.where(valid[:, None, :], d, torch.full_like(d, BIG))
        dk, ik = torch.sort(d, dim=-1, stable=True)
        outs.append((ik[..., :k], dk[..., :k]))
    idx = torch.cat([o[0] for o in outs], 1)
    d2 = torch.cat([o[1] for o in outs], 1)
    if radius <= 0:
        return idx, d2
    return idx, d2, torch.cat(moms, 1)


def gather(values, idx):
    """values (B, N, ...) at idx (B, ...) -> (B, ..., ...)."""
    b = values.shape[0]
    bi = torch.arange(b, device=values.device).view(
        b, *([1] * (idx.dim() - 1)))
    return values[bi, idx]


def fps(xyz, valid, k: int):
    """Farthest point sampling from the first valid point; invalid points
    are never picked while a valid one remains; ties to the lowest index.
    -> idx (B, k), sel_valid (B, k)."""
    b = xyz.shape[0]
    rows = torch.arange(b, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    last = valid.to(torch.uint8).argmax(dim=1)
    mind = torch.where(valid, torch.full_like(x, 3.4e38),
                       torch.full_like(x, -1.0))
    idx = torch.empty((b, k), dtype=torch.int64, device=xyz.device)
    idx[:, 0] = last
    mind[rows, last] = -1.0
    for i in range(1, k):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        mind = torch.minimum(mind, (dx * dx + dy * dy) + dz * dz)
        mind[rows, last] = -1.0
        last = mind.argmax(dim=1)
        idx[:, i] = last
    n_valid = valid.sum(1)
    return idx, torch.arange(k, device=xyz.device)[None] < n_valid[:, None]


def _masked_stats(x, mask):
    x, m = x.double(), mask.double()
    n = torch.clamp(m.sum(-1, keepdim=True), min=1.0)
    mean = (x * m).sum(-1, keepdim=True) / n
    return mean, torch.sqrt((((x - mean) ** 2) * m).sum(-1, keepdim=True)
                            / n)


def normals(pts, mom):
    """Unit normals from the radius moments: the covariance about each
    point's own neighbourhood mean, its smallest eigenvector by eigh in
    float64 (LAPACK on the host); +z for one or two neighbours or an
    isotropic covariance."""
    c = pts.double()
    cnt = torch.clamp(mom[..., 0], min=1.0)
    s, S6 = mom[..., 1:4], mom[..., 4:10]
    xx, xy, xz, yy, yz, zz = S6.unbind(-1)
    second = torch.stack([torch.stack([xx, xy, xz], -1),
                          torch.stack([xy, yy, yz], -1),
                          torch.stack([xz, yz, zz], -1)], -2)
    mean = s / cnt[..., None]
    # about the center first, so that the terms at +-60 m cancel exactly
    cen = second - s[..., :, None] * c[..., None, :] \
        - c[..., :, None] * s[..., None, :] \
        + cnt[..., None, None] * (c[..., :, None] * c[..., None, :])
    mc = mean - c
    cov = cen / cnt[..., None, None] - mc[..., :, None] * mc[..., None, :]
    # on the host: the card's batched solver refuses batches this large
    _, vec = torch.linalg.eigh(cov.cpu())
    n = vec[..., :, 0].to(cov.device)
    q = cov.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    iso = ((cov - q[..., None, None] * eye) ** 2).sum((-2, -1)) / 6.0 < 1e-12
    up = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    n = torch.where((iso | (cnt <= 2))[..., None], up.expand_as(n), n)
    return n.float()


def preprocess(pts, valid, cfg: dict):
    """The filter chain as validity updates -> (normalized points,
    survivors). cfg: the yaml `transforms` tree; a stage it lacks is
    off."""
    pts = pts.float()
    d = cfg.get("DistanceSample")
    if d:
        dist = torch.sqrt(((pts.double()) ** 2).sum(-1))
        valid = valid & (dist >= d["min_dis"]) & (dist <= d["max_dis"])
    of, lp = cfg.get("OutlierFilter"), cfg.get("LowPassFilter")
    if of or lp:
        k_out = int(of["nb_neighbors"]) if of else 0
        k_lp = int(lp["normals_num"]) if lp else 0
        idx, d2, *mom = knn(pts, pts, max(k_out, k_lp) + 1, valid,
                            float(lp["normals_radius"]) if lp else 0.0)
    if of:
        mean_d = torch.sqrt(torch.clamp(d2[..., 1:k_out + 1].double(),
                                        min=0.0)).mean(-1)
        mu, sd = _masked_stats(mean_d, valid)
        valid = valid & (mean_d <= mu + float(of["std_ratio"]) * sd)
    if lp:
        nrm = normals(pts, mom[0])
        nb = idx[..., 1:k_lp + 1]
        sim = torch.abs((gather(nrm, nb) * nrm[:, :, None, :]).sum(-1))
        sim = torch.where(gather(valid, nb), sim, torch.zeros_like(sim))
        score = torch.topk(sim, int(lp["flux"]), dim=-1).values.sum(-1)
        mu, sd = _masked_stats(score, valid)
        valid = valid & (score > mu - float(lp["filter_std"]) * sd)
    ratio = float((cfg.get("CoordinatesNormalization") or {}).get(
        "ratio", 1.0))
    return (pts.double() / ratio).float(), valid


def scan_stats(pts, valid, cfg: dict):
    """The work counts of one scan's filter chain: (valid after the crop,
    in-radius (center, valid point) pairs at the low-pass radius, or 0
    without that filter, valid after the filters)."""
    d = cfg.get("DistanceSample")
    crop = valid
    if d:
        dist = torch.sqrt(((pts.double()) ** 2).sum(-1))
        crop = valid & (dist >= d["min_dis"]) & (dist <= d["max_dis"])
    pairs = 0
    lp = cfg.get("LowPassFilter")
    if lp:
        r2 = f32(float(lp["normals_radius"]) ** 2)
        for c0 in range(0, pts.shape[1], 512):
            dd = dist2(pts[:, c0:c0 + 512].float(), pts.float())
            pairs += int(((dd <= r2) & crop[:, None, :]).sum())
    _, survivors = preprocess(pts, valid, cfg)
    return int(crop.sum()), pairs, int(survivors.sum())


# ------------------------------------------------------------ network
class Ref:
    """The reference model over a Flax tree {'encoder': ..., 'decoder':
    ...} of float32 tensors, in the product precision `prec`."""

    def __init__(self, tree: dict, model: dict, prec: str = "f32"):
        self.P, self.m, self.prec = tree, model, prec
        self.enc, self.dec = model["encoder"], model["decoder"]

    # products
    def mm(self, a, b):
        return _round(a, self.prec) @ _round(b, self.prec)

    def dense(self, x, p):
        y = self.mm(x, p["kernel"])
        return y + p["bias"] if "bias" in p else y

    def ln(self, x, p):
        return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], LN_EPS)

    def mlp(self, x, p, drop_last_act=False):
        n = sum(1 for k in p if k.startswith("dense"))
        for i in range(n):
            x = self.ln(self.dense(x, p[f"dense{i}"]), p[f"norm{i}"])
            if not (drop_last_act and i == n - 1):
                x = F.relu(x)
        return x

    # encoder
    @staticmethod
    def _hybrid(points, centers, k, radius, valid):
        idx, d2 = knn(points, centers, k, valid)
        return torch.where(d2 > f32(radius * radius), idx[..., :1], idx)

    def _grouped(self, coor, fea, centers, gidx, radius, p):
        off = (gather(coor, gidx) - centers[:, :, None, :]) / radius
        g = torch.cat([gather(fea, gidx), off], -1)
        return self.mlp(g, p).amax(dim=2)

    def encode(self, pts, valid):
        """Normalized points (B, N, 3), validity -> (coor (B, S, 3), fea
        (B, S, C), validity (B, S))."""
        e, P = self.enc, self.P["encoder"]
        coor = pts.float()
        fea = self.dense(coor[..., :int(e["in_channel"])], P["point_mlp0"])
        levels = [(coor, fea, valid)]
        for i, npoint in enumerate(e["npoint"]):
            c, f, v = levels[-1]
            radii, ns = e["radius_list"][i], e["nsample_list"][i]
            p = P[f"down{i}"]
            idx, nv = fps(c, v, int(npoint))
            nc = gather(c, idx)
            gidx = self._hybrid(c, nc, int(ns[0]), radii[0], v)
            nf = self._grouped(c, f, nc, gidx, radii[0], p["sa"]["mlp"])
            for j in range(1, len(radii)):
                q = p[f"irm{j - 1}"]
                gidx = self._hybrid(nc, nc, int(ns[j]), radii[j], nv)
                la = self._grouped(nc, nf, nc, gidx, radii[j], q["la"]["mlp"])
                nf = F.relu(self.mlp(la, q["pw_conv"], drop_last_act=True)
                            + nf)
            levels.append((nc, nf, nv))
        n = len(e["npoint"])
        c, f, v = levels[-1]
        for i in range(int(e["upsample_layers"])):
            c1, f1, v1 = levels[n - i - 1]
            idx, d2 = knn(c, c1, 3, v)
            w = 1.0 / torch.clamp(d2, min=1e-8)
            w = w / w.sum(-1, keepdim=True)
            inter = (gather(f, idx) * w[..., None]).sum(2)
            f = self.mlp(torch.cat([f1, inter], -1), P[f"up{i}"]["mlp"])
            c, v = c1, v1
        return c, f, v

    # decoder
    @staticmethod
    def pos_embedding(xyz, emb_dim, temperature=10000.0, scale=math.pi):
        nf = emb_dim // 3 // 2 * 2
        pad = emb_dim - nf * 3
        dim_t = torch.arange(nf, dtype=torch.float32, device=xyz.device)
        dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / nf)
        pos = (xyz.float() * scale)[..., None] / dim_t
        emb = torch.stack([torch.sin(pos[..., 0::2]),
                           torch.cos(pos[..., 1::2])], -1)
        emb = emb.reshape(*xyz.shape[:-1], nf * 3)
        return F.pad(emb, (0, pad)) if pad else emb

    def attention(self, q, k, v, key_valid, p, heads=8):
        b, nq, c = q.shape
        nk = k.shape[1]
        d = c // heads
        W, B = p["in_proj_kernel"], p["in_proj_bias"]

        def proj(x, n, part):
            y = self.mm(x, W[:, part * c:(part + 1) * c]) \
                + B[part * c:(part + 1) * c]
            return y.reshape(b, n, heads, d).transpose(1, 2)

        qh, kh, vh = proj(q, nq, 0), proj(k, nk, 1), proj(v, nk, 2)
        logits = self.mm(qh, kh.transpose(-1, -2)) / math.sqrt(d)
        logits = torch.where(key_valid[:, None, None, :], logits,
                             torch.full_like(logits, -1e9))
        out = self.mm(torch.softmax(logits, -1), vh)
        return self.dense(out.transpose(1, 2).reshape(b, nq, c),
                          p["out_proj"])

    def correlate(self, src, dst, sv, dv):
        P, mc = self.P["decoder"], int(self.dec["model_channel"])
        sp = self.pos_embedding(src[..., -3:], mc)
        dp = self.pos_embedding(dst[..., -3:], mc)
        s = self.dense(src[..., :-3], P["projection"])
        d = self.dense(dst[..., :-3], P["projection"])
        for i in range(int(self.dec["attention_layers"])):
            p = P[f"attn{i}"]
            s, d = s + sp, d + dp
            s = self.ln(s + self.attention(s, s, s, sv, p["self_attn"]),
                        p["norm1"])
            d = self.ln(d + self.attention(d, d, d, dv, p["self_attn"]),
                        p["norm1"])
            s, d = s + sp, d + dp
            so = self.attention(s, d, d, dv, p["cross_attn"])
            do = self.attention(d, s, s, sv, p["cross_attn"])
            s, d = self.ln(s + so, p["norm2"]), self.ln(d + do, p["norm2"])
            mlp = lambda x: self.dense(F.relu(self.dense(x, p["mlp0"])),
                                       p["mlp1"])
            s = self.ln(mlp(s) + s, p["norm3"])
            d = self.ln(mlp(d) + d, p["norm3"])
        return s, d

    def head(self, x, p):
        return self.dense(F.relu(self.dense(x, p["dense0"])), p["dense1"])

    def offset(self, x):
        p = self.P["decoder"]["offset_head"]
        h = F.relu(self.dense(x, p["mlp0"]))
        h = self.dense(F.relu(self.dense(h, p["mlp1"])), p["mlp2"])
        return self.dense(F.relu(h + self.dense(x, p["downsample"])),
                          p["head"])

    def registration(self, src, dst, sv, dv, num_pairs, num_pairs_actual,
                     tau: float, eps_offset: float, robust: bool):
        """One pair: src (M, C+3), dst (N, C+3) -> (R, t, confidence,
        rmse), dst ~= R src + t."""
        m, n = src.shape[0], dst.shape[0]
        sf, df = self.correlate(src[None], dst[None], sv[None], dv[None])
        sf, df = sf[0], df[0]
        sim_head = self.P["decoder"]["similarity_head"]
        sp = F.normalize(self.head(sf, sim_head), dim=-1, eps=1e-12)
        dp = F.normalize(self.head(df, sim_head), dim=-1, eps=1e-12)
        pv = sv[:, None] & dv[None, :]
        sim = torch.where(pv, self.mm(sp, dp.T),
                          torch.full((), -1e9, device=sp.device))
        conf_mat = torch.softmax(sim / tau, 1) * torch.softmax(sim / tau, 0) \
            * pv
        vals, flat = torch.sort(conf_mat.reshape(-1), descending=True,
                                stable=True)
        conf, flat = vals[:num_pairs], flat[:num_pairs]
        si, di = flat // n, flat % n
        sx, dx = src[si, -3:], dst[di, -3:]
        o_sd = self.offset(torch.cat([sf[si], df[di]], -1))
        o_ds = self.offset(torch.cat([df[di], sf[si]], -1))
        a = torch.cat([sx + o_sd, sx], 0)
        b = torch.cat([dx, dx + o_ds], 0)
        w = torch.cat([conf, conf], 0)
        e2 = float(eps_offset ** 2)
        ok = sv[si] & dv[di] & (torch.arange(num_pairs, device=si.device)
                                < num_pairs_actual)
        ok2 = torch.cat([ok & ((o_sd ** 2).sum(-1) <= e2),
                         ok & ((o_ds ** 2).sum(-1) <= e2)], 0)
        solve = ransac if robust else trimmed
        R, t, inlier, rmse = solve(a, b, w, ok2)
        rank = torch.cumsum(inlier.int(), 0) - 1
        take = inlier & (rank < 30)
        confidence = (w * take).sum() / torch.clamp(take.float().sum(),
                                                    min=1.0)
        return R, t, confidence, rmse

    def loop_prob(self, src, dst, sv, dv):
        """Batched overlap probability (B,)."""
        s, d = self.correlate(src, dst, sv, dv)
        p = self.P["decoder"]["loop_head"]
        tok = lambda x: self.dense(F.relu(self.dense(x, p["mlp0"])),
                                   p["mlp1"]).mean(1)
        x = torch.cat([tok(s), tok(d)], -1)
        x = self.dense(F.relu(self.dense(x, p["proj0"])), p["proj1"])
        return torch.sigmoid(x)[..., 0]


# ------------------------------------------------------------ solves
def _solve(src, dst, w):
    wsum = torch.clamp(w.sum(-1), min=1e-12)[..., None]
    cs = (src * w[..., None]).sum(-2) / wsum
    cd = (dst * w[..., None]).sum(-2) / wsum
    S = ((src - cs[..., None, :]) * w[..., None]).transpose(-1, -2) \
        @ (dst - cd[..., None, :])
    u, _, vt = torch.linalg.svd(S)
    v = vt.transpose(-1, -2)
    det = torch.linalg.det(v @ u.transpose(-1, -2))
    dd = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = (v * dd[..., None, :]) @ u.transpose(-1, -2)
    return R, cd - (R @ cs[..., None])[..., 0]


def _apply(p, R, t):
    return p @ R.T + t[None]


def trimmed(src, dst, w, valid, iters=3, std_ratio=3.0):
    w = torch.where(valid, w, torch.zeros_like(w))
    inl = w > 0.5
    top = torch.sort(w, descending=True, stable=True).indices[:min(64,
                                                                   len(w))]
    inl[top] = True
    inl = inl & valid
    R = torch.eye(3, device=src.device)
    t = torch.zeros(3, device=src.device)
    for _ in range(iters):
        R, t = _solve(src, dst, w * inl)
        err = torch.linalg.norm(_apply(src, R, t) - dst, dim=-1)
        fi = inl.float()
        n = torch.clamp(fi.sum(), min=1.0)
        mean = (err * fi).sum() / n
        sd = torch.sqrt((((err - mean) ** 2) * fi).sum()
                        / torch.clamp(n - 1.0, min=1.0))
        new = (err <= mean + std_ratio * sd) & valid
        stop = bool(torch.all(new == inl)) or int(new.sum()) < 30
        inl = new
        if stop:
            break
    err2 = ((_apply(src, R, t) - dst) ** 2).sum(-1)
    fi = inl.float()
    rmse = torch.sqrt((err2 * fi).sum() / torch.clamp(fi.sum(), min=1.0))
    return R, t, inl, rmse


_M32 = 0xFFFFFFFF


def _threefry(x0, x1):
    """Threefry-2x32, 20 rounds, under the key (0, 0)."""
    ks = (0, 0, 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def gumbel(n_hyp: int, k: int, device) -> torch.Tensor:
    """The solve's fixed noise: jax.random.gumbel(PRNGKey(0), (n_hyp, k))
    (counters (0, i), the two words xor-ed, the top 23 bits a mantissa),
    each log in float64 rounded to float32."""
    i = torch.arange(n_hyp * k, dtype=torch.int64, device=device)
    a, b = _threefry(torch.zeros_like(i), i)
    bits = (((a ^ b) >> 9) | 0x3F800000).to(torch.int32)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp(bits.view(torch.float32) - 1.0 + tiny, min=tiny)
    lg = lambda x: torch.log(x.double()).float()
    return (-lg(-lg(u))).view(n_hyp, k)


def ransac(src, dst, w, valid, n_hyp=1024, tau=0.5,
           refine=(0.75, 0.5, 0.4)):
    """Gumbel-top-3 hypotheses over the log-confidence, weighted
    consensus at tau, masked re-solves at the refine radii; rmse over the
    inliers divided by their share of the confidence (clipped to
    [1/64, 1])."""
    w = torch.where(valid, w, torch.zeros_like(w))
    logits = torch.log(torch.clamp(w, min=1e-9).double()).float()[None] \
        + gumbel(n_hyp, w.shape[0], w.device)
    hyp = torch.topk(logits, 3, dim=-1).indices
    Rh, th = _solve(src[hyp], dst[hyp], torch.ones(hyp.shape,
                                                   device=src.device))
    res = torch.linalg.norm(torch.einsum("hij,kj->hki", Rh, src)
                            + th[:, None, :] - dst[None], dim=-1)
    best = int(torch.argmax(((res < tau) * w[None]).sum(-1)))
    R, t = Rh[best], th[best]
    for r in refine:
        inl = (torch.linalg.norm(_apply(src, R, t) - dst, dim=-1) < r) \
            & valid
        R, t = _solve(src, dst, w * inl)
    err2 = ((_apply(src, R, t) - dst) ** 2).sum(-1)
    inl = (torch.sqrt(err2) < refine[-1]) & valid
    fi = inl.float()
    rmse = torch.sqrt((err2 * fi).sum() / torch.clamp(fi.sum(), min=1.0))
    share = (w * fi).sum() / torch.clamp(w.sum(), min=1e-9)
    return R, t, inl, rmse / torch.clamp(share, 1.0 / 64.0, 1.0)


def num_pairs_for(m: int, n: int, num_sample: float = 0.5) -> int:
    return max(int(num_sample * (m + n)) // 2, 1)
