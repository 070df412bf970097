"""Weighted Kabsch/SVD rigid registration (port of
deeppointmap_tpu/ops/kabsch.py): the reference's trimmed solve
(`weighted_kabsch`) and the robust one (`ransac_kabsch`,
`tpu.robust_register`).

The reference's dynamic while loop (network/decoder/decoder.py:227-265)
runs a fixed 3 solves with a `stopped` flag held in a tensor, so the
solve never waits on the host. The covariance is formed after centring
and decomposed in float32 (`torch.linalg.svd`, batched over hypotheses in
the RANSAC solve); a determinant correction rules out reflections.

The RANSAC hypotheses are drawn with the JAX package's own noise,
`jax.random.gumbel(PRNGKey(0), (n_hyp, K))`, reproduced here without JAX:
threefry-2x32 on torch integers (the partitionable counter layout of
JAX 0.9), JAX's bits -> uniform -> Gumbel mapping, and logarithms taken in
float64 and rounded to float32 at the steps where JAX rounds.
"""

from __future__ import annotations

import threading

import torch

from deeppointmap_tpu_torch.utils import timer

_MIN_INLIERS = 30
_TOPK_SEED = 64
#: the trimmed solve's solves (the reference's fixed 3)
TRIM_SOLVES = 3
#: the RANSAC solve's 3-point hypotheses and its refinement radii (m)
RANSAC_HYPOTHESES = 1024
RANSAC_REFINE_TAUS = (0.75, 0.5, 0.4)
#: the solves, host syncs included (utils/timer.py)
_SOLVE = timer.span("kabsch.solve")


def top_k(x: torch.Tensor, k: int):
    """`lax.top_k` over the last axis: the k largest, descending, ties to
    the lower index (a stable sort, where torch.topk leaves ties open)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _apply_rt(pts, R, t):
    return pts @ R.T + t[None, :]


def _solve_rt(src, dst, w):
    """Weighted Kabsch solves, one per leading index: src/dst (..., K, 3),
    w (..., K) >= 0 -> R (..., 3, 3), t (..., 3). The `kabsch.solve` span,
    with the host syncs the SVD and the determinant make on a card."""
    with _SOLVE:
        wsum = torch.clamp(w.sum(-1), min=1e-12)[..., None]
        cs = (src * w[..., None]).sum(-2) / wsum
        cd = (dst * w[..., None]).sum(-2) / wsum
        S = ((src - cs[..., None, :]) * w[..., None]).transpose(-1, -2) \
            @ (dst - cd[..., None, :])
        u, _, vt = torch.linalg.svd(S)
        v = vt.transpose(-1, -2)
        det = torch.linalg.det(v @ u.transpose(-1, -2))
        d = torch.stack([torch.ones_like(det), torch.ones_like(det), det],
                        -1)
        R = (v * d[..., None, :]) @ u.transpose(-1, -2)
        t = cd - (R @ cs[..., None])[..., 0]
    return R, t


def weighted_kabsch(src, dst, weight, valid, num_iter: int = TRIM_SOLVES,
                    std_ratio: float = 3.0):
    """src/dst (K, 3), weight (K,) >= 0, valid (K,) bool ->
    (R (3, 3), t (3,), inlier mask (K,), rmse scalar).

    Trimming rule per solve (reference: decoder.py:247-256): residuals over
    all pairs; pairs with err <= mean + std_ratio * sigma of the current
    inliers' residuals stay. Stops when the mask is stable or fewer than
    30 inliers remain."""
    k = src.shape[0]
    src = src.float()
    dst = dst.float()
    w_masked = torch.where(valid, weight.float(), torch.zeros_like(weight))

    inlier = w_masked > 0.5
    top_idx = top_k(w_masked, min(_TOPK_SEED, k))[1]
    inlier[top_idx] = True
    inlier = inlier & valid

    stopped = torch.zeros((), dtype=torch.bool, device=src.device)
    R = torch.eye(3, dtype=torch.float32, device=src.device)
    t = torch.zeros(3, dtype=torch.float32, device=src.device)
    for _ in range(num_iter):
        R_new, t_new = _solve_rt(src, dst, w_masked * inlier)
        R = torch.where(stopped, R, R_new)
        t = torch.where(stopped, t, t_new)
        err = torch.linalg.norm(_apply_rt(src, R, t) - dst, dim=-1)
        inf = inlier.float()
        n_in = torch.clamp(inf.sum(), min=1.0)
        mean = (err * inf).sum() / n_in
        var = (((err - mean) ** 2) * inf).sum() / torch.clamp(n_in - 1.0,
                                                              min=1.0)
        new_inlier = (err <= mean + std_ratio * torch.sqrt(var)) & valid
        same = torch.all(new_inlier == inlier)
        too_few = new_inlier.sum() < _MIN_INLIERS
        inlier = torch.where(stopped, inlier, new_inlier)
        stopped = stopped | same | too_few

    err2 = ((_apply_rt(src, R, t) - dst) ** 2).sum(-1)
    inf = inlier.float()
    n_in = torch.clamp(inf.sum(), min=1.0)
    rmse = torch.sqrt((err2 * inf).sum() / n_in)
    return R, t, inlier, rmse


# ------------------------------------------------------------- RANSAC
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_GUMBEL_CACHE: dict = {}
_GUMBEL_LOCK = threading.Lock()


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter words x1, x2 under
    the key (k1, k2); 32-bit words held in int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def uniform_bits(n: int, device) -> torch.Tensor:
    """`jax.random.uniform(PRNGKey(0), (n,), minval=tiny, maxval=1)` bit
    for bit, float32: threefry-2x32 under the key (0, 0) of the counters
    (0, i), the two words xor-ed (JAX's partitionable layout); the top 23
    bits as a mantissa in [1, 2), minus 1, plus tiny."""
    count = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(0, 0, torch.zeros_like(count), count)
    bits = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
    tiny = torch.finfo(torch.float32).tiny
    return torch.clamp(bits.view(torch.float32) - 1.0 + tiny, min=tiny)


def log32(x: torch.Tensor) -> torch.Tensor:
    """float32 log, taken in float64 and rounded once, so that the CPU and
    the GPU give the same bits."""
    return torch.log(x.double()).float()


def gumbel_noise(n_hyp: int, k: int, device) -> torch.Tensor:
    """`jax.random.gumbel(jax.random.PRNGKey(0), (n_hyp, k))` as a float32
    tensor on `device`: -log(-log(u)) of `uniform_bits`, rounded to
    float32 after each log as JAX rounds. The uniform is JAX's bit for bit;
    JAX's float32 log is not correctly rounded (one ulp off for ~14% of
    the inputs on the CPU), so each log here is within one ulp of JAX's,
    and the noise within what that ulp becomes (<= 1e-6 absolute at
    K <= 2176). Cached per (n_hyp, k, device): the key is a constant and k
    takes only the values of the pair-count buckets."""
    key = (n_hyp, k, str(torch.device(device)))
    with _GUMBEL_LOCK:
        hit = _GUMBEL_CACHE.get(key)
    if hit is not None:
        return hit
    u = uniform_bits(n_hyp * k, device)
    noise = (-log32(-log32(u))).view(n_hyp, k)
    with _GUMBEL_LOCK:
        return _GUMBEL_CACHE.setdefault(key, noise)


def hypotheses(w_masked: torch.Tensor, n_hyp: int) -> torch.Tensor:
    """The RANSAC solve's 3-point samples: (n_hyp, 3) indices, the top 3
    of log-confidence + Gumbel noise in each row (sampling without
    replacement in proportion to the confidence). The noise is continuous,
    so the top three have no ties in practice and torch.topk's order is
    lax.top_k's; a pick can still part from the JAX package's where two
    logits lie within the one-ulp difference of the two packages' logs."""
    logits = log32(torch.clamp(w_masked, min=1e-9))[None, :] \
        + gumbel_noise(n_hyp, w_masked.shape[0], w_masked.device)
    return torch.topk(logits, 3, dim=-1).indices


def ransac_kabsch(src, dst, weight, valid, n_hyp: int = RANSAC_HYPOTHESES,
                  tau: float = 0.5, refine_taus: tuple = RANSAC_REFINE_TAUS):
    """Robust drop-in for `weighted_kabsch` (same arguments and returns)
    for correspondence sets with many confident outliers (occluded LiDAR:
    50-80%), where mean + 3 sigma trimming is biased toward identity.

    Confidence-seeded 3-point hypotheses (Gumbel top-3 over the
    log-confidence, the JAX package's fixed noise), weighted consensus at
    `tau` meters, then masked re-solves at the annealed `refine_taus`. The
    rmse is the inlier rmse divided by the weighted inlier fraction
    (clipped to [1/64, 1]), so that a consensus covering little of the
    confidence reports a large rmse and the edge gates can drop it."""
    k = src.shape[0]
    src = src.float()
    dst = dst.float()
    w_masked = torch.where(valid, weight.float(), torch.zeros_like(weight))

    hyp_idx = hypotheses(w_masked, n_hyp)                        # (H, 3)
    Rh, th = _solve_rt(src[hyp_idx], dst[hyp_idx],
                       torch.ones(hyp_idx.shape, device=src.device))
    res = torch.linalg.norm(torch.einsum("hij,kj->hki", Rh, src)
                            + th[:, None, :] - dst[None], dim=-1)  # (H, K)
    score = ((res < tau) * w_masked[None, :]).sum(-1)
    best = torch.argmax(score).reshape(1)    # first maximum, as jnp.argmax
    R, t = Rh.index_select(0, best)[0], th.index_select(0, best)[0]

    for tr in refine_taus:
        err = torch.linalg.norm(_apply_rt(src, R, t) - dst, dim=-1)
        inlier = (err < tr) & valid
        R, t = _solve_rt(src, dst, w_masked * inlier)

    err2 = ((_apply_rt(src, R, t) - dst) ** 2).sum(-1)
    inlier = (torch.sqrt(err2) < refine_taus[-1]) & valid
    inf = inlier.float()
    n_in = torch.clamp(inf.sum(), min=1.0)
    rmse_in = torch.sqrt((err2 * inf).sum() / n_in)
    frac_w = (w_masked * inf).sum() / torch.clamp(w_masked.sum(), min=1e-9)
    rmse = rmse_in / torch.clamp(frac_w, 1.0 / 64.0, 1.0)
    return R, t, inlier, rmse
