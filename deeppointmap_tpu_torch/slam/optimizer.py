"""SE(3) pose-graph optimization: sparse Gauss-Newton / Levenberg-Marquardt.

The port's own copy of deeppointmap_tpu/slam/optimizer.py (NumPy / scipy only; the
port imports nothing of the JAX package).

Replaces the reference's Open3D C++ `GlobalOptimizationLevenbergMarquardt`
backend (reference: system/modules/pose_graph.py:565-658). Host-side NumPy
+ scipy.sparse: SLAM graphs here are hundreds of keyframes, far below the
scale where an on-device solver would pay off, and float64 is free on the
host.

Formulation: minimize  sum_e  r_e^T  Omega_e  r_e   with
    r_e = Log( Z_e^{-1} T_i^{-1} T_j )        (right perturbation)
where Z_e is the measured relative pose (pose_dst in src frame -- the
edge convention of slam/pose_graph.py) and Omega_e the 6x6 information
matrix. Jacobians use the inverse right Jacobian series; tests validate
them against finite differences and the full solver against noisy-loop
synthetic graphs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from deeppointmap_tpu_torch.utils import se3 as se3m


def _ad(xi: np.ndarray) -> np.ndarray:
    """se(3) adjoint of a twist (rho, phi): [[phi^, rho^], [0, phi^]]."""
    rho, phi = xi[:3], xi[3:]
    A = np.zeros((6, 6))
    P = se3m.hat(phi)
    A[:3, :3] = P
    A[:3, 3:] = se3m.hat(rho)
    A[3:, 3:] = P
    return A


def _jr_inv(xi: np.ndarray) -> np.ndarray:
    """Inverse right Jacobian of SE(3), 2nd-order series:
    Jr^{-1}(xi) ~= I + ad(xi)/2 + ad(xi)^2 / 12 (residuals are small)."""
    A = _ad(xi)
    return np.eye(6) + 0.5 * A + (A @ A) / 12.0


def edge_residual_jacobians(Ti: np.ndarray, Tj: np.ndarray, Z: np.ndarray):
    """Residual r = Log(Z^{-1} Ti^{-1} Tj) and Jacobians wrt right
    perturbations of (Ti, Tj). Returns (r (6,), Ji (6,6), Jj (6,6))."""
    rel = se3m.inv(Ti) @ Tj
    E = se3m.inv(Z) @ rel
    r = se3m.se3_log(E)
    Jri = _jr_inv(r)
    Jj = Jri
    Ji = -Jri @ se3m.adjoint(se3m.inv(rel))
    return r, Ji, Jj


def _graph_cost(poses, edges) -> float:
    c = 0.0
    for i, j, Z, omega, w in edges:
        r = se3m.se3_log(se3m.inv(Z) @ se3m.inv(poses[i]) @ poses[j])
        c += float(w * r @ omega @ r)
    return c


# ------------------------------------------------------ batched SE3 math
def _batch_so3_log(R: np.ndarray) -> np.ndarray:
    """(E, 3, 3) -> (E, 3). General formula with small-angle fallback;
    residual rotations in pose-graph refinement are far from pi."""
    tr = np.clip((np.trace(R, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    W = 0.5 * (R - np.transpose(R, (0, 2, 1)))
    vee = np.stack([W[:, 2, 1], W[:, 0, 2], W[:, 1, 0]], 1)   # sin(th)*axis
    sin_t = np.sin(theta)
    small = theta < 1e-6
    scale = np.where(small, 1.0, theta / np.where(small, 1.0, sin_t))
    big = theta > np.pi - 1e-4
    if np.any(big):  # rare: exact per-element fallback
        out = vee * scale[:, None]
        for k in np.nonzero(big)[0]:
            out[k] = se3m.so3_log(R[k])
        return out
    return vee * scale[:, None]


def _batch_hat(v: np.ndarray) -> np.ndarray:
    E = v.shape[0]
    H = np.zeros((E, 3, 3))
    H[:, 0, 1], H[:, 0, 2] = -v[:, 2], v[:, 1]
    H[:, 1, 0], H[:, 1, 2] = v[:, 2], -v[:, 0]
    H[:, 2, 0], H[:, 2, 1] = -v[:, 1], v[:, 0]
    return H


def _batch_se3_log(T: np.ndarray) -> np.ndarray:
    """(E, 4, 4) -> (E, 6) twists (rho, phi)."""
    phi = _batch_so3_log(T[:, :3, :3])
    theta = np.linalg.norm(phi, axis=1)
    W = _batch_hat(phi)
    small = theta < 1e-6
    theta_s = np.where(small, 1.0, theta)
    half = theta_s / 2.0
    cot = half / np.tan(half)
    coef = np.where(small, 1.0 / 12.0, (1.0 - cot) / (theta_s ** 2))
    Jl_inv = (np.eye(3)[None] - 0.5 * W
              + coef[:, None, None] * (W @ W))
    rho = np.einsum("eij,ej->ei", Jl_inv, T[:, :3, 3])
    return np.concatenate([rho, phi], 1)


def _batch_se3_exp(xi: np.ndarray) -> np.ndarray:
    """(V, 6) -> (V, 4, 4)."""
    rho, phi = xi[:, :3], xi[:, 3:]
    theta = np.linalg.norm(phi, axis=1)
    W = _batch_hat(phi)
    small = theta < 1e-8
    theta_s = np.where(small, 1.0, theta)
    A = np.where(small, 1.0, np.sin(theta_s) / theta_s)
    B = np.where(small, 0.5, (1.0 - np.cos(theta_s)) / theta_s ** 2)
    C = np.where(small, 1.0 / 6.0, (theta_s - np.sin(theta_s)) / theta_s ** 3)
    W2 = W @ W
    R = np.eye(3)[None] + A[:, None, None] * W + B[:, None, None] * W2
    Jl = np.eye(3)[None] + B[:, None, None] * W + C[:, None, None] * W2
    out = np.tile(np.eye(4), (xi.shape[0], 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = np.einsum("eij,ej->ei", Jl, rho)
    return out


def _batch_inv(T: np.ndarray) -> np.ndarray:
    out = np.tile(np.eye(4), (T.shape[0], 1, 1))
    Rt = np.transpose(T[:, :3, :3], (0, 2, 1))
    out[:, :3, :3] = Rt
    out[:, :3, 3] = -np.einsum("eij,ej->ei", Rt, T[:, :3, 3])
    return out


def _batch_ad(xi: np.ndarray) -> np.ndarray:
    E = xi.shape[0]
    A = np.zeros((E, 6, 6))
    P = _batch_hat(xi[:, 3:])
    A[:, :3, :3] = P
    A[:, :3, 3:] = _batch_hat(xi[:, :3])
    A[:, 3:, 3:] = P
    return A


def _batch_adjoint(T: np.ndarray) -> np.ndarray:
    E = T.shape[0]
    A = np.zeros((E, 6, 6))
    R = T[:, :3, :3]
    A[:, :3, :3] = R
    A[:, :3, 3:] = _batch_hat(T[:, :3, 3]) @ R
    A[:, 3:, 3:] = R
    return A


def optimize_pose_graph(
    poses: np.ndarray,                     # (V, 4, 4)
    edges: Sequence[Tuple[int, int, np.ndarray, np.ndarray, float]],
    fixed_idx: int = 0,
    max_iters: int = 100,
    lm_lambda: float = 1e-4,
    rel_tol: float = 1e-9,
) -> np.ndarray:
    """Levenberg-Marquardt over the pose graph. `edges` entries are
    (src_idx, dst_idx, Z (4,4), information (6,6), weight). The pose at
    `fixed_idx` is the gauge anchor. Returns optimized (V, 4, 4).

    Fully vectorized over edges (batched SE3 log/exp + one-shot sparse
    assembly with a precomputed index structure); scales to thousands of
    keyframes in well under a second per iteration."""
    V = poses.shape[0]
    if V <= 1 or not edges:
        return poses.copy()

    E = len(edges)
    I = np.array([e[0] for e in edges], np.int64)
    J = np.array([e[1] for e in edges], np.int64)
    Z = np.stack([np.asarray(e[2], np.float64) for e in edges])
    Om = np.stack([np.asarray(e[3], np.float64) for e in edges])
    Om = 0.5 * (Om + np.transpose(Om, (0, 2, 1)))
    Om *= np.array([float(e[4]) for e in edges])[:, None, None]
    Z_inv = _batch_inv(Z)

    # static sparse structure: 4 6x6 blocks per edge
    def block_idx(r_nodes, c_nodes):
        r = (6 * r_nodes[:, None, None]
             + np.arange(6)[None, :, None])            # (E, 6, 1)
        c = (6 * c_nodes[:, None, None]
             + np.arange(6)[None, None, :])            # (E, 1, 6)
        return (np.broadcast_to(r, (E, 6, 6)).ravel(),
                np.broadcast_to(c, (E, 6, 6)).ravel())

    rows_ii, cols_ii = block_idx(I, I)
    rows_jj, cols_jj = block_idx(J, J)
    rows_ij, cols_ij = block_idx(I, J)
    rows_ji, cols_ji = block_idx(J, I)
    rows = np.concatenate([rows_ii, rows_jj, rows_ij, rows_ji])
    cols = np.concatenate([cols_ii, cols_jj, cols_ij, cols_ji])
    anchor = np.arange(6 * fixed_idx, 6 * fixed_idx + 6)

    T = poses.astype(np.float64).copy()

    def residuals(T_all):
        rel = _batch_inv(T_all[I]) @ T_all[J]
        return _batch_se3_log(Z_inv @ rel), rel

    def cost_of(r):
        return float(np.einsum("ei,eij,ej->", r, Om, r))

    r, rel = residuals(T)
    cost = cost_of(r)
    lam = lm_lambda

    for _ in range(max_iters):
        Ar = _batch_ad(r)
        Jr_inv = np.eye(6)[None] + 0.5 * Ar + (Ar @ Ar) / 12.0
        Jj = Jr_inv                                    # (E, 6, 6)
        Ji = -Jr_inv @ _batch_adjoint(_batch_inv(rel))

        JiW = np.transpose(Ji, (0, 2, 1)) @ Om
        JjW = np.transpose(Jj, (0, 2, 1)) @ Om
        vals = np.concatenate([(JiW @ Ji).ravel(), (JjW @ Jj).ravel(),
                               (JiW @ Jj).ravel(), (JjW @ Ji).ravel()])
        b = np.zeros(6 * V)
        np.add.at(b.reshape(V, 6), I, np.einsum("eij,ej->ei", JiW, r))
        np.add.at(b.reshape(V, 6), J, np.einsum("eij,ej->ei", JjW, r))

        H = sp.coo_matrix((vals, (rows, cols)),
                          shape=(6 * V, 6 * V)).tocsr()
        # gauge fixing: zero the anchor's rows/cols, identity diagonal
        mask = np.ones(6 * V, bool)
        mask[anchor] = False
        keep = sp.diags(mask.astype(np.float64))
        H = keep @ H @ keep + sp.diags((~mask).astype(np.float64))
        b[anchor] = 0.0

        improved = False
        converged = False
        for _try in range(8):
            Hl = (H + lam * sp.eye(6 * V, format="csr")).tocsc()
            try:
                dx = spla.spsolve(Hl, -b)
            except Exception:
                lam *= 10.0
                continue
            if not np.all(np.isfinite(dx)):
                lam *= 10.0
                continue
            T_new = T @ _batch_se3_exp(dx.reshape(V, 6))
            r_new, rel_new = residuals(T_new)
            new_cost = cost_of(r_new)
            if new_cost < cost:
                T, r, rel = T_new, r_new, rel_new
                improved = True
                lam = max(lam * 0.5, 1e-9)
                converged = (cost - new_cost) <= rel_tol * max(cost, 1e-12)
                cost = new_cost
                break
            lam *= 10.0
        if not improved or converged:
            break
    return T


def spanning_tree_init(poses: np.ndarray, edges,
                       anchor: int) -> np.ndarray:
    """BFS spanning-tree re-initialization: each node's pose composed
    from its parent through the connecting edge measurement. Nodes not
    reachable from the anchor keep their current estimates.

    This exists for MERGED multi-agent graphs (PoseGraph.uncertain):
    incremental cross-coordinate-system merges can seed LM inside a
    wrong local minimum whose total chi2 is indistinguishable from the
    right one (measured on the synthetic 3-agent world: saved state
    chi2 80606 / merged ATE 14.8 m vs tree-init chi2 80931 / ATE
    3.8 m with IDENTICAL σ-verified loop edges -- scripts/
    ma_merge_lab.py). The objective cannot discriminate, so the
    initialization decides; odometry-composed seeding from the anchor
    is deterministic and basin-correct."""
    out = poses.copy()
    adj: dict = {}
    for i, j, Z, _info, _w in edges:
        adj.setdefault(i, []).append((j, Z, False))
        adj.setdefault(j, []).append((i, Z, True))
    vis = {anchor}
    bfs = [anchor]
    while bfs:
        u = bfs.pop(0)
        for v, Z, inverted in adj.get(u, []):
            if v in vis:
                continue
            vis.add(v)
            out[v] = out[u] @ (np.linalg.inv(Z) if inverted else Z)
            bfs.append(v)
    return out


def load_g2o(path: str):
    """Parse a g2o SE3:QUAT file -> (tokens, poses (V,4,4), edges list).
    Counterpart of PoseGraph.to_g2o_file; also reads files exported by the
    reference (pose_graph.py:821-842)."""
    from scipy.spatial.transform import Rotation

    tokens: List[int] = []
    poses: List[np.ndarray] = []
    raw_edges = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "VERTEX_SE3:QUAT":
                tok = int(parts[1])
                t = np.array([float(x) for x in parts[2:5]])
                q = [float(x) for x in parts[5:9]]
                R = Rotation.from_quat(q).as_matrix()
                tokens.append(tok)
                poses.append(se3m.se3(R, t))
            elif parts[0] == "EDGE_SE3:QUAT":
                s, d = int(parts[1]), int(parts[2])
                t = np.array([float(x) for x in parts[3:6]])
                q = [float(x) for x in parts[6:10]]
                R = Rotation.from_quat(q).as_matrix()
                upper = [float(x) for x in parts[10:31]]
                info = np.zeros((6, 6))
                k = 0
                for r0 in range(6):
                    for c0 in range(r0, 6):
                        info[r0, c0] = upper[k]
                        info[c0, r0] = upper[k]
                        k += 1
                raw_edges.append((s, d, se3m.se3(R, t), info, 1.0))
    tok_to_idx = {t: i for i, t in enumerate(tokens)}
    edges = [(tok_to_idx[s], tok_to_idx[d], Z, info, w)
             for s, d, Z, info, w in raw_edges
             if s in tok_to_idx and d in tok_to_idx]
    return tokens, np.stack(poses, 0), edges
