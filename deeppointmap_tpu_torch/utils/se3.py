"""SE(3) pose math on the host (NumPy, float64).

The port's own copy of deeppointmap_tpu/utils/se3.py (NumPy / scipy only; the
port imports nothing of the JAX package).

Covers the reference's PoseTool (reference: system/modules/utils.py:30-57)
and rt_global_to_relative (reference: utils/pose.py:6-18), plus the se(3)
exp/log maps needed by our own pose-graph optimizer (the reference defers
global optimization to Open3D's C++ LM; we solve it ourselves -- see
slam/optimizer.py).

All functions accept/return float64 ndarrays. Host-side pose bookkeeping is
deliberately fp64: poses are composed thousands of times along a trajectory
and fp32 drift is visible at KITTI scale.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


def se3(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Assemble a 4x4 SE3 from a 3x3 rotation and a translation."""
    mat = np.eye(4, dtype=np.float64)
    mat[:3, :3] = np.asarray(R, dtype=np.float64).reshape(3, 3)
    mat[:3, 3] = np.asarray(t, dtype=np.float64).reshape(3)
    return mat


def rt(T: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a 4x4 SE3 into (R (3,3), t (3,1))."""
    T = np.asarray(T, dtype=np.float64)
    return T[:3, :3], T[:3, 3:4]


def inv(T: np.ndarray) -> np.ndarray:
    """Closed-form SE3 inverse."""
    R, t = rt(T)
    out = np.eye(4, dtype=np.float64)
    out[:3, :3] = R.T
    out[:3, 3:4] = -R.T @ t
    return out


def rotation_angle(R: np.ndarray) -> float:
    """Geodesic rotation angle in radians."""
    c = (np.trace(np.asarray(R, dtype=np.float64)) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def global_to_relative(R_cur, t_cur, R_other, t_other):
    """Relative pose of `other` expressed in `cur`'s frame.

    Returns (R_cur^T @ R_other, R_cur^T @ (t_other - t_cur)).
    """
    R_cur = np.asarray(R_cur, dtype=np.float64)
    t_cur = np.asarray(t_cur, dtype=np.float64).reshape(3, 1)
    R_other = np.asarray(R_other, dtype=np.float64)
    t_other = np.asarray(t_other, dtype=np.float64).reshape(3, 1)
    return R_cur.T @ R_other, R_cur.T @ (t_other - t_cur)


def hat(w: np.ndarray) -> np.ndarray:
    """so(3) hat operator: 3-vector -> skew-symmetric 3x3."""
    w = np.asarray(w, dtype=np.float64).reshape(3)
    return np.array([
        [0.0, -w[2], w[1]],
        [w[2], 0.0, -w[0]],
        [-w[1], w[0], 0.0],
    ])


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues' formula: axis-angle 3-vector -> rotation matrix."""
    w = np.asarray(w, dtype=np.float64).reshape(3)
    theta = np.linalg.norm(w)
    W = hat(w)
    if theta < 1e-8:
        # 2nd-order series; accurate to ~1e-16 at this magnitude
        return np.eye(3) + W + 0.5 * (W @ W)
    A = np.sin(theta) / theta
    B = (1.0 - np.cos(theta)) / (theta * theta)
    return np.eye(3) + A * W + B * (W @ W)


def so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle 3-vector (inverse of so3_exp)."""
    R = np.asarray(R, dtype=np.float64)
    theta = rotation_angle(R)
    if theta < 1e-8:
        # near identity: log(R) ~ (R - R^T)/2
        W = 0.5 * (R - R.T)
        return np.array([W[2, 1], W[0, 2], W[1, 0]])
    if abs(np.pi - theta) < 1e-6:
        # near pi: sin(theta) ~ 0; recover axis from R + I
        M = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diagonal(M), 0.0))
        # fix signs using off-diagonals
        i = int(np.argmax(axis))
        if axis[i] > _EPS:
            axis = M[:, i] / axis[i]
            axis = axis / max(np.linalg.norm(axis), _EPS)
        return axis * theta
    W = (R - R.T) * (theta / (2.0 * np.sin(theta)))
    return np.array([W[2, 1], W[0, 2], W[1, 0]])


def _left_jacobian(w: np.ndarray) -> np.ndarray:
    """SO(3) left Jacobian J_l(w) (used for the translation block of Exp)."""
    theta = np.linalg.norm(w)
    W = hat(w)
    if theta < 1e-8:
        return np.eye(3) + 0.5 * W + (W @ W) / 6.0
    B = (1.0 - np.cos(theta)) / (theta * theta)
    C = (theta - np.sin(theta)) / (theta ** 3)
    return np.eye(3) + B * W + C * (W @ W)


def _left_jacobian_inv(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    W = hat(w)
    if theta < 1e-8:
        return np.eye(3) - 0.5 * W + (W @ W) / 12.0
    half = theta / 2.0
    cot = half / np.tan(half)
    coef = (1.0 - cot) / (theta * theta)
    return np.eye(3) - 0.5 * W + coef * (W @ W)


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """se(3) exponential map. xi = (rho, phi): translation part first.

    Exp([rho, phi]) = [[exp(phi^), J_l(phi) rho], [0, 1]]
    """
    xi = np.asarray(xi, dtype=np.float64).reshape(6)
    rho, phi = xi[:3], xi[3:]
    R = so3_exp(phi)
    t = _left_jacobian(phi) @ rho
    return se3(R, t)


def se3_log(T: np.ndarray) -> np.ndarray:
    """se(3) logarithm map (inverse of se3_exp). Returns (rho, phi)."""
    R, t = rt(T)
    phi = so3_log(R)
    rho = _left_jacobian_inv(phi) @ t.reshape(3)
    return np.concatenate([rho, phi])


def adjoint(T: np.ndarray) -> np.ndarray:
    """SE(3) adjoint: 6x6 matrix with (rho, phi) ordering."""
    R, t = rt(T)
    A = np.zeros((6, 6), dtype=np.float64)
    A[:3, :3] = R
    A[:3, 3:] = hat(t.reshape(3)) @ R
    A[3:, 3:] = R
    return A


def project_to_so3(M: np.ndarray) -> np.ndarray:
    """Nearest rotation matrix (Frobenius) via SVD with det fix."""
    U, _, Vt = np.linalg.svd(np.asarray(M, dtype=np.float64))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    return U @ D @ Vt
