"""Wire codec for multi-agent SLAM messages (port of
deeppointmap_tpu/slam/serialization.py).

The reference's agents exchange ScanPack + edge objects through an
in-process queue (reference: system/modules/utils.py:116-154, payload
schema at system/core.py:422). To cross a network the same schema is
packed to bytes (compressed npz, read back with `allow_pickle=False`) and
back. The archive holds the same members, names, dtypes and shapes as the
JAX package's codec, so that an agent of one package and a cloud of the
other understand each other.

Only host arrays cross the wire: a ScanPack whose descriptors or point
validity are still lazy device fetches (slam/pose_graph.ScanPack) is
materialized by the encoder.
"""

from __future__ import annotations

import io
from typing import List, Optional, Tuple

import numpy as np

from deeppointmap_tpu_torch.slam.pose_graph import PoseGraphEdge, ScanPack


def _none_or(v, default):
    return default if v is None else v


def pack_scan(scan: ScanPack) -> dict:
    """ScanPack -> dict of NumPy arrays; the `key_points` / `full_valid`
    properties fetch lazy device outputs."""
    d = {
        "timestamp": np.float64(scan.timestamp),
        "agent_id": np.int64(scan.agent_id),
        "timestep": np.int64(scan.timestep),
        "coor_sys": np.int64(scan.coor_sys),
        "fixed": np.bool_(scan.fixed),
        "type_full": np.bool_(scan.type == "full"),
        "gps_position": scan.gps_position,
    }
    if scan.key_points_ref() is not None:
        d["key_points"] = scan.key_points
        d["key_valid"] = scan.key_valid
    if scan.full_pcd is not None:
        d["full_pcd"] = scan.full_pcd
        d["full_valid"] = scan.full_valid
    if scan.SE3_pred is not None:
        d["SE3_pred"] = scan.SE3_pred
    if scan.SE3_gt is not None:
        d["SE3_gt"] = scan.SE3_gt
    return d


def unpack_scan(d: dict) -> ScanPack:
    scan = ScanPack(
        timestamp=float(d["timestamp"]),
        agent_id=int(d["agent_id"]),
        timestep=int(d["timestep"]),
        key_points=d.get("key_points"),
        key_valid=d.get("key_valid"),
        full_pcd=d.get("full_pcd"),
        full_valid=d.get("full_valid"),
        SE3_pred=d.get("SE3_pred"),
        SE3_gt=d.get("SE3_gt"),
        gps_position=d["gps_position"],
        fixed=bool(d["fixed"]),
        coor_sys=int(d["coor_sys"]),
    )
    scan.type = "full" if bool(d["type_full"]) else "non-keyframe"
    return scan


def pack_edge(e: PoseGraphEdge) -> dict:
    return {
        "src": np.int64(e.src_scan_token),
        "dst": np.int64(e.dst_scan_token),
        "SE3": e.SE3,
        "info": e.information_mat,
        "type": np.bytes_(e.type.encode()),
        "confidence": np.float64(_none_or(e.confidence, np.nan)),
        "rmse": np.float64(_none_or(e.rmse, np.nan)),
    }


def unpack_edge(d: dict) -> PoseGraphEdge:
    conf = float(d["confidence"])
    rmse = float(d["rmse"])
    return PoseGraphEdge(
        src_scan_token=int(d["src"]), dst_scan_token=int(d["dst"]),
        SE3=d["SE3"], information_mat=d["info"],
        type=bytes(d["type"]).decode(),
        confidence=None if np.isnan(conf) else conf,
        rmse=None if np.isnan(rmse) else rmse)


def encode_upload(scan: ScanPack, odom_edge: Optional[PoseGraphEdge],
                  neighbor_edges: List[PoseGraphEdge]) -> bytes:
    """UPLOAD_SCAN payload -> bytes (compressed npz)."""
    arrays = {}
    for k, v in pack_scan(scan).items():
        arrays[f"scan/{k}"] = v
    if odom_edge is not None:
        for k, v in pack_edge(odom_edge).items():
            arrays[f"odom/{k}"] = v
    for i, e in enumerate(neighbor_edges):
        for k, v in pack_edge(e).items():
            arrays[f"nbr{i}/{k}"] = v
    arrays["n_neighbors"] = np.int64(len(neighbor_edges))
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def decode_upload(blob: bytes) -> Tuple[ScanPack, Optional[PoseGraphEdge],
                                        List[PoseGraphEdge]]:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        groups: dict = {}
        for key in z.files:
            if "/" not in key:
                continue
            g, k = key.split("/", 1)
            groups.setdefault(g, {})[k] = z[key]
        scan = unpack_scan(groups["scan"])
        odom = unpack_edge(groups["odom"]) if "odom" in groups else None
        n = int(z["n_neighbors"])
        nbrs = [unpack_edge(groups[f"nbr{i}"]) for i in range(n)]
    return scan, odom, nbrs
