"""Pose graph: vertex/edge store, BFS queries, map assembly, optimization.

The port's own copy of deeppointmap_tpu/slam/pose_graph.py (NumPy / scipy only; the
port imports nothing of the JAX package).

Parity with the reference PoseGraph (reference: system/modules/
pose_graph.py:19-871) with these deliberate changes:
  * NumPy float64 poses instead of torch float32 (drift at KITTI scale).
  * key_points are channel-last (K, 131) with a validity mask.
  * adjacency dict instead of O(E) edge scans per neighbor query
    (reference: pose_graph.py:228-246 scans every edge).
  * backend optimization is our own SE3 Levenberg-Marquardt solver
    (slam/optimizer.py) instead of Open3D C++
    (reference: pose_graph.py:565-658).
  * a single threading.Lock guards mutation (the reference's RW locks
    guard the same invariants; our MT pipeline has one writer per stage).
  * the reference's never-defined `base_scan_token` (called at
    pose_graph.py:333,762,767,869 but not implemented -- a latent crash)
    is actually implemented here: lowest token, optionally per agent.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Literal, Optional, Set, Tuple

import numpy as np

from deeppointmap_tpu_torch.utils import se3 as se3m

EdgeType = Literal["odom", "loop", "locz", "prxy"]


class ScanPack:
    """Per-scan record (reference: pose_graph.py:19-106).
    token = (agent_id << 16) + timestep.

    `key_points` and `full_valid` may be set to ZERO-ARG CALLABLES: the
    streaming engine leaves per-scan device outputs un-fetched and
    materializes them on first host access. Engine calls
    bypass the fetch entirely through the token-keyed device cache; use
    `key_points_ref()` / `full_valid_ref()` to pass the un-materialized
    handle."""

    __slots__ = ("token", "timestep", "timestamp", "agent_id", "_key_points",
                 "key_valid", "full_pcd", "_full_valid", "SE3_pred", "SE3_gt",
                 "gps_position", "fixed", "type", "coor_sys")

    def __init__(self, timestamp: float, agent_id: int, timestep: int,
                 key_points: Optional[np.ndarray],
                 key_valid: Optional[np.ndarray] = None,
                 full_pcd: Optional[np.ndarray] = None,
                 full_valid: Optional[np.ndarray] = None,
                 SE3_pred: Optional[np.ndarray] = None,
                 SE3_gt: Optional[np.ndarray] = None,
                 gps_position: Optional[np.ndarray] = None,
                 fixed: bool = False, coor_sys: int = -1):
        self.token = (agent_id << 16) + timestep
        self.timestep = timestep
        self.timestamp = timestamp
        self.agent_id = agent_id
        self._key_points = key_points         # (K, C+3) float32, xyz last 3
        if key_valid is not None:
            self.key_valid = key_valid
        elif key_points is None:
            self.key_valid = None
        else:
            assert not callable(key_points), \
                "lazy key_points requires explicit key_valid"
            self.key_valid = np.ones(key_points.shape[0], bool)
        self.full_pcd = full_pcd              # (N, 3) float32
        if full_valid is not None:
            self._full_valid = full_valid
        else:
            self._full_valid = (None if full_pcd is None
                                else np.ones(full_pcd.shape[0], bool))
        self.SE3_pred = (np.asarray(SE3_pred, np.float64).reshape(4, 4)
                         if SE3_pred is not None else None)
        self.SE3_gt = (np.asarray(SE3_gt, np.float64).reshape(4, 4)
                       if SE3_gt is not None else None)
        self.gps_position = (np.asarray(gps_position, np.float64).reshape(3)
                             if gps_position is not None else np.zeros(3))
        self.fixed = fixed
        self.type: Literal["full", "non-keyframe"] = "full"
        self.coor_sys = coor_sys

    @property
    def key_points(self) -> Optional[np.ndarray]:
        v = self._key_points
        if callable(v):
            v = np.asarray(v(), np.float32)
            self._key_points = v
        return v

    @key_points.setter
    def key_points(self, v) -> None:
        self._key_points = v

    def key_points_ref(self):
        """Raw handle (array or un-materialized thunk) for engine calls."""
        return self._key_points

    @property
    def full_valid(self) -> Optional[np.ndarray]:
        v = self._full_valid
        if callable(v):
            v = np.asarray(v(), bool)
            self._full_valid = v
        return v

    @full_valid.setter
    def full_valid(self, v) -> None:
        self._full_valid = v

    def full_valid_ref(self):
        return self._full_valid

    def copy(self) -> "ScanPack":
        c = ScanPack(self.timestamp, self.agent_id, self.timestep,
                     self._key_points, self.key_valid, self.full_pcd,
                     self._full_valid, self.SE3_pred, self.SE3_gt,
                     self.gps_position, self.fixed, self.coor_sys)
        c.type = self.type
        return c

    def nonkeyframe(self, drop_full_pcd: bool = False) -> "ScanPack":
        """Copy without key_points (reference: pose_graph.py:88-100).

        full_valid is MATERIALIZED here: non-keyframes are the unbounded
        node class, and a lazy device thunk would pin its ~16 KB device
        buffer for the pose graph's lifetime (the engine prefetches the
        buffer at dispatch, so this fetch is ~free). Keyframe descriptor
        thunks stay device-resident deliberately -- bounded by keyframe
        count and memoized on first host access.

        drop_full_pcd additionally releases the ~196 KB host point cloud
        (tpu.retain_nonkeyframe_pcd=false): non-keyframe full_pcd is only
        ever read by the final map render/save, which skip None -- the
        long-stream memory knob (scale run in BASELINE.md)."""
        c = self.copy()
        c.type = "non-keyframe"
        c.key_points = None
        c.key_valid = None
        if drop_full_pcd:
            c.full_pcd = None
            c.full_valid = None
        else:
            c.full_valid = self.full_valid
        return c

    def __hash__(self):
        return self.token

    def __str__(self):
        return f"ScanPack {self.token}, type {self.type}"


class PoseGraphEdge:
    """Edge: `SE3` is the dst pose expressed in the src frame, i.e.
    pose_dst = pose_src @ SE3 (reference: pose_graph.py:109-143 and the
    propagation rule at :652)."""

    __slots__ = ("src_scan_token", "dst_scan_token", "type", "SE3",
                 "information_mat", "confidence", "rmse")

    def __init__(self, src_scan_token: int, dst_scan_token: int,
                 SE3: np.ndarray, information_mat: np.ndarray,
                 type: EdgeType, confidence=None, rmse=None):
        self.src_scan_token = src_scan_token
        self.dst_scan_token = dst_scan_token
        self.type = type
        self.SE3 = np.asarray(SE3, np.float64).reshape(4, 4)
        self.information_mat = np.asarray(information_mat,
                                          np.float64).reshape(6, 6)
        self.confidence = confidence
        self.rmse = rmse

    def copy(self) -> "PoseGraphEdge":
        return PoseGraphEdge(self.src_scan_token, self.dst_scan_token,
                             self.SE3, self.information_mat, self.type,
                             self.confidence, self.rmse)

    def __str__(self):
        return f"Edge {self.src_scan_token}<->{self.dst_scan_token}"


class PoseGraph:
    def __init__(self, args=None, agent_id: int = 0):
        self.args = args
        self.agent_id = agent_id
        self.vertex: Dict[int, ScanPack] = {}
        self.edge: Dict[Tuple[int, int], PoseGraphEdge] = {}
        self._adj: Dict[int, Set[int]] = {}

        self.key_frame_num = 0
        self.all_frame_num = 0
        self.odom_edge_num = 0
        self.loop_edge_num = 0
        self.locz_edge_num = 0
        self.prxy_edge_num = 0

        # token -> [transformed key_points | None, transformed full_pcd | None]
        self._map_cache: Dict[int, List[Optional[np.ndarray]]] = {}
        # incremental keyframe index: loop-closure detection scans
        # keyframes on EVERY event, and rebuilding the list from all
        # vertices is O(total frames) per event (O(N^2) aggregate over a
        # long stream). Scans never demote from 'full', so append-only.
        self._keyframes: List[ScanPack] = []

        self.last_known_keyframe: Optional[int] = None
        self.last_known_anyframe: Optional[int] = None
        self.uncertain = False
        self._lock = threading.Lock()

    # ------------------------------------------------------------- store
    def add_vertex(self, scan: ScanPack) -> None:
        with self._lock:
            assert scan.token not in self.vertex, \
                f"Scan {scan.token} already in posegraph map"
            self.vertex[scan.token] = scan
            self._adj.setdefault(scan.token, set())
            self._map_cache[scan.token] = [None, None]
            if scan.type == "full":
                self.key_frame_num += 1
                self._keyframes.append(scan)
            self.all_frame_num += 1

    def add_edge(self, new_edge: Optional[PoseGraphEdge]) -> None:
        if new_edge is None:
            return
        s, d = new_edge.src_scan_token, new_edge.dst_scan_token
        if s not in self.vertex:
            raise RuntimeError(f"Scan {s} not exists")
        if d not in self.vertex:
            raise RuntimeError(f"Scan {d} not exists")
        if (s, d) in self.edge or (d, s) in self.edge:
            raise RuntimeError(f"Edge ({s} - {d}) already exists")
        with self._lock:
            self.edge[(s, d)] = new_edge
            self._adj[s].add(d)
            self._adj[d].add(s)
            setattr(self, f"{new_edge.type}_edge_num",
                    getattr(self, f"{new_edge.type}_edge_num") + 1)

    def has_scan(self, token: int) -> bool:
        return token in self.vertex

    def has_edge(self, src: int, dst: int) -> bool:
        return (src, dst) in self.edge

    @classmethod
    def get_agent_id(cls, token: int) -> int:
        return token >> 16

    def get_neighbor_tokens(self, token: int) -> List[int]:
        return list(self._adj.get(token, ()))

    def get_edge(self, src: int, dst: int) -> PoseGraphEdge:
        if (src, dst) not in self.edge:
            raise KeyError(f"edge ({src},{dst}) not exists"
                           + (f" (reverse exists)" if (dst, src) in self.edge
                              else ""))
        return self.edge[(src, dst)]

    def get_edge_either(self, a: int, b: int) -> Optional[PoseGraphEdge]:
        return self.edge.get((a, b)) or self.edge.get((b, a))

    def get_scanpack(self, token: int) -> ScanPack:
        return self.vertex[token]

    def get_all_scans(self) -> List[ScanPack]:
        return list(self.vertex.values())

    def get_keyframes(self) -> List[ScanPack]:
        """Keyframe ('full') scans, O(keyframes): served from the
        append-only index instead of filtering every vertex."""
        return list(self._keyframes)

    def get_all_edges(self) -> List[PoseGraphEdge]:
        return list(self.edge.values())

    def base_scan_token(self, agent_id: Optional[int] = None) -> int:
        toks = [t for t in self.vertex
                if agent_id is None or self.get_agent_id(t) == agent_id]
        return min(toks)

    def update_scan_token(self, token: int, new_SE3_pred=None,
                          new_coor_sys=None) -> None:
        with self._lock:
            scan = self.vertex[token]
            if new_SE3_pred is not None:
                scan.SE3_pred = np.asarray(new_SE3_pred,
                                           np.float64).reshape(4, 4)
                self._map_cache[token] = [None, None]
            if new_coor_sys is not None:
                scan.coor_sys = new_coor_sys

    def update_edge_token(self, src: int, dst: int, new_SE3=None,
                          new_confidence=None, new_information_mat=None,
                          new_rmse=None) -> None:
        e = self.get_edge(src, dst)
        with self._lock:
            if new_SE3 is not None:
                e.SE3 = np.asarray(new_SE3, np.float64).reshape(4, 4)
            if new_confidence is not None:
                e.confidence = new_confidence
            if new_information_mat is not None:
                e.information_mat = np.asarray(new_information_mat,
                                               np.float64).reshape(6, 6)
            if new_rmse is not None:
                e.rmse = new_rmse

    # --------------------------------------------------------- serialize
    def serialize(self):
        return ([s.copy() for s in self.get_all_scans()],
                [e.copy() for e in self.get_all_edges()])

    def deserialize(self, pose_graph_abstract, adjust_other_nodes=True):
        """Merge a (scans, edges) abstract into this graph
        (reference: pose_graph.py:302-355)."""
        scans, edges = pose_graph_abstract
        incoming = set()
        for scan in scans:
            incoming.add(scan.token)
            if self.has_scan(scan.token):
                self.update_scan_token(scan.token, new_SE3_pred=scan.SE3_pred,
                                       new_coor_sys=scan.coor_sys)
            else:
                self.add_vertex(scan)
        for e in edges:
            if self.has_edge(e.src_scan_token, e.dst_scan_token):
                self.update_edge_token(e.src_scan_token, e.dst_scan_token,
                                       new_SE3=e.SE3)
            elif self.has_scan(e.src_scan_token) and self.has_scan(e.dst_scan_token):
                self.add_edge(e)

        if adjust_other_nodes:
            others = {s.token for s in self.get_all_scans()
                      if s.token not in incoming}
            if not others:
                return
            base = self.get_scanpack(self.base_scan_token())
            vis: Set[int] = set()
            bfs = [base]
            while bfs:
                scan = bfs.pop(0)
                if scan.token in vis:
                    continue
                vis.add(scan.token)
                for n in self.get_neighbor_tokens(scan.token):
                    if not self.has_scan(n):
                        continue
                    nb = self.get_scanpack(n)
                    bfs.append(nb)
                    if nb.token in others and nb.coor_sys != base.coor_sys:
                        e = self.get_edge_either(scan.token, nb.token)
                        rel = (e.SE3 if e.src_scan_token == scan.token
                               else se3m.inv(e.SE3))
                        self.update_scan_token(
                            nb.token,
                            new_SE3_pred=scan.SE3_pred @ rel,
                            new_coor_sys=scan.coor_sys)

    # ------------------------------------------------------- map queries
    def _global_mapping(self, scans, full_pcd: bool):
        """Assemble world-frame tiles with per-scan cache
        (reference: pose_graph.py:373-409). Returns (points (N, C), tokens
        (N,)) with only VALID points included."""
        tiles, toks = [], []
        with self._lock:
            for scan in scans:
                R, t = se3m.rt(scan.SE3_pred)
                cache = self._map_cache[scan.token]
                if not full_pcd:
                    if scan.key_points is None:
                        continue
                    if cache[0] is None:
                        pts = scan.key_points[scan.key_valid].astype(np.float64)
                        pts = pts.copy()
                        pts[:, -3:] = pts[:, -3:] @ R.T + t.reshape(1, 3)
                        cache[0] = pts.astype(np.float32)
                    pts = cache[0]
                else:
                    if scan.full_pcd is None:
                        continue
                    if cache[1] is None:
                        pts = scan.full_pcd[scan.full_valid].astype(np.float64)
                        pts = pts.copy()
                        pts[:, :3] = pts[:, :3] @ R.T + t.reshape(1, 3)
                        cache[1] = pts.astype(np.float32)
                    pts = cache[1]
                tiles.append(pts)
                toks.append(np.full(pts.shape[0], scan.token, np.int64))
        if not tiles:
            return None, None
        return np.concatenate(tiles, 0), np.concatenate(toks, 0)

    def global_map_query_graph(self, token: int, neighbor_level: int,
                               coor_sys: int, max_dist: Optional[float] = 20,
                               full_pcd: bool = False,
                               centering_SE3: Optional[np.ndarray] = None):
        """BFS-bounded map tile centered at `centering_SE3`
        (reference: pose_graph.py:471-511). Non-keyframes excluded."""
        if not self.vertex:
            return None, None
        center = self.get_scanpack(token)
        _, center_t = se3m.rt(center.SE3_pred)
        scans = [s for s in self.graph_search(token, neighbor_level, coor_sys,
                                              edge_type=["odom", "loop"])
                 if s.type != "non-keyframe"]
        if max_dist is not None:
            scans = [s for s in scans
                     if np.linalg.norm(s.SE3_pred[:3, 3:] - center_t) < max_dist]
        tile, toks = self._global_mapping(scans, full_pcd)
        if tile is None:
            return None, None
        cSE3 = np.eye(4) if centering_SE3 is None else centering_SE3
        R, t = se3m.rt(cSE3)
        tile = tile.copy()
        cols = slice(-3, None) if not full_pcd else slice(0, 3)
        tile[:, cols] = (tile[:, cols] - t.reshape(1, 3)) @ R
        return tile, toks

    def global_map_query_space(self, SE3: np.ndarray, coor_sys: int,
                               radius: float = float("inf"),
                               full_pcd: bool = False):
        """Metric-radius map query (reference: pose_graph.py:411-446)."""
        if not self.vertex:
            return None, None
        R, t = se3m.rt(SE3)
        scans = [s for s in self.vertex.values()
                 if s.coor_sys == coor_sys
                 and np.linalg.norm(s.SE3_pred[:3, 3:] - t) < radius]
        tile, toks = self._global_mapping(scans, full_pcd)
        if tile is None:
            return None, None
        cols = slice(-3, None) if not full_pcd else slice(0, 3)
        keep = np.linalg.norm(tile[:, cols] - t.reshape(1, 3), axis=1) < radius
        tile, toks = tile[keep].copy(), toks[keep]
        tile[:, cols] = (tile[:, cols] - t.reshape(1, 3)) @ R
        return tile, toks

    # ------------------------------------------------------------ search
    def graph_search(self, token: int, neighbor_level: int, coor_sys: int,
                     edge_type="all", max_k: Optional[int] = 16
                     ) -> List[ScanPack]:
        """BFS up to `neighbor_level` hops over selected edge types
        (reference: pose_graph.py:513-542)."""
        if edge_type == "all":
            edge_type = ["loop", "odom", "locz", "prxy"]
        found: Dict[int, ScanPack] = {}
        bfs: List[Tuple[int, ScanPack]] = [(neighbor_level,
                                            self.get_scanpack(token))]
        while bfs and (max_k is None or len(found) < max_k):
            level, scan = bfs.pop(0)
            if scan.token in found:
                continue
            found[scan.token] = scan
            if level <= 0:
                continue
            for t in self.get_neighbor_tokens(scan.token):
                e = self.get_edge_either(scan.token, t)
                if e is not None and e.type in edge_type:
                    bfs.append((level - 1, self.get_scanpack(t)))
        return list(found.values())

    def shortest_path_length(self, src: int, dst: int, edge_type="all",
                             infinity_length: int = 50) -> int:
        """BFS hop count (reference: pose_graph.py:544-563)."""
        if src == dst:
            return 0
        if edge_type == "all":
            edge_type = ["loop", "odom", "locz", "prxy"]
        vis: Set[int] = set()
        bfs = [(0, src)]
        while bfs:
            dist, tok = bfs.pop(0)
            if tok == dst:
                return dist
            if tok in vis:
                continue
            vis.add(tok)
            if dist >= infinity_length:
                continue
            for t in self.get_neighbor_tokens(tok):
                e = self.get_edge_either(tok, t)
                if e is not None and e.type in edge_type:
                    bfs.append((dist + 1, t))
        return infinity_length

    # -------------------------------------------------------------- optim
    def optim(self):
        """Global pose-graph optimization (replaces the reference's Open3D
        LM backend, pose_graph.py:565-658): keyframes are nodes, non-locz
        edges constraints, lowest token fixed; non-keyframes re-propagated
        by BFS afterwards. Returns (n_nodes, n_edges, mean trans diff)."""
        from deeppointmap_tpu_torch.slam.optimizer import optimize_pose_graph

        keyframes = [s for s in self.get_all_scans()
                     if s.type != "non-keyframe"]
        if not keyframes:
            return 0, 0, 0.0
        token_to_idx = {s.token: i for i, s in enumerate(keyframes)}
        base_token = min(self.vertex)
        if base_token not in token_to_idx:
            # gauge anchor must be a solve node (the reference would crash
            # here if the lowest token were a non-keyframe)
            base_token = min(token_to_idx)
        poses = np.stack([s.SE3_pred for s in keyframes], 0)
        edges = []
        for e in self.get_all_edges():
            if e.type == "locz":
                continue
            if e.src_scan_token in token_to_idx and e.dst_scan_token in token_to_idx:
                # the reference marks every edge certain (uncertain=False,
                # pose_graph.py:597), so preference_loop_closure=2.0 has no
                # effect there; weight all edges equally
                info = e.information_mat
                if self.uncertain:
                    # merged multi-agent graph: ISOTROPIC weights. The
                    # GᵀG information estimates are overconfident and
                    # anisotropic enough that the MLE objective prefers
                    # a metrically-distorted merge: measured on the
                    # synthetic 3-agent world, chi2(GT config) = 202M vs
                    # 52.8k at an ATE-8m solution, and the good basin
                    # (ATE 3.8 m) is found from ANY initialization only
                    # with identity info; unit-trace normalization
                    # (eigenstructure kept) stays distorted at 7.8 m
                    # (scripts/ma_merge_lab.py, BASELINE.md round 5).
                    info = np.eye(6)
                edges.append((token_to_idx[e.src_scan_token],
                              token_to_idx[e.dst_scan_token],
                              e.SE3, info, 1.0))
        if self.uncertain:
            # re-seed by spanning tree from the anchor before LM --
            # incremental coordinate-system merges otherwise strand the
            # solve far from the merged basin (scripts/ma_merge_lab.py
            # measurements in the docstring of spanning_tree_init)
            from deeppointmap_tpu_torch.slam.optimizer import spanning_tree_init

            poses = spanning_tree_init(poses, edges,
                                       token_to_idx[base_token])
        new_poses = optimize_pose_graph(poses, edges,
                                        fixed_idx=token_to_idx[base_token])

        diffs = []
        for s, new in zip(keyframes, new_poses):
            diffs.append(float(np.linalg.norm(s.SE3_pred[:3, 3] - new[:3, 3])))
            self.update_scan_token(s.token, new_SE3_pred=new)

        # propagate non-keyframes along their locz edges
        # (reference: pose_graph.py:635-657)
        todo = {s.token for s in self.get_all_scans()
                if s.token not in token_to_idx}
        vis: Set[int] = set()
        bfs = [base_token]
        while bfs:
            tok = bfs.pop(0)
            if tok in vis:
                continue
            vis.add(tok)
            scan = self.get_scanpack(tok)
            for n in self.get_neighbor_tokens(tok):
                if not self.has_scan(n):
                    continue
                if n in todo:
                    e = self.get_edge_either(tok, n)
                    rel = e.SE3 if e.src_scan_token == tok else se3m.inv(e.SE3)
                    self.update_scan_token(n, new_SE3_pred=scan.SE3_pred @ rel)
                    todo.discard(n)
                if n not in vis:
                    bfs.append(n)
        assert not todo, f"unreachable non-keyframes: {todo}"
        return len(keyframes), len(edges), float(np.mean(diffs)) if diffs else 0.0

    # -------------------------------------------------------- multi-agent
    def repair_coor_sys(self) -> None:
        """Unify coor_sys over connected components, preferring the lowest
        (reference: pose_graph.py:844-864)."""
        not_vis = set(self.vertex.keys())
        while not_vis:
            seed = min((self.get_scanpack(t) for t in not_vis),
                       key=lambda s: s.coor_sys)
            coor = seed.coor_sys
            bfs = [seed.token]
            while bfs:
                tok = bfs.pop()
                if tok not in not_vis:
                    continue
                not_vis.discard(tok)
                s = self.get_scanpack(tok)
                for n in self.get_neighbor_tokens(tok):
                    if n in not_vis:
                        bfs.append(n)
                if s.coor_sys != coor:
                    self.update_scan_token(tok, new_coor_sys=coor)

    def condense(self, base_agent: int,
                 filter_func: Callable[[ScanPack], bool]) -> "PoseGraph":
        """Condensed proxy-edge graph for agent->cloud upload
        (reference: pose_graph.py:735-793): per foreign agent, chain edges
        along the shortest path from that agent's base scan into 'prxy'
        edges."""
        out = PoseGraph(self.args, agent_id=self.agent_id)
        scan_list = [s for s in self.get_all_scans() if filter_func(s)]
        scan_tokens = {s.token for s in scan_list}
        others = [s for s in scan_list if s.agent_id != base_agent]
        agent_ids = {s.agent_id for s in others}

        for s in scan_list:
            out.add_vertex(s.copy())
        base_tokens = {}
        for aid in agent_ids:
            bt = self.base_scan_token(agent_id=aid)
            base_tokens[aid] = bt
            if not out.has_scan(bt):
                out.add_vertex(self.get_scanpack(bt).copy())

        for aid in agent_ids:
            bt = base_tokens[aid]
            for scan in (s for s in others if s.agent_id == aid):
                if scan.token == bt:
                    continue
                path = self._bfs_path(bt, scan.token)
                if path is None:
                    continue
                T = np.eye(4)
                conf = 1.0
                for a, b in zip(path[:-1], path[1:]):
                    e = self.get_edge_either(a, b)
                    rel = e.SE3 if e.src_scan_token == a else se3m.inv(e.SE3)
                    T = T @ rel
                    conf *= (e.confidence if e.confidence is not None else 1.0)
                if out.has_edge(bt, scan.token) or out.has_edge(scan.token, bt):
                    continue
                out.add_edge(PoseGraphEdge(bt, scan.token, T, np.eye(6),
                                           "prxy", confidence=conf))
        for e in self.get_all_edges():
            if (e.src_scan_token in scan_tokens
                    and e.dst_scan_token in scan_tokens
                    and not out.has_edge(e.src_scan_token, e.dst_scan_token)
                    and not out.has_edge(e.dst_scan_token, e.src_scan_token)):
                out.add_edge(e.copy())
        return out

    def _bfs_path(self, src: int, dst: int) -> Optional[List[int]]:
        if src == dst:
            return [src]
        prev: Dict[int, int] = {src: src}
        bfs = [src]
        while bfs:
            tok = bfs.pop(0)
            for n in self.get_neighbor_tokens(tok):
                if n in prev:
                    continue
                prev[n] = tok
                if n == dst:
                    path = [dst]
                    while path[-1] != src:
                        path.append(prev[path[-1]])
                    return path[::-1]
                bfs.append(n)
        return None

    def subgraph(self, filter_func: Callable[[ScanPack], bool]) -> "PoseGraph":
        out = PoseGraph(self.args, agent_id=self.agent_id)
        scans = [s for s in self.get_all_scans() if filter_func(s)]
        toks = {s.token for s in scans}
        for s in scans:
            out.add_vertex(s)
        for e in self.get_all_edges():
            if e.src_scan_token in toks and e.dst_scan_token in toks:
                out.add_edge(e)
        return out

    def to_networkx(self):
        """Export as a networkx.Graph (reference: pose_graph.py:809-819)."""
        import networkx as nx

        g = nx.Graph()
        for s in self.get_all_scans():
            g.add_node(s.token, ntype=s.type, ncoor=s.coor_sys,
                       agentid=s.agent_id, timestep=s.timestep)
        for e in self.get_all_edges():
            g.add_edge(e.src_scan_token, e.dst_scan_token, etype=e.type)
        return g

    def to_g2o_file(self, file_name: str) -> None:
        """g2o export (reference: pose_graph.py:821-842)."""
        from scipy.spatial.transform import Rotation

        with open(file_name, "w+") as f:
            for s in self.get_all_scans():
                R, t = se3m.rt(s.SE3_pred)
                q = Rotation.from_matrix(R).as_quat()
                f.write(f"VERTEX_SE3:QUAT {s.token} {t[0,0]} {t[1,0]} {t[2,0]}"
                        f" {q[0]} {q[1]} {q[2]} {q[3]} \n")
            for e in self.get_all_edges():
                R, t = se3m.rt(e.SE3)
                q = Rotation.from_matrix(R).as_quat()
                i = e.information_mat
                upper = " ".join(
                    str(i[r, c]) for r in range(6) for c in range(r, 6))
                f.write(f"EDGE_SE3:QUAT {e.src_scan_token} {e.dst_scan_token}"
                        f" {t[0,0]} {t[1,0]} {t[2,0]}"
                        f" {q[0]} {q[1]} {q[2]} {q[3]} {upper} \n")

    def __str__(self):
        return (f"PoseGraph with {len(self.vertex)} scans and "
                f"{len(self.edge)} edges, system_id = {self.agent_id}")
