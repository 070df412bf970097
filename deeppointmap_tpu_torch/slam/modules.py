"""SLAM modules: extraction, odometry, mapping/keyframing, loop closure
(port of deeppointmap_tpu/slam/modules.py).

Host-side control flow with NumPy poses (float64) around the
InferenceEngine, mirroring the reference threads:
  Extraction  -- reference: system/modules/odometry.py:17-54
  Odometry    -- reference: system/modules/odometry.py:57-136
  Mapping     -- reference: system/modules/mapping.py:14-217
  LoopClosure -- reference: system/modules/loop_closure.py:15-307
"""

from __future__ import annotations

import logging
import math
from typing import List, Literal, Tuple, Union

import numpy as np

from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.slam.pose_graph import (PoseGraph, PoseGraphEdge,
                                                    ScanPack)
from deeppointmap_tpu_torch.slam.utils import EXIT_CODE
from deeppointmap_tpu_torch.utils import se3 as se3m

logger = logging.getLogger(__name__)


def map_members(pg: PoseGraph, center: ScanPack, coor_sys: int,
                exclude=(), neighbor_level: int = 5,
                max_dist: float = 20.0) -> List[ScanPack]:
    """Keyframes of the local map around `center` -- the member set behind
    global_map_query_graph (reference: pose_graph.py:471-511), returned as
    ScanPacks so the engine can assemble the tile ON DEVICE from cached
    per-scan descriptors instead of the host building + uploading a ~2 MB
    tile."""
    c_t = center.SE3_pred[:3, 3]
    return [s for s in pg.graph_search(center.token, neighbor_level,
                                       coor_sys,
                                       edge_type=["odom", "loop"])
            if s.type != "non-keyframe" and s.token not in exclude
            and np.linalg.norm(s.SE3_pred[:3, 3] - c_t) < max_dist]


def _member_tuples(scans: List[ScanPack]):
    return [(s.token, s.key_points_ref(), s.key_valid, s.SE3_pred)
            for s in scans]


class ExtractionModule:
    """Scan -> descriptors (reference: odometry.py:17-54). The encoder call
    and the coor_scale re-scaling live in InferenceEngine.extract."""

    def __init__(self, args, system_info, posegraph_map: PoseGraph,
                 engine: InferenceEngine):
        self.args = args
        self.system_info = system_info
        self.posegraph_map = posegraph_map
        self.engine = engine

    def process(self, points: np.ndarray, valid: np.ndarray):
        """points (B, P, 3) -> (descriptors (B, K, C+3), desc validity,
        filtered point validity)."""
        return self.engine.extract(points, valid)


class OdometryModule:
    """Candidate search + pairwise registration
    (reference: odometry.py:57-136)."""

    def __init__(self, args, system_info, posegraph_map: PoseGraph,
                 engine: InferenceEngine):
        self.args = args
        self.system_info = system_info
        self.posegraph_map = posegraph_map
        self.engine = engine

    def search_candidates(self, new_scan=None, agent_id: int = None,
                          predicted_SE3=None) -> List[ScanPack]:
        """Graph-BFS keyframes near the last pose, top-k by distance
        (reference: odometry.py:76-101). Depends only on the pose graph,
        NOT on the new scan's content, so it can run before extraction
        (enabling the fused extract+register device call).

        `predicted_SE3`: the pipelined odometer's constant-velocity
        extrapolation of where the NEW scan is -- under pipelining the
        graph pose is several frames stale, and ranking candidates by the
        stale pose picks keyframes the new scan may barely overlap."""
        if agent_id is None:
            agent_id = new_scan.agent_id
        pg = self.posegraph_map
        agents = {s.agent_id for s in pg.get_all_scans()}
        if (not pg.vertex or agent_id not in agents
                or pg.last_known_keyframe is None
                or pg.last_known_anyframe is None):
            return []
        last_scan = pg.get_scanpack(pg.last_known_keyframe)
        last_SE3 = (predicted_SE3 if predicted_SE3 is not None
                    else pg.get_scanpack(pg.last_known_anyframe).SE3_pred)

        key_frames = [s for s in pg.graph_search(
            last_scan.token, neighbor_level=5, coor_sys=last_scan.coor_sys,
            edge_type=["odom", "loop"])
            if s.type != "non-keyframe" and s.agent_id == agent_id]
        if not key_frames:
            return []
        d = np.array([np.linalg.norm(s.SE3_pred[:3, 3] - last_SE3[:3, 3])
                      for s in key_frames])
        k = min(len(key_frames), self.args.slam_system.odometer_candidates_num)
        idx = np.argsort(d)[:k]
        if d.min() > 20:
            logger.warning("The nearest key-frame seems too far (%.3f m)",
                           d.min())
        return [key_frames[i] for i in idx]

    def dispatch(self, new_scan: ScanPack,
                 candidates: List[ScanPack]) -> list:
        """Dispatch registration against each candidate without waiting;
        returns per-candidate resolvers (see
        InferenceEngine.register_with_info_async).

        Two or more candidates go through ONE bucketed vmapped device
        program (engine.register_with_info_multi_async): the per-candidate
        registration program runs at ~2.8% MFU, so K candidates batched
        cost roughly one dispatch instead of K dispatch+fetch round-trips
        (the reference pays the K-times cost -- odometry.py:103-127 loops
        registration_forward per candidate)."""
        ss = self.args.slam_system
        if len(candidates) > 1:
            return self.engine.register_with_info_multi_async(
                [(c.key_points, c.key_valid, c.full_pcd, c.full_valid,
                  c.token) for c in candidates],
                new_scan.key_points, new_scan.key_valid,
                new_scan.full_pcd, new_scan.full_valid,
                num_sample=ss.registration_sample_odometer,
                dst_token=new_scan.token)
        return [self.engine.register_with_info_async(
            cand.key_points, cand.key_valid,
            new_scan.key_points, new_scan.key_valid,
            cand.full_pcd, cand.full_valid,
            new_scan.full_pcd, new_scan.full_valid,
            num_sample=ss.registration_sample_odometer,
            src_token=cand.token, dst_token=new_scan.token)
            for cand in candidates]

    def resolve(self, new_scan: ScanPack, candidates: List[ScanPack],
                resolvers: list) -> List[PoseGraphEdge]:
        """Fetch dispatched registrations and build odom edges with
        information matrices (reference: odometry.py:103-127)."""
        edges = []
        for cand, res in zip(candidates, resolvers):
            SE3, conf, rmse, info = res()
            edges.append(PoseGraphEdge(
                src_scan_token=cand.token, dst_scan_token=new_scan.token,
                SE3=se3m.inv(SE3), information_mat=info, type="odom",
                confidence=conf, rmse=rmse))
        return edges

    def odometry(self, new_scan: ScanPack, candidates: List[ScanPack]
                 ) -> List[PoseGraphEdge]:
        """Register new scan against each candidate; build odom edges with
        information matrices (reference: odometry.py:103-127)."""
        return self.resolve(new_scan, candidates,
                            self.dispatch(new_scan, candidates))

    def process(self, new_scan: ScanPack) -> List[PoseGraphEdge]:
        return self.odometry(new_scan, self.search_candidates(new_scan))


class MappingModule:
    """Edge quality gating, adaptive keyframing, scan-to-map refinement
    (reference: mapping.py:14-217)."""

    def __init__(self, args, system_info, posegraph_map: PoseGraph,
                 engine: InferenceEngine):
        self.args = args
        self.ss = args.slam_system
        self.system_info = system_info
        self.posegraph_map = posegraph_map
        self.engine = engine

        self.dist_ratio = 1.0
        # long-stream memory bound: non-keyframes are the unbounded node
        # class and their stored full_pcd (~196 KB each) is only read by
        # the final map render/save. False caps pose-graph memory at
        # O(keyframes) (scale run, BASELINE.md).
        self.retain_nonkeyframe_pcd = bool(
            (args.get("tpu") or {}).get("retain_nonkeyframe_pcd", True))
        if self.ss.key_frame_distance == "auto":
            self.dist_auto_adjust = True
            self.key_frame_distance_0 = self.ss.get("key_frame_distance_0", 3.0)
            self.current_key_frame_distance = \
                self.key_frame_distance_0 * self.dist_ratio
        else:
            self.dist_auto_adjust = False
            self.key_frame_distance_0 = self.ss.key_frame_distance
            self.current_key_frame_distance = self.key_frame_distance_0
        self.drop_scans_bag: List[Tuple[ScanPack, PoseGraphEdge]] = []

    def valid_check(self, new_scan: ScanPack, edge: PoseGraphEdge):
        """Drop/recover/break gate (reference: mapping.py:52-81).
        Returns (EXIT_CODE, scan, edge) -- recover swaps in the best
        dropped scan."""
        ss = self.ss
        if (edge.confidence < ss.edge_confidence_drop
                or edge.rmse > ss.edge_rmse_drop):
            self.drop_scans_bag.append((new_scan, edge))
            if len(self.drop_scans_bag) >= ss.max_continuous_drop_scan:
                if ss.continuous_drop_scan_strategy == "recover":
                    # the reference logs the lowest-rmse bagged scan but
                    # proceeds with the CURRENT one (mapping.py:61-64
                    # rebinds locals only); keep that exact behavior
                    best_scan, best_edge = min(self.drop_scans_bag,
                                               key=lambda x: x[1].rmse)
                    self.drop_scans_bag.clear()
                    logger.info("Too many dropped scans, recover: best in "
                                "bag was %s (rmse %.4f); accepting current "
                                "%s", best_scan.token, best_edge.rmse,
                                new_scan.token)
                    return EXIT_CODE.acpt, new_scan, edge
                elif ss.continuous_drop_scan_strategy == "break":
                    old = self.posegraph_map.get_scanpack(
                        self.posegraph_map.last_known_anyframe)
                    new_scan.SE3_pred = old.SE3_pred.copy()
                    new_scan.coor_sys = old.coor_sys
                    self.posegraph_map.add_vertex(new_scan)
                    self.posegraph_map.last_known_keyframe = new_scan.token
                    self.posegraph_map.last_known_anyframe = new_scan.token
                    self.drop_scans_bag.clear()
                    logger.info("Too many dropped scans, break posegraph %s",
                                new_scan.token)
                    return EXIT_CODE.acpt, new_scan, edge
                raise ValueError(ss.continuous_drop_scan_strategy)
            return EXIT_CODE.drop, new_scan, edge
        self.drop_scans_bag.clear()
        return EXIT_CODE.acpt, new_scan, edge

    def keyframe_check(self, new_scan: ScanPack, edge: PoseGraphEdge):
        """Adaptive keyframe distance EMA + distance gate
        (reference: mapping.py:83-134)."""
        ss = self.ss
        if self.dist_auto_adjust:
            m = 0.90
            rmse_ratio = min(edge.rmse / ss.edge_rmse_drop, 1.0)
            this_ratio = ((1.0 - rmse_ratio) ** 2) * 2.0
            self.dist_ratio = max(
                min(m * self.dist_ratio + (1 - m) * this_ratio, 2.0), 0.0)
            self.current_key_frame_distance = max(
                self.key_frame_distance_0 * self.dist_ratio, 1.0)

        old_scan = self.posegraph_map.get_scanpack(edge.src_scan_token)
        assert new_scan.token == edge.dst_scan_token
        new_scan.SE3_pred = old_scan.SE3_pred @ edge.SE3
        new_scan.coor_sys = old_scan.coor_sys
        assert old_scan.type != "non-keyframe"
        self.posegraph_map.last_known_keyframe = old_scan.token

        if self.current_key_frame_distance >= 0:
            nearby = [s for s in self.posegraph_map.graph_search(
                old_scan.token, neighbor_level=5, coor_sys=new_scan.coor_sys,
                edge_type=["odom", "loop"]) if s.type != "non-keyframe"]
            d = min(np.linalg.norm(s.SE3_pred[:3, 3] - new_scan.SE3_pred[:3, 3])
                    for s in nearby)
            if d < self.current_key_frame_distance:
                return EXIT_CODE.dist
        return EXIT_CODE.acpt

    def scan_to_map_adjustment(self, edge: PoseGraphEdge) -> PoseGraphEdge:
        """Re-register the new scan against the local descriptor map
        (reference: mapping.py:136-170)."""
        if not self.ss.enable_s2m_adjust:
            return edge
        pg = self.posegraph_map
        src_old = pg.get_scanpack(edge.src_scan_token)
        dst_new = pg.get_scanpack(edge.dst_scan_token)
        # tile assembled on the device from cached per-scan descriptors
        # (the scan's own descriptors excluded, as in the reference)
        scans = map_members(pg, src_old, src_old.coor_sys,
                            exclude=(dst_new.token,))
        if not scans:
            return edge
        SE3, conf, rmse, info = \
            self.engine.register_scan_to_map_with_info_async(
                _member_tuples(scans), src_old.SE3_pred,
                dst_new.key_points_ref(), dst_new.key_valid,
                src_old.full_pcd, src_old.full_valid_ref(),
                dst_new.full_pcd, dst_new.full_valid_ref(),
                num_sample=self.ss.registration_sample_mapping,
                src_token=src_old.token, dst_token=dst_new.token)()
        return PoseGraphEdge(edge.src_scan_token, edge.dst_scan_token,
                             se3m.inv(SE3), info, "odom",
                             confidence=conf, rmse=rmse)

    def process(self, new_scan: ScanPack, odom_edge: PoseGraphEdge
                ) -> Union[EXIT_CODE, PoseGraphEdge]:
        """Full mapping step (reference: mapping.py:172-217)."""
        pg = self.posegraph_map
        result, new_scan, odom_edge = self.valid_check(new_scan, odom_edge)
        if result != EXIT_CODE.acpt:
            return result
        if pg.has_scan(new_scan.token):
            # 'break' strategy already added the vertex
            return EXIT_CODE.acpt
        pg.last_known_keyframe = odom_edge.src_scan_token

        result = self.keyframe_check(new_scan, odom_edge)
        if result != EXIT_CODE.acpt:
            pg.add_vertex(new_scan.nonkeyframe(
                drop_full_pcd=not self.retain_nonkeyframe_pcd))
            pg.last_known_anyframe = new_scan.token
            odom_edge.type = "locz"
            pg.add_edge(odom_edge)
            return result

        pg.add_vertex(new_scan.copy())
        pg.last_known_anyframe = new_scan.token
        pg.last_known_keyframe = new_scan.token
        odom_edge.type = "odom"
        pg.add_edge(odom_edge)

        adjusted = self.scan_to_map_adjustment(odom_edge)
        if (adjusted.rmse <= self.ss.edge_rmse_drop
                or adjusted.rmse <= odom_edge.rmse):
            src_old = pg.get_scanpack(adjusted.src_scan_token)
            new_SE3 = src_old.SE3_pred @ adjusted.SE3
            pg.update_scan_token(new_scan.token, new_SE3_pred=new_SE3)
            pg.update_edge_token(odom_edge.src_scan_token,
                                 odom_edge.dst_scan_token,
                                 new_SE3=adjusted.SE3,
                                 new_confidence=adjusted.confidence,
                                 new_information_mat=adjusted.information_mat,
                                 new_rmse=adjusted.rmse)
        return adjusted


class LoopClosureModule:
    """Loop detection + map-vs-map registration + statistical verification
    + global optimization trigger (reference: loop_closure.py:15-307)."""

    TRANS_STD = 0.4
    ROT_STD = 0.5

    def __init__(self, args, system_info, posegraph_map: PoseGraph,
                 engine: InferenceEngine):
        self.args = args
        self.ss = args.slam_system
        self.system_info = system_info
        self.posegraph_map = posegraph_map
        self.engine = engine
        self.last_loop_pose_num = -self.ss.loop_detection_gap - 1
        self.last_optim_pose_num = -self.ss.global_optimization_gap - 1
        self.last_loop_token = -1
        self.required_optim = False
        # beyond-reference: `loop_detection_attempt_gap` (keyframes)
        # rate-limits ALL loop attempts, not just post-success ones --
        # the reference's loop_detection_gap only arms after a VALIDATED
        # loop (loop_closure.py:57,68), so failed attempts (scoring +
        # map-vs-map registration) can run every frame and, on a single
        # chip, serialize against the odometer. Default 0 = reference
        # behavior.
        self.attempt_gap = int(self.ss.get("loop_detection_attempt_gap", 0))
        self.last_attempt_pose_num = -self.attempt_gap - 1
        # gate-by-gate observability (scale_run / bench print these):
        # counts where candidates die between "keyframe exists" and
        # "verified loop edge", plus the best score ever seen so a
        # too-high prob threshold is visible even at 0 edges
        self.stats = {
            "attempts": 0, "candidates": 0, "after_distance": 0,
            "after_trust": 0, "scored_pass_prob": 0, "registered": 0,
            "verified": 0, "best_prob": 0.0, "rej_confidence": 0,
            "rej_sigma_trans": 0, "rej_sigma_rot": 0,
        }
        #: (confidence, rmse) of the most recent registered loop edges,
        #: BEFORE verification -- shows how far rejects sit from the
        #: acceptance gates
        self.recent_edges: List[Tuple[float, float]] = []

    def process(self, new_scan: ScanPack,
                targets: Literal["self", "others", "all"] = "all"):
        pg = self.posegraph_map
        assert pg.has_scan(new_scan.token)
        ss = self.ss
        if not ss.enable_loop_closure:
            return []
        if pg.key_frame_num - self.last_loop_pose_num <= ss.loop_detection_gap:
            return []
        if self.attempt_gap > 0:     # 0 = reference: attempt every call
            if (pg.key_frame_num - self.last_attempt_pose_num
                    <= self.attempt_gap):
                return []
            self.last_attempt_pose_num = pg.key_frame_num
        self.stats["attempts"] += 1
        candidates = self.loop_closure_detection(new_scan, targets)
        edges = self.loop_closure_registration(new_scan, candidates)
        self.stats["registered"] += len(edges)
        for e in edges:
            self.recent_edges.append((float(e.confidence), float(e.rmse)))
        del self.recent_edges[:-50]
        validated = self.loop_closure_verification(edges)
        self.stats["verified"] += len(validated)
        if validated:
            self.required_optim = True
            for e in validated:
                pg.add_edge(e)
            self.last_loop_pose_num = pg.key_frame_num
            self.last_loop_token = new_scan.token
            self.global_optimization(forced=False)
            if targets in ("all", "others"):
                pg.repair_coor_sys()
        return validated

    def loop_closure_detection(self, new_scan: ScanPack,
                               targets: str = "all") -> List[ScanPack]:
        """Candidate filter + batched loop scoring
        (reference: loop_closure.py:90-183)."""
        pg = self.posegraph_map
        ss = self.ss
        # O(keyframes) via the incremental index (rebuilding from
        # get_all_scans() is O(total frames) per event -- quadratic
        # aggregate over a long stream). key_points_ref: presence check
        # must not materialize lazy device thunks.
        cands = [s for s in pg.get_keyframes()
                 if s.key_points_ref() is not None]
        if targets == "self":
            cands = [s for s in cands if s.agent_id == new_scan.agent_id]
        elif targets == "others":
            cands = [s for s in cands if s.agent_id != new_scan.agent_id]
        elif targets != "all":
            raise RuntimeError(f"unknown targets: {targets}")
        self.stats["candidates"] += len(cands)
        if not cands:
            return []

        trust1 = {s.token for s in pg.graph_search(
            new_scan.token, ss.loop_detection_trust_range - 1,
            new_scan.coor_sys, edge_type=["odom", "loop"], max_k=None)}
        trust2 = {s.token for s in pg.graph_search(
            new_scan.token, int(ss.loop_detection_trust_range * 10),
            new_scan.coor_sys, edge_type=["odom", "loop"], max_k=None)}

        mask = np.ones(len(cands), bool)
        if ss.loop_detection_gnss_distance > 0:
            d = np.array([np.linalg.norm(
                (s.gps_position - new_scan.gps_position)[:2]) for s in cands])
            mask &= d <= ss.loop_detection_gnss_distance
        if ss.loop_detection_pred_distance > 0:
            d = np.array([np.linalg.norm(
                (s.SE3_pred - new_scan.SE3_pred)[:2, 3]) for s in cands])
            diff_sys = np.array([s.coor_sys != new_scan.coor_sys
                                 for s in cands])
            mask &= (d <= ss.loop_detection_pred_distance) | diff_sys
        cands = [c for c, m in zip(cands, mask) if m]
        self.stats["after_distance"] += len(cands)
        if not cands:
            return []

        valid = []
        for prev in cands:
            if prev.token in trust1 or prev is new_scan:
                continue
            if prev.agent_id == new_scan.agent_id and prev.token in trust2:
                delta = se3m.inv(prev.SE3_pred) @ new_scan.SE3_pred
                dR, dT = se3m.rt(delta)
                if (se3m.rotation_angle(dR) * 180 / math.pi
                        < ss.loop_detection_rotation_min
                        or np.linalg.norm(dT)
                        < ss.loop_detection_translation_min):
                    continue
                if self.last_loop_token != -1:
                    last = pg.get_scanpack(self.last_loop_token).SE3_pred
                    _, gap = se3m.rt(se3m.inv(last) @ new_scan.SE3_pred)
                    if np.linalg.norm(gap) < ss.loop_detection_transaction_gap:
                        continue
            valid.append(prev)
        self.stats["after_trust"] += len(valid)
        if not valid:
            return []

        # candidate descriptors stay on the device (token cache)
        probs = self.engine.loop_scores_by_token(
            [(s.token, s.key_points_ref(), s.key_valid) for s in valid],
            new_scan.key_points_ref(), new_scan.key_valid,
            new_token=new_scan.token)

        self.stats["best_prob"] = max(self.stats["best_prob"],
                                      float(np.max(probs)))
        k = min(ss.loop_detection_candidates_num, len(valid))
        top = np.argsort(probs)[::-1][:k]
        picked = [valid[i] for i in top
                  if probs[i] > ss.loop_detection_prob_acpt_threshold]
        self.stats["scored_pass_prob"] += len(picked)
        return picked

    def loop_closure_registration(self, new_scan: ScanPack,
                                  scan_list: List[ScanPack]
                                  ) -> List[PoseGraphEdge]:
        """Map-vs-map registration with overlap de-dup
        (reference: loop_closure.py:185-258)."""
        pg = self.posegraph_map
        ss = self.ss
        edges = []
        for prev in scan_list:
            e = self._register_pair_device(pg, ss, prev, new_scan)
            if e is not None:
                edges.append(e)
        return edges

    def _register_pair_device(self, pg, ss, prev: ScanPack,
                              new_scan: ScanPack):
        """Map-vs-map registration with BOTH tiles assembled on device
        (scan-level overlap de-dup applied to the member lists)."""
        prev_scans = map_members(pg, prev, prev.coor_sys)
        new_scans = map_members(pg, new_scan, new_scan.coor_sys)
        overlap = ({s.token for s in prev_scans}
                   & {s.token for s in new_scans})
        if overlap:
            src_t = prev.SE3_pred[:3, 3]
            dst_t = new_scan.SE3_pred[:3, 3]
            drop_prev, drop_new = set(), set()
            for tok in overlap:
                t = pg.get_scanpack(tok).SE3_pred[:3, 3]
                if (np.linalg.norm(t - src_t)
                        < np.linalg.norm(t - dst_t)):
                    drop_new.add(tok)
                else:
                    drop_prev.add(tok)
            prev_scans = [s for s in prev_scans
                          if s.token not in drop_prev]
            new_scans = [s for s in new_scans if s.token not in drop_new]
        assert not ({s.token for s in prev_scans}
                    & {s.token for s in new_scans})
        if not prev_scans or not new_scans:
            return None
        SE3, conf, rmse, info = \
            self.engine.register_map_to_map_with_info_async(
                _member_tuples(prev_scans), prev.SE3_pred,
                _member_tuples(new_scans), new_scan.SE3_pred,
                prev.full_pcd, prev.full_valid_ref(),
                new_scan.full_pcd, new_scan.full_valid_ref(),
                num_sample=ss.registration_sample_loop,
                src_token=prev.token, dst_token=new_scan.token)()
        return PoseGraphEdge(prev.token, new_scan.token, se3m.inv(SE3),
                             info, "loop", confidence=conf, rmse=rmse)

    def loop_closure_verification(self, edge_list: List[PoseGraphEdge]
                                  ) -> List[PoseGraphEdge]:
        """Statistical check vs graph-path uncertainty
        (reference: loop_closure.py:260-292)."""
        pg = self.posegraph_map
        out = []
        for e in edge_list:
            if e.confidence < self.ss.loop_detection_confidence_acpt_threshold:
                self.stats["rej_confidence"] += 1
                continue
            dist = pg.shortest_path_length(e.src_scan_token, e.dst_scan_token,
                                           edge_type=["odom", "loop"],
                                           infinity_length=5000)
            if dist < 5000:
                src = pg.get_scanpack(e.src_scan_token)
                dst = pg.get_scanpack(e.dst_scan_token)
                delta = se3m.inv(src.SE3_pred @ e.SE3) @ dst.SE3_pred
                dR, dT = se3m.rt(delta)
                sq = math.sqrt(max(dist, 1))
                if (np.linalg.norm(dT) / (self.TRANS_STD * sq) > 3
                        and dist < 100):
                    self.stats["rej_sigma_trans"] += 1
                    continue
                if (se3m.rotation_angle(dR) * 180 / math.pi
                        / (self.ROT_STD * sq) > 3):
                    self.stats["rej_sigma_rot"] += 1
                    continue
            out.append(e)
        return out

    def global_optimization(self, forced=False):
        """Trigger the pose-graph backend
        (reference: loop_closure.py:294-307)."""
        ss = self.ss
        if not ss.enable_loop_closure:
            return False
        if not forced and not ss.enable_global_optimization:
            return False
        if (not forced and self.posegraph_map.key_frame_num
                - self.last_optim_pose_num < ss.global_optimization_gap):
            return False
        if not forced and not self.required_optim:
            return False
        result = self.posegraph_map.optim()
        self.last_optim_pose_num = self.posegraph_map.key_frame_num
        self.required_optim = False
        return result
