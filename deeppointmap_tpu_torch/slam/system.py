"""SLAM system: the sequential step (port of deeppointmap_tpu/slam/
system.py, `SlamSystem.step`).

Parity with the reference `SlamSystem` (reference: system/core.py:30-423):
candidate search, the fused odometry call, mapping with scan-to-map
refinement, loop closure. The threaded pipeline (`MT_Init` ... ) and the
agent / cloud systems of the JAX package are not ported yet.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Tuple

import numpy as np

from deeppointmap_tpu_torch.config import Config
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.slam.modules import (ExtractionModule,
                                                 LoopClosureModule,
                                                 MappingModule, OdometryModule)
from deeppointmap_tpu_torch.slam.pose_graph import (PoseGraph, PoseGraphEdge,
                                                    ScanPack)
from deeppointmap_tpu_torch.slam.recoder import ResultLogger
from deeppointmap_tpu_torch.slam.utils import EXIT_CODE, CommModule
from deeppointmap_tpu_torch.utils import se3 as se3m

logger = logging.getLogger(__name__)


class SlamSystem:
    def __init__(self, args, engine: InferenceEngine, system_id: int,
                 logger_dir: Optional[str] = None,
                 comm_module: Optional[CommModule] = None):
        self.args = args
        self.system_id = system_id
        self.coor_sys = system_id
        self.system_info = Config({"agent_id": system_id})
        self.engine = engine
        self.frame_id = -1
        self.coor_scale = float(args.slam_system.coor_scale)

        self.posegraph_map = PoseGraph(args=args, agent_id=system_id)
        ss_args = args  # modules read args.slam_system themselves
        self.extraction = ExtractionModule(ss_args, self.system_info,
                                           self.posegraph_map, engine)
        self.odometry = OdometryModule(ss_args, self.system_info,
                                       self.posegraph_map, engine)
        self.mapping = MappingModule(ss_args, self.system_info,
                                     self.posegraph_map, engine)
        self.loop = LoopClosureModule(ss_args, self.system_info,
                                      self.posegraph_map, engine)
        if logger_dir is None:
            logger_dir = args.infer_tgt
        self.result_logger = ResultLogger(args, self.system_info,
                                          self.posegraph_map, logger_dir)
        self.comm_module = comm_module
        if comm_module is not None:
            self.comm_id = system_id
            comm_module.register(self.comm_id)

    # -------------------------------------------------------------- build
    def _make_scan(self, descriptors, desc_valid, point_cloud, pcd_valid,
                   R, T, timestep: Optional[int] = None) -> ScanPack:
        """Assemble a ScanPack (reference: core.py:371-379); full_pcd is
        stored in meters (inputs are normalized unless the engine runs the
        preprocessing on device, in which case they are raw meters).
        `descriptors`/`pcd_valid` may be zero-arg thunks (lazy device
        fetches, engine.odometry_step_async with new_token); a caller that
        needs the scan token before the scan exists passes `timestep`."""
        if timestep is None:
            self.frame_id += 1
            timestep = self.frame_id
        scale = 1.0 if self.engine.preprocess_cfg is not None \
            else self.coor_scale
        return ScanPack(
            timestamp=timestep * 0.1,
            agent_id=self.system_id,
            timestep=timestep,
            key_points=(descriptors if callable(descriptors)
                        else np.asarray(descriptors, np.float32)),
            key_valid=np.asarray(desc_valid, bool),
            full_pcd=np.asarray(point_cloud, np.float32) * scale,
            full_valid=(pcd_valid if callable(pcd_valid)
                        else np.asarray(pcd_valid, bool)),
            coor_sys=self.coor_sys,
            SE3_gt=se3m.se3(R, T) if R is not None else None)

    def _first_scan(self, new_scan: ScanPack) -> None:
        """First scan in the graph (reference: core.py:385-390)."""
        new_scan.SE3_pred = np.eye(4)
        self.posegraph_map.add_vertex(new_scan)
        self.posegraph_map.last_known_anyframe = new_scan.token
        self.posegraph_map.last_known_keyframe = new_scan.token

    def _upload(self, new_scan: ScanPack,
                odom_edge: Optional[PoseGraphEdge]) -> None:
        """Ship scan + edges to the cloud (reference: core.py:411-422)."""
        if self.comm_module is None:
            return
        neighbor_edges = []
        for j in self.posegraph_map.get_neighbor_tokens(new_scan.token):
            if odom_edge is not None and j in (odom_edge.src_scan_token,
                                               odom_edge.dst_scan_token):
                continue
            e = self.posegraph_map.get_edge_either(j, new_scan.token)
            if e is None:
                raise RuntimeError(f"edge {(new_scan.token, j)} not exists")
            neighbor_edges.append(e)
        self.comm_module.send_message(
            self.comm_id, 0, "UPLOAD_SCAN",
            dict(new_scan=new_scan.copy(), odometer_edge=odom_edge,
                 neighbor_edges=neighbor_edges))

    def warmup(self, example: Tuple) -> None:
        """Run the hot path once on an example frame (extract B=1 and
        B=chunk, fused odometry, register+info) so that the kernels are
        built and the libraries initialized before the first real frame."""
        point_cloud, R, T, valid = example[:4]
        point_cloud = np.asarray(point_cloud, np.float32)
        valid = np.asarray(valid, bool)
        if point_cloud.ndim == 2:
            point_cloud, valid = point_cloud[None], valid[None]
        desc, dv, pv = self.engine.extract(point_cloud, valid)
        chunk = self.engine.extract_chunk
        self.engine.extract(np.repeat(point_cloud, chunk, 0),
                            np.repeat(valid, chunk, 0))
        self.engine.odometry_step(point_cloud, valid, desc[0], dv[0],
                                  point_cloud[0], pv[0])
        self.engine.register_with_info(
            desc[0], dv[0], desc[0], dv[0], point_cloud[0], pv[0],
            point_cloud[0], pv[0],
            num_sample=self.args.slam_system.registration_sample_mapping)

    # --------------------------------------------------------- sequential
    def step(self, sensor_data: Tuple) -> EXIT_CODE:
        """One frame through the full pipeline (reference: core.py:360-423).
        sensor_data = (points (1, P, 3) normalized, R, T, valid, original)."""
        point_cloud, R, T, valid = sensor_data[:4]
        point_cloud = np.asarray(point_cloud)
        valid = np.asarray(valid)
        if point_cloud.ndim == 2:
            point_cloud, valid = point_cloud[None], valid[None]

        # candidate search only needs the pose graph, so it runs BEFORE
        # extraction; with one candidate (the default config) extraction +
        # registration + information matrix run as one engine call
        # (engine.odometry_step)
        candidates = self.odometry.search_candidates(
            agent_id=self.system_id)

        perf_t = time.perf_counter()
        if not candidates:
            descriptors, desc_valid, pts_valid = self.extraction.process(
                point_cloud, valid)
            new_scan = self._make_scan(descriptors[0], desc_valid[0],
                                       point_cloud[0], pts_valid[0], R, T)
            self.result_logger.record_perf("extract",
                                           time.perf_counter() - perf_t)
            self._first_scan(new_scan)
            self._upload(new_scan, None)
            return EXIT_CODE.acpt

        cand = candidates[0]
        desc, dvalid, pts_valid, SE3, conf, rmse, info = \
            self.engine.odometry_step(
                point_cloud, valid, cand.key_points, cand.key_valid,
                cand.full_pcd, cand.full_valid,
                num_sample=self.args.slam_system.registration_sample_odometer,
                cand_token=cand.token)
        new_scan = self._make_scan(desc[0], dvalid[0],
                                   point_cloud[0], pts_valid[0], R, T)
        self.result_logger.record_perf("extract", time.perf_counter() - perf_t)

        perf_t = time.perf_counter()
        odom_edge = PoseGraphEdge(
            src_scan_token=cand.token, dst_scan_token=new_scan.token,
            SE3=se3m.inv(SE3), information_mat=info, type="odom",
            confidence=conf, rmse=rmse)
        # extra candidates (odometer_candidates_num > 1): one batched
        # device call for all of them (their edges are discarded for
        # parity with the reference, which also only uses odom_edges[0]
        # -- core.py:214 "Assert odometry edge contains only one edge")
        if len(candidates) > 1:
            self.odometry.odometry(new_scan, candidates[1:])
        self.result_logger.record_perf("odometer", time.perf_counter() - perf_t)

        perf_t = time.perf_counter()
        result = self.mapping.process(new_scan, odom_edge)
        self.result_logger.record_perf("mapping", time.perf_counter() - perf_t)
        if isinstance(result, EXIT_CODE):
            return result

        perf_t = time.perf_counter()
        self.loop.process(new_scan, targets="self")
        self.posegraph_map.last_known_anyframe = new_scan.token
        self.result_logger.record_perf("loop_closure",
                                       time.perf_counter() - perf_t)

        self._upload(new_scan, odom_edge)
        return EXIT_CODE.acpt
