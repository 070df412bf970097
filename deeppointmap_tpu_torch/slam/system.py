"""SLAM system: the sequential step and the pipelined mode (port of
deeppointmap_tpu/slam/system.py, `SlamSystem`).

Parity with the reference `SlamSystem` (reference: system/core.py:30-423):
candidate search, the fused odometry call, mapping with scan-to-map
refinement, loop closure. The pipelined mode (`MT_Init` ... `MT_Wait`)
keeps the JAX package's stage layout around one engine: to-device ->
odometer (fused extraction + registration, up to
`tpu.odometer_pipeline_depth` frames in flight) -> mapping (resolves the
odometer's results, depth-1 queue) -> backend (loop closure) -> output,
each a host thread. A stage thread runs its torch calls under
`torch.inference_mode()` (which is per thread) with the engine's device
current.

The multi-agent systems (reference: core.py:426-546) sit on top:
`AgentSystem` is a SlamSystem fed from a dataloader on a thread of its own
that uploads each accepted scan to the cloud; `CloudSystem` consumes the
uploads on its own thread, merges the agents' graphs into one `uncertain`
graph and closes loops across agents. All of them may share one engine:
its device cache is keyed by scan token (agent id << 16 | timestep) and
locked, and each thread runs with the engine's device current. An error
on either thread is re-raised by `wait`.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

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
    MAX_CAP_QUEUE = 50

    def __init__(self, args, engine: InferenceEngine, system_id: int,
                 logger_dir: Optional[str] = None,
                 comm_module: Optional[CommModule] = None):
        self.args = args
        self.system_id = system_id
        self.coor_sys = system_id
        self.system_info = Config({"agent_id": system_id})
        self.engine = engine
        self.frame_id = -1
        # last two resolved (timestep, SE3_pred): the pipelined odometer
        # extrapolates a constant-velocity pose from them for candidate
        # search (the graph pose is in-flight-depth frames stale); written
        # by the mapping stage, read by the odometer
        self._recent_poses = deque(maxlen=2)
        self.coor_scale = float(args.slam_system.coor_scale)
        # mapping-progress handshake of the staleness fallback: when the
        # platform speed x the in-flight depth approaches the keyframe
        # distance, the odometer waits for mapping to drain so that
        # candidate search sees a current graph
        self._map_progress = threading.Condition()
        self._mapped_count = 0
        self._staleness_active = False
        self._staleness_events = 0   # ON transitions

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

    # ----------------------------------------------------------- pipeline
    def MT_Init(self) -> None:
        """Start the pipelined mode (reference: core.py:82-109), in the
        JAX package's stage layout: extraction and registration run fused
        in the odometer stage (one engine call a frame), and their results
        are resolved on the mapping thread."""
        # bounded ingest: MT_Step blocks once MAX_CAP_QUEUE frames are
        # buffered, so a fast producer cannot run far ahead of the
        # odometer; a crashed stage keeps draining its input until EXIT
        self._q_in = queue.Queue(maxsize=self.MAX_CAP_QUEUE)
        self._q_pre_odo = queue.Queue(maxsize=self.MAX_CAP_QUEUE)
        self._q_odo_map = queue.Queue(maxsize=1)   # backpressure
        self._q_map_bak = queue.Queue(maxsize=self.MAX_CAP_QUEUE)
        self._q_bak_out = queue.Queue(maxsize=self.MAX_CAP_QUEUE)
        self._mt_errors: List = []
        self._mapped_count = 0          # matches the odometer's `sent`
        self._staleness_active = False
        stages = [
            ("todevice", self._mt_todevice, (self._q_in, self._q_pre_odo),
             self._q_pre_odo),
            ("odometer", self._mt_odometer, (self._q_pre_odo,
                                             self._q_odo_map),
             self._q_odo_map),
            ("mapping", self._mt_mapping, (self._q_odo_map,
                                           self._q_map_bak),
             self._q_map_bak),
            ("backend", self._mt_backend, (self._q_map_bak,
                                           self._q_bak_out),
             self._q_bak_out),
            ("output", self._mt_output, (self._q_bak_out,), None),
        ]
        self._threads = [
            threading.Thread(target=self._mt_stage_guard,
                             args=(name, fn, fn_args, q_next),
                             name=f"mt-{name}", daemon=True)
            for name, fn, fn_args, q_next in stages]
        for t in self._threads:
            t.start()

    def _mt_stage_guard(self, name, fn, fn_args, q_next) -> None:
        """Fail-fast wrapper around a stage: an uncaught exception would
        leave the pipeline blocked (downstream starves on its queue,
        upstream blocks on this stage's full input queue). On failure the
        error is recorded, EXIT flows downstream, the dead stage's input
        keeps draining so that upstream can finish, and MT_Wait raises."""
        try:
            device = self.engine.device
            if device.type == "cuda":
                torch.cuda.set_device(device)
            with torch.inference_mode():
                fn(*fn_args)
        except Exception as e:                       # noqa: BLE001
            logger.exception("MT stage %r crashed", name)
            self._mt_errors.append((name, e))
            if q_next is not None:
                q_next.put(EXIT_CODE.exit)
            q_in = fn_args[0]
            while True:                      # swallow until upstream EXIT
                item = q_in.get()
                if isinstance(item, EXIT_CODE) and item == EXIT_CODE.exit:
                    break

    def MT_Step(self, sensor_data) -> None:
        self._q_in.put(sensor_data)

    def MT_Done(self) -> None:
        self._q_in.put(EXIT_CODE.exit)

    def MT_Wait(self) -> None:
        for t in self._threads:
            t.join()
        if self._mt_errors:
            name, err = self._mt_errors[0]
            raise RuntimeError(
                f"MT stage {name!r} failed: {err!r}") from err

    def _mt_todevice(self, q_in, q_out):
        while True:
            item = q_in.get()
            if isinstance(item, EXIT_CODE):
                q_out.put(item)
                if item == EXIT_CODE.exit:
                    break
                continue
            perf_t = time.perf_counter()
            point_cloud, R, T, valid = item[:4]
            point_cloud = np.asarray(point_cloud, np.float32)
            valid = np.asarray(valid, bool)
            if point_cloud.ndim == 2:
                point_cloud, valid = point_cloud[None], valid[None]
            # the scan's upload starts on this thread (pinned memory, the
            # engine's upload stream), not inside the odometer's dispatch
            pc_dev, v_dev = self.engine.upload_scan(point_cloud, valid)
            self.result_logger.record_perf("to_device",
                                           time.perf_counter() - perf_t)
            q_out.put((point_cloud, R, T, valid, pc_dev, v_dev))

    def _mt_odometer(self, q_in, q_out):
        """Fused extraction + registration with up to
        `tpu.odometer_pipeline_depth` frames launched before the oldest
        result is handed on. Candidate search therefore sees the pose
        graph up to `depth` frames staler than in sequential mode (the
        reference's queued threads have the same class of staleness,
        core.py:82-358); the staleness fallback serializes against mapping
        when that staleness nears the keyframe distance."""
        ss = self.args.slam_system
        tpu_cfg = self.args.get("tpu") or {}
        depth = int(tpu_cfg.get("odometer_pipeline_depth", 1))
        fb_on = bool(tpu_cfg.get("staleness_fallback", True))
        fb_frac = float(tpu_cfg.get("staleness_fallback_frac", 0.9))
        sent = 0       # frames handed downstream (matched by _mapped_count)
        pending = []  # FIFO of (resolver, pc, R, T, cand, extras, ts, perf_t)

        def flush():
            """Hand the unresolved bundle downstream: the MAPPING stage
            calls the resolver, so waiting for the results never blocks
            this thread's launches."""
            nonlocal sent
            bundle = pending.pop(0)
            sent += 1
            self.result_logger.record_perf("odometer",
                                           time.perf_counter() - bundle[-1])
            q_out.put(("bundle", bundle))

        while True:
            item = q_in.get()
            if isinstance(item, EXIT_CODE):
                while pending:
                    flush()
                q_out.put(item)
                if item == EXIT_CODE.exit:
                    break
                continue
            point_cloud, R, T, valid = item[:4]
            pc_dev, v_dev = item[4:6] if len(item) > 4 else (point_cloud,
                                                             valid)
            perf_t = time.perf_counter()
            if fb_on and self._update_staleness_mode(depth, fb_frac):
                # sequential ordering: drain the frames in flight and wait
                # for mapping to catch up, so that candidate search reads
                # a current pose graph
                while pending:
                    flush()
                with self._map_progress:
                    self._map_progress.wait_for(
                        lambda: self._mapped_count >= sent, timeout=30.0)
            candidates = self.odometry.search_candidates(
                agent_id=self.system_id,
                predicted_SE3=self._predict_pose(self.frame_id + 1))
            if not candidates:
                while pending:
                    flush()
                descriptors, desc_valid, pts_valid = self.extraction.process(
                    pc_dev, v_dev)
                new_scan = self._make_scan(descriptors[0], desc_valid[0],
                                           point_cloud[0], pts_valid[0],
                                           R, T)
                self.result_logger.record_perf(
                    "extract", time.perf_counter() - perf_t)
                self._first_scan(new_scan)
                self._upload(new_scan, None)
                continue
            cand = candidates[0]
            # the scan's token is assigned now, so that the engine caches
            # the new scan's tensors under it at launch time
            self.frame_id += 1
            ts = self.frame_id
            resolver = self.engine.odometry_step_async(
                pc_dev, v_dev, cand.key_points_ref(), cand.key_valid,
                cand.full_pcd, cand.full_valid_ref(),
                num_sample=ss.registration_sample_odometer,
                cand_token=cand.token,
                new_token=(self.system_id << 16) + ts)
            pending.append((resolver, point_cloud, R, T, cand,
                            candidates[1:], ts, perf_t))
            while len(pending) > depth:
                flush()

    def _platform_speed(self):
        """Meters of translation per frame, from the last two
        mapping-resolved poses (None until two frames are resolved)."""
        rp = list(self._recent_poses)
        if len(rp) < 2:
            return None
        (t1, P1), (t2, P2) = rp
        if t2 <= t1:
            return None
        return float(np.linalg.norm(P2[:3, 3] - P1[:3, 3])) / float(t2 - t1)

    def _update_staleness_mode(self, depth: int, frac: float) -> bool:
        """The staleness fallback: when candidate staleness (the pipeline
        depth, in frames) x platform speed exceeds `frac` of the adaptive
        keyframe distance, the odometer serializes against mapping until
        the ratio drops below 0.7 x `frac` (hysteresis). A disabled
        distance gate (negative keyframe distance) disables it."""
        spd = self._platform_speed()
        if spd is None:
            return self._staleness_active
        kfd = float(self.mapping.current_key_frame_distance)
        if kfd < 0:
            return self._staleness_active
        kfd = max(kfd, 1e-6)
        lag = depth
        ratio = spd * lag / kfd
        if not self._staleness_active and ratio > frac:
            self._staleness_active = True
            self._staleness_events += 1
            logger.warning(
                "MT staleness fallback ON: %.2f m/frame x %d frames in "
                "flight = %.1f m vs keyframe distance %.1f m; odometer "
                "now serializes against mapping", spd, lag, spd * lag, kfd)
        elif self._staleness_active and ratio < 0.7 * frac:
            self._staleness_active = False
            logger.info("MT staleness fallback OFF (ratio %.2f)", ratio)
        return self._staleness_active

    def _predict_pose(self, ts: int):
        """Constant-velocity extrapolation of the pose at timestep `ts`
        from the last two mapping-resolved poses (None when unavailable),
        so that the pipelined odometer ranks candidates near the new scan
        rather than near the stale graph pose."""
        rp = list(self._recent_poses)
        if len(rp) < 2:
            return None
        (t1, P1), (t2, P2) = rp
        if t2 <= t1 or ts <= t2:
            return None
        xi = se3m.se3_log(se3m.inv(P1) @ P2) / float(t2 - t1)
        return P2 @ se3m.se3_exp(xi * float(ts - t2))

    def _resolve_bundle(self, bundle):
        """An odometer launch -> (scan, odometry edge). Runs on the mapping
        thread: the wait for the results overlaps the odometer's next
        launches."""
        resolver, pc, R, T, cand, extras, ts, perf_t = bundle
        desc_thunk, dvalid, pv_thunk, SE3, conf, rmse, info = resolver()
        new_scan = self._make_scan(desc_thunk, dvalid, pc[0],
                                   pv_thunk, R, T, timestep=ts)
        odom_edge = PoseGraphEdge(
            src_scan_token=cand.token, dst_scan_token=new_scan.token,
            SE3=se3m.inv(SE3), information_mat=info, type="odom",
            confidence=conf, rmse=rmse)
        # extra candidates (odometer_candidates_num > 1): their edges are
        # discarded, as in the reference (core.py:214)
        if extras:
            self.odometry.odometry(new_scan, extras)
        return new_scan, odom_edge

    def _mt_mapping(self, q_in, q_out):
        while True:
            item = q_in.get()
            if isinstance(item, EXIT_CODE):
                q_out.put(item)
                if item == EXIT_CODE.exit:
                    break
                continue
            if item[0] == "bundle":
                new_scan, odom_edge = self._resolve_bundle(item[1])
            else:
                new_scan, odom_edge = item
            perf_t = time.perf_counter()
            try:
                result = self.mapping.process(new_scan, odom_edge)
            finally:
                # the odometer may be waiting for this frame's graph update
                with self._map_progress:
                    self._mapped_count += 1
                    self._map_progress.notify_all()
            self.result_logger.record_perf("mapping",
                                           time.perf_counter() - perf_t)
            if new_scan.SE3_pred is not None:
                self._recent_poses.append((new_scan.timestep,
                                           np.array(new_scan.SE3_pred)))
            if isinstance(result, EXIT_CODE):
                continue
            self._upload(new_scan, odom_edge)
            q_out.put(new_scan)

    def _mt_backend(self, q_in, q_out):
        while True:
            item = q_in.get()
            if isinstance(item, EXIT_CODE):
                q_out.put(item)
                if item == EXIT_CODE.exit:
                    break
                continue
            new_scan = item
            perf_t = time.perf_counter()
            self.loop.process(new_scan, targets="all")
            self.posegraph_map.last_known_anyframe = new_scan.token
            self.result_logger.record_perf("loop_closure",
                                           time.perf_counter() - perf_t)
            q_out.put(EXIT_CODE.acpt)

    def _mt_output(self, q_in):
        while True:
            item = q_in.get()
            if item == EXIT_CODE.exit:
                break


def _run_guarded(system, name: str, fn) -> threading.Thread:
    """Start `fn` on a daemon thread with the engine's device current and
    autograd off; an exception is logged and kept in `system._errors`, so
    that `wait` re-raises it instead of returning a truncated run."""
    def body():
        try:
            device = system.engine.device
            if device.type == "cuda":
                torch.cuda.set_device(device)
            with torch.inference_mode():
                fn()
        except Exception as e:                       # noqa: BLE001
            logger.exception("%s thread of system %d crashed", name,
                             system.system_id)
            system._errors.append(e)

    t = threading.Thread(target=body, name=f"{name}-{system.system_id}",
                         daemon=True)
    t.start()
    return t


def _join(system, thread: threading.Thread, what: str) -> None:
    thread.join()
    if system._errors:
        raise RuntimeError(f"{what} of system {system.system_id} failed: "
                           f"{system._errors[0]!r}") from system._errors[0]


class AgentSystem(SlamSystem):
    """SlamSystem fed from its own dataloader thread
    (reference: core.py:426-448)."""

    def start(self, dataloader) -> None:
        def feed():
            for data in dataloader:
                self.step(data)
        self._errors: List[Exception] = []
        self._feed_thread = _run_guarded(self, "agent", feed)

    def wait(self) -> None:
        _join(self, self._feed_thread, "agent feed")


class CloudSystem(SlamSystem):
    """Consumes UPLOAD_SCAN messages, merges pose graphs, runs cross-agent
    loop closure (reference: core.py:451-546)."""

    def __init__(self, args, engine: InferenceEngine,
                 logger_dir: Optional[str] = None,
                 comm_module: Optional[CommModule] = None):
        if comm_module is None:
            raise ValueError("CloudSystem needs a comm_module")
        super().__init__(args, engine, system_id=0, logger_dir=logger_dir,
                         comm_module=comm_module)
        # merged graphs optimize with isotropic weights from a
        # spanning-tree initialization (slam/pose_graph.py optim)
        self.posegraph_map.uncertain = True

    def cloud_step(self, scan_pack: ScanPack,
                   odom_edge: Optional[PoseGraphEdge],
                   neighbor_edges: List[PoseGraphEdge]) -> None:
        """One uploaded keyframe into the merged graph
        (reference: core.py:466-514)."""
        pg = self.posegraph_map
        if scan_pack.type != "full":
            raise ValueError(f"upload {scan_pack.token} is not a keyframe")
        pg.add_vertex(scan_pack)
        if odom_edge is not None:
            if scan_pack.token == odom_edge.src_scan_token:
                dst = pg.get_scanpack(odom_edge.dst_scan_token)
                SE3 = dst.SE3_pred @ se3m.inv(odom_edge.SE3)
                pg.update_scan_token(scan_pack.token, new_SE3_pred=SE3,
                                     new_coor_sys=dst.coor_sys)
            else:
                src = pg.get_scanpack(odom_edge.src_scan_token)
                SE3 = src.SE3_pred @ odom_edge.SE3
                pg.update_scan_token(scan_pack.token, new_SE3_pred=SE3,
                                     new_coor_sys=src.coor_sys)
            pg.add_edge(odom_edge)
        for e in neighbor_edges:
            pg.add_edge(e)

        # repair stale coordinate systems (reference: core.py:488-505)
        base = min((s for s in pg.get_all_scans()
                    if s.agent_id == scan_pack.agent_id),
                   key=lambda s: s.timestep)
        scan_now = pg.get_scanpack(scan_pack.token)
        if base.coor_sys != scan_now.coor_sys:
            pose_new = coor_new = None
            for n in pg.get_neighbor_tokens(scan_pack.token):
                nb = pg.get_scanpack(n)
                e = pg.get_edge_either(n, scan_pack.token)
                rel = (e.SE3 if e.src_scan_token == n else se3m.inv(e.SE3))
                pose_new = nb.SE3_pred @ rel
                coor_new = nb.coor_sys
            if pose_new is not None:
                # (the reference would NameError here on a neighbor-less
                # scan, core.py:495-505)
                pg.update_scan_token(scan_pack.token, new_SE3_pred=pose_new,
                                     new_coor_sys=coor_new)

        self.loop.process(scan_now, targets="others")

    def start(self) -> None:
        def fetch():
            while True:
                src_id, command, data = self.comm_module.fetch_message(
                    self.system_id)
                if command == "QUIT":
                    break
                if command in ("NO_OP", "AGENT_QUIT"):
                    continue
                if command == "UPLOAD_SCAN":
                    self.cloud_step(data["new_scan"], data["odometer_edge"],
                                    data["neighbor_edges"])
                else:
                    raise RuntimeError(f"unknown operation {command}")
        self._errors: List[Exception] = []
        self._fetch_thread = _run_guarded(self, "cloud", fetch)

    def wait(self) -> None:
        _join(self, self._fetch_thread, "cloud merge")
