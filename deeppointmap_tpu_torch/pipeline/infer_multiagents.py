"""Collaborative multi-agent SLAM inference entry point (port of
deeppointmap_tpu/pipeline/infer_multiagents.py).

    python -m deeppointmap_tpu_torch.pipeline.infer_multiagents \
        --yaml_file configs/infer/ma_synthetic.yaml \
        --weight artifacts/full_size_occ_v2/weights_final.msgpack \
        [--transport tcp] [--device cpu]

Parity with the reference (reference: pipeline/infer_multiagents.py:41-130):
AGENT_NUMBER agents + one cloud share one sequence, each agent taking a
~1/N slice with 5% overlap (data/dataset.BasicAgent); agents upload
keyframes + edges to the cloud over the message bus; the cloud merges the
pose graphs and closes loops across agents. Results: `<infer_tgt>/agent_i/
trajectory.*` per agent, `<infer_tgt>/cloud/cloud_trajectory.*` and
`loop_edges.json` for the merged graph.

Two transports (--transport):
  inproc  agent threads + the cloud in one process sharing ONE
          InferenceEngine on one device (the reference deep-copies its
          torch models per system, infer_multiagents.py:100-120; the
          engine's state is a token-keyed, locked device cache, and a
          token carries its agent's id).
  tcp     the cloud hosts a TransportServer; each agent runs in a process
          of its own and ships UPLOAD_SCAN messages over the wire codec
          (slam/transport.py). This process spawns the agent workers on
          this host, on the same device as the cloud (`--device`), or on
          the CPU with `tpu.agent_platform: cpu`; on several hosts, start
          each worker yourself with --agent_index i --transport_host H
          --transport_port P. Workers find the kernels the parent built
          (kernels.py builds under a content hash with an atomic rename,
          so concurrent first builds cannot clash).
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys

from deeppointmap_tpu_torch.config import (load_config, refuse_unported,
                                           save_settings)
from deeppointmap_tpu_torch.data.dataset import BasicAgent
from deeppointmap_tpu_torch.pipeline.common import build_models
from deeppointmap_tpu_torch.pipeline.infer import (device_preprocess_config,
                                                   make_infer_transform,
                                                   prefetch)
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.slam.system import AgentSystem, CloudSystem
from deeppointmap_tpu_torch.slam.utils import CommModule

logger = logging.getLogger("deeppointmap_tpu_torch.infer_multiagents")

AGENT_NUMBER = 3  # reference: pipeline/infer_multiagents.py:38
#: seconds the cloud waits, after every worker exited 0, for the server to
#: forward each worker's last frames
DRAIN_TIMEOUT_S = 60.0


def _build_engine(args) -> InferenceEngine:
    return InferenceEngine(args, *build_models(args, args.weight),
                           preprocess_cfg=device_preprocess_config(args),
                           device=args.device)


def _make_agent(args, engine, comm, agent_id: int) -> AgentSystem:
    agent_dir = os.path.join(args.infer_tgt, f"agent_{agent_id}")
    os.makedirs(agent_dir, exist_ok=True)
    dataset = BasicAgent(root=args.infer_src[0], reader="auto",
                         split_num=AGENT_NUMBER, split_index=agent_id - 1)
    dataset.set_independent(make_infer_transform(args))
    system = AgentSystem(args, engine, system_id=agent_id,
                         logger_dir=agent_dir, comm_module=comm)
    system.start(prefetch(dataset))
    return system


def _finish_agent(system) -> None:
    system.wait()
    system.result_logger.save_trajectory("trajectory")
    system.result_logger.save_posegraph("trajectory")


def run_agent_worker(args) -> AgentSystem:
    """One agent in its own process, uploading to the cloud over TCP."""
    from deeppointmap_tpu_torch.slam.transport import RemoteCommModule

    i = int(args.agent_index)
    if not 1 <= i <= AGENT_NUMBER:
        raise ValueError(f"agent_index {i} out of range 1..{AGENT_NUMBER}")
    comm = RemoteCommModule(args.transport_host, int(args.transport_port))
    try:
        engine = _build_engine(args)
        system = _make_agent(args, engine, comm, i)
        _finish_agent(system)
        comm.send_message(i, 0, "AGENT_QUIT")
    finally:
        comm.close()
    logger.info("agent %d done: %s", i, system.posegraph_map)
    return system


def agent_device(args) -> str:
    """The device of the agent workers: the cloud's (`--device`), or the
    CPU with `tpu.agent_platform: cpu`."""
    platform = str((args.get("tpu") or {}).get("agent_platform", "")).lower()
    return "cpu" if platform == "cpu" else str(args.device)


def _spawn_agent_procs(args, port: int):
    """Local agent worker processes, one per agent."""
    procs = []
    for i in range(1, AGENT_NUMBER + 1):
        cmd = [sys.executable, "-m",
               "deeppointmap_tpu_torch.pipeline.infer_multiagents",
               "--yaml_file", args.yaml_file, "--transport", "tcp",
               "--agent_index", str(i), "--transport_port", str(port),
               "--transport_host", args.transport_host,
               "--infer_tgt", args.infer_tgt, "--device", agent_device(args)]
        if args.weight:
            cmd += ["--weight", args.weight]
        procs.append(subprocess.Popen(cmd))
    return procs


def run_cloud_tcp(args) -> CloudSystem:
    """Cloud + TransportServer; spawns local agent processes and merges
    their uploads (the multi-process form of the in-process flow). Raises
    if a worker exits non-zero."""
    from deeppointmap_tpu_torch.slam.transport import TransportServer

    engine = _build_engine(args)
    comm = CommModule()
    server = TransportServer(comm, host=args.transport_host,
                             port=int(args.transport_port))
    logger.info("cloud transport listening on %s:%d", args.transport_host,
                server.port)
    cloud_dir = os.path.join(args.infer_tgt, "cloud")
    os.makedirs(cloud_dir, exist_ok=True)
    cloud = CloudSystem(args, engine, logger_dir=cloud_dir, comm_module=comm)
    cloud.start()
    agents = range(1, AGENT_NUMBER + 1)
    try:
        procs = _spawn_agent_procs(args, server.port)
        failed = [i for i, p in zip(agents, procs) if p.wait() != 0]
        if failed:
            raise RuntimeError(f"agent processes failed: {failed}")
        # a worker's frames may still be in the server's hands when the
        # process is gone; its AGENT_QUIT comes after all of them
        if not server.wait_agents_quit(agents, DRAIN_TIMEOUT_S):
            raise RuntimeError("agent uploads were not all received")
    finally:
        comm.send_message(0, 0, "QUIT")
        server.close()
    cloud.wait()
    return cloud


def run_inproc(args) -> CloudSystem:
    """The agents as threads of this process, the cloud as another, all on
    one engine."""
    engine = _build_engine(args)
    comm = CommModule()
    cloud_dir = os.path.join(args.infer_tgt, "cloud")
    os.makedirs(cloud_dir, exist_ok=True)
    cloud = CloudSystem(args, engine, logger_dir=cloud_dir, comm_module=comm)
    cloud.start()
    try:
        agents = [_make_agent(args, engine, comm, i)
                  for i in range(1, AGENT_NUMBER + 1)]
        for a in agents:
            _finish_agent(a)
            comm.send_message(a.system_id, 0, "AGENT_QUIT")
    finally:
        comm.send_message(0, 0, "QUIT")
    cloud.wait()
    return cloud


def write_cloud_results(args, cloud: CloudSystem) -> None:
    """The merged graph's outputs: loop_edges.json, the trajectory files,
    the g2o graph and the map render (a missing matplotlib is logged, as in
    the JAX package)."""
    loop_edges = [dict(src=int(e.src_scan_token), dst=int(e.dst_scan_token),
                       conf=float(e.confidence or 0.0),
                       rmse=float(e.rmse or 0.0), SE3=e.SE3.tolist())
                  for e in cloud.posegraph_map.get_all_edges()
                  if e.type == "loop"]
    with open(os.path.join(args.infer_tgt, "cloud", "loop_edges.json"),
              "w") as f:
        json.dump(loop_edges, f)
    cloud.result_logger.save_trajectory("cloud_trajectory")
    cloud.result_logger.save_posegraph("cloud_trajectory")
    try:
        cloud.result_logger.draw_trajectory("cloud_trajectory")
    except ImportError as e:
        logger.warning("cloud map render failed: %s", e)


def main(argv=None):
    """-> the CloudSystem of the run (None for an agent worker)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = load_config(argv)
    args.mode = "infer"
    refuse_unported(args)

    if int(args.agent_index) >= 1:
        run_agent_worker(args)
        return None

    os.makedirs(args.infer_tgt, exist_ok=True)
    save_settings(args, os.path.join(args.infer_tgt, "settings.yaml"))

    if args.transport == "tcp":
        cloud = run_cloud_tcp(args)
    else:
        cloud = run_inproc(args)

    # gate-by-gate observability for the cross-agent merge: where the
    # cloud's loop candidates die (reference merge: core.py:466-514)
    logger.info("cloud loop funnel: %s", cloud.loop.stats)
    if cloud.loop.recent_edges:
        logger.info("cloud recent (conf, rmse) pre-verification: %s",
                    [(round(c, 3), round(r, 3))
                     for c, r in cloud.loop.recent_edges[-12:]])
    write_cloud_results(args, cloud)
    logger.info("multi-agent run complete: %s", cloud.posegraph_map)
    return cloud


if __name__ == "__main__":
    main()
