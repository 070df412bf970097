"""Multi-agent SLAM on the CPU, the port against the JAX package:

(a) the wire codec: bytes encoded by either package decode in the other
    with equal arrays, and both write the same archive members;
(b) the TCP transport: a server of one package receives uploads from a
    client of the other;
(c) each package's AgentSystem over the same agent slices (the port's three
    agents at once on one shared engine whose device cache holds about two
    scans, so that its LRU evicts while the threads run; the JAX package's
    one after another): the upload sequences match in tokens, edge types
    and exit codes, and in poses at tests/test_torch_slam.py's rule (each
    scan's pose relative to the agent's scan before it: rotation <= 0.05
    deg, translation <= 1 cm);
(d) one fixed, ordered list of uploads (the JAX agents', through the wire)
    into each package's CloudSystem.cloud_step, no threads: the same
    vertices, edges by (type, src, dst), coordinate systems, and poses at
    the same rule;
(e) the port's pipeline/infer_multiagents.main with --device cpu, in
    process and over TCP (three worker processes): both finish, write
    loop_edges.json and every agent's trajectory, and the agents'
    trajectories agree.

Model, weights and config are tests/test_torch_slam.py's (small_args,
random weights made by the JAX package and shared, exact grades); the
sequence is rendered with data/synthetic.write_npz_sequence into a
temporary directory.
"""

import io
import os
import zipfile

import numpy as np
import pytest
import torch

from deeppointmap_tpu.data import synthetic as jsyn
from deeppointmap_tpu.data.dataset import BasicAgent as JAgent
from deeppointmap_tpu.pipeline import infer as jinfer
from deeppointmap_tpu.pipeline.common import init_params
from deeppointmap_tpu.slam import serialization as jser
from deeppointmap_tpu.slam import transport as jtr
from deeppointmap_tpu.slam.engine import InferenceEngine as JEngine
from deeppointmap_tpu.slam.pose_graph import PoseGraphEdge as JEdge
from deeppointmap_tpu.slam.pose_graph import ScanPack as JScan
from deeppointmap_tpu.slam.system import AgentSystem as JAgentSystem
from deeppointmap_tpu.slam.system import CloudSystem as JCloud
from deeppointmap_tpu.slam.utils import CommModule as JComm
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data.dataset import BasicAgent
from deeppointmap_tpu_torch.models.weights import state_dicts_from_jax
from deeppointmap_tpu_torch.pipeline import infer as tinfer
from deeppointmap_tpu_torch.pipeline import infer_multiagents as tma
from deeppointmap_tpu_torch.slam import serialization as tser
from deeppointmap_tpu_torch.slam import transport as ttr
from deeppointmap_tpu_torch.slam.engine import InferenceEngine
from deeppointmap_tpu_torch.slam.pose_graph import PoseGraphEdge, ScanPack
from deeppointmap_tpu_torch.slam.system import AgentSystem, CloudSystem
from deeppointmap_tpu_torch.slam.utils import CommModule
from tests.test_torch_ops import _pin_two_point_normals, rotation_deg
from tests.test_torch_slam import jax_config, slam_config

torch.set_num_threads(2)

N_FRAMES = 12
AGENTS = (1, 2, 3)
#: the port's device cache in test (c): room for about two scans
SMALL_CACHE_MB = 0.1


def ma_config(tmp) -> dict:
    """tests/test_torch_slam.py's config with every registered loop edge
    accepted (random weights register at low confidence) and a trust range
    of two, so that a scan's direct neighbours are no loop candidates: the
    cloud then verifies loops across agents and merges their coordinate
    systems."""
    cfg = slam_config(tmp)
    cfg["slam_system"].update(loop_detection_confidence_acpt_threshold=0.0,
                              loop_detection_trust_range=2)
    return cfg


def write_world(root: str) -> str:
    """N_FRAMES synthetic scans along a circle (1.3 m apart) as an npz
    sequence with ground-truth poses -> the sequence directory."""
    rng = np.random.default_rng(11)
    world = jsyn.make_world(rng, n_clusters=60, extent=30.0,
                            pts_per_cluster=300)
    poses = jsyn.circle_trajectory(60, radius=12.0)[:N_FRAMES]
    return jsyn.write_npz_sequence(root, world, poses, rng=rng,
                                   sensor_range=35.0, max_points=8000)


# ------------------------------------------------------------ (a), (b)
def _scans(rng, lazy: bool = False):
    """The same scan as the JAX package's ScanPack and the port's (with
    lazy device fetches in place of the descriptors and point validity
    when `lazy`)."""
    kp = rng.normal(size=(32, 19)).astype(np.float32)
    kv = rng.random(32) > 0.2
    pcd = rng.normal(size=(128, 3)).astype(np.float32)
    pv = rng.random(128) > 0.1
    kw = dict(timestamp=0.5, agent_id=2, timestep=7, key_valid=kv,
              full_pcd=pcd, SE3_pred=np.eye(4) + 0.0, SE3_gt=None,
              gps_position=np.array([1.0, 2.0, 3.0]), coor_sys=2)
    j = JScan(key_points=kp, full_valid=pv, **kw)
    t = ScanPack(key_points=(lambda: torch.from_numpy(kp).numpy())
                 if lazy else kp,
                 full_valid=(lambda: torch.from_numpy(pv).numpy())
                 if lazy else pv, **kw)
    return j, t


def _edges(rng, dst):
    info = rng.normal(size=(3, 6, 6))
    spec = [(131072, "odom", 0.8, 0.1), (131073, "locz", None, None),
            (131074, "loop", 0.7, 0.3)]
    j = [JEdge(s, dst, np.eye(4), info[i], typ, confidence=c, rmse=r)
         for i, (s, typ, c, r) in enumerate(spec)]
    t = [PoseGraphEdge(s, dst, np.eye(4), info[i], typ, confidence=c,
                       rmse=r) for i, (s, typ, c, r) in enumerate(spec)]
    return j, t


def _members(blob: bytes) -> dict:
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        return {name: z.read(name) for name in z.namelist()}


def _same_upload(a, b) -> None:
    (sa, oa, na), (sb, ob, nb) = a, b
    assert sa.token == sb.token and sa.type == sb.type
    assert sa.coor_sys == sb.coor_sys and sa.fixed == sb.fixed
    for name in ("key_points", "key_valid", "full_pcd", "full_valid",
                 "SE3_pred", "gps_position"):
        x, y = getattr(sa, name), getattr(sb, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert sa.SE3_gt is None and sb.SE3_gt is None
    for ea, eb in zip([oa] + na, [ob] + nb):
        assert (ea.src_scan_token, ea.dst_scan_token, ea.type) == \
            (eb.src_scan_token, eb.dst_scan_token, eb.type)
        assert (ea.confidence, ea.rmse) == (eb.confidence, eb.rmse)
        np.testing.assert_array_equal(ea.SE3, eb.SE3)
        np.testing.assert_array_equal(ea.information_mat, eb.information_mat)
    assert len(na) == len(nb)


@pytest.mark.parametrize("lazy", [False, True])
def test_wire_codec_same_members_as_jax(lazy):
    """Both codecs write the same archive members with the same bytes
    (names, dtypes, shapes, values); lazy device fetches are materialized
    by the port's encoder."""
    rng = np.random.default_rng(0)
    j_scan, t_scan = _scans(rng, lazy)
    j_edges, t_edges = _edges(rng, j_scan.token)
    j_blob = jser.encode_upload(j_scan, j_edges[0], j_edges[1:])
    t_blob = tser.encode_upload(t_scan, t_edges[0], t_edges[1:])
    assert _members(t_blob) == _members(j_blob)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_wire_bytes_decode_in_the_other_package(direction):
    rng = np.random.default_rng(1)
    j_scan, t_scan = _scans(rng, lazy=True)
    j_edges, t_edges = _edges(rng, j_scan.token)
    if direction == "port_to_jax":
        blob = tser.encode_upload(t_scan, t_edges[0], t_edges[1:])
        got, want = jser.decode_upload(blob), tser.decode_upload(blob)
    else:
        blob = jser.encode_upload(j_scan, j_edges[0], j_edges[1:])
        got, want = tser.decode_upload(blob), jser.decode_upload(blob)
    _same_upload(got, want)
    _same_upload(tser.decode_upload(blob),
                 (t_scan, t_edges[0], t_edges[1:]))
    # no odometry edge and no neighbours
    empty = tser.encode_upload(t_scan, None, [])
    scan, odom, nbrs = jser.decode_upload(empty)
    assert odom is None and nbrs == [] and scan.token == t_scan.token


@pytest.mark.parametrize("server", ["port", "jax"])
def test_transport_across_packages(server):
    """A TransportServer of one package receives an upload, AGENT_QUIT and
    QUIT from the other package's RemoteCommModule."""
    rng = np.random.default_rng(2)
    j_scan, t_scan = _scans(rng, lazy=True)
    j_edges, t_edges = _edges(rng, j_scan.token)
    if server == "port":
        comm, srv_mod, cli_mod, scan, edges = CommModule(), ttr, jtr, \
            j_scan, j_edges
    else:
        comm, srv_mod, cli_mod, scan, edges = JComm(), jtr, ttr, t_scan, \
            t_edges
    srv = srv_mod.TransportServer(comm, port=0)
    cli = cli_mod.RemoteCommModule("127.0.0.1", srv.port)
    try:
        cli.send_message(2, 0, "UPLOAD_SCAN", dict(
            new_scan=scan, odometer_edge=edges[0],
            neighbor_edges=edges[1:]))
        cli.send_message(2, 0, "AGENT_QUIT")
        cli.send_message(2, 0, "QUIT")
        src, op, msg = comm.fetch_message(0, timeout=10)
        assert (src, op) == (2, "UPLOAD_SCAN")
        _same_upload((msg["new_scan"], msg["odometer_edge"],
                      msg["neighbor_edges"]),
                     tser.decode_upload(jser.encode_upload(
                         j_scan, j_edges[0], j_edges[1:])))
        assert comm.fetch_message(0, timeout=10)[1] == "AGENT_QUIT"
        assert comm.fetch_message(0, timeout=10)[1] == "QUIT"
        if server == "port":
            assert srv.wait_agents_quit([2], timeout=10)
    finally:
        cli.close()
        srv.close()


# ------------------------------------------------------------ (c), (d)
def _drain(comm) -> list:
    out = []
    while True:
        msg = comm.fetch_message(0, block=False)
        if msg is None:
            return out
        src, op, data = msg
        assert op == "UPLOAD_SCAN"
        out.append((src, data))


def _run_agents(pkg, args, engine, seq, tmp, concurrent: bool):
    """Every agent's AgentSystem over its slice -> {agent: (exit codes,
    [(upload bytes of the package's codec, (scan, odom, neighbours))])}."""
    agent_cls, mod, system_cls, comm_cls, ser = (
        (JAgent, jinfer, JAgentSystem, JComm, jser) if pkg == "j" else
        (BasicAgent, tinfer, AgentSystem, CommModule, tser))
    comm = comm_cls()
    comm.register(0)
    systems, codes = {}, {}
    for i in AGENTS:
        ds = agent_cls(root=seq, reader="auto", split_num=len(AGENTS),
                       split_index=i - 1)
        ds.set_independent(mod.make_infer_transform(args))
        out = os.path.join(tmp, f"{pkg}_agent_{i}")
        os.makedirs(out, exist_ok=True)
        system = system_cls(args, engine, system_id=i, logger_dir=out,
                            comm_module=comm)
        codes[i] = []

        def step(data, _step=system.step, _codes=codes[i]):
            code = _step(data)
            _codes.append(code.name)
            return code
        system.step = step
        systems[i] = system
        system.start([ds[k] for k in range(len(ds))])
        if not concurrent:
            system.wait()
    for system in systems.values():
        system.wait()
    uploads = {i: [] for i in AGENTS}
    for src, d in _drain(comm):
        blob = ser.encode_upload(d["new_scan"], d["odometer_edge"],
                                 d["neighbor_edges"])
        uploads[src].append((blob, (d["new_scan"], d["odometer_edge"],
                                    d["neighbor_edges"])))
    return {i: (codes[i], uploads[i]) for i in AGENTS}


@pytest.fixture(scope="module")
def ma(tmp_path_factory):
    """Both packages' agents over the same slices; then the JAX agents'
    uploads, round-robin over the agents, into each package's cloud."""
    with pytest.MonkeyPatch.context() as mp:
        _pin_two_point_normals(mp)
        tmp = tmp_path_factory.mktemp("torch_ma")
        seq = write_world(str(tmp / "world"))
        cfg = ma_config(tmp)
        jargs, targs = jax_config(cfg), config_from_dict(cfg)
        # a device cache of a few scans: the LRU evicts members of one
        # agent's map while the other agents' threads run (a miss uploads
        # the same host values again, so results do not change)
        targs.tpu.device_cache_mb = SMALL_CACHE_MB
        enc, dec, enc_p, dec_p = init_params(jargs, seed=3)
        j_eng = JEngine(jargs, enc_p, dec_p, encoder=enc, decoder=dec,
                        preprocess_cfg=jinfer.device_preprocess_config(jargs))
        t_eng = InferenceEngine(targs, *state_dicts_from_jax(enc_p, dec_p),
                                preprocess_cfg=tinfer.device_preprocess_config(
                                    targs), device="cpu")
        j_run = _run_agents("j", jargs, j_eng, seq, str(tmp), False)
        t_run = _run_agents("t", targs, t_eng, seq, str(tmp), True)
        t_cache = (t_eng._dcache_bytes, len(t_eng._dcache))

        # (d): one fixed order, the JAX agents' uploads through the wire;
        # the clouds' engines start from empty device caches, so both
        # read the uploaded descriptors
        blobs = [b for k in range(max(len(u) for _, u in j_run.values()))
                 for i in AGENTS for b, _ in j_run[i][1][k:k + 1]]
        clouds = {}
        for name, cls, comm_cls, ser, args, eng in (
                ("j", JCloud, JComm, jser, jargs, j_eng),
                ("t", CloudSystem, CommModule, tser, targs, t_eng)):
            eng.invalidate_device_cache()
            out = str(tmp / f"{name}_cloud")
            os.makedirs(out, exist_ok=True)
            cloud = cls(args, eng, logger_dir=out, comm_module=comm_cls())
            for blob in blobs:
                cloud.cloud_step(*ser.decode_upload(blob))
            clouds[name] = cloud
        yield j_run, t_run, clouds, len(blobs), t_cache


def _relative_ok(a, b, label) -> None:
    """Poses of consecutive scans, a against b (lists of 4x4)."""
    for (ja, jb), (ta, tb) in zip(zip(a, a[1:]), zip(b, b[1:])):
        jr = np.linalg.inv(ja) @ jb
        tr = np.linalg.inv(ta) @ tb
        assert rotation_deg(tr[:3, :3], jr[:3, :3]) <= 0.05, label
        assert np.linalg.norm(tr[:3, 3] - jr[:3, 3]) <= 0.01, label


@pytest.mark.parametrize("agent", AGENTS)
def test_agent_uploads_match_jax(ma, agent):
    j_run, t_run, _, _, _ = ma
    (j_codes, j_up), (t_codes, t_up) = j_run[agent], t_run[agent]
    assert t_codes == j_codes and len(j_codes) >= 4
    assert len(t_up) == len(j_up) >= 2, (t_codes, len(t_up))

    def decisions(ups):
        return [(s.token, s.coor_sys,
                 None if o is None else (o.src_scan_token, o.dst_scan_token,
                                         o.type),
                 [(e.type, e.src_scan_token, e.dst_scan_token) for e in n])
                for _, (s, o, n) in ups]
    assert decisions(t_up) == decisions(j_up)
    assert all(s.token >> 16 == agent for _, (s, _, _) in t_up)
    _relative_ok([s.SE3_pred for _, (s, _, _) in j_up],
                 [s.SE3_pred for _, (s, _, _) in t_up], f"agent {agent}")
    # the port's uploads cross the wire as the JAX package's do
    for blob, _ in t_up:
        scan, _, _ = jser.decode_upload(blob)
        assert scan.key_points.dtype == np.float32


def test_port_agents_ran_on_a_full_device_cache(ma):
    """(c) ran with the LRU evicting: the cache ended at its budget."""
    *_, (nbytes, entries) = ma
    assert entries >= 2
    assert nbytes <= SMALL_CACHE_MB * 2 ** 20 < 8 * nbytes


def _cloud_scans(cloud):
    return sorted(cloud.posegraph_map.get_all_scans(), key=lambda s: s.token)


def test_cloud_step_same_graph(ma):
    _, _, clouds, n, _ = ma
    j, t = clouds["j"], clouds["t"]
    assert t.posegraph_map.uncertain and j.posegraph_map.uncertain
    js, ts = _cloud_scans(j), _cloud_scans(t)
    assert [s.token for s in ts] == [s.token for s in js]
    assert len(ts) == n and {s.agent_id for s in ts} == set(AGENTS)
    assert [s.coor_sys for s in ts] == [s.coor_sys for s in js]
    edges = lambda c: sorted((e.type, e.src_scan_token, e.dst_scan_token)
                             for e in c.posegraph_map.get_all_edges())
    assert edges(t) == edges(j)
    assert any(typ == "loop" and (a >> 16) != (b >> 16)
               for typ, a, b in edges(t)), "no loop across agents"
    assert len({s.coor_sys for s in ts}) < len(AGENTS), "nothing merged"
    assert t.loop.stats == j.loop.stats


def test_cloud_step_same_poses(ma):
    _, _, clouds, _, _ = ma
    js, ts = _cloud_scans(clouds["j"]), _cloud_scans(clouds["t"])
    for agent in AGENTS:
        pick = lambda ss: [s.SE3_pred for s in ss if s.agent_id == agent]
        _relative_ok(pick(js), pick(ts), f"cloud, agent {agent}")
    for a, b in zip(js, ts):
        assert np.isfinite(b.SE3_pred).all()


def test_cloud_step_keeps_a_neighbourless_scan(ma, tmp_path):
    """A scan whose coordinate system differs from its agent's first scan
    and which has no neighbour keeps its pose and coordinate system (the
    reference raises NameError there); loop closure off."""
    _, t_run, clouds, _, _ = ma
    cfg = ma_config(tmp_path)
    cfg["slam_system"]["enable_loop_closure"] = False
    cloud = CloudSystem(config_from_dict(cfg), clouds["t"].engine,
                        logger_dir=str(tmp_path), comm_module=CommModule())
    _, (base, odom, nbrs) = t_run[1][1][0]
    cloud.cloud_step(base, odom, nbrs)
    lone = base.copy()
    lone.timestep, lone.token = 90, base.token + 90
    lone.coor_sys = base.coor_sys + 7
    lone.SE3_pred = np.diag([1.0, 1.0, 1.0, 1.0]) + 0.5 * np.eye(4, k=3)
    cloud.cloud_step(lone, None, [])
    got = cloud.posegraph_map.get_scanpack(lone.token)
    np.testing.assert_array_equal(got.SE3_pred, lone.SE3_pred)
    assert got.coor_sys == base.coor_sys + 7


# ------------------------------------------------------------------ (e)
@pytest.fixture(scope="module")
def ma_cli(tmp_path_factory):
    """pipeline/infer_multiagents.main in process and over TCP, both with
    --device cpu and random weights from the same seed."""
    yaml = pytest.importorskip("yaml")
    tmp = tmp_path_factory.mktemp("torch_ma_cli")
    seq = write_world(str(tmp / "world"))
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        # the worker processes' intra-op threads
        mp.setenv("OMP_NUM_THREADS", "2")
        for transport in ("inproc", "tcp"):
            cfg = ma_config(tmp)
            cfg.pop("weight")
            cfg["infer_src"] = [seq]
            cfg["infer_tgt"] = outs[transport] = str(tmp / transport)
            path = tmp / f"{transport}.yaml"
            path.write_text(yaml.safe_dump(cfg))
            cloud = tma.main(["--yaml_file", str(path), "--device", "cpu",
                              "--transport", transport])
            outs[transport] = (outs[transport], cloud)
    return outs


@pytest.mark.parametrize("transport", ["inproc", "tcp"])
def test_infer_multiagents_writes_every_result(ma_cli, transport):
    import json

    out, cloud = ma_cli[transport]
    for i in AGENTS:
        rows = np.loadtxt(os.path.join(out, f"agent_{i}",
                                       "trajectory.allframes.txt"), ndmin=2)
        assert rows.shape[1] == 12 and len(rows) >= 4
        assert np.isfinite(rows).all()
    with open(os.path.join(out, "cloud", "loop_edges.json")) as f:
        assert isinstance(json.load(f), list)
    for name in ("cloud_trajectory.allframes.txt", "cloud_trajectory.pg.g2o"):
        assert os.path.exists(os.path.join(out, "cloud", name)), name
    assert {s.agent_id for s in cloud.posegraph_map.get_all_scans()} == \
        set(AGENTS)
    assert cloud.posegraph_map.uncertain


def test_infer_multiagents_tcp_equals_inproc(ma_cli):
    """Each agent's trajectory does not depend on the transport; the cloud
    holds the same keyframes."""
    (inp, c_in), (tcp, c_tcp) = ma_cli["inproc"], ma_cli["tcp"]
    for i in AGENTS:
        for name in ("allsteps", "keysteps"):
            a = np.loadtxt(os.path.join(inp, f"agent_{i}",
                                        f"trajectory.{name}.txt"))
            b = np.loadtxt(os.path.join(tcp, f"agent_{i}",
                                        f"trajectory.{name}.txt"))
            np.testing.assert_array_equal(a, b)
        a = np.loadtxt(os.path.join(inp, f"agent_{i}",
                                    "trajectory.allframes.txt"))
        b = np.loadtxt(os.path.join(tcp, f"agent_{i}",
                                    "trajectory.allframes.txt"))
        np.testing.assert_allclose(a, b, atol=1e-6)
    tokens = lambda c: sorted(s.token for s in
                              c.posegraph_map.get_all_scans())
    assert tokens(c_tcp) == tokens(c_in)


@pytest.mark.parametrize("device,platform,want", [
    ("cuda", None, "cuda"), ("cpu", None, "cpu"), ("cuda", "cpu", "cpu")])
def test_workers_run_on_the_cloud_device(monkeypatch, device, platform, want):
    """Spawned workers get the cloud's --device, or the CPU with
    tpu.agent_platform: cpu."""
    tpu = {} if platform is None else {"agent_platform": platform}
    args = config_from_dict({"tpu": tpu}, device=device, weight="w.pth",
                            yaml_file="cfg.yaml", infer_tgt="out",
                            transport_host="127.0.0.1")
    cmds = []
    monkeypatch.setattr(tma.subprocess, "Popen", cmds.append)
    tma._spawn_agent_procs(args, 4321)
    assert [c[c.index("--agent_index") + 1] for c in cmds] == ["1", "2", "3"]
    for c in cmds:
        assert c[c.index("--device") + 1] == want
        assert c[c.index("--transport_port") + 1] == "4321"
        assert c[c.index("--weight") + 1] == "w.pth"


def test_a_failed_worker_fails_the_run(monkeypatch, tmp_path):
    """run_cloud_tcp raises when a worker exits non-zero, and stops its
    cloud thread and server."""
    class Proc:
        def __init__(self, rc):
            self.rc = rc

        def wait(self):
            return self.rc

    cfg = ma_config(tmp_path)
    cfg.update(infer_tgt=str(tmp_path / "out"), weight="")
    args = config_from_dict(cfg, device="cpu", transport_host="127.0.0.1",
                            transport_port=0)
    clouds = []
    monkeypatch.setattr(tma, "_spawn_agent_procs",
                        lambda a, port: [Proc(0), Proc(3), Proc(0)])
    real_cloud = tma.CloudSystem
    monkeypatch.setattr(tma, "CloudSystem", lambda *a, **kw: clouds.append(
        real_cloud(*a, **kw)) or clouds[-1])
    with pytest.raises(RuntimeError, match=r"agent processes failed: \[2\]"):
        tma.run_cloud_tcp(args)
    clouds[0]._fetch_thread.join(timeout=10)
    assert not clouds[0]._fetch_thread.is_alive()
