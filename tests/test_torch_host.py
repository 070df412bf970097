"""The port's copies of the NumPy / scipy host modules (`utils/se3`,
`slam/pose_graph`, `slam/optimizer`, `slam/recoder`, `slam/utils`,
`data/readers`, `data/dataset`) against the JAX package's modules on the
same inputs. They are float64 copies, so the tolerance is atol 1e-9; files
must be equal byte for byte.
"""

import os

import numpy as np
import pytest

from deeppointmap_tpu.data import dataset as jdataset
from deeppointmap_tpu.data import readers as jreaders
from deeppointmap_tpu.slam import optimizer as jopt
from deeppointmap_tpu.slam import pose_graph as jpg
from deeppointmap_tpu.slam import recoder as jrec
from deeppointmap_tpu.slam import utils as jutils
from deeppointmap_tpu.utils import se3 as jse3
from deeppointmap_tpu_torch.data import dataset as tdataset
from deeppointmap_tpu_torch.data import readers as treaders
from deeppointmap_tpu_torch.slam import optimizer as topt
from deeppointmap_tpu_torch.slam import pose_graph as tpg
from deeppointmap_tpu_torch.slam import recoder as trec
from deeppointmap_tpu_torch.slam import utils as tutils
from deeppointmap_tpu_torch.utils import se3 as tse3

ATOL = 1e-9


def poses(n, seed, step=1.5):
    """A noisy chain of n SE3 poses."""
    g = np.random.default_rng(seed)
    out = [np.eye(4)]
    for _ in range(n - 1):
        xi = np.concatenate([[step, 0, 0] + g.normal(0, 0.1, 3),
                             g.normal(0, 0.05, 3)])
        out.append(out[-1] @ jse3.se3_exp(xi))
    return np.stack(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_se3_matches_jax(seed):
    g = np.random.default_rng(seed)
    xi = g.normal(0, 0.7, 6)
    T = jse3.se3_exp(xi)
    for name, args in (("se3_exp", (xi,)), ("se3_log", (T,)), ("inv", (T,)),
                       ("adjoint", (T,)), ("so3_exp", (xi[3:],)),
                       ("so3_log", (T[:3, :3],)), ("hat", (xi[:3],)),
                       ("rotation_angle", (T[:3, :3],)),
                       ("project_to_so3", (T[:3, :3] + 0.01 * g.normal(
                           size=(3, 3)),)),
                       ("se3", (T[:3, :3], T[:3, 3]))):
        np.testing.assert_allclose(getattr(tse3, name)(*args),
                                   getattr(jse3, name)(*args), rtol=0,
                                   atol=ATOL, err_msg=name)
    T2 = jse3.se3_exp(g.normal(0, 0.5, 6))
    for a, b in zip(tse3.global_to_relative(T[:3, :3], T[:3, 3:], T2[:3, :3],
                                            T2[:3, 3:]),
                    jse3.global_to_relative(T[:3, :3], T[:3, 3:], T2[:3, :3],
                                            T2[:3, 3:])):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    for a, b in zip(tse3.rt(T), jse3.rt(T)):
        np.testing.assert_array_equal(a, b)


def _noisy_edges(P, seed):
    """Chain edges plus two loop edges, measurements with noise."""
    g = np.random.default_rng(seed)
    n = len(P)
    pairs = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1), (2, n - 3)]
    edges = []
    for i, j in pairs:
        Z = np.linalg.inv(P[i]) @ P[j] @ jse3.se3_exp(g.normal(0, 0.02, 6))
        A = g.normal(size=(6, 6))
        edges.append((i, j, Z, A @ A.T + 10 * np.eye(6), 1.0 + (i % 3)))
    return edges


@pytest.mark.parametrize("seed", [0, 1])
def test_optimizer_matches_jax(seed):
    P = poses(12, seed)
    edges = _noisy_edges(P, seed)
    g = np.random.default_rng(seed + 10)
    init = np.stack([p @ jse3.se3_exp(g.normal(0, 0.05, 6)) for p in P])
    np.testing.assert_allclose(topt.optimize_pose_graph(init, edges),
                               jopt.optimize_pose_graph(init, edges), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(topt.spanning_tree_init(init, edges, 0),
                               jopt.spanning_tree_init(init, edges, 0), rtol=0,
                               atol=ATOL)
    Ti, Tj, Z = init[0], init[1], edges[0][2]
    for a, b in zip(topt.edge_residual_jacobians(Ti, Tj, Z),
                    jopt.edge_residual_jacobians(Ti, Tj, Z)):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def build_graph(pg_mod, P, seed):
    """A pose graph of len(P) scans (every third a non-keyframe) with odom,
    locz and two loop edges, descriptors and point clouds from a seed."""
    g = np.random.default_rng(seed)
    pg = pg_mod.PoseGraph(args=None, agent_id=1)
    n = len(P)
    last_kf = None
    for i in range(n):
        scan = pg_mod.ScanPack(
            timestamp=0.1 * i, agent_id=1, timestep=i,
            key_points=g.normal(size=(16, 11)).astype(np.float32),
            key_valid=g.random(16) > 0.2,
            full_pcd=g.normal(0, 5, (64, 3)).astype(np.float32),
            full_valid=g.random(64) > 0.1, SE3_pred=P[i], SE3_gt=P[i],
            coor_sys=1)
        keyframe = i % 3 != 1
        pg.add_vertex(scan if keyframe else scan.nonkeyframe())
        if last_kf is not None:
            Z = np.linalg.inv(P[last_kf]) @ P[i] @ jse3.se3_exp(
                g.normal(0, 0.02, 6))
            A = g.normal(size=(6, 6))
            pg.add_edge(pg_mod.PoseGraphEdge(
                scan.token - i + last_kf, scan.token, Z,
                A @ A.T + 10 * np.eye(6), "odom" if keyframe else "locz",
                confidence=0.9, rmse=0.3))
        if keyframe:
            last_kf = i
    tok = lambda i: (1 << 16) + i
    for i, j in ((0, n - 1), (3, n - 3)):
        Z = np.linalg.inv(P[i]) @ P[j] @ jse3.se3_exp(g.normal(0, 0.05, 6))
        pg.add_edge(pg_mod.PoseGraphEdge(tok(i), tok(j), Z, 50 * np.eye(6),
                                         "loop", confidence=0.8, rmse=0.4))
    pg.last_known_keyframe = pg.last_known_anyframe = tok(n - 1)
    return pg


@pytest.fixture(scope="module")
def graphs():
    P = poses(15, 4)            # 15 % 3 == 0: scans 0, n-1, 3, n-3 are keyframes
    return build_graph(jpg, P, 7), build_graph(tpg, P, 7)


def test_pose_graph_queries_match_jax(graphs):
    j, t = graphs
    tok = lambda i: (1 << 16) + i
    assert t.key_frame_num == j.key_frame_num
    assert [s.token for s in t.get_keyframes()] == \
        [s.token for s in j.get_keyframes()]
    for level in (1, 3, 5):
        search = lambda pg: [s.token for s in pg.graph_search(
            tok(6), level, 1, edge_type=["odom", "loop"])]
        assert search(t) == search(j)
    for a, b in ((0, 14), (2, 9), (5, 6)):
        path = lambda pg: pg.shortest_path_length(
            tok(a), tok(b), edge_type=["odom", "loop"], infinity_length=5000)
        assert path(t) == path(j)
    for full in (False, True):
        query = lambda pg: pg.global_map_query_graph(
            tok(6), 5, 1, full_pcd=full,
            centering_SE3=pg.get_scanpack(tok(6)).SE3_pred, max_dist=20)
        (tm, tt), (jm, jt) = query(t), query(j)
        np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-6)  # float32 maps
        np.testing.assert_array_equal(tt, jt)
    assert sorted(t.get_neighbor_tokens(tok(6))) == \
        sorted(j.get_neighbor_tokens(tok(6)))


def test_pose_graph_optim_and_files_match_jax(graphs, tmp_path):
    """Global optimization moves both graphs to the same poses (the sparse
    solve in float64), and the result files are equal byte for byte."""
    j, t = graphs
    jr, tr = j.optim(), t.optim()
    assert tr[:2] == jr[:2] and abs(tr[2] - jr[2]) <= ATOL
    for a, b in zip(sorted(t.get_all_scans(), key=lambda s: s.token),
                    sorted(j.get_all_scans(), key=lambda s: s.token)):
        np.testing.assert_allclose(a.SE3_pred, b.SE3_pred, rtol=0, atol=ATOL)
    for name, mod, pg in (("j", jrec, j), ("t", trec, t)):
        os.makedirs(tmp_path / name)
        log = mod.ResultLogger(None, None, pg, str(tmp_path / name))
        log.record_perf("extract", 0.25)
        log.record_perf("extract", 0.75)
        assert log.log_time()["extract"] == (0.5, 0.25)
        assert log.log_time(1)["extract"] == (0.75, 0.0)
        log.save_trajectory("trajectory")
        log.save_posegraph("trajectory")
        log.save_map("map")
        np.testing.assert_allclose(log.interp_pose(1.45),
                                   jrec.ResultLogger(None, None, j, "")
                                   .interp_pose(1.45), rtol=0, atol=1e-6)
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t")) and len(files) == 6
    for f in files:
        if f.endswith(".txt") or f.endswith(".g2o"):
            assert (tmp_path / "t" / f).read_bytes() == \
                (tmp_path / "j" / f).read_bytes(), f
    a, b = (np.load(tmp_path / d / "map.fullpoints.npz")["points"]
            for d in "tj")
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert np.loadtxt(tmp_path / "t" / "trajectory.allframes.txt").shape == \
        (15, 12)


def test_draw_trajectory_names_the_later_slice(graphs, tmp_path):
    """The map render, which an earlier slice refused, is ported: on equal
    graphs both packages' ResultLogger write the same image."""
    pytest.importorskip("matplotlib")
    out = []
    for mod, pg, name in ((jrec, graphs[0], "j"), (trec, graphs[1], "t")):
        os.makedirs(tmp_path / name)
        mod.ResultLogger(None, None, pg, str(tmp_path / name)).draw_trajectory(
            "trajectory", draft=True)
        out.append((tmp_path / name / "trajectory.map.jpg").read_bytes())
    assert out[0][:2] == b"\xff\xd8" and len(out[1]) > 1000
    assert out[1] == out[0]


def test_exit_codes_and_comm_module_match_jax():
    assert [(c.name, c.value) for c in tutils.EXIT_CODE] == \
        [(c.name, c.value) for c in jutils.EXIT_CODE]
    got = []
    for mod in (tutils, jutils):
        bus = mod.CommModule()
        bus.register(1)
        bus.register(2)
        bus.send_message(1, 2, "UPLOAD_SCAN", dict(x=3))
        got.append((bus.fetch_message(2), bus.fetch_message(2, block=False)))
    assert got[0] == got[1] == ((1, "UPLOAD_SCAN", dict(x=3)), None)
    g = np.random.default_rng(0).random(50)
    assert tutils.__dict__.keys() == jutils.__dict__.keys()
    scalar = [n for n in vars(jutils) if "conf" in n.lower()]
    for n in scalar:
        assert getattr(tutils, n)(g) == getattr(jutils, n)(g)


def test_readers_and_agent_match_jax(tmp_path):
    """KITTI .bin and .npy scans through both readers and both BasicAgents
    (numeric file order, the multi-agent split with its overlap)."""
    g = np.random.default_rng(0)
    root = tmp_path / "seq"
    os.makedirs(root)
    for i in (0, 1, 2, 10, 11, 3, 4, 5, 6, 7, 8, 9):
        xyz = g.normal(0, 10, (50 + i, 4)).astype(np.float32)
        xyz[3, 0] = np.nan
        xyz.tofile(root / f"{i:06d}.bin")
    for i in (0, 11):
        a = treaders.read_auto(str(root / f"{i:06d}.bin"))
        b = jreaders.read_auto(str(root / f"{i:06d}.bin"))
        np.testing.assert_array_equal(a.xyz, b.xyz)
        np.testing.assert_array_equal(a.rotation, b.rotation)
        assert a.n_points == 49 + i
    np.save(tmp_path / "scan.npy", g.normal(size=(20, 3)).astype(np.float32))
    np.testing.assert_array_equal(
        treaders.read_auto(str(tmp_path / "scan.npy")).xyz,
        jreaders.read_auto(str(tmp_path / "scan.npy")).xyz)
    for kw in (dict(), dict(split_num=3, split_index=1)):
        t_agent = tdataset.BasicAgent(str(root), "auto", **kw)
        j_agent = jdataset.BasicAgent(str(root), "auto", **kw)
        assert t_agent.file_list == j_agent.file_list and len(t_agent) > 0
        t_agent.set_independent(lambda scan: scan.n_points)
        j_agent.set_independent(lambda scan: scan.n_points)
        assert list(t_agent) == list(j_agent)
