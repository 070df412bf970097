"""The port's viewer (deeppointmap_tpu_torch/utils/visualization.py) and map
render (ResultLogger.draw_trajectory): tests/test_visualization.py's cases
on the port, its normals against the JAX package's on the same cloud, and
the matplotlib render of a pose graph. Normals are estimated on the CPU
here (K2's plain version); on the card they go through K2."""

import base64
import json
import re

import numpy as np
import pytest
import torch

from deeppointmap_tpu.utils.visualization import show_pcd as jshow_pcd
from deeppointmap_tpu_torch.config import Config
from deeppointmap_tpu_torch.slam.pose_graph import (PoseGraph, PoseGraphEdge,
                                                    ScanPack)
from deeppointmap_tpu_torch.slam.recoder import ResultLogger
from deeppointmap_tpu_torch.utils import se3 as se3m
from deeppointmap_tpu_torch.utils.visualization import (show_pcd,
                                                        show_posegraph)

torch.set_num_threads(2)


def _extract_data(html: str):
    m = re.search(r"const DATA = (\[.*?\]);\n", html, re.S)
    assert m, "DATA payload not found"
    return json.loads(m.group(1))


def _decode(b64: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(b64), np.float32).reshape(-1, 3)


def _show(clouds, path, **kw):
    return show_pcd(clouds, out_html=str(path), open_browser=False,
                    device="cpu", **kw)


def test_embeds_points_and_colors(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.normal(0, 5, (500, 3)).astype(np.float32)
    b = rng.normal(0, 5, (300, 3)).astype(np.float32)
    out = _show([a, b], tmp_path / "v.html", colors=[(1, 0, 0), (0, 0, 1)],
                window_name="t")
    html = open(out).read()
    data = _extract_data(html)
    assert len(data) == 2
    np.testing.assert_array_equal(_decode(data[0]["xyz"]), a)
    np.testing.assert_array_equal(_decode(data[1]["xyz"]), b)
    assert data[0]["color"] == [1, 0, 0]
    assert data[1]["color"] == [0, 0, 1]
    # self-contained: no external script/style/font references
    assert "<script src" not in html
    assert 'src="' not in html and "@import" not in html
    assert "https://" not in html and "http://" not in html


def test_same_file_as_jax(tmp_path):
    """Without normals estimation both packages write the same bytes."""
    rng = np.random.default_rng(7)
    a = rng.normal(0, 5, (256, 3)).astype(np.float32)
    out_t = _show([a], tmp_path / "t.html", window_name="same")
    out_j = jshow_pcd([a], window_name="same", out_html=str(
        tmp_path / "j.html"), open_browser=False)
    assert open(out_t).read() == open(out_j).read()


def test_statistical_filter_drops_outliers(tmp_path):
    rng = np.random.default_rng(1)
    dense = rng.normal(0, 1, (1000, 3)).astype(np.float32)
    outliers = np.array([[50, 50, 50], [-60, 0, 70]], np.float32)
    cloud = np.concatenate([dense, outliers])
    out = _show([cloud], tmp_path / "f.html", filter=True)
    kept = _decode(_extract_data(open(out).read())[0]["xyz"])
    assert len(kept) < len(cloud)
    assert np.abs(kept).max() < 20.0   # the far outliers are gone


def test_has_normals_passthrough_and_segments(tmp_path):
    rng = np.random.default_rng(2)
    xyz = rng.normal(0, 3, (200, 3)).astype(np.float32)
    nrm = np.tile(np.float32([0, 0, 1]), (200, 1))
    cloud = np.concatenate([xyz, nrm], axis=1)
    out = _show([cloud], tmp_path / "n.html", has_normals=True)
    data = _extract_data(open(out).read())
    np.testing.assert_array_equal(_decode(data[0]["normals"]), nrm)


def test_estimate_normals_on_plane(tmp_path):
    """Radius-PCA normals of a flat plane point +-z (ops/normals path,
    mirroring the reference's estimate_normals option)."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(-5, 5, (800, 2)).astype(np.float32)
    cloud = np.concatenate([xy, np.zeros((800, 1), np.float32)], axis=1)
    out = _show([cloud], tmp_path / "e.html", estimate_normals=True,
                estimate_kwargs=dict(radius=1.0, max_nn=30))
    nrm = _decode(_extract_data(open(out).read())[0]["normals"])
    assert np.all(np.abs(nrm[:, 2]) > 0.99)


def test_estimated_normals_match_jax(tmp_path):
    """A curved surface with noise: the port's normals equal the JAX
    package's up to sign, |cos| >= 1 - 1e-4, wherever the neighbourhood
    holds more than two points."""
    rng = np.random.default_rng(4)
    xy = rng.uniform(-4, 4, (600, 2))
    z = 0.3 * np.sin(xy[:, 0]) + 0.2 * xy[:, 1] ** 2 / 4
    cloud = np.concatenate([xy, z[:, None]], 1) + rng.normal(0, 0.01,
                                                               (600, 3))
    cloud = cloud.astype(np.float32)
    kw = dict(estimate_normals=True, estimate_kwargs=dict(radius=0.8,
                                                          max_nn=30))
    got = _decode(_extract_data(open(_show(
        [cloud], tmp_path / "t.html", **kw)).read())[0]["normals"])
    want = _decode(_extract_data(open(jshow_pcd(
        [cloud], out_html=str(tmp_path / "j.html"), open_browser=False,
        **kw)).read())[0]["normals"])
    d2 = ((cloud[:, None] - cloud[None]) ** 2).sum(-1)
    rich = (d2 <= 0.8 ** 2).sum(1) > 2
    assert rich.mean() > 0.9
    cos = np.abs((got * want).sum(1))
    assert cos[rich].min() >= 1 - 1e-4


def test_torch_tensors_accepted(tmp_path):
    cloud = torch.ones((64, 3))
    out = _show([cloud], tmp_path / "j.html")
    assert len(_decode(_extract_data(open(out).read())[0]["xyz"])) == 64


def test_rejects_bad_shape(tmp_path):
    with pytest.raises(ValueError):
        _show([np.zeros((4, 2))], tmp_path / "x.html")


def _small_graph(agent_id: int = 1, n: int = 6) -> PoseGraph:
    """A line of n scans with odometry edges and one loop edge; each scan
    holds a padded cloud whose last rows are invalid."""
    rng = np.random.default_rng(5)
    pg = PoseGraph(args=Config(slam_system=Config(coor_scale=60)),
                   agent_id=agent_id)
    for i in range(n):
        pcd = rng.normal(0, 4, (128, 3)).astype(np.float32)
        valid = np.arange(128) < 100
        pose = se3m.se3(np.eye(3), [2.0 * i, 0.0, 0.0])
        s = ScanPack(timestamp=0.1 * i, agent_id=agent_id, timestep=i,
                     key_points=None, full_pcd=pcd, full_valid=valid,
                     SE3_pred=pose, SE3_gt=pose, coor_sys=agent_id)
        pg.add_vertex(s)
        if i:
            prev = (agent_id << 16) + i - 1
            pg.add_edge(PoseGraphEdge(prev, s.token,
                                      se3m.se3(np.eye(3), [2.0, 0, 0]),
                                      np.eye(6), "odom", 0.9, 0.1))
    pg.add_edge(PoseGraphEdge(agent_id << 16, (agent_id << 16) + n - 1,
                              se3m.se3(np.eye(3), [2.0 * (n - 1), 0, 0]),
                              np.eye(6), "loop", 0.8, 0.2))
    return pg


@pytest.mark.parametrize("draft", [True, False])
def test_draw_trajectory_writes_the_render(tmp_path, draft):
    pytest.importorskip("matplotlib")
    pg = _small_graph()
    rl = ResultLogger(None, None, pg, str(tmp_path))
    rl.draw_trajectory("trajectory", draft=draft)
    out = tmp_path / "trajectory.map.jpg"
    assert out.exists() and out.stat().st_size > 1000
    assert out.read_bytes()[:2] == b"\xff\xd8"   # a JPEG


def test_show_posegraph_embeds_valid_world_points(tmp_path):
    pg = _small_graph(n=3)
    out = show_posegraph(pg, str(tmp_path / "m.html"))
    data = _extract_data(open(out).read())
    scans = sorted(pg.get_all_scans(), key=lambda s: s.timestep)
    assert len(data) == 4     # three scans and the trajectory
    for d, s in zip(data, scans):
        want = s.full_pcd[s.full_valid] + s.SE3_pred[:3, 3]
        np.testing.assert_allclose(_decode(d["xyz"]), want, atol=1e-5)
    assert len(_decode(data[-1]["xyz"])) == 2 * 12 + 1
