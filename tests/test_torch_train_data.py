"""The port's training data path against the JAX package's, byte for byte:
the SlamDatasets sampler (registration and loop items), the frame-distance
cache, build_registration_batch, build_loop_batch, the refined-SE3 lookup
(inversion, bridge composition, calib correction; tests/test_refined_se3.py
is the JAX side) and the ICP tool (data/refined_se3.py against
scripts/make_refined_se3.py). Every random draw comes from one generator
per package, seeded alike, so equal outputs also mean equal draw order.
"""

import copy
import json
import os
import pickle

import numpy as np
import pytest

from deeppointmap_tpu.config import Config as JConfig
from deeppointmap_tpu.data import dataset as jdataset
from deeppointmap_tpu.data.readers import Scan as JScan
from deeppointmap_tpu.data.transforms import (PointCloudTransforms as
                                              JTransforms)
from deeppointmap_tpu.pipeline import batching as jbatching
from deeppointmap_tpu_torch.config import config_from_dict
from deeppointmap_tpu_torch.data import dataset as tdataset
from deeppointmap_tpu_torch.data import refined_se3
from deeppointmap_tpu_torch.data import synthetic as syn
from deeppointmap_tpu_torch.data.readers import Scan
from deeppointmap_tpu_torch.data.transforms import RandomRT
from deeppointmap_tpu_torch.pipeline import batching as tbatching
from deeppointmap_tpu_torch.pipeline.train import training_transforms
from deeppointmap_tpu_torch.utils import se3 as se3m
from scripts import make_refined_se3 as jrefined
from tests.test_trainer import make_synthetic_dataset, train_args

#: a training chain with every kind of draw the sampler meets
RANDOM_TRANSFORMS = {
    "RandomShuffle": {"p": 1.0},
    "RandomDrop": {"max_ratio": 0.2, "p": 0.5},
    "RandomRT": {"r_std": 0.5, "t_std": 1.0, "p": 1.0, "pair": True},
    "RandomPosJitter": {"std": 0.05, "p": 0.5},
    "CoordinatesNormalization": {"ratio": 60.0},
    "ToTensor": {"padding_to": -1},
}


def configs(root: str, **train_edits):
    """(JAX args, port args) of tests/test_trainer.py's config with the
    random transform chain."""
    cfg = json.loads(json.dumps(train_args(root)))
    cfg["transforms"] = copy.deepcopy(RANDOM_TRANSFORMS)
    cfg["train"]["registration"].update(train_edits)
    return JConfig(copy.deepcopy(cfg)), config_from_dict(cfg)


def samplers(root: str, seed: int, **train_edits):
    """The JAX and the port SlamDatasets over `root`, each with its own
    generator seeded `seed` and shared with its transforms, as both
    pipeline/train.py do."""
    jargs, targs = configs(root, **train_edits)
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    jt = JTransforms(jargs, mode="train", rng=jrng)
    jt.transforms.transforms = jt.transforms.transforms[:-1]
    jds = jdataset.SlamDatasets(jargs, data_transforms=jt, rng=jrng)
    tds = tdataset.SlamDatasets(targs, data_transforms=training_transforms(
        targs, trng), rng=trng)
    return (jargs, jds, jrng), (targs, tds, trng)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_data"))
    make_synthetic_dataset(root, n_frames=12)
    return root


def assert_scans_equal(a, b):
    assert a.xyz.tobytes() == b.xyz.tobytes()
    assert a.rotation.tobytes() == b.rotation.tobytes()
    assert a.translation.tobytes() == b.translation.tobytes()
    assert np.asarray(a.calib).tobytes() == np.asarray(b.calib).tobytes()


def assert_batches_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    assert a._fields == b._fields
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


def test_hierarchy_and_frame_distance(root):
    (_, jds, _), (_, tds, _) = samplers(root, 0)
    assert len(tds) == len(jds) == 12
    scene = tds.dataset_list[0].scene_list[0]
    assert scene.agent_list[0].parent is scene
    assert scene.parent is tds.dataset_list[0]
    assert tds.dataset_list[0].get_frame_order(5) == \
        jds.dataset_list[0].get_frame_order(5)
    fd_t, fd_j = tds.frame_distance[0][0], jds.frame_distance[0][0]
    assert fd_t.dtype == np.float16 and fd_t.tobytes() == fd_j.tobytes()
    assert os.path.exists(os.path.join(scene.root, "frame_dis.npy"))


def test_frame_distance_kept_in_memory_when_read_only(tmp_path,
                                                     monkeypatch):
    """A scene directory that refuses the cache file (np.save raises
    OSError, as on a read-only mount): the distances stay in memory."""
    make_synthetic_dataset(str(tmp_path), n_frames=5)

    def refuse(path, arr):
        raise PermissionError(f"read-only: {path}")

    monkeypatch.setattr(np, "save", refuse)
    _, targs = configs(str(tmp_path))
    ds = tdataset.SlamDatasets(targs, rng=np.random.default_rng(0))
    out = ds.frame_distance
    assert not (tmp_path / "scene0" / "frame_dis.npy").exists()
    assert out[0][0].shape == (5, 5) and out[0][0].dtype == np.float16
    assert float(out[0][0][0, 3]) == 6.0          # frames 2 m apart


@pytest.mark.parametrize("K,fill", [(3, True), (4, True), (2, False)])
def test_registration_items_and_batches_equal(root, K, fill):
    (jargs, jds, jrng), (targs, tds, trng) = samplers(root, K, K=K,
                                                      fill=fill)
    for index in (0, 7, 11):
        jframes, jinfo = jds[index]
        tframes, tinfo = tds[index]
        assert tinfo == jinfo
        assert len(tframes) == len(jframes)
        for a, b in zip(tframes, jframes):
            assert_scans_equal(a, b)
        want = jbatching.build_registration_batch(
            jframes, jinfo, jargs.train.registration, 512, jrng)
        got = tbatching.build_registration_batch(
            tframes, tinfo, targs.train.registration, 512, trng)
        assert_batches_equal(got, want)
    tds.forced_S = jds.forced_S = 2
    assert tds[3][1] == jds[3][1]
    assert tds.sample_S() == jds.sample_S()


def test_loop_items_and_batches_equal(root):
    (jargs, jds, jrng), (targs, tds, trng) = samplers(root, 5)
    jds.loop_detection()
    tds.loop_detection()
    jpairs = [jds[i] for i in (0, 4, 9, 11, 2, 6)]
    tpairs = [tds[i] for i in (0, 4, 9, 11, 2, 6)]
    for (ja, jb), (ta, tb) in zip(jpairs, tpairs):
        assert_scans_equal(ta, ja)
        assert_scans_equal(tb, jb)
    want = jbatching.build_loop_batch(jpairs, 8.0, 512)
    got = tbatching.build_loop_batch(tpairs, 8.0, 512)
    assert_batches_equal(got, want)
    assert 0 < got.label.sum() < len(got.label)


# ------------------------------------------------------------ refined SE3
def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    world = syn.make_world(rng)
    poses = syn.circle_trajectory(10, radius=12.0)
    scans = [Scan(xyz=syn.render_scan(world, p, sensor_range=30.0,
                                      noise=0.01, max_points=3000, rng=rng),
                  rotation=p[:3, :3], translation=p[:3, 3:]) for p in poses]
    return scans, poses


def jscan(s: Scan) -> JScan:
    return JScan(xyz=s.xyz.copy(), rotation=s.rotation.copy(),
                 translation=s.translation.copy(), calib=s.calib.copy())


def test_refine_scene_equals_the_script(scene, tmp_path):
    """The ICP tool gives the JAX package's script's dict, and its CLI
    writes it as refined_SE3.pkl from a scene directory."""
    scans, _ = scene
    scans = scans[:4]
    kw = dict(max_distance=15.0, voxel=0.3, iters=10, max_corr=1.0)
    got = refined_se3.refine_scene(scans, **kw)
    want = jrefined.refine_scene([jscan(s) for s in scans], **kw)
    assert set(got) == set(want) and got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-9)
    agent = tmp_path / "scene" / "0"
    agent.mkdir(parents=True)
    for i, s in enumerate(scans):
        np.savez(agent / f"{i}.npz", lidar_pcd=s.xyz,
                 ego_rotation=s.rotation, ego_translation=s.translation)
    refined_se3.main(["--scene", str(tmp_path / "scene"), "--iters", "10",
                      "--voxel", "0.3", "--max_distance", "15"])
    with open(tmp_path / "scene" / "refined_SE3.pkl", "rb") as f:
        back = pickle.load(f)
    assert set(back) == set(want)


def test_bridge_composition_and_calib_correction(scene, tmp_path):
    """Inversion, bridge composition and the calib correction under
    RandomRT, against the JAX package's functions, and the batch builder
    taking the (perturbed) dict instead of the GT pose."""
    scans, _ = scene
    gt = lambda s, d: jrefined.gt_relative_SE3(jscan(s), jscan(d))
    refined = {(0, 1): gt(scans[1], scans[0]), (0, 2): gt(scans[2], scans[0])}
    for s, t, bridge in ((1, 2, 0), (2, 1, 0), (0, 1, None), (1, 0, None),
                         (2, 2, None)):
        got = tbatching.get_SE3_from_dict(refined, s, t, bridge)
        want = jbatching.get_SE3_from_dict(refined, s, t, bridge)
        assert got.tobytes() == np.asarray(want).tobytes()
    with pytest.raises(KeyError):
        tbatching.get_SE3_from_dict(refined, 1, 2)
    np.testing.assert_allclose(
        tbatching.get_SE3_from_dict(refined, 1, 2, bridge=0),
        np.linalg.inv(refined[(0, 2)]) @ refined[(0, 1)], atol=1e-12)

    a, b = (Scan(xyz=s.xyz.copy(), rotation=s.rotation.copy(),
                 translation=s.translation.copy()) for s in scans[1:3])
    rt = RandomRT(r_std=0.8, t_std=1.0, p=1.0, pair=True,
                  rng=np.random.default_rng(9))
    rt(a)
    rt(b)
    out = tbatching.accurate_relative_SE3(1, 2, a, b, refined, bridge=0)
    want = jbatching.accurate_relative_SE3(1, 2, jscan(a), jscan(b), refined,
                                           bridge=0)
    assert out.tobytes() == np.asarray(want).tobytes()
    R, T = se3m.global_to_relative(b.rotation, b.translation, a.rotation,
                                   a.translation)
    np.testing.assert_allclose(out, se3m.se3(R, T), atol=1e-4)

    # a perturbed dict on disk (pair (1, 2) absent: bridged through 0)
    delta = se3m.se3(rot_z(0.05), np.array([0.3, 0.0, 0.0]))
    pert = {k: delta @ v for k, v in refined.items()}
    path = str(tmp_path / "refined_SE3.pkl")
    with open(path, "wb") as f:
        pickle.dump(pert, f)
    tbatching._SE3_CACHE.clear()
    jbatching._SE3_CACHE.clear()
    assert tbatching.load_refined_SE3(path) is tbatching.load_refined_SE3(
        path)
    assert tbatching.load_refined_SE3(str(tmp_path / "missing.pkl")) is None
    frames = [scans[0], scans[1], scans[2], scans[0]]
    info = dict(num_map=1, refined_SE3_file=[path],
                dsf_index=[(0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 0, 0)])
    cfg = dict(map_size_max=8, K=4, K_max=4, fill=True, distance=20.0)
    got = tbatching.build_registration_batch(
        frames, info, config_from_dict(cfg), 3200, np.random.default_rng(3))
    want = jbatching.build_registration_batch(
        [jscan(s) for s in frames], info, JConfig(cfg), 3200,
        np.random.default_rng(3))
    assert_batches_equal(got, want)
    if got.group_id[0, 1] == 0:    # frame 1 in the src map, anchored at 0
        np.testing.assert_allclose(got.group_SE3[0, 1],
                                   np.linalg.inv(pert[(0, 1)]), atol=1e-5)
