"""The benchmark's frozen copies agree with the port's originals as they
stand: the scan generator (benchmark/gen) and the work count
(benchmark/counts), at small sizes."""

import numpy as np
import pytest

from benchmark.counts import roofline as frozen
from benchmark.gen import synthetic as gen


def test_world_trajectory_and_render_equal_the_ports():
    from deeppointmap_tpu_torch.data import synthetic as port

    w_port = port.make_world(np.random.default_rng(5), 12, 20.0, 50)
    w_gen = gen.make_world(np.random.default_rng(5), 12, 20.0, 50)
    np.testing.assert_array_equal(w_port, w_gen)
    for a, b in zip(port.circle_trajectory(7, 9.0),
                    gen.circle_trajectory(7, 9.0)):
        np.testing.assert_array_equal(a, b)
    pose = gen.circle_trajectory(7, 9.0)[3]
    for bins in (0, 64):
        kw = dict(sensor_range=15.0, max_points=300, occlusion_bins=bins)
        np.testing.assert_array_equal(
            port.render_scan(w_port, pose, rng=np.random.default_rng(1),
                             **kw),
            gen.render_scan(w_gen, pose, rng=np.random.default_rng(1), **kw))


def test_the_accuracy_world_is_the_ports_stream_world():
    from deeppointmap_tpu_torch.data import synthetic as port

    w_port = port.make_world(np.random.default_rng(port.STREAM_SEED),
                             **port.STREAM_WORLD)
    w_gen = gen.world_for(dict(port.STREAM_WORLD, seed=0))
    np.testing.assert_array_equal(w_port, w_gen)


def test_drive_is_the_same_whatever_the_workers():
    world = {"seed": 4, "n_clusters": 8, "extent": 15.0,
             "pts_per_cluster": 40}
    render = {"sensor_range": 12.0, "max_points": 100}
    traj = {"radius": 6.0, "frames_per_lap": 3, "laps": 2}
    a, pa = gen.render_drive(2 ** 31 + 11, world, render, traj, workers=1)
    b, pb = gen.render_drive(2 ** 31 + 11, world, render, traj, workers=2)
    assert len(a) == 6
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c, _ = gen.render_drive(7, world, render, traj, workers=1)
    assert not np.array_equal(a[0], c[0])


def _trees():
    from deeppointmap_tpu_torch.pipeline.demo import demo_args
    from deeppointmap_tpu_torch.pipeline.full_size import full_eval_args

    return [demo_args("", ""), full_eval_args("", "")]


@pytest.mark.parametrize("which", [0, 1])
def test_counts_equal_the_ports(which):
    import json

    from deeppointmap_tpu_torch.data.preprocess import PreprocessConfig
    from deeppointmap_tpu_torch.utils import roofline as port

    args = _trees()[which]
    tree = frozen.Tree(json.loads(json.dumps(args)))
    assert frozen.H100_SXM == tuple(port.H100_SXM)
    assert frozen.KNOWN_CARDS.keys() == port.KNOWN_CARDS.keys()
    same = lambda a, b: np.testing.assert_allclose(
        [a.flops, a.bytes, a.bf16_flops, a.matmul_flops],
        [b.flops, b.bytes, b.bf16_flops, b.matmul_flops], rtol=0)
    same(frozen.fps_cost(2, 500, 64, 700), port.fps_cost(2, 500, 64, 700))
    same(frozen.knn_cost(1, 500, 40, 16, 300),
         port.knn_cost(1, 500, 40, 16, 300))
    same(frozen.moments_cost(2, 50, 999), port.moments_cost(2, 50, 999))
    pre = PreprocessConfig.from_transforms(
        {"DistanceSample": {"min_dis": 1.0, "max_dis": 60.0},
         "OutlierFilter": {"nb_neighbors": 10, "std_ratio": 3.0},
         "LowPassFilter": {"normals_radius": 0.5, "normals_num": 16,
                           "filter_std": 2.0, "flux": 4},
         "CoordinatesNormalization": {"ratio": 60.0}})
    counts = dict(crop_valid=(1900,), in_radius=12345, valid=(1800,))
    for policy in (frozen.BF16, frozen.UNCHANGED):
        a = frozen.extract_cost(tree, 2048, frozen.ScanCounts(**counts),
                                pre, policy)
        a.update(frozen.register_cost(tree, 256, 2048, 1800, 256, policy))
        b = port.odometry_cost(args, 2048, port.ScanCounts(**counts), 256,
                               256, pre, policy)
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
        a = frozen.train_step_cost(tree, 2, 2, 2048, [1500, 1600, 1700,
                                                       1800], 256, policy)
        b = port.train_step_cost(args, 2, 2, 2048, [1500, 1600, 1700,
                                                     1800], 256, policy)
        for k in a:
            same(a[k], b[k])
