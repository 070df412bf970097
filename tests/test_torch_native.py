"""The port's native host library (deeppointmap_tpu_torch/native): built
with g++ from the port's own source into build/native/, its 'first'
voxel downsample identical to the NumPy route (the plain version) and to
the JAX package's data.voxel, the KITTI reader equal to NumPy, and a
failed build raising with the compiler's output."""

import threading

import numpy as np
import pytest

from deeppointmap_tpu.data.voxel import voxel_downsample_indices as jvox
from deeppointmap_tpu_torch import native
from deeppointmap_tpu_torch.data import voxel


def cloud(n, seed, lo=-60.0, hi=60.0, dup=0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    if dup:
        xyz = np.concatenate([xyz, xyz[rng.integers(0, n, dup)]])
        xyz = xyz[rng.permutation(len(xyz))]
    return xyz


CLOUDS = {
    "empty": lambda: np.zeros((0, 3), np.float32),
    "one": lambda: cloud(1, 1),
    "1000": lambda: cloud(1000, 2),
    "kitti_size": lambda: cloud(122880, 3),
    "duplicates": lambda: cloud(1000, 4, dup=3000),
    "negative": lambda: cloud(5000, 5, lo=-80.0, hi=-0.5),
    "dense": lambda: cloud(20000, 6, lo=-3.0, hi=3.0),
}


@pytest.mark.parametrize("voxel_size", [0.1, 0.3])
@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_native_route_equals_numpy_and_jax(name, voxel_size):
    xyz = CLOUDS[name]()
    calls = native.LIB.voxel_calls
    got = voxel.voxel_downsample_indices(xyz, voxel_size, "first")
    assert native.LIB.voxel_calls == calls + (len(xyz) > 0)
    ref = voxel.voxel_downsample_indices_numpy(xyz, voxel_size, "first")
    assert got.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jvox(xyz, voxel_size, "first"))


def test_other_routes_stay_numpy():
    """'center' retention and a voxel cap never call the library."""
    xyz = cloud(3000, 7, lo=-5.0, hi=5.0)
    calls = native.LIB.voxel_calls
    for retention, num in (("center", None), ("first", 100),
                           ("center", 100)):
        np.testing.assert_array_equal(
            voxel.voxel_downsample_indices(xyz, 0.3, retention, num),
            voxel.voxel_downsample_indices_numpy(xyz, 0.3, retention, num))
    assert native.LIB.voxel_calls == calls


def test_threads_share_one_build():
    """Sixteen threads downsample at once: one library, every result
    right, every call counted."""
    xyz = cloud(20000, 8, lo=-10.0, hi=10.0)
    ref = voxel.voxel_downsample_indices_numpy(xyz, 0.3, "first")
    lib = native.NativeLibrary()
    out = [None] * 16

    def run(i):
        keep = lib.voxel_downsample_first(xyz, 0.3)
        out[i] = keep[np.argsort(voxel.voxel_ids(xyz, 0.3)[keep],
                                 kind="stable")]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for keep in out:
        np.testing.assert_array_equal(keep, ref)
    assert lib.voxel_calls == 16


def test_read_kitti_xyz_drops_nan_rows():
    rng = np.random.default_rng(9)
    raw = rng.normal(0, 20, (4000, 4)).astype(np.float32)
    for col in range(4):
        raw[rng.integers(0, 4000, 50), col] = np.nan
    got = native.LIB.read_kitti_xyz(raw)
    ref = raw[~np.isnan(raw[:, :3]).any(axis=1), :3]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert native.LIB.read_kitti_xyz(raw[:0]).shape == (0, 3)


def test_built_from_the_port_source_into_build_native():
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert native.SOURCE.parent.name == "native"
    assert native.SOURCE.parent.parent.name == "deeppointmap_tpu_torch"
    assert path.name.startswith("libvoxel_native-") and path.exists()


def test_broken_source_raises_with_compiler_output(tmp_path):
    bad = tmp_path / "voxel_native.cpp"
    bad.write_text(native.SOURCE.read_text().replace(
        "int read_kitti_xyz(", "int read_kitti_xyz(this is not C++ ", 1))
    lib = native.NativeLibrary(bad, tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        lib.voxel_downsample_first(cloud(10, 10), 0.3)
    assert "error:" in str(err.value)
    assert not list((tmp_path / "out").glob("*.so"))


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        native.LIB.voxel_downsample_first(np.zeros((4, 2), np.float32), 0.3)
    with pytest.raises(ValueError):
        native.LIB.voxel_downsample_first(np.zeros((4, 3), np.float32), 0.0)
    with pytest.raises(ValueError):
        native.LIB.read_kitti_xyz(np.zeros((4, 3), np.float32))
