"""The port's msgpack reader and weight map against Flax's own reader."""

import numpy as np
import pytest
import torch
from flax import serialization

from deeppointmap_tpu_torch.models.weights import (read_flax_msgpack,
                                                   state_dict_from_flax)

torch.set_num_threads(2)

DEMO = "artifacts/synthetic_demo/weights_final.msgpack"


def _flat(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}"
        if isinstance(v, dict):
            yield from _flat(v, p)
        else:
            yield p, v


def test_reader_matches_flax_on_checkpoint():
    with open(DEMO, "rb") as f:
        ref = dict(_flat(serialization.msgpack_restore(f.read())))
    got = dict(_flat(read_flax_msgpack(DEMO)))
    assert got.keys() == ref.keys()
    for k in ref:
        # bitwise: the reader only reinterprets the stored bytes
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_reader_covers_msgpack_subset(tmp_path):
    """Every type the decoder claims: nested maps, arrays, strings, ints of
    each width, floats, nil/bools, ndarray and NumPy-scalar extensions."""
    tree = {"a": {"b": np.arange(300, dtype=np.int64).reshape(3, 100),
                  "c": np.float32(1.5), "d": [1, -3, 200, -200, 70000,
                                              -70000, 2 ** 40, None, True,
                                              False, 0.25, "x" * 40]},
            "e": np.ones((2,), np.float16), "f": "s" * 300}
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    got = read_flax_msgpack(str(path))
    np.testing.assert_array_equal(got["a"]["b"], tree["a"]["b"])
    assert got["a"]["c"] == np.float32(1.5)
    assert got["a"]["d"] == tree["a"]["d"]
    np.testing.assert_array_equal(got["e"], tree["e"])
    assert got["f"] == tree["f"]


@pytest.mark.parametrize("leaf,expect", [
    ("kernel", "weight"), ("scale", "weight"), ("bias", "bias"),
    ("in_proj_kernel", "in_proj_weight"), ("in_proj_bias", "in_proj_bias")])
def test_state_dict_names_and_layout(leaf, expect):
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(4, 6) if "kernel" in leaf else (6,)).astype(
        np.float32)
    sd = state_dict_from_flax({"params": {"down0": {"sa": {leaf: arr}}}})
    out = sd[f"down0.sa.{expect}"]
    # Dense (in, out) kernels become Linear (out, in) weights
    want = arr.T if "kernel" in leaf else arr
    np.testing.assert_array_equal(out.numpy(), want)


FULL = "artifacts/full_size/weights_final.msgpack"


def test_pth_written_by_jax_loads_as_the_msgpack(tmp_path):
    """The JAX package writes the reference's .pth schema from a committed
    full-size checkpoint; the port's .pth reader gives the same names and
    the same tensors, bit for bit, as its msgpack reader of that file."""
    from deeppointmap_tpu.config import config_from_yaml as j_config_from_yaml
    from deeppointmap_tpu.models.weights import save_torch_weight
    from deeppointmap_tpu_torch.config import config_from_yaml
    from deeppointmap_tpu_torch.models.weights import (load_msgpack_weights,
                                                       load_torch_weight)
    from deeppointmap_tpu_torch.pipeline.common import load_weights

    blob = read_flax_msgpack(FULL)
    path = str(tmp_path / "DeepPointMap-B.pth")
    save_torch_weight(path, {"params": blob["encoder"]},
                      {"params": blob["decoder"]},
                      j_config_from_yaml("configs/infer/sample.yaml"))
    args = config_from_yaml("configs/infer/sample.yaml")
    want = load_msgpack_weights(FULL)
    for got in (load_torch_weight(path, args), load_weights(args, path)):
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                assert torch.equal(g[k], w[k]), k
