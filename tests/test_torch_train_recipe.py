"""The port's full-size training recipe (deeppointmap_tpu_torch/pipeline/
full_size.py and its CLI scripts/train_full_size_torch.py) against the JAX
package's scripts/train_full_size.py: the same constants and arguments,
the same rendered worlds bit for bit, the same fingerprint rule; and the
CLI's evaluation, training and remat measurement at a cut depth on the
CPU."""

import copy
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from deeppointmap_tpu_torch.pipeline import full_size as fs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = os.path.join(REPO, "artifacts/full_size/weights_final.msgpack")
OCC = os.path.join(REPO, "artifacts/full_size_occ_v2/weights_final.msgpack")
OCC_OLD = os.path.join(REPO,
                       "artifacts/full_size_occluded/weights_final.msgpack")
SETTINGS = ("WORLD", "RENDER", "EVAL_WORLD")
CONSTANTS = ("TRAIN_SCENES", "FRAMES_PER_SCENE", "DEFAULT_WORLD",
             "DEFAULT_RENDER", "DEFAULT_EVAL", "OCCLUSION_RENDER",
             "OCCLUSION_WORLD", "OCCLUSION_EVAL", "OCCLUSION_SCENES",
             "TRANSFORMS")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def mods():
    """(the JAX script, the port's recipe), their settings restored after
    the test (both keep them in module-level dicts)."""
    jax_script = _load("jax_train_full_size",
                       os.path.join(REPO, "scripts/train_full_size.py"))
    saved = {m: {k: copy.deepcopy(getattr(m, k)) for k in SETTINGS
                 + ("TRAIN_SCENES",)} for m in (jax_script, fs)}
    yield jax_script, fs
    for m, kept in saved.items():
        for k, v in kept.items():
            if k == "TRAIN_SCENES":
                setattr(m, k, v)
            else:
                getattr(m, k).clear()
                getattr(m, k).update(v)


def plain(x):
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


@pytest.mark.parametrize("recipe", ["compact", "occlusion"])
def test_constants_equal_the_jax_scripts(mods, recipe):
    j, t = mods
    if recipe == "occlusion":
        j.apply_occlusion_recipe()
        t.apply_occlusion_recipe()
    for name in CONSTANTS + SETTINGS:
        assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("which", ["train", "eval"])
def test_args_equal_the_jax_scripts(mods, which):
    """full_train_args / full_eval_args as plain dicts. The `tpu:` trees
    lie over each package's TPU_DEFAULTS: the port's holds the keys it
    reads, each with the JAX package's value, and the recipe's own keys."""
    j, t = mods
    if which == "train":
        got = plain(t.full_train_args("/r", "/o", 7, 3, remat=True))
        want = plain(j.full_train_args("/r", "/o", 7, 3, remat=True))
        own = {"remat": True, "encoder_bf16": False}
    else:
        got = plain(t.full_eval_args("/r", "/o"))
        want = plain(j.full_eval_args("/r", "/o"))
        own = {"robust_register": True}
    g_tpu, w_tpu = got.pop("tpu"), want.pop("tpu")
    assert got == want
    for k, v in own.items():
        assert g_tpu[k] == w_tpu[k] == v, k
    assert set(g_tpu) <= set(w_tpu)
    assert {k: g_tpu[k] for k in g_tpu} == {k: w_tpu[k] for k in g_tpu}


def _npz_tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".npz"):
                with np.load(path) as z:
                    out[rel] = {k: z[k] for k in z.files}
            else:
                with open(path) as fh:
                    out[rel] = json.load(fh)
    return out


def _assert_same_tree(got, want):
    assert sorted(got) == sorted(want)
    for rel, w in want.items():
        g = got[rel]
        if rel.endswith(".npz"):
            assert sorted(g) == sorted(w), rel
            for k in w:
                assert g[k].dtype == w[k].dtype, (rel, k)
                np.testing.assert_array_equal(g[k], w[k], err_msg=rel)
        else:
            assert g == w, rel


@pytest.mark.parametrize("recipe", ["compact", "occlusion"])
def test_worlds_equal_the_jax_scripts(mods, tmp_path, recipe):
    """Training scenes at 2 frames and the two-lap world at 2 frames a lap,
    of either recipe: the same npz scans, bit for bit, and the same
    world_meta.json."""
    j, t = mods
    for m in (j, t):
        if recipe == "occlusion":
            m.apply_occlusion_recipe()
        m.EVAL_WORLD["frames_per_lap"] = 2
    for name, m in (("jax", j), ("port", t)):
        m.build_training_worlds(str(tmp_path / name / "train"), frames=2)
        m.build_eval_world(str(tmp_path / name / "eval"))
    for part in ("train", "eval"):
        _assert_same_tree(_npz_tree(tmp_path / "port" / part),
                          _npz_tree(tmp_path / "jax" / part))
    assert len(_npz_tree(tmp_path / "port" / "train")) == \
        len(fs.TRAIN_SCENES) * 3


@pytest.mark.parametrize("change", ["none", "world", "render", "frames"])
def test_fingerprint_regenerates_a_changed_world(mods, tmp_path, change):
    """A world is rendered again exactly when a setting it was made with
    changed (a stale frame_dis.npy beside it goes too); otherwise reused."""
    _, t = mods
    t.TRAIN_SCENES = t.TRAIN_SCENES[:1]
    root = str(tmp_path / "train")
    t.build_training_worlds(root, frames=2)
    scan = os.path.join(root, "scene0", "0", "0.npz")
    stale = os.path.join(root, "scene0", "frame_dis.npy")
    np.save(stale, np.zeros(1))
    before = os.stat(scan).st_mtime_ns
    with np.load(scan) as z:
        first = z["lidar_pcd"]
    frames = 2
    if change == "world":
        t.WORLD["n_clusters"] = 200
    elif change == "render":
        t.RENDER["max_points"] = 4096
    elif change == "frames":
        frames = 3
    t.build_training_worlds(root, frames=frames)
    with open(os.path.join(root, "scene0", "world_meta.json")) as f:
        meta = json.load(f)
    assert meta == dict(seed=1, radius=20.0, direction=1, frames=frames,
                        **t.WORLD, **t.RENDER)
    if change == "none":
        assert os.stat(scan).st_mtime_ns == before
        assert os.path.exists(stale)
        return
    assert not os.path.exists(stale)
    assert len(os.listdir(os.path.join(root, "scene0", "0"))) == frames
    with np.load(scan) as z:
        again = z["lidar_pcd"]
    if change != "frames":
        assert again.shape != first.shape or not np.array_equal(again, first)


def test_apply_artifact_render_equals_the_jax_scripts(mods):
    """Each committed artifact's settings, in a row: an artifact without
    render_meta.json resets to the compact defaults."""
    j, t = mods
    for weights in (OCC, FULL, OCC_OLD, FULL, OCC):
        j.apply_artifact_render(weights)
        t.apply_artifact_render(weights)
        for name in SETTINGS:
            assert getattr(t, name) == getattr(j, name), (weights, name)
    t.apply_artifact_render(FULL)
    assert (t.WORLD, t.RENDER, t.EVAL_WORLD) == (
        t.DEFAULT_WORLD, t.DEFAULT_RENDER, t.DEFAULT_EVAL)


def _cli():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import train_full_size_torch
    finally:
        sys.path.pop(0)
    return train_full_size_torch


SMALL_META = {"render": {"sensor_range": 30.0, "max_points": 3000},
              "world": {"n_clusters": 60, "extent": 30.0,
                        "pts_per_cluster": 300},
              "eval": {"radius": 8.0, "frames_per_lap": 2}}


def test_skip_train_evaluates_on_the_cpu(mods, tmp_path, monkeypatch):
    """`--skip_train`: the committed full-size model evaluated through
    main on the CPU, on a two-lap world cut by the render_meta.json beside
    a copy of it (4 frames), loops on and off; the trajectory files of
    each run are written."""
    _, t = mods
    monkeypatch.setattr(t, "TRAIN_SCENES", [])
    wdir = tmp_path / "w"
    wdir.mkdir()
    shutil.copy(FULL, wdir / "weights_final.msgpack")
    (wdir / "render_meta.json").write_text(json.dumps(SMALL_META))
    res = _cli().main([
        "--skip_train", "--weights_out", str(wdir / "weights_final.msgpack"),
        "--root", str(tmp_path / "train"), "--eval_root",
        str(tmp_path / "eval"), "--out", str(tmp_path / "out"),
        "--device", "cpu"])["eval"]
    assert t.EVAL_WORLD == SMALL_META["eval"]
    assert len(os.listdir(tmp_path / "eval" / "scene0" / "0")) == 4
    assert set(res) == {"ate_m", "ate_no_loop_m", "loop_edges", "runs"}
    for name, run in res["runs"].items():
        assert np.isfinite(run["ate_aligned_m"]), name
        assert 1 <= run["frames_in_graph"] <= 4
        rows = np.loadtxt(os.path.join(run["out_dir"],
                                       "trajectory.allframes.txt"), ndmin=2)
        assert rows.shape[1] == 12 and np.isfinite(rows).all()
        assert os.path.exists(os.path.join(run["out_dir"],
                                           "trajectory.pg.g2o"))
    assert res["ate_m"] == round(res["runs"]["loops_on"]["ate_aligned_m"], 4)


def test_train_writes_weights_and_render_meta(mods, tmp_path, monkeypatch):
    """main trains both stages from scratch at a cut depth on the CPU (one
    scene of 4 frames, one epoch a stage): finite weights that moved from
    the seeded init, and render_meta.json with the compact settings, land
    at --weights_out; steps.jsonl holds 4 stage-1 steps and one of stage
    2."""
    from deeppointmap_tpu_torch.pipeline.common import (init_params,
                                                        load_weights)

    _, t = mods
    monkeypatch.setattr(t, "TRAIN_SCENES", t.TRAIN_SCENES[:1])
    monkeypatch.setattr(t, "FRAMES_PER_SCENE", 4)
    out = tmp_path / "out"
    w = tmp_path / "w" / "weights_final.msgpack"
    res = _cli().main([
        "--root", str(tmp_path / "train"), "--out", str(out),
        "--weights_out", str(w), "--epochs1", "1", "--epochs2", "1",
        "--skip_eval", "--device", "cpu"])["train"]
    assert res["stage1_s"] > 0 and res["stage2_s"] > 0
    with open(w.parent / "render_meta.json") as f:
        assert json.load(f) == {"render": t.DEFAULT_RENDER,
                                "world": t.DEFAULT_WORLD,
                                "eval": t.DEFAULT_EVAL}
    args = t.full_train_args(str(tmp_path / "train"), str(out))
    enc, dec = load_weights(args, str(w))
    init_enc, _ = init_params(args, torch.Generator().manual_seed(0))
    assert any(not torch.equal(enc[k], init_enc[k]) for k in enc)
    assert all(torch.isfinite(v).all() for v in list(enc.values())
               + list(dec.values()))
    with open(out / "steps.jsonl") as f:
        stages = [json.loads(x)["stage"] for x in f]
    assert stages == [1] * 4 + [2]


def test_measure_remat_on_the_cpu(mods, tmp_path, monkeypatch):
    """--measure_remat at one timed step a setting (one scene, 4 frames)."""
    _, t = mods
    monkeypatch.setattr(t, "TRAIN_SCENES", t.TRAIN_SCENES[:1])
    root = str(tmp_path / "train")
    t.build_training_worlds(root, frames=4)
    res = t.measure_remat(root, str(tmp_path / "out"), n_steps=1,
                          device="cpu")
    assert set(res) == {"remat_off", "remat_on"}
    assert all(v["sec_per_step"] > 0 for v in res.values())
