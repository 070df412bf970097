"""The port stands alone: no module of deeppointmap_tpu_torch imports JAX,
Flax, optax, orbax or the JAX package (deeppointmap_tpu), at run time or in
its source; neither do the scripts that drive it on the card, nor the
worker of its data-parallel test."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parent.parent / "deeppointmap_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py"))
ROOT = PORT.parent
#: the scripts that run on a machine without JAX
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_step.py",
           ROOT / "scripts" / "train_ddp_check.py",
           ROOT / "scripts" / "extract_multi_check.py",
           ROOT / "scripts" / "train_full_size_torch.py",
           ROOT / "scripts" / "full_size_card_run.py",
           ROOT / "tests" / "test_torch_ddp_worker.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "deeppointmap_tpu")
MODULES = sorted(
    ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(
        ".__init__") for p in SOURCES)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_modules_found():
    for name in ("slam.engine", "slam.system", "slam.modules",
                 "slam.pose_graph", "slam.optimizer", "slam.recoder",
                 "slam.utils", "utils.se3", "pipeline.infer",
                 "pipeline.common", "data.dataset", "data.readers",
                 "ops.sweep", "ops.normals", "kernels", "config",
                 "data.transforms", "utils.timer", "utils.evaluation",
                 "utils.visualization", "slam.serialization",
                 "slam.transport", "pipeline.infer_multiagents",
                 "models.loss", "data.refined_se3", "parallel",
                 "parallel.ddp", "parallel.train_step", "pipeline.batching",
                 "pipeline.train_utils", "pipeline.trainer",
                 "pipeline.train", "native", "parallel.sharded_extract",
                 "pipeline.full_size"):
        assert f"deeppointmap_tpu_torch.{name}" in MODULES, name
    assert len(MODULES) >= 53


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest)."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(PORT.parent),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", SOURCES + SCRIPTS, ids=lambda p: str(
    p.relative_to(PORT if PORT in p.parents else ROOT)))
def test_source_imports_no_jax(path):
    """Every import statement, at any depth (lazy imports included)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_importing_the_cli_needs_no_yaml():
    """PyYAML is imported only where a YAML file is read, so the entry
    point and the smoke script load on a machine without it."""
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "import deeppointmap_tpu_torch.pipeline.infer\n"
        "import deeppointmap_tpu_torch.config as c\n"
        "c.load_config([])\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                       env=dict(os.environ, PYTHONPATH=str(ROOT)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_guard_tells_the_prefix_apart():
    assert _forbidden("deeppointmap_tpu.ops") and _forbidden("jax.numpy")
    assert _forbidden("optax") and _forbidden("orbax.checkpoint")
    assert not _forbidden("deeppointmap_tpu_torch.ops")
