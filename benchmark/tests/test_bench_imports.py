"""What a run loads: no module of JAX or of the JAX package (top-level
names compared whole, so the port's own name passes), and a plain
reference that imports nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark.lib.spec import BENCH, REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "deeppointmap_tpu")


def _loaded(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in "
                          "sys.modules}))"], capture_output=True, text=True,
                         env=env, cwd=REPO, check=True, timeout=300)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_every_cells_modules_load_no_jax():
    code = ("import json, importlib\n"
            "from benchmark import run\n"
            "run._setup_env()\n"
            "from benchmark.lib import spec\n"
            "b = spec.load_benchmark()\n"
            "for w in b['workloads']:\n"
            "    c = spec.cell(w['name'])\n"
            "    spec.driver(c.traffic)\n"
            "    for m in c.per_layer: spec.metric_reader(m['name'])\n"
            "import benchmark.drivers.slam, benchmark.drivers.train\n"
            "from deeppointmap_tpu_torch.slam.engine import InferenceEngine\n"
            "from deeppointmap_tpu_torch.slam.system import SlamSystem\n"
            "from deeppointmap_tpu_torch.pipeline.trainer import Trainer\n"
            "from deeppointmap_tpu_torch.pipeline.infer import prefetch\n")
    loaded = _loaded(code)
    assert "deeppointmap_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in sorted(os.listdir(ref)):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN + ("deeppointmap_tpu_torch",), \
                    (f, n)
    loaded = _loaded("import benchmark.reference.model, "
                     "benchmark.reference.train, "
                     "benchmark.reference.weights")
    assert not loaded & set(FORBIDDEN + ("deeppointmap_tpu_torch",))


def test_the_guard_compares_whole_names():
    from benchmark import run

    sys.modules.setdefault("deeppointmap_tpu_torch", __import__(
        "deeppointmap_tpu_torch"))
    assert "deeppointmap_tpu_torch" not in run.loaded_forbidden()
