"""On the card (marker `cuda`; skipped without one): each cell's run
at its own sizes with a short window is correct, and the control, the
reference in the precision below the configuration's (float8 operands
for the tpu.bf16 rule's bfloat16) put in the program's place, is not:
it reads over at least one limit. Run with

    python -m pytest -q benchmark/tests/test_bench_card.py
"""

import ast
import json
import re

import pytest
import torch

from benchmark import run
from benchmark.lib import spec


def _cells():
    return [w["name"] for w in spec.load_benchmark()["workloads"]
            if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_the_control_reads_over_a_limit(cell, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc = run.main(["--workload", cell, "--seed", "97",
                   "--seconds", "12", "--trace", "0", "--control", "1"])
    cap = capsys.readouterr()
    assert rc == 0
    assert "program correct: True" in cap.err, cap.err[-2000:]
    assert not json.loads(cap.out.strip().splitlines()[-1])["correct"]
    over = re.search(r"control fp8 over its limits: (\[.*\])", cap.err)
    assert over and ast.literal_eval(over.group(1)), cap.err[-2000:]
