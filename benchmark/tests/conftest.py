"""Fixtures of the benchmark's own tests."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    """A small copy of the benchmark (benchmark/tests/tiny.py)."""
    from benchmark.tests import tiny

    dst = str(tmp_path_factory.mktemp("tiny_bench"))
    return dst, tiny.build(dst)
