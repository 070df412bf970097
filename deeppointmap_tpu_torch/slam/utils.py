"""SLAM-side shared utilities (reference: system/modules/utils.py).

The port's own copy of deeppointmap_tpu/slam/utils.py (NumPy / scipy only; the
port imports nothing of the JAX package).

Pose math lives in utils/se3.py; this module holds the exit codes, the
pair-confidence scalarizer and the in-process message bus used by the
multi-agent mode.
"""

from __future__ import annotations

import queue
from enum import Enum, unique
from typing import Any, Dict, Tuple

import numpy as np


@unique
class EXIT_CODE(Enum):
    """Stage result codes (reference: system/modules/utils.py:21-27)."""
    acpt = 0
    drop = 10
    dist = 11
    engy = 12
    exit = 21


def simvec_to_num_np(sim_vec: np.ndarray) -> float:
    """Mean of the first 30 pair confidences
    (reference: system/modules/utils.py:18)."""
    v = np.asarray(sim_vec).reshape(-1)[:30]
    return float(v.mean()) if v.size else 0.0


class CommModule:
    """In-process message bus for multi-agent SLAM
    (reference: system/modules/utils.py:116-154): per-member FIFO queues,
    commands NO_OP / UPLOAD_SCAN / AGENT_QUIT / QUIT."""

    OPERATIONS = ("NO_OP", "UPLOAD_SCAN", "AGENT_QUIT", "QUIT")

    def __init__(self):
        self._queues: Dict[int, "queue.Queue"] = {}

    def register(self, member_id: int) -> None:
        self._queues.setdefault(member_id, queue.Queue())

    def send_message(self, src_id: int, dst_id: int, operation: str,
                     message: Any = None) -> None:
        assert operation in self.OPERATIONS, operation
        self._queues[dst_id].put((src_id, operation, message))

    def fetch_message(self, member_id: int, block: bool = True,
                      timeout: float | None = None
                      ) -> Tuple[int, str, Any] | None:
        try:
            return self._queues[member_id].get(block=block, timeout=timeout)
        except queue.Empty:
            return None
