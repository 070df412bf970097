"""The per-sequence inference dataset (port of `BasicAgent` from
deeppointmap_tpu/data/dataset.py; reference: dataloader/body.py:317-360).

One directory of scans in one format, sorted by their numeric file names,
with the reference's split_num/split_index multi-agent slicing (5% overlap).
Iteration is plain Python; the inference pipeline overlaps reading with
device compute through its own prefetch threads. The scene / dataset
hierarchy and the training sampler of the JAX package are not ported yet.
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Callable, Optional, Union

from deeppointmap_tpu_torch.data.readers import get_reader, read_auto


class BasicAgent:
    """One agent's frame sequence in one scene
    (reference: body.py:317-360)."""

    def __init__(self, root: str, reader: Union[Callable, str] = "auto",
                 split_num: int = 1, split_index: int = 0):
        self.root = root
        self.data_transforms: Optional[Callable] = None

        files = globlib.glob(os.path.join(root, "*.*"))
        types = {os.path.splitext(f)[1] for f in files}
        assert len(types) <= 1, (
            f"mixed file extensions under {root!r}: {sorted(types)}; an "
            "agent directory must hold a single scan format")
        if isinstance(reader, str):
            reader = (read_auto if reader == "auto"
                      else get_reader(reader))
        self.reader = reader
        files = sorted(files,
                       key=lambda s: int(os.path.basename(s).split(".")[0]))
        if split_num > 1:
            total = len(files)
            ratio = 1.0 / split_num
            # adjacent agent slices share a 5%-of-sequence overlap band so
            # cross-agent loop closure has common geometry to latch onto
            # (split semantics must match reference body.py:340-348)
            overlap = 1.0 / 20.0
            start = max(ratio * split_index - overlap, 0.0)
            end = min(ratio * (split_index + 1) + overlap, 1.0)
            files = files[int(total * start):int(total * end)]
        self.file_list = files

    def __getitem__(self, item: int):
        data = self.reader(self.file_list[item])
        if self.data_transforms is not None:
            data = self.data_transforms(data)
        return data

    def __len__(self) -> int:
        return len(self.file_list)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def set_independent(self, data_transforms: Callable) -> None:
        self.data_transforms = data_transforms
