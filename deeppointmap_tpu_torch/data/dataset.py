"""Dataset hierarchy: BasicDataset -> BasicScene -> BasicAgent, and the
training sampler SlamDatasets (port of deeppointmap_tpu/data/dataset.py;
reference: dataloader/body.py:36-397).

  * BasicAgent is one directory of scans in one format, sorted by their
    numeric file names: the inference per-sequence dataset (with the
    reference's split_num/split_index multi-agent slicing, 5% overlap) and
    the training leaf.
  * SlamDatasets' registration item samples S in [2, K] nearby frames x
    num_map map groups (body.py:97-153); its loop item samples a pair
    stratified <d / d-2d / >2d (body.py:62-95).
  * the per-scene pairwise frame-distance matrix is cached as
    frame_dis.npy (body.py:363-396), kept in memory when the scene
    directory is read-only, and stored as float16.

Every random draw comes from the one np.random.Generator the caller
passes, in the JAX package's order, so that both packages build the same
items from the same seed. Iteration is plain Python (no DataLoader); the
Trainer's batch producer (pipeline/producer.py) runs it in a process of
its own. There, when the chain draws nothing (`transforms_draw`), its
`loader` (an executor of loader processes) reads and transforms the
frames: an item then holds futures of its frames, which `ready` waits
for, and the draws stay in the serial order on the producer's thread.
"""

from __future__ import annotations

import glob as globlib
import logging
import os
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from deeppointmap_tpu_torch.data.readers import get_reader, read_auto
from deeppointmap_tpu_torch.data.transforms import draws, unchanged
from deeppointmap_tpu_torch.utils import timer

logger = logging.getLogger(__name__)

#: a training item's scan reads and host transforms (utils/timer.py)
_READ = timer.span("train.read")
_TRANSFORM = timer.span("train.transform")


def _read_frame(reader, path: str, agent_transforms):
    """A BasicAgent's frame: the file read, then the agent's transforms."""
    data = reader(path)
    if agent_transforms is not None:
        data = agent_transforms(data)
    return data


def _load_frame(reader, path: str, agent_transforms, data_transforms):
    """A loader process's task: (the frame read and transformed, the tally
    of its spans)."""
    with timer.scope("train.load") as tally:
        with _READ:
            frame = _read_frame(reader, path, agent_transforms)
        with _TRANSFORM:
            frame = data_transforms(frame)
    return frame, tally


def ready(frame):
    """A frame of a SlamDatasets item: the scan itself, or, where a loader
    built it, the scan waited for, its spans added to this thread's scope."""
    if isinstance(frame, Future):
        frame, tally = frame.result()
        timer.add(tally)
    return frame


def _length_range(items) -> np.ndarray:
    out = [0]
    for it in items:
        out.append(len(it) + out[-1])
    return np.asarray(out, np.int64)


class BasicAgent:
    """One agent's frame sequence in one scene
    (reference: body.py:317-360)."""

    def __init__(self, root: str, reader: Union[Callable, str] = "auto",
                 parent: Optional["BasicScene"] = None,
                 split_num: int = 1, split_index: int = 0):
        self.root = root
        self.parent = parent
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
        return _read_frame(self.reader, self.file_list[item],
                           self.data_transforms)

    def __len__(self) -> int:
        return len(self.file_list)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def set_independent(self, data_transforms: Callable) -> None:
        self.data_transforms = data_transforms


class BasicScene:
    """All agents of one scene (reference: body.py:285-314)."""

    def __init__(self, root: str, reader, parent=None, args=None):
        self.root = root
        self.parent = parent
        self.agent_list: List[BasicAgent] = []
        for name in sorted(os.listdir(root)):
            agent_root = os.path.join(root, name)
            if os.path.isdir(agent_root):
                self.agent_list.append(
                    BasicAgent(agent_root, reader, parent=self))
        self.pcd_range = _length_range(self.agent_list)

    def agent_of(self, item: int) -> Tuple[BasicAgent, int]:
        aid = int(np.sum(self.pcd_range <= item) - 1)
        return self.agent_list[aid], int(item - self.pcd_range[aid])

    def __getitem__(self, item: int):
        agent, i = self.agent_of(item)
        return agent[i]

    def __len__(self) -> int:
        return int(self.pcd_range[-1])


class BasicDataset:
    """All scenes of one dataset (reference: body.py:229-282)."""

    def __init__(self, root: str, reader, scenes: Sequence[str], name: str,
                 args=None):
        self.root = root
        self.name = name
        if not os.path.isdir(root):
            raise NotADirectoryError(f"{root!r} is not a directory")
        self.scene_list: List[BasicScene] = []
        for scene_name in scenes:
            scene_root = os.path.join(root, str(scene_name))
            if not os.path.isdir(scene_root):
                raise NotADirectoryError(f"{scene_root!r} is not a directory")
            self.scene_list.append(BasicScene(scene_root, reader, parent=self,
                                              args=args))
        self.pcd_range = _length_range(self.scene_list)

    def agent_of(self, item: int) -> Tuple[BasicAgent, int]:
        """(the agent that holds frame `item`, its index there)."""
        sid = int(np.sum(self.pcd_range <= item) - 1)
        return self.scene_list[sid].agent_of(item - self.pcd_range[sid])

    def __getitem__(self, item: int):
        agent, i = self.agent_of(item)
        return agent[i]

    def __len__(self) -> int:
        return int(self.pcd_range[-1])

    def get_frame_order(self, item: int) -> Tuple[int, int]:
        sid = int(np.sum(self.pcd_range <= item) - 1)
        return sid, int(item - self.pcd_range[sid])


def get_frame_dis(dataset_list: List[BasicDataset]) -> List[List[np.ndarray]]:
    """Pairwise GT translation distances per scene, float16, cached as
    frame_dis.npy in the scene directory (reference: body.py:363-396);
    kept in memory when that directory is not writable."""
    out = []
    for dataset in dataset_list:
        per_scene = []
        for scene in dataset.scene_list:
            files: List[str] = []
            for agent in scene.agent_list:
                files += agent.file_list
            cache = os.path.join(scene.root, "frame_dis.npy")
            dis = None
            if os.path.exists(cache):
                arr = np.load(cache).astype(np.float32)
                if arr.shape[0] == arr.shape[1] == len(files):
                    dis = arr
            if dis is None:
                poses = np.stack([read_auto(f).translation.reshape(3)
                                  for f in files], 0)
                dis = np.linalg.norm(poses[:, None] - poses[None, :],
                                     axis=-1).astype(np.float32)
                try:
                    np.save(cache, dis)
                except OSError:
                    logger.warning("scene dir read-only; frame_dis kept "
                                   "in memory for %s", scene.root)
            per_scene.append(dis.astype(np.float16))
        out.append(per_scene)
    return out


class SlamDatasets:
    """Training sampler over the dataset hierarchy
    (reference: body.py:36-226)."""

    def __init__(self, args, data_transforms: Optional[Callable] = None,
                 rng: Optional[np.random.Generator] = None):
        self.args = args
        self.dataset_cfg = args.dataset
        self.registration_cfg = args.train.registration
        self.loop_detection_cfg = args.train.loop_detection
        self.data_transforms = data_transforms or unchanged
        self.rng = rng or np.random.default_rng()
        #: an executor whose processes read and transform frames, for a
        #: chain that draws nothing; None: inline
        self.loader = None

        self.dataset_list = self._load_datasets()
        self.pcd_range = _length_range(self.dataset_list)
        self.frame_distance = get_frame_dis(self.dataset_list)
        self._getitem_method = self._getitem_registration
        #: when set, registration items use this S instead of drawing it:
        #: the trainer fixes one S per global batch, so that every rank's
        #: slice has the same shape
        self.forced_S: Optional[int] = None

    def _load_datasets(self) -> List[BasicDataset]:
        out = []
        for cfg in self.dataset_cfg:
            reader = get_reader(cfg.reader["type"])
            out.append(BasicDataset(root=cfg.root, reader=reader,
                                    scenes=cfg.scenes, name=cfg.name.lower(),
                                    args=self.args))
        return out

    def __len__(self) -> int:
        return int(self.pcd_range[-1])

    def __getitem__(self, item: int):
        return self._getitem_method(item)

    def registration(self) -> None:
        self._getitem_method = self._getitem_registration

    def loop_detection(self) -> None:
        self._getitem_method = self._getitem_loop_detection

    def transforms_draw(self) -> bool:
        """Whether the transform chain draws from a generator."""
        return draws(self.data_transforms)

    def sample_S(self) -> int:
        """Draw the map size S in [2, K], biased toward pairs
        (reference: body.py:98-102)."""
        S = int(self.rng.integers(2, self.registration_cfg.K + 1))
        if self.rng.random() < 0.34:
            S = 2
        return S

    def _locate(self, index: int):
        did = int(np.sum(self.pcd_range <= index) - 1)
        offset = int(index - self.pcd_range[did])
        ds = self.dataset_list[did]
        sid, foff = ds.get_frame_order(offset)
        return did, offset, ds, sid, foff

    def _getitem_registration(self, index: int):
        """S nearby frames x num_map groups (reference: body.py:97-115)."""
        cfg = self.registration_cfg
        S = int(self.forced_S) if self.forced_S is not None else \
            self.sample_S()
        num_map = (cfg.K_max // S) if cfg.fill else 1
        info = dict(dsf_index=[], refined_SE3_file=[], num_map=num_map)
        frames = []
        for i in range(num_map):
            idx = index if i == 0 else int(self.rng.integers(0, len(self)))
            frames += self._map_query(idx, K=S, info=info)
        return frames, info

    def _map_query(self, index: int, K: int, info: dict) -> List:
        """K frames within cfg.distance of the anchor
        (reference: body.py:117-153)."""
        did, offset, ds, sid, foff = self._locate(index)
        frame_dis = self.frame_distance[did][sid][foff].astype(np.float32)

        dis_mask = frame_dis <= self.registration_cfg.distance - 0.25
        cand = (np.nonzero(dis_mask)[0] - foff).tolist()
        cand.remove(0)
        if len(dis_mask.nonzero()[0]) <= K:
            if not cand:
                cand = [0]
            cand = cand * (K // len(cand) + 1)
        offs = list(self.rng.choice(len(cand), size=K - 1, replace=False))
        map_offsets = [0] + [cand[i] for i in offs]
        info["dsf_index"] += [(did, sid, foff + o) for o in map_offsets]
        scene_root = ds.scene_list[sid].root
        info["refined_SE3_file"].append(
            "" if "carla" in ds.name else
            os.path.join(scene_root, "refined_SE3.pkl"))
        return [self._frame(did, offset + o) for o in map_offsets]

    def _frame(self, did: int, index: int):
        """Frame `index` of dataset `did`, read and transformed; with a
        loader, a future of it (`ready`)."""
        if self.loader is not None:
            agent, i = self.dataset_list[did].agent_of(index)
            return self.loader.submit(_load_frame, agent.reader,
                                      agent.file_list[i],
                                      agent.data_transforms,
                                      self.data_transforms)
        return self._load(did, index)

    def _load(self, did: int, index: int):
        with _READ:
            frame = self.dataset_list[did][index]
        with _TRANSFORM:
            return self.data_transforms(frame)

    def _getitem_loop_detection(self, index: int):
        """A pair stratified <d / d-2d / >2d (reference: body.py:62-95);
        the reads draw nothing, so both come after the pair's draws."""
        did, offset, ds, sid, foff = self._locate(index)
        frame_dis = self.frame_distance[did][sid][foff].astype(np.float32)
        s = self.rng.random()
        d = self.loop_detection_cfg.distance
        if s < 0.5:
            mask = frame_dis <= d
        elif s < 0.75:
            mask = (frame_dis > d) & (frame_dis <= 2 * d)
        else:
            mask = frame_dis > 2 * d
        cand = np.nonzero(mask)[0] - foff
        pair = int(self.rng.choice(cand)) if cand.size else 0
        return self._frame(did, offset), self._frame(did, offset + pair)
