"""Data parallelism over torch.distributed, one process per device (the
port's counterpart of deeppointmap_tpu/parallel/mesh.py and of the JAX
Trainer's mesh logic: `_build_mesh`, `_globalize`,
`_check_multihost_determinism`).

Every rank builds the SAME global batch from the same seed and takes its
slice of the batch axis; parameters are replicated; after the backward pass
the gradients are summed over the ranks. The JAX package's sharded step is
its single-device step on the global batch, whose masked means divide by
counts over the WHOLE batch, so the losses here divide by counts summed
over the ranks (`reduce_sum`, models/loss.py) and every rank's loss is its
share of the global one: the summed gradient is then the single-process
gradient on the global batch, also when the ranks hold different counts.
NCCL carries the sums on CUDA devices, gloo on the CPU.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def init_process_group(address: str, world_size: int, rank: int,
                       device: str = "cuda") -> None:
    """Join the process group at `address` (tcp://host:port; a torchrun
    environment when empty) with NCCL for CUDA devices, gloo for the CPU."""
    backend = "nccl" if str(device).startswith("cuda") else "gloo"
    kwargs = {}
    if address:
        kwargs = dict(init_method=address, world_size=int(world_size),
                      rank=int(rank))
    dist.init_process_group(backend, **kwargs)
    logger.info("torch.distributed: rank %d of %d (%s)", dist.get_rank(),
                dist.get_world_size(), backend)


def group_size() -> int:
    """The process group's world size; 1 when there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


class DataParallel:
    """This process's place in the data-parallel group: `world` ranks,
    this one `rank`. With world 1 every method is the identity."""

    def __init__(self, world: int = 1, rank: int = 0):
        self.world, self.rank = int(world), int(rank)

    @classmethod
    def from_config(cls, dp="auto") -> "DataParallel":
        """tpu.data_parallel: "auto" is the process group's world size (1
        without a group); a number must equal it, since a rank left out
        would idle or train apart."""
        world = group_size()
        n = world if dp in ("auto", None) else max(int(dp), 1)
        if n != world:
            raise ValueError(f"tpu.data_parallel {dp!r} asks for {n} ranks "
                             f"but the process group has {world}")
        if world > 1:
            logger.info("data parallel over %d ranks", world)
        return cls(world, dist.get_rank() if world > 1 else 0)

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A detached copy of `x` summed over the ranks."""
        if self.world == 1:
            return x.detach()
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def shard(self, batch: NamedTuple) -> NamedTuple:
        """This rank's slice of the batch axis of every field."""
        if self.world == 1:
            return batch
        fields = []
        for x in batch:
            n = x.shape[0]
            if n % self.world:
                raise ValueError(f"batch axis {n} does not split over "
                                 f"{self.world} ranks")
            per = n // self.world
            fields.append(x[self.rank * per:(self.rank + 1) * per])
        return type(batch)(*fields)

    def sum_grads(self, params: Sequence[torch.nn.Parameter]) -> None:
        """Sum the gradients over the ranks, in one flat buffer."""
        if self.world == 1 or not params:
            return
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def check_determinism(self, rng: np.random.Generator, n_items: int,
                          device) -> None:
        """Every rank must build the same global batch from its own dataset
        scan and generator; a divergent file system or seed would corrupt
        the gradients silently. A 65-element probe (the dataset size and a
        permutation drawn from a snapshot of `rng`, whose state is then
        restored) is gathered from every rank, a fixed size so that ranks
        that disagree on the dataset still meet in the collective."""
        if self.world == 1:
            return
        state = rng.bit_generator.state
        probe = np.concatenate([[n_items], rng.permutation(64)]).astype(
            np.int64)
        rng.bit_generator.state = state
        mine = torch.from_numpy(probe).to(device)
        gathered = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(gathered, mine)
        rows = torch.stack(gathered).cpu().numpy()
        if not (rows == rows[0]).all():
            raise RuntimeError(
                "data-parallel batch divergence: ranks disagree on dataset "
                "size or RNG stream; every rank must see the same files and "
                f"pass the same seed (probe rows: {rows[:, :4]})")
