"""A mesh axis's positions and its collectives, in one process or over
torch.distributed ranks: the port's counterpart of a shard_map axis and
its psum and all_gather.

One interface, two implementations, so that each strategy keeps a single
code path (parallel/ring.py adds the ring hop to both):

  * `LocalAxis`: every position in this process, position p on devices[p]
    (the mesh's devices along the axis). A collective moves each position's
    tensor to the caller's device and reduces there.
  * `GroupAxis`: position r is rank r of a torch.distributed process group
    (None: the default group) and holds its own tensors on `device`. A
    collective is a `dist.all_gather` over the group.

`positions` says which positions this process holds: all of them, or its
own rank. The collectives take a dict position -> tensor of the held
positions' parts and return the same result on every rank:

  * `gather`: every position's part, in position order;
  * `sum`: the sum over the positions, added in position order, 0, 1, ...
    n - 1, so that the ranks' sum is bit-equal to the in-process one.
    (`all_reduce(SUM)` promises no order on more than two ranks: the
    parts are gathered and added in order instead.)
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist


class LocalAxis:
    """An axis whose positions all live in this process, position p on
    devices[p]."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.positions = range(self.size)

    def device(self, position: int) -> torch.device:
        return self.devices[position]

    def gather(self, parts: dict, device=None) -> list:
        """[part of position 0, ..., n - 1], each on `device` (default the
        first part's)."""
        dev = device or parts[0].device
        return [parts[p].to(dev) for p in range(self.size)]

    def sum(self, parts: dict, device=None) -> torch.Tensor:
        return functools.reduce(torch.add, self.gather(parts, device))


class GroupAxis:
    """An axis over the ranks of a process group (None: the default group),
    rank r at position r, its tensors on `device`."""

    def __init__(self, group=None, device: str | torch.device = "cuda"):
        self.group = group
        self._device = torch.device(device)
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.positions = (self.rank,)

    def device(self, position: int) -> torch.device:
        return self._device

    def _own(self, parts: dict) -> torch.Tensor:
        if set(parts) != {self.rank}:
            raise ValueError(f"rank {self.rank} holds position {self.rank}, not {sorted(parts)}")
        return parts[self.rank].contiguous()

    def gather(self, parts: dict, device=None) -> list:
        t = self._own(parts)
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return [o.to(device) for o in out] if device is not None else out

    def sum(self, parts: dict, device=None) -> torch.Tensor:
        return functools.reduce(torch.add, self.gather(parts, device))
