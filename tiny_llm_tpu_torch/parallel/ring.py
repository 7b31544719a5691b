"""The ring hop: the port's counterpart of `jax.lax.ppermute` over one mesh
axis, shared by the pipeline (parallel/pipeline.py) and the overlapped TP
matmuls (parallel/overlap.py).

An axis has n positions; a hop delivers the tensor that position p sends to
position p + 1 (mod n). Two implementations, one interface, each the axis
of ops/axis.py (whose collectives the SP, TP, DP and EP strategies use)
with the hop added:

  * `LocalRing` (a LocalAxis): every position in this process, position p
    on devices[p] (the port's mesh devices). The hop is a copy to the next
    position's device; on one card `.to()` returns the tensor itself.
  * `GroupRing` (a GroupAxis): position r is rank r of a torch.distributed
    process group, holding its own tensors. The hop is one
    `dist.batch_isend_irecv` of this rank's sends and receives, issued by
    `start` and completed by `wait`, so a caller overlaps it with compute
    issued in between.

`positions` says which positions this process holds: all of them in a
LocalRing, its own rank in a GroupRing. `start(sends, expect)` takes a dict
position -> tensor of what the held positions send, and a dict position ->
(shape, dtype) of what the held positions receive (a GroupRing allocates
those buffers; a LocalRing knows them from the sends).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.axis import GroupAxis, LocalAxis


class Hop:
    """A started hop: wait() completes it and returns position -> tensor."""

    def __init__(self, received: dict, works=(), sent=()):
        # The sent tensors stay referenced until the hop completes.
        self._received, self._works, self._sent = received, works, sent

    def wait(self) -> dict:
        for w in self._works:
            w.wait()
        self._works, self._sent = (), ()
        return self._received


class LocalRing(LocalAxis):
    """An axis whose positions all live in this process, position p on
    devices[p]."""

    def start(self, sends: dict, expect: dict | None = None) -> Hop:
        n = self.size
        return Hop({(p + 1) % n: t.to(self.devices[(p + 1) % n]) for p, t in sends.items()})


class GroupRing(GroupAxis):
    """An axis over the ranks of a process group (None: the default group),
    rank r at position r, its tensors on `device`."""

    def peer(self, position: int) -> int:
        """The global rank of an axis position."""
        p = position % self.size
        return p if self.group is None else dist.get_global_rank(self.group, p)

    def start(self, sends: dict, expect: dict | None = None) -> Hop:
        expect = expect or {}
        if set(sends) - {self.rank} or set(expect) - {self.rank}:
            raise ValueError(f"rank {self.rank} sends or receives for positions "
                             f"{sorted(set(sends) | set(expect))}")
        if self.size == 1:  # the position sends to itself
            return Hop(dict(sends))
        received = {p: torch.empty(shape, dtype=dtype, device=self._device)
                    for p, (shape, dtype) in expect.items()}
        ops = [dist.P2POp(dist.isend, t.contiguous(), self.peer(self.rank + 1), self.group)
               for t in sends.values()]
        ops += [dist.P2POp(dist.irecv, b, self.peer(self.rank - 1), self.group)
                for b in received.values()]
        return Hop(received, dist.batch_isend_irecv(ops) if ops else (), ops)
