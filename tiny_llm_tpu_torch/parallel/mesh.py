"""Device mesh — counterpart of tiny_llm_tpu/parallel/mesh.py.

A mesh names its axes ("dp", optionally "ep", then "tp"), their sizes and
the devices laid out on them in row-major order. The port's strategies run
the shards of one axis in one process, one after another, each on its mesh
device; a device list that repeats one device (`[torch.device("cuda", 0)]
* 8`) puts every shard on it, as the JAX package's tests put their shards
on 8 virtual CPU devices. A list of distinct cards places each shard on its
own card, with the collectives as copies through the process. Across
processes, torch.distributed ranks (distributed.py) carry the pipeline and
the overlapped TP matmuls through the ring hop of ring.py.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]  # row-major over the axes

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.sizes))

    def devices_along(self, axis: str, **at: int) -> list[torch.device]:
        """The devices along `axis`, every other axis at its index in `at`
        (default 0): the devices of one shard group, as a shard_map over
        `axis` sees them from mesh position `at`."""
        out = []
        for i in range(self.shape[axis]):
            idx = 0
            for name, size in zip(self.axis_names, self.sizes):
                idx = idx * size + (i if name == axis else at.get(name, 0))
            out.append(self.devices[idx])
        return out


def make_mesh(dp: int = 1, tp: int | None = None, ep: int = 1, devices=None) -> Mesh:
    """A (dp[, ep], tp) mesh over `devices` (default: every CUDA device);
    tp defaults to what the devices leave after dp and ep."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= (e.g. [cpu] * 8)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if tp is None:
        tp = n // (dp * ep)
    if dp * ep * tp != n:
        raise ValueError(f"dp({dp}) * ep({ep}) * tp({tp}) != devices({n})")
    if ep > 1:
        return Mesh(("dp", "ep", "tp"), (dp, ep, tp), devices)
    return Mesh(("dp", "tp"), (dp, tp), devices)
