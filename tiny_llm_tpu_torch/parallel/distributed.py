"""The multi-process runtime — counterpart of tiny_llm_tpu/parallel/distributed.py.

The JAX package joins every host process into one runtime
(`jax.distributed.initialize`) and lays a mesh whose inner axes ride ICI
inside a slice and whose outer axes ride DCN between slices. The port's
processes are `torch.distributed` ranks, one process group over them: a
"slice" is a node (NVLink inside it, the network between nodes), and a
launcher such as `torchrun --nproc-per-node N` names the group through
MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK /
LOCAL_WORLD_SIZE.

Single-process sessions need no configuration: `initialize()` is a strict
no-op unless the caller passes an address or a launcher named a group of
more than one rank, and `make_multihost_mesh` is `make_mesh` on one node.
The backend follows the device: NCCL for the card (the default), gloo only
when the caller asks for the CPU; a failure raises, it never switches
backends.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
    *,
    device: str = "cuda",
) -> bool:
    """Join the process group; a no-op in a single process.

    Returns True if a group is initialized (now or earlier in this
    process), False for a single-process session. `coordinator_address`:
    an init method ("tcp://host:port", "file:///path", or "host:port" for
    tcp), else the launcher's MASTER_ADDR with WORLD_SIZE > 1 and RANK
    ("env://"), else nothing happens. `num_processes` / `process_id`
    default to WORLD_SIZE / RANK. On the card the rank takes CUDA device
    `local_device_ids[0]` (default LOCAL_RANK, else 0) and the NCCL
    backend; `device="cpu"` takes gloo."""
    if dist.is_initialized():
        return True
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address is None:
        if not (os.environ.get("MASTER_ADDR") and (world or 1) > 1 and rank is not None):
            return False
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if device == "cpu":
        backend = "gloo"
    elif device == "cuda":
        backend = "nccl"
        local = local_device_ids[0] if local_device_ids else (_env_int("LOCAL_RANK") or 0)
        torch.cuda.set_device(local)
    else:
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    dist.init_process_group(backend, init_method=init_method, world_size=world if world else -1,
                            rank=rank if rank is not None else -1)
    return True


@dataclasses.dataclass(frozen=True)
class Topology:
    """What the runtime looks like after initialize(): processes (ranks),
    this process's index, devices over all processes and in this one, and
    slices (nodes)."""

    num_processes: int
    process_index: int
    num_devices: int
    num_local_devices: int
    num_slices: int

    @property
    def devices_per_slice(self) -> int:
        return self.num_devices // self.num_slices


def _local_devices(devices) -> list[torch.device]:
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("runtime_topology: no CUDA device; pass devices= (e.g. [cpu] * 8)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def runtime_topology(devices=None) -> Topology:
    """The group's shape: its world size and this rank, `devices` (default:
    every CUDA device) as this process's devices, each rank driving as
    many, and the nodes from LOCAL_WORLD_SIZE (ranks a node; unset: one
    node)."""
    local = _local_devices(devices)
    if dist.is_initialized():
        n, idx = dist.get_world_size(), dist.get_rank()
    else:
        n, idx = 1, 0
    per_node = _env_int("LOCAL_WORLD_SIZE") or n
    return Topology(num_processes=n, process_index=idx, num_devices=len(local) * n,
                    num_local_devices=len(local), num_slices=max(n // per_node, 1))


def make_multihost_mesh(dp: int = 1, tp: int | None = None, devices=None) -> Mesh:
    """A (dp, tp) mesh that keeps TP inside one node when the run spans
    nodes. On one node (every single-process session): `make_mesh`. Across
    nodes, dp must be a multiple of the node count and tp must fit in one
    node; `devices` in rank order (a launcher numbers ranks node by node)
    laid out row-major puts every node crossing on the dp axis."""
    devices = _local_devices(devices)
    topo = runtime_topology(devices)
    n = len(devices)
    if tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != devices({n})")
    if topo.num_slices > 1:
        if dp % topo.num_slices:
            raise ValueError(f"dp({dp}) must be a multiple of the slice count "
                             f"({topo.num_slices}) so only dp traffic crosses nodes")
        if tp > topo.devices_per_slice:
            raise ValueError(f"tp({tp}) exceeds devices per slice ({topo.devices_per_slice}); "
                             "TP collectives must stay on NVLink, inside one node")
    return make_mesh(dp=dp, tp=tp, devices=devices)


def host_local_requests(requests: list, topo: Topology | None = None) -> list:
    """Scheduler-level DP across processes: each rank serves its stride of
    the request list, in admission order."""
    topo = topo or runtime_topology([])
    if topo.num_processes <= 1:
        return list(requests)
    return list(requests[topo.process_index :: topo.num_processes])


def barrier(name: str = "tiny_llm_tpu_barrier") -> None:
    """A sync point of every rank (a no-op in a single process). `name`
    labels the call, as in the JAX package; torch's barrier has none."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
