"""The rank side of tests/test_torch_ranks.py: one spawned process per rank
joins a gloo group through the port's `initialize`, runs a job and saves
what it computed for the test to compare with the in-process form. It
imports no JAX (a rank starts in about a second): the params arrive as the
bridge's numpy tree (models/bridge.py), the same full params on every
rank."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tiny_llm_tpu_torch.models import Qwen3Config, from_jax_numpy
from tiny_llm_tpu_torch.parallel import (
    DecodePipeline,
    MicrobatchedPipeline,
    barrier,
    host_local_requests,
    initialize,
    overlapped_tp_matmuls,
    runtime_topology,
)

CPU = torch.device("cpu")


def pipelines(rank: int, world: int, tree: dict, cfg: dict, prompts: np.ndarray,
              tokens: np.ndarray, bursts: tuple[int, ...]) -> dict:
    """DecodePipeline (S = world, Bm = B / world): prefill, then `bursts`
    decode bursts, each continuing the last; MicrobatchedPipeline (S = M =
    world) on `tokens`. Then the runtime's calls."""
    cfg = Qwen3Config(**cfg)
    params = from_jax_numpy(tree, cfg, device="cpu")
    dp = DecodePipeline(params, cfg, num_stages=world, max_seq_len=64, devices=[CPU],
                        group=dist.group.WORLD)
    tok = dp.prefill(prompts)
    out = {"tok0": tok.numpy()}
    for i, steps in enumerate(bursts):
        got = dp.decode(tok, steps)
        out[f"burst{i}"] = got
        tok = got[-1]
    mp = MicrobatchedPipeline(params, cfg, num_stages=world, num_microbatches=world,
                              devices=[CPU], group=dist.group.WORLD)
    out["logits"] = mp(tokens).float().numpy()
    topo = runtime_topology([CPU])
    out["initialize_again"] = initialize("unused://", device="cpu")
    out["topology"] = (topo.num_processes, topo.process_index, topo.num_devices,
                       topo.num_local_devices, topo.num_slices)
    out["requests"] = host_local_requests(list(range(10)))
    barrier("ranks")
    out["barrier"] = True
    return out


def overlap(rank: int, world: int, x: np.ndarray, w1: np.ndarray, w2: np.ndarray,
            w3: np.ndarray) -> dict:
    """The overlapped TP pair over the group, on this rank's parts:
    qkv_style(x, w1) (w1 split on columns), oproj_style(x, w3) (w3 split on
    rows) and the chain oproj_style(qkv_style(x, w1), w2)."""
    qkv_style, oproj_style = overlapped_tp_matmuls(group=dist.group.WORLD, device=CPU)

    def part(a, dim):
        return torch.from_numpy(np.ascontiguousarray(np.split(a, world, axis=dim)[rank]))

    y1 = qkv_style(part(x, 1), part(w1, 1))
    return {"qkv": y1.numpy(), "oproj": oproj_style(part(x, 1), part(w3, 0)).numpy(),
            "chain": oproj_style(y1, part(w2, 0)).numpy()}


JOBS = {"pipelines": pipelines, "overlap": overlap}


def run(rank: int, world: int, init_method: str, out_dir: str, job: str, args: tuple) -> None:
    """One rank: one torch thread, a gloo group through `initialize`, the
    job, its result saved as out_dir/rank<r>.pt."""
    torch.set_num_threads(1)
    if not initialize(init_method, num_processes=world, process_id=rank, device="cpu"):
        raise RuntimeError(f"rank {rank}: initialize({init_method!r}) joined no group")
    try:
        result = JOBS[job](rank, world, *args)
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(out_dir) / f"rank{rank}.pt")
