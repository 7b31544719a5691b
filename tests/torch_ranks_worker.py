"""The rank side of tests/test_torch_ranks.py and
tests/test_torch_ranks_strategies.py: one spawned process per rank joins a
gloo group through the port's `initialize`, runs a job and saves what it
computed for the test to compare with the in-process form. It imports no
JAX (a rank starts in about a second): the params arrive as the bridge's
numpy tree (models/bridge.py), the same full params on every rank.

`strategies` runs SP, TP, DP and EP through one code path in both forms:
the test calls it in its own process (`rank=None`, every shard of the axis
here) and each rank calls it with its rank (ShardingConfig.rank_axis: one
shard a rank). A rank's copy of every slab, pool or KV head it does not own
is NaN, so a rank that read another's shard could not match."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tiny_llm_tpu_torch.kv import DenseKVCache
from tiny_llm_tpu_torch.models import Qwen3Config, Qwen3Model, from_jax_numpy
from tiny_llm_tpu_torch.ops.sharded import shard_weight, sharded_linear
from tiny_llm_tpu_torch.parallel import (
    DecodePipeline,
    DPPagedAttention,
    EPMoE,
    MicrobatchedPipeline,
    ShardingConfig,
    SPAttention,
    TPAttention,
    barrier,
    host_local_requests,
    initialize,
    make_mesh,
    overlapped_tp_matmuls,
    runtime_topology,
    shard_params,
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


def _poison(t: torch.Tensor, dim: int, n: int, rank: int | None) -> torch.Tensor:
    """t with every shard along `dim` but this rank's set to NaN (in the
    test's own process, rank None: t as it is)."""
    if rank is None:
        return t
    out = torch.full_like(t, float("nan"))
    loc = t.shape[dim] // n
    out.narrow(dim, rank * loc, loc).copy_(t.narrow(dim, rank * loc, loc))
    return out


def _decode_run(model, prompts: np.ndarray, steps: int) -> np.ndarray:
    """A dense cache: the prompts' prefill, then `steps` decode steps fed
    the greedy tokens; every step's last-position logits [steps + 1, B, V]."""
    B, L = prompts.shape
    cfg = model.cfg
    cache = DenseKVCache(cfg.num_hidden_layers, B, cfg.num_key_value_heads, 64, cfg.head_dim,
                         dtype=model.dtype, device="cpu")
    logits = [model(prompts, cache=cache)[:, -1]]
    for _ in range(steps):
        logits.append(model(logits[-1].argmax(-1)[:, None], cache=cache)[:, -1])
    return torch.stack(logits).float().numpy()


def strategies(rank: int | None, world: int, tree: dict, cfg: dict, data: dict) -> dict:
    """SP, TP, DP and EP over an axis of `world` positions: each one's
    attention or matmul calls on `data`'s tensors, and the 2-layer model's
    logits through it (a prefill and 2 greedy decode steps), as a dict of
    numpy arrays."""
    cfg = Qwen3Config(**cfg)
    params = from_jax_numpy(tree, cfg, device="cpu")
    n = world

    def scfg(axis: str) -> ShardingConfig:
        mesh = make_mesh(dp=n, tp=1, devices=[CPU] * n) if axis == "dp" else \
            make_mesh(tp=n, devices=[CPU] * n)
        return ShardingConfig(mesh, rank_axis=None if rank is None else axis)

    def t(name):  # float arrays as bf16, the kernels' type
        a = torch.from_numpy(data[name])
        return a.to(torch.bfloat16) if a.is_floating_point() else a

    q1, q8, q20 = t("q1"), t("q8"), t("q20")
    k, v, lens = t("k"), t("v"), t("lens")
    kp, vp, bt, ctx = t("kp"), t("vp"), t("bt"), t("ctx")
    out = {}
    # SP: each rank's shard of the slab (dim 2) and of the pool (dim 0).
    sp = SPAttention(scfg("tp"))
    ks, vs = _poison(k, 2, n, rank), _poison(v, 2, n, rank)
    kps, vps = _poison(kp, 0, n, rank), _poison(vp, 0, n, rank)
    out["sp_flash_decode"] = sp.flash(q1, ks, vs, lens)
    out["sp_flash_chunk"] = sp.flash(q8, ks, vs, lens)
    out["sp_paged_decode"] = sp.paged(q1, kps, vps, bt, ctx)
    out["sp_paged_chunk"] = sp.paged(q20, kps, vps, bt, ctx)
    out["sp_paged_none"] = sp.paged(q8, kps, vps, bt, ctx, mask=None)
    # TP: each rank's KV heads (dim 1) of the slab and the pool.
    tp = TPAttention(scfg("tp"))
    out["tp_flash"] = tp.flash(q8, _poison(k, 1, n, rank), _poison(v, 1, n, rank), lens)
    out["tp_paged"] = tp.paged(q1, _poison(kp, 1, n, rank), _poison(vp, 1, n, rank), bt, ctx)
    out["tp_paged_none"] = tp.paged(q8, _poison(kp, 1, n, rank), _poison(vp, 1, n, rank), bt,
                                    ctx, mask=None)
    wq = params.layers[0].attn.wo  # in-features split (partial sums) and out-features split
    x = t("x")
    out["tp_linear_in"] = sharded_linear(x, shard_weight(wq, "in", "tp", [CPU] * n,
                                                         comm=scfg("tp").axis_impl("tp")))
    out["tp_linear_out"] = sharded_linear(x, shard_weight(wq, "out", "tp", [CPU] * n,
                                                          comm=scfg("tp").axis_impl("tp")))
    # DP: each replica's rows over its own stripe (the table's pages pinned).
    dp = DPPagedAttention(scfg("dp"))
    kpd, vpd, btd = _poison(kp, 0, n, rank), _poison(vp, 0, n, rank), t("bt_dp")
    out["dp_paged"] = dp.paged(q1, kpd, vpd, btd, ctx)
    out["dp_paged_none"] = dp.paged(q8, kpd, vpd, btd, ctx, mask=None)
    out["dp_paged_one"] = dp.paged(q1[:1], kpd, vpd, btd[:1], ctx[:1])
    out["dp_paged_one_chunk"] = dp.paged(q20[:1], kpd, vpd, btd[:1], ctx[:1])
    # EP: each rank's experts' weights alone.
    moe = params.layers[1].mlp
    ep = EPMoE(scfg("tp"), moe.w_router, moe.w_gate, moe.w_up, moe.w_down,
               cfg.num_experts_per_tok, cfg.norm_topk_prob)
    out["ep"] = ep(t("x_moe"))
    # The model through each strategy: TP (and the experts over tp), SP, DP.
    prompts = data["prompts"]
    for name, axis, strategy, split in (("tp", "tp", TPAttention, True),
                                        ("sp", "tp", SPAttention, False),
                                        ("dp", "dp", None, True)):
        c = scfg(axis)
        model = Qwen3Model(shard_params(params, c) if split else params, cfg, max_seq_len=64,
                           device="cpu", attn_impl=None if strategy is None else strategy(c))
        out[f"model_{name}"] = _decode_run(model, prompts, 2)
    return {key: val if isinstance(val, np.ndarray) else val.float().numpy()
            for key, val in out.items()}


JOBS = {"pipelines": pipelines, "overlap": overlap, "strategies": strategies}


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
