"""The port's pipelines, overlapped TP matmuls and runtime as
torch.distributed ranks: gloo CPU ranks spawned by the test (one spawn per
group of checks; tests/torch_ranks_worker.py, which imports no JAX), each
rank holding its own stage or shard, against the in-process form of the
same code on the same params, which must agree bit for bit. The params are
the JAX package's random_params carried across by the bridge."""

from __future__ import annotations

import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from tiny_llm_tpu.models import random_params, tiny_test_config  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Config, from_jax_numpy  # noqa: E402
from tiny_llm_tpu_torch.parallel import (  # noqa: E402
    DecodePipeline,
    MicrobatchedPipeline,
    make_mesh,
    overlapped_tp_matmuls,
)

from . import torch_ranks_worker  # noqa: E402
from .torch_port import one_torch_thread, params_to_numpy  # noqa: E402
from .utils import assert_allclose  # noqa: E402

CPU = torch.device("cpu")
SPAWN_TIMEOUT_S = 120
BURSTS = (3, 3)


def _spawn(tmp_path, world: int, job: str, args: tuple) -> list[dict]:
    """`world` gloo ranks running torch_ranks_worker.run(job), joined within
    SPAWN_TIMEOUT_S; each rank's saved result, in rank order."""
    init = f"file://{tmp_path / 'store'}"
    ctx = mp.spawn(torch_ranks_worker.run, args=(world, init, str(tmp_path), job, args),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks of {job!r} still running after {SPAWN_TIMEOUT_S} s")
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _setup():
    jcfg = tiny_test_config(num_hidden_layers=4)
    tree = params_to_numpy(random_params(jcfg, key=1))
    cfg = Qwen3Config(**vars(jcfg))
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 4)).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, size=(4, 6)).astype(np.int32)
    return tree, cfg, prompts, tokens


@pytest.fixture(scope="module")
def pipeline_ranks(tmp_path_factory):
    """Two ranks: DecodePipeline (S = 2, Bm = 2, two bursts),
    MicrobatchedPipeline (S = 2, M = 2) and the runtime's calls; and the
    in-process forms of both pipelines on [cpu] * 2."""
    tree, cfg, prompts, tokens = _setup()
    ranks = _spawn(tmp_path_factory.mktemp("pp"), 2, "pipelines",
                   (tree, vars(cfg), prompts, tokens, BURSTS))
    with one_torch_thread():
        params = from_jax_numpy(tree, cfg, device="cpu")
        dp = DecodePipeline(params, cfg, num_stages=2, max_seq_len=64, devices=[CPU] * 2)
        tok = dp.prefill(prompts)
        local = {"tok0": tok.numpy()}
        for i, steps in enumerate(BURSTS):
            local[f"burst{i}"] = dp.decode(tok, steps)
            tok = local[f"burst{i}"][-1]
        mb = MicrobatchedPipeline(params, cfg, num_stages=2, num_microbatches=2,
                                  devices=[CPU] * 2)
        local["logits"] = mb(tokens).float().numpy()
    return ranks, local


@pytest.mark.parametrize("key", ["tok0", "burst0", "burst1"])
def test_decode_pipeline_ranks_equal_in_process(pipeline_ranks, key):
    """2 ranks, each its stage's layers and KV, tokens around the ring's
    wrap: every rank ends with the in-process form's tokens, bit for bit
    (prefill, then two bursts, the second continuing the first)."""
    ranks, local = pipeline_ranks
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[key], local[key], err_msg=f"rank {r}")


def test_microbatched_pipeline_ranks_equal_in_process(pipeline_ranks):
    """2 ranks, S = M = 2: the logits on every rank (the last stage's
    residual broadcast, the head on each) bit-equal to the in-process
    form's."""
    ranks, local = pipeline_ranks
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["logits"], local["logits"], err_msg=f"rank {r}")


def test_runtime_over_two_ranks(pipeline_ranks):
    """initialize returned True and again True (idempotent: the second call
    joins nothing); runtime_topology reads 2 processes, one node;
    host_local_requests partitions the requests by stride; barrier
    returned on both ranks."""
    ranks, _ = pipeline_ranks
    for r, got in enumerate(ranks):
        assert got["initialize_again"] is True
        assert got["topology"] == (2, r, 2, 1, 1)
        assert got["barrier"] is True
    assert ranks[0]["requests"] == [0, 2, 4, 6, 8]
    assert sorted(ranks[0]["requests"] + ranks[1]["requests"]) == list(range(10))


@pytest.fixture(scope="module")
def overlap_ranks(tmp_path_factory):
    """Four ranks running the overlapped pair and the chain, and the
    in-process form on the mesh [cpu] * 4."""
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 64)).astype(np.float32)
    w1 = rng.standard_normal((64, 128)).astype(np.float32)
    w2 = rng.standard_normal((128, 64)).astype(np.float32)
    w3 = rng.standard_normal((64, 32)).astype(np.float32)
    ranks = _spawn(tmp_path_factory.mktemp("overlap"), 4, "overlap", (x, w1, w2, w3))
    qkv_style, oproj_style = overlapped_tp_matmuls(make_mesh(tp=4, devices=[CPU] * 4))

    def parts(a, dim):
        return list(torch.from_numpy(a).chunk(4, dim))

    y1 = qkv_style(parts(x, 1), parts(w1, 1))
    local = {"qkv": y1, "oproj": oproj_style(parts(x, 1), parts(w3, 0)),
             "chain": oproj_style(y1, parts(w2, 0))}
    return ranks, {k: [t.numpy() for t in v] for k, v in local.items()}, (x, w1, w2, w3)


@pytest.mark.parametrize("key", ["qkv", "oproj", "chain"])
def test_overlap_ranks_equal_in_process(overlap_ranks, key):
    """Rank r's part equals the in-process form's part r, and the parts
    make up the unsharded product at tests/test_distributed.py's atol
    1e-4."""
    ranks, local, (x, w1, w2, w3) = overlap_ranks
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[key], local[key][r], err_msg=f"rank {r}")
    want = {"qkv": x @ w1, "oproj": x @ w3, "chain": (x @ w1) @ w2}[key]
    assert_allclose(np.concatenate([g[key] for g in ranks], axis=1), want, atol=1e-4)
