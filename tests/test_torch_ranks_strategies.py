"""The port's SP, TP, DP and EP as torch.distributed ranks: gloo CPU ranks
spawned by the test (one spawn a world size; tests/torch_ranks_worker.py
`strategies`, which imports no JAX), one shard of the axis a rank, against
the in-process form of the same code on the same inputs, which must agree
bit for bit on every rank, at world 2 and 4. A rank's copy of the slab,
pool or KV heads it does not own is NaN. The params are the JAX package's
random_params carried across by the bridge: a 2-layer model (a dense layer
and a MoE layer of 8 experts), whose TP logits are also held to the JAX
package's unsharded model."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params, tiny_test_config  # noqa: E402

from . import torch_ranks_worker  # noqa: E402
from .test_torch_ranks import _spawn  # noqa: E402
from .torch_port import one_torch_thread, params_to_numpy  # noqa: E402
from .utils import assert_allclose  # noqa: E402

WORLDS = (2, 4)
B, HQ, HKV, D, S, PAGES, PS = 4, 8, 4, 32, 64, 16, 8
CTX = np.array([24, 21, 20, 23], np.int32)  # every row within 3 pages: a dp = 4 stripe
KEYS = ("sp_flash_decode", "sp_flash_chunk", "sp_paged_decode", "sp_paged_chunk",
        "sp_paged_none", "tp_flash", "tp_paged", "tp_paged_none", "tp_linear_in",
        "tp_linear_out", "dp_paged", "dp_paged_none", "dp_paged_one", "dp_paged_one_chunk",
        "ep", "model_tp", "model_sp", "model_dp")


def _config():
    return tiny_test_config(num_hidden_layers=2, num_attention_heads=HQ, num_key_value_heads=HKV,
                            head_dim=D, max_position_embeddings=128, num_experts=8,
                            num_experts_per_tok=2, moe_intermediate_size=128,
                            norm_topk_prob=True, mlp_only_layers=(0,))


def _pinned_table(world: int, rng) -> np.ndarray:
    """A block table whose row b's 3 pages lie in its dp replica's stripe
    (replica b // (B / world); its first page is its trash page)."""
    p_loc, rows = PAGES // world, B // world
    table = np.full((B, 4), -1, np.int32)
    for b in range(B):
        lo = (b // rows) * p_loc
        table[b, :3] = rng.choice(np.arange(lo + 1, lo + p_loc), 3, replace=p_loc - 1 < 3)
    return table


def _data(world: int) -> dict:
    rng = np.random.default_rng(21)

    def normal(*shape):  # f32, carried to the ranks as numpy; the worker rounds to bf16
        return rng.normal(size=shape).astype(np.float32)

    out = {"q1": normal(B, HQ, 1, D), "q8": normal(B, HQ, 8, D), "q20": normal(B, HQ, 20, D),
           "k": normal(B, HKV, S, D), "v": normal(B, HKV, S, D),
           "kp": normal(PAGES, HKV, PS, D), "vp": normal(PAGES, HKV, PS, D),
           "x": normal(3, HQ * D), "x_moe": normal(1, 6, 128)}
    out["lens"] = np.array([64, 40, 17, 9], np.int32)
    out["bt"] = rng.integers(1, PAGES, size=(B, 4)).astype(np.int32)
    out["bt_dp"] = _pinned_table(world, rng)
    out["ctx"] = CTX
    out["prompts"] = rng.integers(0, 128, size=(B, 6)).astype(np.int32)
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=[f"world{w}" for w in WORLDS])
def strategy_ranks(request, tmp_path_factory):
    """`world` ranks running `strategies`, and the same call in this process
    (every shard of the axis here)."""
    world = request.param
    jcfg = _config()
    jparams = random_params(jcfg, key=4)
    tree = params_to_numpy(jparams)
    data = _data(world)
    ranks = _spawn(tmp_path_factory.mktemp(f"strategies{world}"), world, "strategies",
                   (tree, vars(jcfg), data))
    with one_torch_thread():
        local = torch_ranks_worker.strategies(None, world, tree, vars(jcfg), data)
    return world, ranks, local, (jcfg, jparams, data)


@pytest.mark.parametrize("key", KEYS)
def test_strategy_ranks_equal_in_process(strategy_ranks, key):
    """Every rank's result bit-equal to the in-process form's, which is
    finite (a NaN shard read would show)."""
    world, ranks, local, _ = strategy_ranks
    assert np.isfinite(local[key]).all(), key
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[key], local[key], err_msg=f"world {world} rank {r}")


def test_tp_ranks_model_matches_jax(strategy_ranks):
    """The TP model's prefill logits over ranks within tests/test_torch_tp.py's
    tolerance of the JAX package's unsharded model's."""
    world, ranks, _, (jcfg, jparams, data) = strategy_ranks
    want = np.asarray(JaxQwen3Model(jparams, jcfg, max_seq_len=64)(
        jnp.asarray(data["prompts"]))[:, -1], np.float32)
    for got in ranks:
        assert_allclose(got["model_tp"][0], want, jnp.bfloat16, atol=5e-2)
