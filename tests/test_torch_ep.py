"""The port's expert parallelism (tiny_llm_tpu_torch.parallel.EPMoE, and MoE
layers whose experts shard_params splits over tp or over ep x tp, on the
CPU) against the JAX package's: all of tests/test_ep_moe.py (dropless
equal to the unsharded layer, quantized experts, capacity drops equal to
JAX's) and tests/test_sharding.py's EP cases (:144 EP over tp, :190 the
composed EP x TP model, dense and quantized, with a decode step; :229 its
specs; :245 speculative decoding under a composed target), on the same
numpy inputs, JAX on tests/conftest.py's 8 virtual devices and the port
on the mesh [cpu] * 8."""

from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.generate import simple_generate_with_kv_cache as jax_greedy  # noqa: E402
from tiny_llm_tpu.generate import speculative_generate as jax_speculative  # noqa: E402
from tiny_llm_tpu.models import Qwen3Config as JaxQwen3Config  # noqa: E402
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu.ops.moe import moe_forward as jax_moe_forward  # noqa: E402
from tiny_llm_tpu.ops.quantize import quantize_stacked as jax_quantize_stacked  # noqa: E402
from tiny_llm_tpu.parallel import EPMoE as JaxEPMoE  # noqa: E402
from tiny_llm_tpu.parallel import ShardingConfig as JaxShardingConfig  # noqa: E402
from tiny_llm_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tiny_llm_tpu.parallel import param_shardings as jax_param_shardings  # noqa: E402
from tiny_llm_tpu.parallel import shard_params as jax_shard_params  # noqa: E402
from tiny_llm_tpu_torch.generate import simple_generate_with_kv_cache  # noqa: E402
from tiny_llm_tpu_torch.generate import speculative_generate  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Config, Qwen3Model  # noqa: E402
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402
from tiny_llm_tpu_torch.ops.moe import moe_forward  # noqa: E402
from tiny_llm_tpu_torch.ops.sharded import ShardedWeight  # noqa: E402
from tiny_llm_tpu_torch.parallel import (  # noqa: E402
    EPMoE,
    ShardingConfig,
    make_mesh,
    param_shardings,
    shard_params,
)

from .torch_port import f32, port_params, qt_to_numpy  # noqa: E402
from .utils import FakeTokenizer, assert_allclose  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

CPU8 = [torch.device("cpu")] * 8


def _weights(E=8, D=64, I=96, quantized=False, seed=5):
    """tests/test_ep_moe.py's weights, as (JAX, port) pairs."""
    rng = np.random.default_rng(seed)
    wr = rng.normal(size=(E, D)).astype(np.float32) * 0.3
    ws = [rng.normal(size=s).astype(np.float32) * 0.1 for s in ((E, I, D), (E, I, D), (E, D, I))]
    jw = [jnp.asarray(wr)] + [jnp.asarray(w) for w in ws]
    pw = [torch.from_numpy(wr)] + [torch.from_numpy(w) for w in ws]
    if quantized:
        qs = [jax_quantize_stacked(jnp.asarray(w, jnp.bfloat16), group_size=32) for w in ws]
        jw = jw[:1] + qs
        pw = pw[:1] + [quantized_from_numpy(qt_to_numpy(q)) for q in qs]
    return jw, pw


def _x(shape, seed, dtype=np.float32):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return jx, tx


def _scfg(tp, dp=1, ep=1):
    return ShardingConfig(make_mesh(dp=dp, ep=ep, tp=tp, devices=CPU8[: dp * ep * tp]))


def _jax_scfg(tp, dp=1, ep=1, **kw):
    return JaxShardingConfig(jax_make_mesh(dp=dp, ep=ep, tp=tp,
                                           devices=jax.devices()[: dp * ep * tp]), **kw)


def _jax_ep(shards, jw, jx, **kw):
    """JAX's EPMoE under jit (its shard_map traced once, not op by op)."""
    layer = JaxEPMoE(_jax_scfg(shards), *jw, num_experts_per_tok=2, **kw)
    return np.asarray(jax.jit(lambda x: layer(x))(jx), np.float32)


@pytest.mark.parametrize("shards", [2, 8])
def test_ep_moe_matches_single_device(shards):
    """test_ep_moe.py:30 on the port: dropless EPMoE against the port's
    unsharded moe_forward and against JAX's EPMoE."""
    jw, pw = _weights()
    jx, tx = _x((2, 3, 64), 6)
    want = _jax_ep(shards, jw, jx, norm_topk_prob=True)
    ep = EPMoE(_scfg(shards), *pw, num_experts_per_tok=2, norm_topk_prob=True)
    got = f32(ep(tx))
    ref = f32(moe_forward(tx, *pw, num_experts_per_tok=2, norm_topk_prob=True))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert isinstance(ep.w_gate, ShardedWeight) and len(ep.w_gate.parts) == shards


def test_ep_moe_quantized_experts():
    """test_ep_moe.py:46 on the port: group-32 quantized experts, bf16 x,
    four shards."""
    jw, pw = _weights(quantized=True)
    jx, tx = _x((1, 4, 64), 7, "bf16")
    want = _jax_ep(4, jw, jx)
    got = f32(EPMoE(_scfg(4), *pw, num_experts_per_tok=2)(tx))
    ref = f32(moe_forward(tx, *pw, num_experts_per_tok=2))
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got, ref, rtol=5e-2, atol=5e-2)
    unsharded = jax.jit(lambda x: jax_moe_forward(x, *jw, num_experts_per_tok=2))(jx)
    np.testing.assert_allclose(np.asarray(unsharded, np.float32), ref, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("factor,shards", [(1.25, 2), (1.0, 2), (1.0, 4)])
def test_ep_moe_capacity_drops_match_jax(factor, shards):
    """test_ep_moe.py:60 on the port: a capacity factor bounds each shard at
    ceil(T f / n) rows and drops the overflow. The drops are the same as
    JAX's, row for row (the same outputs), and some happen."""
    jw, pw = _weights()
    jx, tx = _x((2, 4, 64), 8)
    want = _jax_ep(shards, jw, jx, capacity_factor=factor)
    got = f32(EPMoE(_scfg(shards), *pw, num_experts_per_tok=2, capacity_factor=factor)(tx))
    full = f32(EPMoE(_scfg(shards), *pw, num_experts_per_tok=2)(tx))
    assert np.isfinite(got).all() and got.shape == full.shape
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    if factor == 1.0:  # 1.25 drops nothing on these tokens, in both packages
        assert np.abs(got - full).max() > 1e-2


def _a3b_shaped_config(layers=2):
    """tests/test_sharding.py:164: GQA 8q / 4kv, MoE on every layer, counts
    that divide over (dp = 1, ep = 2, tp = 4)."""
    return JaxQwen3Config(
        num_hidden_layers=layers, hidden_size=256, num_attention_heads=8, num_key_value_heads=4,
        head_dim=64, intermediate_size=512, vocab_size=512, rope_theta=10000.0,
        max_position_embeddings=128, num_experts=8, num_experts_per_tok=2,
        moe_intermediate_size=512, norm_topk_prob=True,
    )


def _ep_config():
    """test_sharding.py:148's tiny MoE config; its 2 heads (1 KV head) do
    not split over 8 shards in the port, which keeps whole heads on a
    shard (GSPMD splits any axis), so the model case takes 8 of each."""
    return jax_tiny_config(num_hidden_layers=1, num_experts=8, num_experts_per_tok=2,
                           moe_intermediate_size=128, norm_topk_prob=True,
                           num_attention_heads=8, num_key_value_heads=8)


@functools.cache
def _model_params(kind: str, quantized: bool, key: int):
    jcfg = {"ep": _ep_config(), "a3b": _a3b_shaped_config()}[kind]
    jp = random_params(jcfg, key=key, quantized=quantized)
    return jcfg, jp, port_params(jp, Qwen3Config(**vars(jcfg)))


def test_expert_parallel_moe_model_matches_single_device():
    """test_sharding.py:144 on the port: experts split over tp = 8 (the
    dense projections over tp too), the model's logits against JAX's."""
    jcfg, jp, pp = _model_params("ep", True, 4)
    toks = [[5, 3, 8, 1]]
    want = np.asarray(JaxQwen3Model(jax_shard_params(jp, _jax_scfg(8)), jcfg, max_seq_len=32)
                      .forward_full(jnp.asarray(toks)), np.float32)
    got = f32(Qwen3Model(shard_params(pp, _scfg(8)), Qwen3Config(**vars(jcfg)), max_seq_len=32,
                         device="cpu")(toks))
    assert_allclose(got, want, jnp.bfloat16, atol=5e-2)
    small = jax_tiny_config(num_hidden_layers=1, num_experts=8, num_experts_per_tok=2,
                            moe_intermediate_size=128)  # 2 heads, 1 KV head
    two_heads = port_params(random_params(small, key=4), Qwen3Config(**vars(small)))
    with pytest.raises(ValueError, match="whole units"):
        shard_params(two_heads, _scfg(8))


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "quant"])
def test_composed_ep_tp_moe_matches_single_device(quantized):
    """test_sharding.py:190 on the port: experts over ep = 2, each expert's
    features and the attention over tp = 4; the prompt's logits and a decode
    step's against JAX's composed model and the port's unsharded model.
    Quantized, the decode step's routing parts from JAX's at a near-tie
    (the port's router folds in f32, JAX's XLA route dequantizes it to
    bf16: tests/test_torch_moe.py), unsharded as sharded, so that step is
    held to the port's unsharded model alone."""
    jcfg, jp, pp = _model_params("a3b", quantized, 6)
    cfg = Qwen3Config(**vars(jcfg))
    toks = [[5, 3, 8, 1]]
    jscfg = _jax_scfg(4, ep=2, ep_axis="ep")
    jm = JaxQwen3Model(jax_shard_params(jp, jscfg), jcfg, max_seq_len=32, attn_impl="xla")
    model = Qwen3Model(shard_params(pp, ShardingConfig(make_mesh(ep=2, tp=4, devices=CPU8),
                                                       ep_axis="ep")),
                       cfg, max_seq_len=32, device="cpu")
    single = Qwen3Model(pp, cfg, max_seq_len=32, device="cpu")
    w = model.params.layers[0].mlp.w_gate
    assert w.axis == "ep" and all(p.axis == "tp" and p.dim == "out" for p in w.parts)
    assert_allclose(f32(model(toks)), np.asarray(jm.forward_full(jnp.asarray(toks)), np.float32),
                    jnp.bfloat16, atol=5e-2)
    assert_allclose(f32(model(toks)), f32(single(toks)), jnp.bfloat16, atol=5e-2)
    jc, pc = jm.create_kv_cache(), model.create_kv_cache()
    jm(jnp.asarray(toks), 0, jc)
    model(toks, 0, pc)
    sc = single.create_kv_cache()
    single(toks, 0, sc)
    got = f32(model([[7]], 4, pc, logits_to_keep=1))
    assert_allclose(got, f32(single([[7]], 4, sc, logits_to_keep=1)), jnp.bfloat16, atol=5e-2)
    if not quantized:
        want = np.asarray(jm(jnp.asarray([[7]]), 4, jc, logits_to_keep=1), np.float32)
        assert_allclose(got, want, jnp.bfloat16, atol=5e-2)


def test_dp_replicated_moe_model_matches_single_device():
    """A MoE model under dp = 2 x tp = 4: the experts split over tp and the
    router, replicated, both copied per replica; each replica's row through
    its own copies. The logits of a batch of two against JAX's model on
    that mesh and the port's unsharded model."""
    jcfg, jp, pp = _model_params("a3b", False, 6)
    cfg = Qwen3Config(**vars(jcfg))
    toks = [[5, 3, 8, 1], [2, 7, 7, 4]]
    params = shard_params(pp, _scfg(4, dp=2))
    mlp = params.layers[0].mlp
    assert mlp.w_router.dim == "batch" and mlp.w_gate.dim == "batch"
    assert all(p.dim == "expert" and p.axis == "tp" for p in mlp.w_gate.parts)
    got = f32(Qwen3Model(params, cfg, max_seq_len=32, device="cpu")(toks))
    want = np.asarray(JaxQwen3Model(jax_shard_params(jp, _jax_scfg(4, dp=2)), jcfg, max_seq_len=32,
                                    attn_impl="xla").forward_full(jnp.asarray(toks)), np.float32)
    assert_allclose(got, want, jnp.bfloat16, atol=5e-2)
    single = f32(Qwen3Model(pp, cfg, max_seq_len=32, device="cpu")(toks))
    assert_allclose(got, single, jnp.bfloat16, atol=5e-2)


def test_composed_ep_tp_specs_place_expert_and_feature_axes():
    """test_sharding.py:229 on the port."""
    jcfg, jp, pp = _model_params("a3b", False, 6)
    specs = param_shardings(pp, ShardingConfig(make_mesh(ep=2, tp=4, devices=CPU8),
                                               ep_axis="ep"))
    mlp = specs.layers[0].mlp
    assert mlp.w_gate == ("ep", "tp", None) and mlp.w_up == ("ep", "tp", None)
    assert mlp.w_down == ("ep", None, "tp") and mlp.w_router == (None, None)
    jspecs = jax_param_shardings(jp, _jax_scfg(4, ep=2, ep_axis="ep")).layers[0].mlp
    assert (mlp.w_gate, mlp.w_up, mlp.w_down) == tuple(
        tuple(s) for s in (jspecs.w_gate, jspecs.w_up, jspecs.w_down))
    assert param_shardings(pp, _scfg(8)).layers[0].mlp.w_gate == ("tp", None, None)


def test_speculative_under_composed_ep_tp_target():
    """test_sharding.py:245 on the port: speculative decoding with a small
    dense draft under the ep x tp target gives the target's own greedy
    text, and JAX's."""
    jcfg, jp, pp = _model_params("a3b", False, 8)
    dcfg = jax_tiny_config(num_hidden_layers=1)
    djp = random_params(dcfg, key=9)
    tok = FakeTokenizer()
    jtarget = JaxQwen3Model(jp, jcfg, max_seq_len=64, attn_impl="xla")
    jdraft = JaxQwen3Model(djp, dcfg, max_seq_len=64)
    want = jax_speculative(jdraft, jtarget, tok, tok, "hello", proposal_length=3, max_tokens=8,
                           auto_disable=False)
    assert want == jax_greedy(jtarget, tok, "hello", max_tokens=8)
    scfg = ShardingConfig(make_mesh(ep=2, tp=4, devices=CPU8), ep_axis="ep")
    target = Qwen3Model(shard_params(pp, scfg), Qwen3Config(**vars(jcfg)), max_seq_len=64,
                        device="cpu")
    draft = Qwen3Model(port_params(djp, Qwen3Config(**vars(dcfg))), Qwen3Config(**vars(dcfg)),
                       max_seq_len=64, device="cpu")
    got = speculative_generate(draft, target, tok, tok, "hello", proposal_length=3,
                               max_tokens=8, auto_disable=False)
    assert got == simple_generate_with_kv_cache(target, tok, "hello", max_tokens=8)
    assert got == want
