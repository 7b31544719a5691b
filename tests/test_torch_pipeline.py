"""The port's pipeline parallelism (tiny_llm_tpu_torch.parallel: split_stages,
PipelinedQwen3, MicrobatchedPipeline, DecodePipeline, on the CPU with each
stage on [cpu] * S) against the JAX package's (tests/test_pipeline_decode.py
and tests/test_sharding.py's pipeline cases on tests/conftest.py's 8
virtual devices), on the same numpy params, and against the port's own
unsharded model: PipelinedQwen3 runs the unsharded step's calls stage by
stage, so its logits are forward_full's bit for bit; DecodePipeline's
tokens are the unsharded dense-cache greedy tokens."""

from __future__ import annotations

import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.models import Qwen3Config as JaxQwen3Config  # noqa: E402
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params, tiny_test_config  # noqa: E402
from tiny_llm_tpu.parallel.pipeline import DecodePipeline as JaxDecodePipeline  # noqa: E402
from tiny_llm_tpu.parallel.pipeline import MicrobatchedPipeline as JaxMicrobatched  # noqa: E402
from tiny_llm_tpu.parallel.pipeline import PipelinedQwen3 as JaxPipelined  # noqa: E402
from tiny_llm_tpu.parallel.pipeline import split_stages as jax_split_stages  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Config, Qwen3Model, forward_full  # noqa: E402
from tiny_llm_tpu_torch.parallel import (  # noqa: E402
    DecodePipeline,
    MicrobatchedPipeline,
    PipelinedQwen3,
    split_stages,
)

from .torch_port import LOGIT_ATOL, f32, port_params, torch_one_thread  # noqa: E402,F401
from .utils import assert_allclose  # noqa: E402

pytestmark = [pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices"),
              pytest.mark.usefixtures("torch_one_thread")]

CPU = torch.device("cpu")


def tp_config(layers: int = 2):
    """tests/test_sharding.py's tp_config (4 layers in its microbatched case)."""
    return JaxQwen3Config(
        num_hidden_layers=layers, hidden_size=256, num_attention_heads=8, num_key_value_heads=8,
        head_dim=64, intermediate_size=512, vocab_size=512, rope_theta=10000.0,
        max_position_embeddings=128,
    )


def _port_cfg(jcfg) -> Qwen3Config:
    return Qwen3Config(**vars(jcfg))


@functools.cache
def _params(layers: int, key: int, quantized: bool):
    jcfg = tp_config(layers)
    jp = random_params(jcfg, key=key, quantized=quantized)
    return jcfg, jp, port_params(jp, _port_cfg(jcfg))


@pytest.mark.parametrize("layers,stages", [(2, 1), (2, 2), (4, 2), (4, 3), (4, 4), (36, 4),
                                           (36, 5)])
def test_split_stages_ranges_equal_jax(layers, stages):
    """ceil(n / S) layers a stage, the same ranges as JAX's (4 layers over
    3 stages give 2 stages of 2, as there)."""
    p = types.SimpleNamespace(layers=list(range(layers)))
    assert split_stages(p, stages) == jax_split_stages(p, stages)
    with pytest.raises(ValueError):
        split_stages(p, layers + 1)


def test_pipeline_parallel_matches_single_device():
    """test_sharding.py:290 on the port: S = 2, quantized; against JAX's
    PipelinedQwen3 on two virtual devices (bf16 ladder, atol 5e-2) and
    bit-equal to the port's unsharded forward_full."""
    jcfg, jp, pp = _params(2, 5, True)
    cfg = _port_cfg(jcfg)
    tokens = [[5, 3, 8, 1, 9]]
    want = np.asarray(JaxPipelined(jp, jcfg, devices=jax.devices()[:2], num_stages=2)(
        jnp.asarray(tokens)), np.float32)
    pipe = PipelinedQwen3(pp, cfg, devices=[CPU] * 2, num_stages=2)
    got = pipe(tokens)
    assert_allclose(f32(got), want, jnp.bfloat16, atol=5e-2)
    assert torch.equal(got, forward_full(pp, cfg, torch.as_tensor(tokens)))
    assert torch.equal(got, Qwen3Model(pp, cfg, max_seq_len=64, device="cpu").forward_full(tokens))
    assert [len(s.layers) for s in pipe._stages] == [1, 1]


def test_pipeline_parallel_moe_equals_forward_full():
    """PipelinedQwen3 takes MoE layers, as the JAX package's _stage_forward
    does: a 4-layer MoE model (layer 0 dense) at S = 2, bit-equal to the
    unsharded forward_full."""
    jcfg = tiny_test_config(num_hidden_layers=4, num_experts=8, num_experts_per_tok=2,
                            moe_intermediate_size=128, norm_topk_prob=True,
                            mlp_only_layers=(0,))
    cfg = _port_cfg(jcfg)
    pp = port_params(random_params(jcfg, key=2), cfg)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, 7))
    got = PipelinedQwen3(pp, cfg, devices=[CPU] * 2, num_stages=2)(tokens)
    assert torch.equal(got, forward_full(pp, cfg, torch.as_tensor(tokens)))


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "quant"])
@pytest.mark.parametrize("stages,microbatches", [(4, 4), (2, 4)])
def test_microbatched_pipeline_matches_single_device(quantized, stages, microbatches):
    """test_sharding.py:380 on the port: the GPipe schedule over S stages
    and M microbatches of 8 prompts, against JAX's MicrobatchedPipeline
    and the port's unsharded forward_full (bf16 ladder, atol 5e-2)."""
    jcfg, jp, pp = _params(4, 8, quantized)
    cfg = _port_cfg(jcfg)
    tokens = np.random.default_rng(0).integers(0, 512, size=(8, 6))
    want = np.asarray(JaxMicrobatched(jp, jcfg, num_stages=stages,
                                      num_microbatches=microbatches)(jnp.asarray(tokens)),
                      np.float32)
    got = f32(MicrobatchedPipeline(pp, cfg, num_stages=stages, num_microbatches=microbatches,
                                   devices=[CPU] * stages)(tokens))
    assert_allclose(got, want, jnp.bfloat16, atol=5e-2)
    assert_allclose(got, f32(forward_full(pp, cfg, torch.as_tensor(tokens))), jnp.bfloat16,
                    atol=5e-2)


def _tiny(key: int):
    jcfg = tiny_test_config(num_hidden_layers=4)
    jp = random_params(jcfg, key=key)
    return jcfg, jp, port_params(jp, _port_cfg(jcfg))


def _unsharded(model, prompts, steps: int) -> np.ndarray:
    """The port's single-device dense-cache greedy tokens [steps + 1, B], as
    test_pipeline_decode.py's _reference_tokens."""
    B, L = prompts.shape
    cache = model.create_kv_cache(batch_size=B)
    toks = [f32(model(prompts, 0, cache, logits_to_keep=1)[:, -1]).argmax(-1)]
    for k in range(steps):
        toks.append(f32(model(toks[-1][:, None], L + k, cache, logits_to_keep=1)[:, -1])
                    .argmax(-1))
    return np.stack(toks)


def _teacher_forced(model, prompts, stream: np.ndarray) -> np.ndarray:
    """The unsharded model's logits [steps + 1, B, V] fed `stream` [steps + 1,
    B] (the prompt, then stream's tokens one by one)."""
    B, L = prompts.shape
    cache = model.create_kv_cache(batch_size=B)
    out = [f32(model(prompts, 0, cache, logits_to_keep=1)[:, -1])]
    for k in range(stream.shape[0] - 1):
        out.append(f32(model(stream[k][:, None], L + k, cache, logits_to_keep=1)[:, -1]))
    return np.stack(out)


def _jax_against_port(jm, model, prompts, jax_stream, port_stream) -> None:
    """JAX's pipeline tokens against the port's: both models teacher-forced
    on JAX's stream agree within the logit ladder, and the port's token
    equals JAX's at every step where JAX's top two logits are more than
    2 * LOGIT_ATOL apart (a row is compared up to its first such step
    where the two differ: a flip at a near-tie cascades)."""
    B, L = prompts.shape
    cache = jm.create_kv_cache(batch_size=B)
    want = [np.asarray(jm(jnp.asarray(prompts), 0, cache, logits_to_keep=1)[:, -1], np.float32)]
    for k in range(jax_stream.shape[0] - 1):
        want.append(np.asarray(jm(jnp.asarray(jax_stream[k][:, None]), L + k, cache,
                                  logits_to_keep=1)[:, -1], np.float32))
    want = np.stack(want)
    got = _teacher_forced(model, prompts, jax_stream)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_ATOL
    for b in range(B):
        for k in range(jax_stream.shape[0]):
            if port_stream[k, b] != jax_stream[k, b]:
                assert not decided[k, b], (b, k)
                break


@pytest.mark.parametrize("stages,bm", [(2, 2), (4, 1)])
def test_decode_pipeline_matches_single_device(stages, bm):
    """test_pipeline_decode.py:40 on the port: S stages of Bm rows, a
    6-token prompt each, prefill then 5 steps: tokens equal the port's
    unsharded dense decode; against JAX's DecodePipeline through
    teacher-forced logits."""
    jcfg, jp, pp = _tiny(0)
    cfg = _port_cfg(jcfg)
    B = stages * bm
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(B, 6)).astype(np.int32)
    steps = 5
    model = Qwen3Model(pp, cfg, max_seq_len=64, device="cpu")
    ref = _unsharded(model, prompts, steps)
    pipe = DecodePipeline(pp, cfg, num_stages=stages, max_seq_len=64, devices=[CPU] * stages)
    tok0 = pipe.prefill(prompts)
    got = np.concatenate([tok0.numpy()[None], pipe.decode(tok0, steps)])
    np.testing.assert_array_equal(got, ref)
    assert {s: k.shape for s, k in pipe.keys.items()} == {
        s: (stages, 4 // stages, bm, cfg.num_key_value_heads, 64, cfg.head_dim)
        for s in range(stages)}
    jpipe = JaxDecodePipeline(jp, jcfg, num_stages=stages, max_seq_len=64)
    jtok0 = np.asarray(jpipe.prefill(prompts))
    jstream = np.concatenate([jtok0[None], jpipe.decode(jtok0, steps)])
    _jax_against_port(JaxQwen3Model(jp, jcfg, max_seq_len=64), model, prompts, jstream, got)


def test_decode_pipeline_two_bursts_continue():
    """test_pipeline_decode.py:60 on the port: a second burst continues
    from the first's KV state; both equal the unsharded tokens."""
    jcfg, jp, pp = _tiny(1)
    cfg = _port_cfg(jcfg)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(4, 4)).astype(np.int32)
    model = Qwen3Model(pp, cfg, max_seq_len=64, device="cpu")
    ref = _unsharded(model, prompts, 6)
    pipe = DecodePipeline(pp, cfg, num_stages=2, max_seq_len=64, devices=[CPU] * 2)
    tok0 = pipe.prefill(prompts)
    np.testing.assert_array_equal(tok0.numpy(), ref[0])
    first = pipe.decode(tok0, 3)
    np.testing.assert_array_equal(first, ref[1:4])
    second = pipe.decode(first[-1], 3)
    np.testing.assert_array_equal(second, ref[4:7])
    assert pipe.offsets == [10, 10]
    with pytest.raises(ValueError, match="past max_seq_len"):
        pipe.decode(second[-1], 64)


@pytest.mark.parametrize("cls", ["microbatched", "decode"])
def test_pipelines_refuse_moe_and_non_dividing_stages(cls):
    """As JAX's (which asserts): MoE layers, and stages that do not divide
    the layers, are refused; so are fewer devices than stages."""
    jcfg = tiny_test_config(num_hidden_layers=4, num_experts=8, num_experts_per_tok=2,
                            moe_intermediate_size=128)
    cfg = _port_cfg(jcfg)
    jmoe = random_params(jcfg, key=3)
    moe = port_params(jmoe, cfg)
    _, jdense, dense = _tiny(0)
    dcfg = _port_cfg(tiny_test_config(num_hidden_layers=4))

    def port(p, c, s, devices=None):
        devices = [CPU] * s if devices is None else devices
        if cls == "microbatched":
            return MicrobatchedPipeline(p, c, num_stages=s, num_microbatches=2, devices=devices)
        return DecodePipeline(p, c, num_stages=s, devices=devices)

    def jax_(p, c, s):
        if cls == "microbatched":
            return JaxMicrobatched(p, c, num_stages=s, num_microbatches=2)
        return JaxDecodePipeline(p, c, num_stages=s)

    with pytest.raises(ValueError, match="dense-MLP"):
        port(moe, cfg, 2)
    with pytest.raises(AssertionError):
        jax_(jmoe, jcfg, 2)
    with pytest.raises(ValueError, match="divide"):
        port(dense, dcfg, 3)
    with pytest.raises(AssertionError):
        jax_(jdense, tiny_test_config(num_hidden_layers=4), 3)
    with pytest.raises(ValueError, match="devices"):
        port(dense, dcfg, 4, devices=[CPU] * 2)
