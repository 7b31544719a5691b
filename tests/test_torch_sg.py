"""The port's any-width weights ("sg" in the JAX package: bits 2, 4, 8 and
groups 32, 64, 128, on the CPU: plain kernel versions) against the JAX
package: the dense and grouped plain versions against the Pallas kernels
in interpret mode and the XLA twins at every width, synthetic params'
centring, and 2-layer models at W8 g64 (dense, tied head: the LM head is
the embedding) and W4 g64 (MoE, untied head) against JAX's."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import tiny_llm_tpu.ops.moe as jax_moe  # noqa: E402
from tiny_llm_tpu.kernels import quantized_matmul  # noqa: E402
from tiny_llm_tpu.kernels.moe_matmul import _gqmm_pallas  # noqa: E402
from tiny_llm_tpu.kernels.quant_matmul import _qmm_pallas  # noqa: E402
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu.ops.quantize import quantize, quantize_stacked  # noqa: E402
from tiny_llm_tpu.serving import batch_generate as jax_batch_generate  # noqa: E402
from tiny_llm_tpu_torch.kernels.moe_matmul import grouped_quant_matmul  # noqa: E402
from tiny_llm_tpu_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from tiny_llm_tpu_torch.models import (  # noqa: E402
    Qwen3Model,
    from_jax_numpy,
    synthetic_quantized_params,
    tiny_test_config,
)
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402
from tiny_llm_tpu_torch.ops.quantize import dequantize  # noqa: E402
from tiny_llm_tpu_torch.serving import batch_generate  # noqa: E402

from .test_torch_moe import (  # noqa: E402,F401  (routing_log is a fixture)
    MAX_EXCLUDED,
    _excluded,
    moe_params_to_numpy,
    routing_log,
)
from .torch_port import (  # noqa: E402
    assert_logit_calls,
    bf16_numpy,
    f32,
    params_to_numpy,
    qt_to_numpy,
    teacher_forced,
)
from .utils import FakeTokenizer, assert_allclose  # noqa: E402

WIDTHS = [(bits, gs) for bits in (2, 4, 8) for gs in (32, 64, 128)]
WIDTH_IDS = [f"W{b}g{g}" for b, g in WIDTHS]
# bf16 ladder (tests/utils.py), absolute 2e-2 as K1's decode schedule is
# held: the port dequantizes in f32; the Pallas kernel rounds q * s, then
# + b, to bf16 and its XLA twin the dequantized weight once. Outputs here
# are O(1) (x ~ N(0, 1), weights quantized from N(0, 0.05^2), K = 512).
ATOL = RTOL = 2e-2


@pytest.mark.parametrize("bits,gs", WIDTHS, ids=WIDTH_IDS)
def test_sg_plain_matches_pallas_and_xla(bits, gs):
    N, K, M = 128, 512, 6
    rng = np.random.default_rng(bits * 100 + gs)
    jqt = quantize(jnp.asarray(rng.standard_normal((N, K)) * 0.05, jnp.float32),
                   group_size=gs, bits=bits, layout="sg")
    port = quantized_from_numpy(qt_to_numpy(jqt))
    assert (port.bits, port.group_size, port.k_padded) == (bits, gs, 512)
    xj, xt = bf16_numpy(rng.standard_normal((M, K)))
    got = f32(quant_matmul(xt, port))
    xpad = jnp.pad(xj, ((0, 0), (0, jqt.k_padded - K)))
    pallas = _qmm_pallas(xpad, jqt.packed, jqt.scales, jqt.biases, group_size=gs, bits=bits,
                         interpret=True)
    xla = quantized_matmul(xj, jqt, impl="xla")
    for want in (pallas, xla):
        assert_allclose(got, f32(want), precision=jnp.bfloat16, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bits,gs", WIDTHS, ids=WIDTH_IDS)
def test_grouped_sg_plain_matches_pallas_and_xla(bits, gs):
    sizes = [5, 0, 9, 3]
    E, N, K = len(sizes), 128, 256
    rng = np.random.default_rng(bits * 10 + gs)
    jqt = quantize_stacked(jnp.asarray(rng.standard_normal((E, N, K)) * 0.05, jnp.float32),
                           group_size=gs, bits=bits, layout="sg")
    port = quantized_from_numpy(qt_to_numpy(jqt))
    xj, xt = bf16_numpy(rng.standard_normal((sum(sizes), K)))
    gs_np = np.asarray(sizes, np.int32)
    got = f32(grouped_quant_matmul(xt, port, torch.from_numpy(gs_np)))
    xpad = jnp.pad(xj, ((0, 0), (0, jqt.k_padded - K)))
    pallas = _gqmm_pallas(xpad, jqt.packed, jqt.scales, jqt.biases, jnp.asarray(gs_np),
                          group_size=gs, bits=bits, interpret=True)
    xla = jax_moe.grouped_matmul(xj, jqt, jnp.asarray(gs_np), use_ragged=False, impl="xla")
    for want in (pallas, xla):
        assert_allclose(got, f32(want), precision=jnp.bfloat16, rtol=RTOL, atol=ATOL)


def test_synthetic_params_centre_codes_at_every_width():
    """bias = -(levels / 2) * scale and levels * scale spanning what
    15 * scale spans at W4: the mean dequantized weight is ~0 at every
    width, and W4 g128 keeps the earlier draw (bias -7.5 * scale)."""
    cfg = tiny_test_config(num_hidden_layers=1)
    for bits, gs in ((2, 32), (4, 64), (8, 64), (4, 128)):
        p = synthetic_quantized_params(cfg, seed=1, device="cpu", group_size=gs, bits=bits)
        w = p.layers[0].mlp.w_down
        levels = (1 << bits) - 1
        assert tuple(w.packed.shape) == (128, 128 * bits // 32)
        assert tuple(w.scales.shape) == (128, 128 // gs)
        assert torch.equal(w.biases, (-(levels / 2) * w.scales.float()).to(torch.bfloat16))
        s = w.scales.float() * levels / 15
        assert float(s.min()) >= 0.001 * (1 - 2**-8) and float(s.max()) <= 0.005 * (1 + 2**-8)
        dense = dequantize(w, torch.float32)
        assert abs(float(dense.mean())) < 0.1 * float(dense.abs().mean())
    m = Qwen3Model(synthetic_quantized_params(cfg, device="cpu", group_size=64, bits=8), cfg,
                   max_seq_len=32, device="cpu")
    assert torch.isfinite(m([[1, 2, 3]]).float()).all()


# ---------------------------------------------------------------------------
# 2-layer models against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def w8_dense():
    """W8 g64, tied: the JAX package keeps no magic_t head copy at W8, so
    both packages read the embedding as the LM head."""
    jcfg, pcfg = jax_tiny_config(num_hidden_layers=2), tiny_test_config(num_hidden_layers=2)
    params = random_params(jcfg, key=5, group_size=64, bits=8)
    assert params.lm_head is None
    port = from_jax_numpy(params_to_numpy(params), pcfg, device="cpu")
    assert (port.embedding.bits, port.embedding.group_size) == (8, 64)
    return params, port, jcfg, pcfg


def test_w8_model_teacher_forced_logits_match_jax(w8_dense):
    params, port, jcfg, pcfg = w8_dense
    jm = JaxQwen3Model(params, jcfg, max_seq_len=128)
    pm = Qwen3Model(port, pcfg, max_seq_len=128, device="cpu")
    assert_logit_calls(teacher_forced(jm, pm, (40,), 8))


def test_w8_paged_decode_burst_and_batch_generate_match_jax(w8_dense):
    params, port, jcfg, pcfg = w8_dense
    jm = JaxQwen3Model(params, jcfg, max_seq_len=64).enable_paged_attention(
        num_pages=24, page_size=8)
    pm = Qwen3Model(port, pcfg, max_seq_len=64, device="cpu").enable_paged_attention(
        num_pages=24, page_size=8)
    prompt = [int(t) for t in np.random.default_rng(8).integers(0, 128, size=21)]
    cj, cp = jm.create_kv_cache(), pm.create_kv_cache()
    tok = int(np.argmax(np.asarray(jm(jnp.asarray([prompt], jnp.int32), 0, cj), np.float32)[0, -1]))
    assert int(f32(pm([prompt], 0, cp))[0, -1].argmax()) == tok
    bj, bp = jm.create_batching_kv_cache(max_active_requests=2), pm.create_batching_kv_cache(2)
    bj.add_request(cj, 0)
    bp.add_request(cp, 0)
    want = jm.decode_burst(bj, np.asarray([tok, 0], np.int32), 6)
    got = pm.decode_burst(bp, np.asarray([tok, 0], np.int32), 6)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])  # slot 1 is idle
    bj.release()
    bp.release()
    prompts = [f"w8 prompt {i} {'cd' * i}" for i in range(4)]
    kw = dict(max_seq_len=64, batch_size=2, prefill_step=8, max_output_tokens=5, decode_burst=4)
    tok = FakeTokenizer()
    assert batch_generate(pm, tok, prompts, **kw) == jax_batch_generate(jm, tok, prompts, **kw)
    assert pm.page_pool.live_pages == 0


def test_w4g64_moe_model_teacher_forced_logits_match_jax(routing_log):
    """W4 g64 (mlx_lm.convert's default group size), 2 layers (dense, then
    sparse), untied head (JAX's random_params would convert a tied W4 head
    to magic_t, which is g128 only): a 56-token prompt and 8 decode steps,
    near-tie routing flips excluded as in tests/test_torch_moe.py."""
    over = dict(num_hidden_layers=2, num_experts=8, num_experts_per_tok=2,
                moe_intermediate_size=128, norm_topk_prob=True, mlp_only_layers=(0,),
                tie_word_embeddings=False)
    jcfg, pcfg = jax_tiny_config(**over), tiny_test_config(**over)
    params = random_params(jcfg, key=6, group_size=64, bits=4)
    jm = JaxQwen3Model(params, jcfg, max_seq_len=128)
    pm = Qwen3Model(from_jax_numpy(moe_params_to_numpy(params), pcfg, device="cpu"), pcfg,
                    max_seq_len=128, device="cpu")
    assert pm.params.lm_head.group_size == 64 and pm.params.layers[1].mlp.w_up.group_size == 64
    routing_log["jax"].clear()
    routing_log["port"].clear()
    calls = teacher_forced(jm, pm, (56,), 8)
    jax.effects_barrier()
    skip = _excluded(routing_log["jax"], routing_log["port"], pcfg.num_experts_per_tok)
    positions = sum(w.shape[0] for w, _ in calls)
    assert len(skip) <= MAX_EXCLUDED * positions, f"{len(skip)} of {positions} excluded"
    assert_logit_calls(calls, skip)
