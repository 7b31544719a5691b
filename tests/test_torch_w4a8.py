"""The port's W4A8 tier (act_quant="int8", on the CPU: plain kernel
versions) against the JAX package's "pair_t" tier: the activation
quantization against the numpy oracle, the W4A8 matmul's and grouped
matmul's plain versions against the Pallas kernels in interpret mode and
the XLA twins, the row gates (32 dense rows, 128 grouped rows), and
2-layer dense and MoE models with act_quant="int8" against JAX's."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels import quantized_matmul  # noqa: E402
from tiny_llm_tpu.kernels.moe_matmul import _gqmm_pair_pallas  # noqa: E402
from tiny_llm_tpu.kernels.moe_matmul import grouped_quantized_matmul  # noqa: E402
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu.ops.quantize import convert_layout, quantize, quantize_stacked  # noqa: E402
from tiny_llm_tpu.serving import batch_generate as jax_batch_generate  # noqa: E402
from tiny_llm_tpu_torch.kernels.moe_matmul import (  # noqa: E402
    grouped_quant_matmul,
    grouped_quant_matmul_a8_plain,
    grouped_quant_matmul_plain,
)
from tiny_llm_tpu_torch.kernels.quant_matmul import (  # noqa: E402
    quant_matmul,
    quant_matmul_a8_plain,
    quant_matmul_staged_plain,
)
from tiny_llm_tpu_torch.models import (  # noqa: E402
    Qwen3Model,
    from_jax_numpy,
    synthetic_quantized_params,
    tiny_test_config,
)
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402
from tiny_llm_tpu_torch.ops.quantize import (  # noqa: E402
    dequantize,
    quantize_activations,
    unpack_codes,
)
from tiny_llm_tpu_torch.serving import batch_generate  # noqa: E402

from .test_torch_moe import (  # noqa: E402,F401  (routing_log is a fixture)
    MAX_EXCLUDED,
    MOE_CONFIGS,
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


def _numpy_oracle(xf: np.ndarray):
    """tests/test_quantize.py's W4A8 activation oracle (sx = 1 where 0)."""
    sx = np.abs(xf).max(axis=-1, keepdims=True) / np.float32(127.0)
    sx = np.where(sx == 0, np.float32(1.0), sx).astype(np.float32)
    return np.clip(np.round(xf / sx), -127, 127), sx


def test_activation_quantization_matches_numpy_oracle():
    """Codes and sx bit for bit, including a row whose x / sx lands on
    k + 0.5 (round half to even) and an all-zero row (sx = 1, codes 0)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 384)).astype(np.float32) * 3
    x[1] = 0.0
    x[2, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]  # sx = 1: ties at k + 0.5
    x[2, 6:] = np.clip(x[2, 6:], -100, 100)
    _, xt = bf16_numpy(x)
    xq, sx = quantize_activations(xt)
    want_q, want_sx = _numpy_oracle(f32(xt))
    assert xq.dtype == torch.int8 and sx.dtype == torch.float32
    np.testing.assert_array_equal(sx.numpy(), want_sx)
    np.testing.assert_array_equal(xq.numpy().astype(np.float32), want_q)
    assert xq[2, :6].tolist() == [127, 2, -4, 0, 0, 126] and not xq[1].any()
    assert float(sx[1]) == 1.0


def _pair_weight(N, K, seed):
    rng = np.random.default_rng(seed)
    jqt = convert_layout(quantize(jnp.asarray(rng.standard_normal((N, K)) * 0.05,
                                              jnp.float32)), "pair_t")
    return jqt, quantized_from_numpy(qt_to_numpy(jqt))


@pytest.mark.parametrize("M,residual", [(1, False), (8, False), (32, False), (8, True)])
def test_a8_plain_matches_pallas_and_xla(M, residual):
    """K = 1920 pads to 2048 in the JAX pair_t layout and to 1920 in the
    port's. Relative max error < 1e-2 of the output scale, as
    tests/test_quantize.py holds the Pallas kernel to its oracle; with a
    residual atol 0.06, rtol 0.02, as its residual-epilogue test."""
    N, K = 256, 1920
    jqt, port = _pair_weight(N, K, seed=M)
    assert port.act == "int8" and port.k_padded == 1920
    rng = np.random.default_rng(10 + M)
    xj, xt = bf16_numpy(rng.standard_normal((M, K)))
    rj, rt = bf16_numpy(rng.standard_normal((M, N))) if residual else (None, None)
    got = f32(quant_matmul(xt, port, residual=rt))
    np.testing.assert_array_equal(got, f32(quant_matmul_a8_plain(xt, port, rt)))
    for impl in ("pallas", "xla"):
        want = np.asarray(quantized_matmul(xj, jqt, residual=rj, impl=impl, act="int8",
                                           interpret=True), np.float32)
        if residual:
            np.testing.assert_allclose(got, want, atol=0.06, rtol=0.02)
        else:
            assert np.abs(got - want).max() / np.abs(want).max() < 1e-2, impl


def test_a8_dispatch_takes_k1_above_32_rows():
    """At 33 rows the JAX package runs W4A16-exact staged dots on pair_t
    weights, and the port K1 on its staged tile: the port's output is the
    staged tile's plain version (the bridge unpacks pair_t codes into the
    port's one packed layout, which it reads as dequantize does), and
    within K1's staged-schedule tolerance of the Pallas kernel (it rounds
    q * s to bf16, tests/test_torch_kernels.py)."""
    N, K = 256, 512
    jqt, port = _pair_weight(N, K, seed=33)
    xj, xt = bf16_numpy(np.random.default_rng(33).standard_normal((33, K)))
    got = quant_matmul(xt, port)
    assert torch.equal(got, quant_matmul_staged_plain(xt, port))
    codes = unpack_codes(port.packed, port.bits).float().reshape(N, -1, port.group_size)
    staged = (codes * port.scales.float()[..., None]).reshape(N, -1)
    want_w = staged + port.biases.float().repeat_interleave(port.group_size, 1)
    assert torch.equal(want_w, dequantize(port, torch.float32))
    assert not torch.equal(got[:32], quant_matmul(xt[:32], port))  # 32 rows: W4A8
    want = quantized_matmul(xj, jqt, impl="pallas", act="int8", interpret=True)
    assert_allclose(f32(got), f32(want), precision=jnp.bfloat16, rtol=2e-2, atol=6e-2)


def _pair_stacked(E, N, K, seed):
    rng = np.random.default_rng(seed)
    jqt = quantize_stacked(jnp.asarray(rng.standard_normal((E, N, K)) * 0.05, jnp.float32),
                           layout="pair_t")
    return jqt, quantized_from_numpy(qt_to_numpy(jqt))


@pytest.mark.parametrize("sizes", [[7, 0, 20, 3, 9], [0, 0, 39, 0, 0], [40, 0, 0, 0, 24]],
                         ids=["mixed", "one_expert", "empty_middle"])
def test_grouped_a8_plain_matches_pallas(sizes):
    """The W4A8 walk's plain version against _gqmm_pair_pallas(a8=True) in
    interpret mode, as tests/test_moe.py holds the Pallas walk: per expert
    segment, relative max error < 1e-2."""
    E, N, K = len(sizes), 96, 512
    jqt, port = _pair_stacked(E, N, K, seed=4)
    T = sum(sizes)
    xj, xt = bf16_numpy(np.random.default_rng(5).standard_normal((T, K)))
    gs = np.asarray(sizes, np.int32)
    got = f32(grouped_quant_matmul(xt, port, torch.from_numpy(gs)))
    want = np.asarray(_gqmm_pair_pallas(xj, jqt.packed, jqt.scales, jqt.biases, jnp.asarray(gs),
                                        group_size=128, bits=4, a8=True, interpret=True),
                      np.float32)
    r = 0
    for s in sizes:
        if s:
            seg = slice(r, r + s)
            assert np.abs(got[seg] - want[seg]).max() / np.abs(want[seg]).max() < 1e-2
            r += s


def test_grouped_a8_gate_at_128_rows():
    """T = 128 grouped rows run W4A8, T = 129 the exact walk, as
    grouped_quantized_matmul's gate; both within tolerance of it."""
    E, N, K = 4, 96, 256
    jqt, port = _pair_stacked(E, N, K, seed=6)
    rng = np.random.default_rng(7)
    for T, plain in ((128, grouped_quant_matmul_a8_plain), (129, grouped_quant_matmul_plain)):
        gs = np.asarray([T - 60, 0, 40, 20], np.int32)
        xj, xt = bf16_numpy(rng.standard_normal((T, K)))
        got = grouped_quant_matmul(xt, port, torch.from_numpy(gs))
        assert torch.equal(got, plain(xt, port, torch.from_numpy(gs))), T
        want = grouped_quantized_matmul(xj, jqt, jnp.asarray(gs), interpret=True)
        assert_allclose(f32(got), f32(want), precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)


def test_act_quant_int8_refuses_other_widths_and_shares_tensors():
    cfg = tiny_test_config(num_hidden_layers=1)
    w8 = synthetic_quantized_params(cfg, device="cpu", group_size=64, bits=8)
    with pytest.raises(ValueError, match="W4 g128"):
        Qwen3Model(w8, cfg, device="cpu", act_quant="int8")
    params = synthetic_quantized_params(cfg, device="cpu")
    a8 = Qwen3Model(params, cfg, device="cpu", act_quant="int8").params
    a16 = Qwen3Model(params, cfg, device="cpu").params
    assert a8.layers[0].attn.wqkv.act == "int8" and a16.layers[0].attn.wqkv.act == "bf16"
    assert a8.embedding is params.embedding  # the tied LM head stays W4A16
    assert a8.layers[0].mlp.w_down.packed is params.layers[0].mlp.w_down.packed


# ---------------------------------------------------------------------------
# 2-layer models with act_quant="int8" against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def a8_dense():
    jcfg, pcfg = jax_tiny_config(num_hidden_layers=2), tiny_test_config(num_hidden_layers=2)
    params = random_params(jcfg, key=3)
    port = from_jax_numpy(params_to_numpy(params), pcfg, device="cpu")
    jm = JaxQwen3Model(params, jcfg, max_seq_len=128, act_quant="int8")
    pm = Qwen3Model(port, pcfg, max_seq_len=128, device="cpu", act_quant="int8")
    a16 = Qwen3Model(port, pcfg, max_seq_len=128, device="cpu")
    return params, port, jm, pm, a16


def test_a8_model_teacher_forced_logits_match_jax(a8_dense):
    """A 24-token prompt (24 rows: W4A8) and a 40-token one (exact), then 6
    decode steps (W4A8); the port's W4A8 and W4A16 models differ exactly
    where the rows gate says."""
    _, _, jm, pm, a16 = a8_dense
    assert_logit_calls(teacher_forced(jm, pm, (24,), 6))
    assert_logit_calls(teacher_forced(jm, pm, (40,), 0))
    prompt = [[int(t) for t in range(3, 43)]]
    assert torch.equal(pm(prompt), a16(prompt))  # 40 rows: W4A16-exact
    assert not torch.equal(pm([prompt[0][:24]]), a16([prompt[0][:24]]))


def test_a8_paged_decode_burst_and_batch_generate_match_jax(a8_dense):
    params, port, _, _, _ = a8_dense
    jcfg, pcfg = jax_tiny_config(num_hidden_layers=2), tiny_test_config(num_hidden_layers=2)
    jp = JaxQwen3Model(params, jcfg, max_seq_len=64, act_quant="int8")
    pp = Qwen3Model(port, pcfg, max_seq_len=64, device="cpu", act_quant="int8")
    jp.enable_paged_attention(num_pages=24, page_size=8)
    pp.enable_paged_attention(num_pages=24, page_size=8)
    prompt = [int(t) for t in np.random.default_rng(6).integers(0, 128, size=19)]
    cj, cp = jp.create_kv_cache(), pp.create_kv_cache()
    tok = int(np.argmax(np.asarray(jp(jnp.asarray([prompt], jnp.int32), 0, cj), np.float32)[0, -1]))
    assert int(f32(pp([prompt], 0, cp))[0, -1].argmax()) == tok
    bj, bp = jp.create_batching_kv_cache(max_active_requests=2), pp.create_batching_kv_cache(2)
    bj.add_request(cj, 1)
    bp.add_request(cp, 1)
    want = jp.decode_burst(bj, np.asarray([0, tok], np.int32), 6)
    got = pp.decode_burst(bp, np.asarray([0, tok], np.int32), 6)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])  # slot 0 is idle
    bj.release()
    bp.release()
    prompts = [f"w4a8 prompt {i} {'ab' * i}" for i in range(4)]
    kw = dict(max_seq_len=64, batch_size=2, prefill_step=8, max_output_tokens=5, decode_burst=4)
    tok = FakeTokenizer()
    assert batch_generate(pp, tok, prompts, **kw) == jax_batch_generate(jp, tok, prompts, **kw)
    assert pp.page_pool.live_pages == 0


def test_a8_moe_model_teacher_forced_logits_match_jax(routing_log):
    """2-layer MoE (layer 0 dense, layer 1 sparse): a 56-token prompt (56 x 2
    = 112 grouped rows: W4A8 experts; 56 dense rows: exact) and 8 decode
    steps, 64 positions; near-tie routing flips excluded as in
    tests/test_torch_moe.py."""
    over = MOE_CONFIGS["moe"]
    jcfg, pcfg = jax_tiny_config(**over), tiny_test_config(**over)
    params = random_params(jcfg, key=3)
    jm = JaxQwen3Model(params, jcfg, max_seq_len=128, act_quant="int8")
    pm = Qwen3Model(from_jax_numpy(moe_params_to_numpy(params), pcfg, device="cpu"), pcfg,
                    max_seq_len=128, device="cpu", act_quant="int8")
    assert pm.params.layers[1].mlp.w_gate.act == "int8"
    assert pm.params.layers[1].mlp.w_router.act == "bf16"
    routing_log["jax"].clear()
    routing_log["port"].clear()
    calls = teacher_forced(jm, pm, (56,), 8)
    jax.effects_barrier()
    skip = _excluded(routing_log["jax"], routing_log["port"], pcfg.num_experts_per_tok)
    positions = sum(w.shape[0] for w, _ in calls)
    assert len(skip) <= MAX_EXCLUDED * positions, f"{len(skip)} of {positions} excluded"
    assert_logit_calls(calls, skip)
