"""The last API differences between the port and the JAX package, on the
CPU: batch_generate's and paged_attention's signatures (names and order,
positional calls), paged_attention's `mask` ("causal", None, additive 2-D
and 3-D arrays) and the strategies' `paged(..., mask=...)` against the JAX
package's XLA route, the TLT_ACT_QUANT, TLT_PAIR_ACT and TLT_FUSED_ATTN
knobs against their explicit arguments (routes, launches, logits), the
unfused decode chain against the JAX package's TLT_FUSED_ATTN=0 model, and
quantize / dequantize at group sizes outside 32, 64 and 128."""

from __future__ import annotations

import inspect
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.generate import simple_generate_with_kv_cache as jax_greedy  # noqa: E402
from tiny_llm_tpu.kernels.paged_attention import (  # noqa: E402
    paged_attention as jax_paged_attention,
)
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu.serving import batch_generate as jax_batch_generate  # noqa: E402
from tiny_llm_tpu_torch.generate import simple_generate_with_kv_cache  # noqa: E402
from tiny_llm_tpu_torch.kernels import fused_decode_attention as fda  # noqa: E402
from tiny_llm_tpu_torch.kernels import quant_matmul as qm  # noqa: E402
from tiny_llm_tpu_torch.kernels.paged_attention import paged_attention  # noqa: E402
from tiny_llm_tpu_torch.kv import DenseKVCache  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Model, from_jax_numpy, tiny_test_config  # noqa: E402
from tiny_llm_tpu_torch.ops import quantize as PQ  # noqa: E402
from tiny_llm_tpu_torch.parallel import (  # noqa: E402
    DPPagedAttention,
    ShardingConfig,
    SPAttention,
    TPAttention,
    make_mesh,
)
from tiny_llm_tpu_torch.serving import batch_generate  # noqa: E402

from .test_torch_quantize import JQ, _assert_same, _weight  # noqa: E402
from .torch_port import bf16_numpy, f32, params_to_numpy, torch_one_thread  # noqa: E402,F401
from .utils import FakeTokenizer, assert_allclose  # noqa: E402

pytestmark = pytest.mark.usefixtures("torch_one_thread")

B, HQ, HKV, D, PS, PAGES = 2, 8, 4, 32, 8, 16
LENS = np.asarray([45, 22], np.int32)


def _names(fn) -> list[str]:
    return list(inspect.signature(fn).parameters)


@pytest.mark.parametrize("fns", [(batch_generate, jax_batch_generate),
                                 (paged_attention, jax_paged_attention)],
                         ids=["batch_generate", "paged_attention"])
def test_signatures_equal_jax(fns):
    """The same parameter names in the same order, so a positional call
    binds as in the JAX package."""
    port, jax_fn = fns
    assert _names(port) == _names(jax_fn)


@pytest.fixture(scope="module")
def tiny():
    """A 2-layer tiny model's JAX params, config and the port's params."""
    jcfg, cfg = jax_tiny_config(num_hidden_layers=2), tiny_test_config(num_hidden_layers=2)
    jp = random_params(jcfg, key=4)
    return jcfg, cfg, jp, from_jax_numpy(params_to_numpy(jp), cfg, device="cpu")


def test_positional_batch_generate_gives_jax_texts(tiny):
    """batch_generate(model, tok, prompts, max_seq_len, batch_size,
    prefill_step, progress_callback, use_paged, max_output_tokens): the
    positional call written for the JAX package, on both."""
    jcfg, cfg, jp, pp = tiny
    prompts = ["hello world", "abc", "the quick brown fox"]
    args = (64, 2, 8, None, True, 6)
    want = jax_batch_generate(JaxQwen3Model(jp, jcfg, max_seq_len=64), FakeTokenizer(),
                              prompts, *args)
    got = batch_generate(Qwen3Model(pp, cfg, max_seq_len=64, device="cpu"), FakeTokenizer(),
                         prompts, *args)
    assert got == want
    assert all(len(FakeTokenizer().encode(t)) <= 6 for _, t in got)


def _pool(rng):
    """A shuffled pool and each row's table over it (f32 values in bf16)."""
    perm = rng.permutation(np.arange(1, PAGES))
    bt = np.full((B, 8), -1, np.int32)
    k = 0
    for b, n in enumerate(-(-LENS // PS)):
        bt[b, :n] = perm[k : k + n]
        k += n
    kp = bf16_numpy(rng.standard_normal((PAGES, HKV, PS, D)))
    vp = bf16_numpy(rng.standard_normal((PAGES, HKV, PS, D)))
    return bt, kp, vp


def _mask_of(kind: str, L: int, rng):
    """(port, JAX) mask: "causal", None, or an additive [L, s] / [B, L, s]
    array over each row's last s = 20 keys (0 or -1e9)."""
    if kind in ("causal", "none"):
        m = None if kind == "none" else "causal"
        return m, m
    shape = (L, 20) if kind == "2d" else (B, L, 20)
    a = np.where(rng.random(shape) < 0.3, -1e9, 0.0).astype(np.float32)
    a[..., -1] = 0.0  # every query sees its row's last key
    return torch.from_numpy(a), jnp.asarray(a)


@pytest.mark.parametrize("L", [1, 8, 20])
@pytest.mark.parametrize("kind", ["causal", "none", "2d", "3d"])
def test_paged_attention_mask_matches_jax_xla(kind, L):
    """paged_attention(mask=...) against the JAX package's XLA route at the
    bf16 ladder of tests/test_torch_paged.py; None is non-causal (the XLA
    reading), so it differs from causal wherever L > 1."""
    rng = np.random.default_rng(L + len(kind))
    bt, (kp_j, kp_t), (vp_j, vp_t) = _pool(rng)
    q_j, q_t = bf16_numpy(rng.standard_normal((B, HQ, L, D)))
    pm, jm = _mask_of(kind, L, rng)
    got = f32(paged_attention(q_t, kp_t, vp_t, torch.from_numpy(bt), torch.from_numpy(LENS),
                              None, pm))
    want = f32(jax_paged_attention(q_j, kp_j, vp_j, jnp.asarray(bt), jnp.asarray(LENS), None,
                                   jm, impl="xla"))
    assert_allclose(got, want, precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)
    if kind == "none" and L > 1:
        causal = f32(paged_attention(q_t, kp_t, vp_t, torch.from_numpy(bt),
                                     torch.from_numpy(LENS)))
        assert np.abs(causal - got).max() > 0.05


def test_paged_attention_refuses_bad_masks():
    rng = np.random.default_rng(0)
    bt, (_, kp), (_, vp) = _pool(rng)
    q = torch.zeros((B, HQ, 1, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mask"):
        paged_attention(q, kp, vp, torch.from_numpy(bt), torch.from_numpy(LENS), mask="full")
    # The kernel route takes no array mask (CUDA tensors only; the check
    # comes before any launch, so it shows without a card).
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="array mask"):
            paged_attention(q.cuda(), kp.cuda(), vp.cuda(), torch.from_numpy(bt).cuda(),
                            torch.from_numpy(LENS).cuda(), mask=torch.zeros(1, 20),
                            impl="cuda")


def _dp_table(rng):
    """Row b's pages in dp replica b's stripe of the 16-page pool."""
    bt = np.full((B, 8), -1, np.int32)
    for b, n in enumerate(-(-LENS // PS)):
        bt[b, :n] = rng.permutation(np.arange(b * 8 + 1, b * 8 + 8))[:n]
    return bt


@pytest.mark.parametrize("mask", ["causal", "none"])
@pytest.mark.parametrize("strategy", ["sp", "tp", "dp"])
def test_strategies_pass_mask_through(strategy, mask):
    """SPAttention, TPAttention and DPPagedAttention .paged(..., mask=...)
    on the mesh [cpu] * 2, as `impl` of paged_attention, against the JAX
    package's unsharded XLA route with the same mask (L = 1 and 8)."""
    rng = np.random.default_rng(7)
    _, (kp_j, kp_t), (vp_j, vp_t) = _pool(rng)
    bt = _dp_table(rng)
    cpu2 = [torch.device("cpu")] * 2
    scfg = ShardingConfig(make_mesh(dp=2, tp=1, devices=cpu2) if strategy == "dp"
                          else make_mesh(tp=2, devices=cpu2))
    impl = {"sp": SPAttention, "tp": TPAttention, "dp": DPPagedAttention}[strategy](scfg)
    m = None if mask == "none" else "causal"
    for L in (1, 8):
        q_j, q_t = bf16_numpy(rng.standard_normal((B, HQ, L, D)))
        got = f32(paged_attention(q_t, kp_t, vp_t, torch.from_numpy(bt),
                                  torch.from_numpy(LENS), mask=m, impl=impl))
        want = f32(jax_paged_attention(q_j, kp_j, vp_j, jnp.asarray(bt), jnp.asarray(LENS),
                                       mask=m, impl="xla"))
        assert_allclose(got, want, precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)


def _count(monkeypatch, module, name: str) -> dict:
    """Count the calls of module.name (a route's plain version on the CPU)."""
    seen = {"n": 0}
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        seen["n"] += 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return seen


def _step(model, tokens):
    """A 6-token prefill and one decode step on a dense cache: the logits."""
    cache = DenseKVCache(2, 1, model.cfg.num_key_value_heads, 32, model.cfg.head_dim,
                         device="cpu")
    first = model([tokens], cache=cache)
    return f32(torch.cat([first[:, -1:], model([[int(first[0, -1].argmax())]], cache=cache)],
                         dim=1))


def test_act_quant_knob_equals_explicit_argument(tiny, monkeypatch):
    """TLT_ACT_QUANT=int8, read once at construction: the W4A8 layout and
    the W4A8 route (its plain version's calls) of act_quant="int8"."""
    _, cfg, _, pp = tiny
    calls = _count(monkeypatch, qm, "quant_matmul_a8_plain")
    explicit = Qwen3Model(pp, cfg, max_seq_len=32, device="cpu", act_quant="int8")
    want, n_explicit = _step(explicit, [5, 3, 8, 1, 9, 2]), calls["n"]
    monkeypatch.setenv("TLT_ACT_QUANT", "int8")
    knob = Qwen3Model(pp, cfg, max_seq_len=32, device="cpu")
    monkeypatch.delenv("TLT_ACT_QUANT")
    assert knob.act_quant == "int8" and knob.params.layers[0].attn.wqkv.act == "int8"
    calls["n"] = 0
    np.testing.assert_array_equal(_step(knob, [5, 3, 8, 1, 9, 2]), want)
    assert calls["n"] == n_explicit > 0
    assert Qwen3Model(pp, cfg, max_seq_len=32, device="cpu").act_quant == "bf16"


def test_pair_act_knob_read_at_import():
    """TLT_PAIR_ACT is read once, when kernels/quant_matmul.py is imported
    (a fresh interpreter: "int8" unless set)."""
    code = "from tiny_llm_tpu_torch.kernels import quant_matmul as q; print(q.PAIR_ACT_DEFAULT)"
    for env, want in ((None, "int8"), ("bf16", "bf16")):
        e = {k: v for k, v in os.environ.items() if k != "TLT_PAIR_ACT"}
        if env:
            e["TLT_PAIR_ACT"] = env
        out = subprocess.run([sys.executable, "-c", code], env=e, capture_output=True, text=True,
                             check=True, cwd=str(os.path.dirname(os.path.dirname(__file__))))
        assert out.stdout.strip() == want


def test_pair_act_bf16_takes_w4a16_route(tiny, monkeypatch):
    """With the tier "bf16" (TLT_PAIR_ACT=bf16), act="int8" weights take
    K1's route: the W4A8 route is never called, and the logits are those
    of the W4A16 model and of act="bf16" passed explicitly."""
    _, cfg, _, pp = tiny
    a8 = Qwen3Model(pp, cfg, max_seq_len=32, device="cpu", act_quant="int8")
    w4a16 = _step(Qwen3Model(pp, cfg, max_seq_len=32, device="cpu"), [5, 3, 8, 1])
    calls = _count(monkeypatch, qm, "quant_matmul_a8_plain")
    monkeypatch.setattr(qm, "PAIR_ACT_DEFAULT", "bf16")
    np.testing.assert_array_equal(_step(a8, [5, 3, 8, 1]), w4a16)
    assert calls["n"] == 0
    x = torch.randn(2, cfg.hidden_size).to(torch.bfloat16)
    w = a8.params.layers[0].attn.wqkv
    np.testing.assert_array_equal(f32(qm.quant_matmul(x, w)),
                                  f32(qm.quant_matmul(x, w, act="bf16")))
    monkeypatch.setattr(qm, "PAIR_ACT_DEFAULT", "int8")
    assert not np.array_equal(f32(qm.quant_matmul(x, w)), f32(qm.quant_matmul(x, w, act="bf16")))


def test_fused_attn_knob_equals_explicit_argument(tiny, monkeypatch):
    """TLT_FUSED_ATTN=0, read once at construction: the unfused decode
    chain of fused_attn=False (no fused decode step; the same logits)."""
    _, cfg, _, pp = tiny
    fused = _count(monkeypatch, fda, "fused_decode_attention_plain")
    explicit = _step(Qwen3Model(pp, cfg, max_seq_len=32, device="cpu", fused_attn=False),
                     [5, 3, 8, 1])
    assert fused["n"] == 0
    monkeypatch.setenv("TLT_FUSED_ATTN", "0")
    knob = Qwen3Model(pp, cfg, max_seq_len=32, device="cpu")
    monkeypatch.delenv("TLT_FUSED_ATTN")
    assert knob.fused_attn is False
    np.testing.assert_array_equal(_step(knob, [5, 3, 8, 1]), explicit)
    assert fused["n"] == 0
    _step(Qwen3Model(pp, cfg, max_seq_len=32, device="cpu"), [5, 3, 8, 1])
    assert fused["n"] == 2  # the fused route: one call a layer of the decode step


def test_unfused_decode_matches_jax_fused_attn_off(tiny, monkeypatch):
    """fused_attn=False against the JAX model built under TLT_FUSED_ATTN=0:
    teacher-forced logits within the bf16 ladder, greedy tokens equal."""
    jcfg, cfg, jp, pp = tiny
    monkeypatch.setenv("TLT_FUSED_ATTN", "0")
    jm = JaxQwen3Model(jp, jcfg, max_seq_len=64)
    monkeypatch.delenv("TLT_FUSED_ATTN")
    assert jm.fused_attn is False
    pm = Qwen3Model(pp, cfg, max_seq_len=64, device="cpu", fused_attn=False)
    ids = [5, 3, 8, 1, 9, 2, 7, 4]
    jcache, pcache = jm.create_kv_cache(1), pm.create_kv_cache(1)
    want = [np.asarray(jm(jnp.asarray([ids[:4]]), cache=jcache), np.float32)[:, -1]]
    got = [f32(pm([ids[:4]], cache=pcache))[:, -1]]
    for t in ids[4:]:
        want.append(np.asarray(jm(jnp.asarray([[t]]), cache=jcache), np.float32)[:, -1])
        got.append(f32(pm([[t]], cache=pcache))[:, -1])
    assert_allclose(np.stack(got), np.stack(want), jnp.bfloat16, atol=3e-2)
    tok = FakeTokenizer()
    assert simple_generate_with_kv_cache(pm, tok, "hello world", max_tokens=8) == \
        jax_greedy(jm, tok, "hello world", max_tokens=8)


NEW_WIDTHS = [(4, 16), (2, 16), (8, 256), (4, 256), (4, 80), (8, 48)]


@pytest.mark.parametrize("bits,group_size", NEW_WIDTHS)
def test_quantize_bit_equal_at_new_group_sizes(bits, group_size):
    """quantize / dequantize bit-equal to the JAX package's at group sizes
    below 32, above 128 and not dividing 128; K pads to lcm(128, g)."""
    K = {16: 384, 256: 512, 80: 480, 48: 480}[group_size]
    w = _weight((24, K), group_size, bits, seed=group_size)
    pq = PQ.quantize(torch.from_numpy(w), group_size, bits)
    assert pq.k_padded % np.lcm(128, group_size) == 0 and not pq.is_templated
    _assert_same(JQ.quantize(jnp.asarray(w), group_size=group_size, bits=bits), pq)


@pytest.mark.parametrize("bits,group_size", [(4, 16), (8, 256)])
def test_new_group_sizes_through_the_model_match_jax(bits, group_size):
    """A 2-layer model quantized at the width (the run-time-width walk's
    route; on the CPU its plain version) against the JAX model at the same
    width: logits within the bf16 ladder."""
    shape = dict(num_hidden_layers=2, hidden_size=256, intermediate_size=256, vocab_size=256,
                 num_attention_heads=4, num_key_value_heads=2,
                 tie_word_embeddings=False)  # the JAX package ties W4 g128 heads only
    jcfg, cfg = jax_tiny_config(**shape), tiny_test_config(**shape)
    jp = random_params(jcfg, key=6, group_size=group_size, bits=bits)
    pp = from_jax_numpy(params_to_numpy(jp), cfg, device="cpu")
    assert pp.layers[0].attn.wq.group_size == group_size
    want = np.asarray(JaxQwen3Model(jp, jcfg, max_seq_len=32)(jnp.asarray([[5, 3, 8, 1]])),
                      np.float32)
    got = f32(Qwen3Model(pp, cfg, max_seq_len=32, device="cpu")([[5, 3, 8, 1]]))
    assert_allclose(got, want, jnp.bfloat16, atol=3e-2)
