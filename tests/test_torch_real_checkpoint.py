"""tests/test_real_checkpoint.py's checks with the port doing the loading:
genuine HF checkpoints built by scripts/make_real_checkpoint.py (random-
init transformers weights saved with save_pretrained, a trained byte-level
BPE tokenizer, the HF forward's own logits and greedy tokens as the
oracle), read by the port's loader and tokenizer and run by the port's
model on the CPU. The JAX suite's tolerances. Every weight the port loads
dequantizes bit-equal to the JAX package's load_params."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models.loader import load_params as jax_load_params  # noqa: E402
from tiny_llm_tpu_torch.kernels.quant_matmul import STAGED_MIN_ROWS  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Model, load_config, load_params  # noqa: E402
from tiny_llm_tpu_torch.tokenizer import load_tokenizer  # noqa: E402

from .test_real_checkpoint import _dequantized_params  # noqa: E402
from .torch_port import torch_one_thread  # noqa: E402,F401
from .torch_port import assert_loaded_equal, f32, real_checkpoint  # noqa: E402

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.fixture(scope="module")
def ckpt_dir() -> str:
    return real_checkpoint("qwen3-tiny-real")


@pytest.fixture(scope="module")
def moe_ckpt_dir() -> str:
    return real_checkpoint("qwen3-tiny-moe", ("--moe",))


@pytest.fixture(scope="module")
def full_vocab_ckpt_dir() -> str:
    return real_checkpoint("qwen3-tiny-fullvocab", ("--full-vocab",))


def _oracle(d: str) -> dict:
    with open(os.path.join(d, "oracle", "greedy.json")) as f:
        return json.load(f)


def _ref_logits(d: str) -> np.ndarray:
    return np.load(os.path.join(d, "oracle", "prefix_logits.npy"))


def _f32_model(d: str, max_seq_len: int | None = None) -> Qwen3Model:
    params, cfg = load_params(d, quantized=False, dtype=torch.float32, device="cpu")
    return Qwen3Model(params, cfg, max_seq_len=max_seq_len, device="cpu")


def _greedy_ids(model, prompt_ids: list[int], steps: int) -> list[int]:
    """KV-cached greedy continuation, no EOS stop (the oracle decodes
    through EOS)."""
    cache = model.create_kv_cache()
    try:
        out, tokens, offset = [], [prompt_ids], 0
        for _ in range(steps):
            logits = model(tokens, offset, cache, logits_to_keep=1)
            nxt = int(torch.argmax(logits[0, -1].to(torch.float32)))
            out.append(nxt)
            offset += len(tokens[0])
            tokens = [[nxt]]
        return out
    finally:
        cache.release()


# ---------------------------------------------------------------------------
# Weights, config and tokenizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["real", "moe", "fullvocab"])
@pytest.mark.parametrize("quantized", [True, False], ids=["w4a16", "f32"])
def test_loaded_weights_bit_equal_to_jax(variant, quantized, request):
    d = request.getfixturevalue({"real": "ckpt_dir", "moe": "moe_ckpt_dir",
                                 "fullvocab": "full_vocab_ckpt_dir"}[variant])
    dtype = (torch.bfloat16, jnp.bfloat16) if quantized else (torch.float32, jnp.float32)
    jp, jcfg = jax_load_params(d, quantized=quantized, dtype=dtype[1])
    pp, pcfg = load_params(d, quantized=quantized, dtype=dtype[0], device="cpu")
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert_loaded_equal(jp, pp)


def test_tokenizer_chat_template_and_roundtrip(ckpt_dir):
    tok = load_tokenizer(ckpt_dir)
    o = _oracle(ckpt_dir)
    text = tok.apply_chat_template(o["messages"], tokenize=False, add_generation_prompt=True)
    assert text == o["prompt_text"]
    assert tok.encode(text) == o["prompt_ids"]
    sample = "naïve café — 你好世界 🌍"
    assert tok.decode(tok.encode(sample)) == sample


def test_config_parses_hf_json(ckpt_dir, moe_ckpt_dir):
    cfg = load_config(ckpt_dir)
    assert cfg.num_hidden_layers == 4 and cfg.head_dim == 64
    assert not cfg.is_moe_layer(0)
    mcfg = load_config(moe_ckpt_dir)
    assert mcfg.is_moe_layer(0) and mcfg.moe_intermediate_size == 128


# ---------------------------------------------------------------------------
# f32 parity and greedy agreement with the HF oracle
# ---------------------------------------------------------------------------


def test_f32_prompt_logits_match_oracle(ckpt_dir):
    o = _oracle(ckpt_dir)
    ours = f32(_f32_model(ckpt_dir)([o["prompt_ids"]])[0])
    np.testing.assert_allclose(ours, _ref_logits(ckpt_dir), rtol=1e-4, atol=1e-4)


def test_f32_greedy_64_tokens_match_oracle(ckpt_dir):
    o = _oracle(ckpt_dir)
    model = _f32_model(ckpt_dir, 256)
    assert _greedy_ids(model, o["prompt_ids"], len(o["greedy_ids"])) == o["greedy_ids"]


def test_dense_vs_paged_equal_on_real_weights(ckpt_dir):
    o = _oracle(ckpt_dir)
    want = _greedy_ids(_f32_model(ckpt_dir, 256), o["prompt_ids"], 32)
    paged = _f32_model(ckpt_dir, 256)
    paged.enable_paged_attention(page_size=16, num_pages=64)
    assert paged.page_pool.key_pages.dtype == torch.float32
    assert _greedy_ids(paged, o["prompt_ids"], 32) == want


def test_burst_vs_per_step_equal_on_real_weights(ckpt_dir):
    o = _oracle(ckpt_dir)
    model = _f32_model(ckpt_dir, 256)
    per_step = _greedy_ids(model, o["prompt_ids"], 32)
    cache = model.create_kv_cache()
    try:
        logits = model([o["prompt_ids"]], 0, cache, logits_to_keep=1)
        first = int(torch.argmax(logits[0, -1]))
        burst = model.decode_burst_dense(cache, [first], 31)
        got = [first] + [int(t) for t in burst[:, 0]]
    finally:
        cache.release()
    assert got == per_step


# ---------------------------------------------------------------------------
# Quantize at load
# ---------------------------------------------------------------------------


def _chunked_logits(model, ids: list[int], chunk: int = STAGED_MIN_ROWS - 1) -> np.ndarray:
    """Prompt logits, the prompt prefilled in chunks of at most 32 rows:
    K1's routes there (the GEMV and the bf16 tile) dequantize q * s + b in
    f32. From 33 rows K1's staged tile takes over (the whole-prompt test)."""
    cache = model.create_kv_cache()
    rows = [f32(model([ids[o : o + chunk]], o, cache)[0]) for o in range(0, len(ids), chunk)]
    return np.concatenate(rows)


def _jax_quantized_logits(d: str, ids: list[int]) -> np.ndarray:
    """The JAX suite's dequantized oracle on the JAX package's own W4A16 load
    of `d`: every weight dequantized to bf16, the XLA route."""
    pq, cfg = jax_load_params(d, quantized=True)
    return np.asarray(JaxQwen3Model(_dequantized_params(pq), cfg, max_seq_len=256)
                      .forward_full(jnp.asarray([ids]))[0], np.float32)


def test_quantized_forward_matches_dequantized_oracle(ckpt_dir):
    """The JAX suite's oracle (its dequantized model on the same weights)
    and tolerance, on K1's routes of at most 32 rows."""
    o = _oracle(ckpt_dir)
    pq, cfg = load_params(ckpt_dir, quantized=True, device="cpu")
    got = _chunked_logits(Qwen3Model(pq, cfg, max_seq_len=256, device="cpu"), o["prompt_ids"])
    want = _jax_quantized_logits(ckpt_dir, o["prompt_ids"])
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("variant", ["real", "fullvocab"])
def test_quantized_whole_prompt_matches_jax_staged_schedule(variant, request):
    """The whole prompt in one prefill (K1's staged tile, which stages the
    dequantized weight bf16(q * s + b)) against the JAX suite's dequantized
    oracle, under its tolerance. The Pallas staged schedule, which rounds
    q * s to bf16 and adds the biases through group sums, misses it (144 of
    108544 logits here, 1257 of 8052608 on the full vocabulary)."""
    d = request.getfixturevalue({"real": "ckpt_dir", "fullvocab": "full_vocab_ckpt_dir"}[variant])
    o = _oracle(d)
    pq, cfg = load_params(d, quantized=True, device="cpu")
    assert len(o["prompt_ids"]) >= STAGED_MIN_ROWS
    got = f32(Qwen3Model(pq, cfg, max_seq_len=256, device="cpu")([o["prompt_ids"]])[0])
    want = _jax_quantized_logits(d, o["prompt_ids"])
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_quantized_load_generates(ckpt_dir):
    o = _oracle(ckpt_dir)
    pq, cfg = load_params(ckpt_dir, quantized=True, device="cpu")
    toks = _greedy_ids(Qwen3Model(pq, cfg, max_seq_len=256, device="cpu"), o["prompt_ids"], 8)
    assert len(toks) == 8 and all(0 <= t < cfg.vocab_size for t in toks)


def test_w4a8_decode_close_to_w4a16_on_real_checkpoint(ckpt_dir):
    """The JAX suite's W4A8 gate on the port: teacher-forced decode logits
    under act_quant="int8" within KL 1e-2 and 15 % of the W4A16 model's,
    top-1 agreement >= 0.6."""
    o = _oracle(ckpt_dir)
    pq, cfg = load_params(ckpt_dir, quantized=True, device="cpu")
    m16 = Qwen3Model(pq, cfg, max_seq_len=256, device="cpu")
    m8 = Qwen3Model(pq, cfg, max_seq_len=256, device="cpu", act_quant="int8")
    steps = 16
    forced = _greedy_ids(m16, o["prompt_ids"], steps)

    def forced_logits(model):
        cache = model.create_kv_cache()
        toks, off, logs = [o["prompt_ids"]], 0, []
        for i in range(steps):
            logs.append(f32(model(toks, off, cache, logits_to_keep=1)[0, -1]))
            off += len(toks[0])
            toks = [[forced[i]]]
        return np.stack(logs)

    g16, g8 = forced_logits(m16), forced_logits(m8)

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    p, q = softmax(g16), softmax(g8)
    kl = (p * (np.log(p + 1e-12) - np.log(q + 1e-12))).sum(-1)
    assert kl.max() < 1e-2, kl.max()
    rel = np.abs(g8 - g16).max(-1) / np.abs(g16).max(-1)
    assert rel.max() < 0.15, rel.max()
    agree = np.mean(np.argmax(g8, axis=-1) == np.argmax(g16, axis=-1))
    assert agree >= 0.6, agree


# ---------------------------------------------------------------------------
# MoE (HF per-expert tensors) and the production vocabulary
# ---------------------------------------------------------------------------


def test_moe_f32_prompt_logits_match_oracle(moe_ckpt_dir):
    o = _oracle(moe_ckpt_dir)
    model = _f32_model(moe_ckpt_dir)
    assert model.cfg.num_experts == 8 and model.cfg.num_experts_per_tok == 2
    ours = f32(model([o["prompt_ids"]])[0])
    np.testing.assert_allclose(ours, _ref_logits(moe_ckpt_dir), rtol=1e-4, atol=1e-4)


def test_moe_f32_greedy_matches_oracle(moe_ckpt_dir):
    o = _oracle(moe_ckpt_dir)
    model = _f32_model(moe_ckpt_dir, 256)
    assert _greedy_ids(model, o["prompt_ids"], len(o["greedy_ids"])) == o["greedy_ids"]


def test_full_vocab_config_and_logit_parity(full_vocab_ckpt_dir):
    o = _oracle(full_vocab_ckpt_dir)
    ref = _ref_logits(full_vocab_ckpt_dir)
    model = _f32_model(full_vocab_ckpt_dir)
    assert model.cfg.vocab_size == 151_936 and ref.shape[-1] == 151_936
    ours = f32(model([o["prompt_ids"]])[0])
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_full_vocab_greedy_matches_oracle(full_vocab_ckpt_dir):
    o = _oracle(full_vocab_ckpt_dir)
    model = _f32_model(full_vocab_ckpt_dir, 256)
    assert _greedy_ids(model, o["prompt_ids"], len(o["greedy_ids"])) == o["greedy_ids"]


def test_full_vocab_quantized_embedding_and_head(full_vocab_ckpt_dir):
    o = _oracle(full_vocab_ckpt_dir)
    pq, cfg = load_params(full_vocab_ckpt_dir, quantized=True, device="cpu")
    assert cfg.vocab_size == 151_936
    got = _chunked_logits(Qwen3Model(pq, cfg, max_seq_len=256, device="cpu"), o["prompt_ids"])
    want = _jax_quantized_logits(full_vocab_ckpt_dir, o["prompt_ids"])
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
