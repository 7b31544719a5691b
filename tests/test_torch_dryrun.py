"""A dry run of the port's parallel modes: the counterpart of
__graft_entry__.py's dryrun_multichip(8), whose 13 modes MULTICHIP_r05.json
lists, each at 8 shards on the mesh [cpu] * 8 (the pipelines at 8 stages
of an 8-layer model). Each case builds the sharded form through the
port's public API, runs one step and checks finite outputs of the right
shape within the bf16 ladder (atol 5e-2, rtol 5e-2) of the unsharded
port model on the same params; the decode pipeline's tokens equal the
unsharded greedy tokens. Imports no JAX."""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from tiny_llm_tpu_torch.generate import speculative_generate  # noqa: E402
from tiny_llm_tpu_torch.kernels.paged_attention import paged_attention  # noqa: E402
from tiny_llm_tpu_torch.kv.paged import PagePool  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Config, Qwen3Model, forward_full  # noqa: E402
from tiny_llm_tpu_torch.models import random_params  # noqa: E402
from tiny_llm_tpu_torch.ops.moe import moe_forward  # noqa: E402
from tiny_llm_tpu_torch.parallel import (  # noqa: E402
    DecodePipeline,
    DPPagedAttention,
    DPServing,
    EPMoE,
    MicrobatchedPipeline,
    ShardingConfig,
    SPAttention,
    TPAttention,
    make_mesh,
    shard_params,
)

from .torch_port import torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

N = 8
CPU = torch.device("cpu")
CFG = Qwen3Config(num_hidden_layers=2, hidden_size=256, num_attention_heads=8,
                  num_key_value_heads=8, head_dim=64, intermediate_size=512, vocab_size=512,
                  rope_theta=10000.0, max_position_embeddings=128)
MOE = dataclasses.replace(CFG, num_hidden_layers=1, num_experts=8, num_experts_per_tok=2,
                          moe_intermediate_size=128, norm_topk_prob=True)
COMP = dataclasses.replace(CFG, num_key_value_heads=4, num_experts=8, num_experts_per_tok=2,
                           moe_intermediate_size=512, norm_topk_prob=True)
PP = dataclasses.replace(CFG, num_hidden_layers=N)


def _scfg(**axes) -> ShardingConfig:
    axes = axes or {"tp": N}
    return ShardingConfig(make_mesh(devices=[CPU] * N, **axes),
                          ep_axis="ep" if "ep" in axes else None)


def _params(cfg, seed=0, quantized=True):
    return random_params(cfg, seed=seed, quantized=quantized, device="cpu")


def _step(model, tokens, then=None):
    """A prefill of `tokens`, then (optionally) one decode step of `then`."""
    cache = model.create_kv_cache(batch_size=len(tokens))
    out = model(tokens, 0, cache, logits_to_keep=1)
    if then is not None:
        out = model(then, len(tokens[0]), cache, logits_to_keep=1)
    return out


def _batching(model, dp_cache=None):
    """4 slots, each a 4-token prefill installed; one batched decode step."""
    cache = dp_cache or model.create_batching_kv_cache(max_active_requests=4)
    for slot in range(4):
        rc = model.create_kv_cache()
        if dp_cache is not None and model.page_pool is not None:
            rc.shard = dp_cache.slot_shard(slot)
        model(np.ones((1, 4), np.int64), 0, rc, logits_to_keep=1)
        cache.add_request(rc, slot)
    return model(np.ones((4, 1), np.int64), [4] * 4, cache, logits_to_keep=1)


def mode_tp():
    p = _params(CFG)
    toks = np.ones((4, 8), np.int64)
    got = _step(Qwen3Model(shard_params(p, _scfg()), CFG, max_seq_len=128, device="cpu"), toks)
    return got, _step(Qwen3Model(p, CFG, max_seq_len=128, device="cpu"), toks)


def mode_dp():
    scfg = _scfg(dp=2, tp=N // 2)
    p = _params(CFG)
    dp = DPServing(Qwen3Model(shard_params(p, scfg), CFG, max_seq_len=64, device="cpu"), scfg)
    got = _batching(dp, dp.create_batching_kv_cache(max_active_requests=4))
    return got, _batching(Qwen3Model(p, CFG, max_seq_len=64, device="cpu"))


def mode_dp_paged():
    scfg = _scfg(dp=2, tp=N // 2)
    p = _params(CFG)
    m = Qwen3Model(shard_params(p, scfg), CFG, max_seq_len=64, device="cpu",
                   attn_impl=DPPagedAttention(scfg))
    m.enable_paged_attention(num_pages=34, page_size=8)
    dp = DPServing(m, scfg)
    got = _batching(dp, dp.create_batching_kv_cache(max_active_requests=4))
    whole = Qwen3Model(p, CFG, max_seq_len=64, device="cpu")
    whole.enable_paged_attention(num_pages=34, page_size=8)
    return got, _batching(whole)


def mode_sp():
    p = _params(CFG)
    toks = np.ones((4, 8), np.int64)
    sp = Qwen3Model(p, CFG, max_seq_len=128, device="cpu", attn_impl=SPAttention(_scfg()))
    return _step(sp, toks), _step(Qwen3Model(p, CFG, max_seq_len=128, device="cpu"), toks)


def mode_sp_combine():
    p = _params(CFG)
    toks, dec = np.ones((4, 16), np.int64), np.ones((4, 1), np.int64)
    sp = Qwen3Model(p, CFG, max_seq_len=128, device="cpu", attn_impl=SPAttention(_scfg()))
    return _step(sp, toks, dec), _step(Qwen3Model(p, CFG, max_seq_len=128, device="cpu"), toks,
                                       dec)


def mode_sp_paged():
    pool = PagePool(1, 2 * N, CFG.num_key_value_heads, 8, CFG.head_dim, device="cpu",
                    stripe_shards=N)
    gen = torch.Generator().manual_seed(5)
    for t in (pool.key_pages, pool.value_pages):
        t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    bt = torch.tensor([[pool.allocate_page(), pool.allocate_page()]], dtype=torch.int32)
    q = torch.ones((1, CFG.num_attention_heads, 1, CFG.head_dim), dtype=torch.bfloat16)
    lens = torch.tensor([11], dtype=torch.int32)
    got = SPAttention(_scfg()).paged(q, pool.key_pages[0], pool.value_pages[0], bt, lens)
    return got, paged_attention(q, pool.key_pages[0], pool.value_pages[0], bt, lens)


def mode_ep():
    p = _params(MOE, seed=1)
    toks = torch.ones((2, 4), dtype=torch.long)
    return forward_full(shard_params(p, _scfg()), MOE, toks), forward_full(p, MOE, toks)


def mode_ep_routing():
    mlp = _params(MOE, seed=1).layers[0].mlp
    x = torch.ones((2, 4, MOE.hidden_size), dtype=torch.bfloat16)
    ep = EPMoE(_scfg(), mlp.w_router, mlp.w_gate, mlp.w_up, mlp.w_down,
               num_experts_per_tok=MOE.num_experts_per_tok, norm_topk_prob=MOE.norm_topk_prob)
    return ep(x), moe_forward(x, mlp.w_router, mlp.w_gate, mlp.w_up, mlp.w_down,
                              MOE.num_experts_per_tok, MOE.norm_topk_prob)


def _composed():
    p = _params(COMP, seed=3)
    sharded = shard_params(p, _scfg(dp=1, ep=2, tp=N // 2))
    return (Qwen3Model(sharded, COMP, max_seq_len=64, device="cpu"),
            Qwen3Model(p, COMP, max_seq_len=64, device="cpu"))


def mode_ep_tp():
    comp, whole = _composed()
    toks, dec = np.ones((1, 5), np.int64), np.ones((1, 1), np.int64)
    return _step(comp, toks, dec), _step(whole, toks, dec)


class _Tok:
    eos_token_id = -1

    def encode(self, s):
        return [ord(c) % 90 for c in s]

    def decode(self, ids):
        return "".join(chr(97 + i % 26) for i in ids)

    def get_vocab(self):
        return {str(i): i for i in range(128)}


def mode_speculative_ep_tp():
    """The EP x TP target under speculative decoding with a small dense
    draft: the text equals the unsharded target's; the logits compared are
    the target's over the prompt and the emitted text."""
    comp, whole = _composed()
    dcfg = Qwen3Config(num_hidden_layers=1, hidden_size=128, num_attention_heads=2,
                       num_key_value_heads=1, head_dim=64, intermediate_size=128,
                       vocab_size=512, rope_theta=10000.0, max_position_embeddings=128)
    draft = Qwen3Model(_params(dcfg, seed=4, quantized=False), dcfg, max_seq_len=64,
                       device="cpu")
    texts = [speculative_generate(draft, m, _Tok(), _Tok(), "hello", proposal_length=3,
                                  max_tokens=6, auto_disable=False) for m in (comp, whole)]
    assert isinstance(texts[0], str) and len(texts[0]) > 0 and texts[0] == texts[1]
    ids = [_Tok().encode("hello" + texts[0])]
    return comp(ids), whole(ids)


def mode_tp_paged():
    p = _params(CFG)
    scfg = _scfg()
    tp = Qwen3Model(shard_params(p, scfg), CFG, max_seq_len=64, device="cpu",
                    attn_impl=TPAttention(scfg))
    whole = Qwen3Model(p, CFG, max_seq_len=64, device="cpu")
    for m in (tp, whole):
        m.enable_paged_attention(num_pages=32, page_size=8)
    toks, dec = np.ones((1, 5), np.int64), np.ones((1, 1), np.int64)
    return _step(tp, toks, dec), _step(whole, toks, dec)


def mode_pp_microbatched():
    p = _params(PP, seed=2, quantized=False)
    toks = np.ones((2 * N, 4), np.int64)
    got = MicrobatchedPipeline(p, PP, num_stages=N, num_microbatches=N, devices=[CPU] * N)(toks)
    return got, forward_full(p, PP, torch.as_tensor(toks))


def mode_decode_pp():
    """Decode PP at 8 stages: prefill and 2 steps, tokens [2, 8] equal to
    the unsharded greedy tokens; the logits compared are the unsharded
    model's teacher-forced on the pipeline's tokens, against forward_full
    over the same sequence."""
    p = _params(PP, seed=2, quantized=False)
    prompts = np.ones((N, 4), np.int64)
    pipe = DecodePipeline(p, PP, num_stages=N, max_seq_len=32, devices=[CPU] * N)
    tok0 = pipe.prefill(prompts)
    toks = pipe.decode(tok0, steps=2)
    assert toks.shape == (2, N)
    whole = Qwen3Model(p, PP, max_seq_len=32, device="cpu")
    cache = whole.create_kv_cache(batch_size=N)
    first = whole(prompts, 0, cache, logits_to_keep=1)[:, -1].float().argmax(-1)
    ref = whole.decode_burst_dense(cache, first, 2)
    np.testing.assert_array_equal(tok0.numpy(), first.numpy())
    np.testing.assert_array_equal(toks, ref)
    seq = np.concatenate([prompts, tok0.numpy()[:, None], toks[:1].T], axis=1)
    return whole(seq[:, :-1], 0, whole.create_kv_cache(batch_size=N))[:, -1:], \
        forward_full(p, PP, torch.as_tensor(seq[:, :-1]))[:, -1:]


MODES = {
    "tp": (mode_tp, (4, 1, 512)),
    "dp": (mode_dp, (4, 1, 512)),
    "dp_paged": (mode_dp_paged, (4, 1, 512)),
    "sp": (mode_sp, (4, 1, 512)),
    "sp_combine": (mode_sp_combine, (4, 1, 512)),
    "sp_paged": (mode_sp_paged, (1, 8, 1, 64)),
    "ep": (mode_ep, (2, 4, 512)),
    "ep_routing": (mode_ep_routing, (2, 4, 256)),
    "ep_tp": (mode_ep_tp, (1, 1, 512)),
    "speculative_ep_tp": (mode_speculative_ep_tp, None),
    "tp_paged": (mode_tp_paged, (1, 1, 512)),
    "pp_microbatched": (mode_pp_microbatched, (2 * N, 4, 512)),
    "decode_pp": (mode_decode_pp, (N, 1, 512)),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_dryrun_mode_at_8_shards(mode):
    fn, shape = MODES[mode]
    got, want = fn()
    got, want = got.float().numpy(), want.float().numpy()
    if shape is not None:
        assert got.shape == shape
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
