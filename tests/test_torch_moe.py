"""The port's MoE layers (on the CPU, plain kernel versions) against the JAX
package's: routing with ties, the stacked-weight bridge, the grouped
matmul's plain version against the Pallas walk in interpret mode and the
XLA grouped matmul, moe_forward, and 2-layer MoE models (dense and paged,
and served by batch_generate) against JAX's, on the same numpy inputs."""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import tiny_llm_tpu.ops.moe as jax_moe  # noqa: E402
import tiny_llm_tpu_torch.ops.moe as port_moe  # noqa: E402
from tiny_llm_tpu.kernels.moe_matmul import _gqmm_magic_pallas  # noqa: E402
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu.ops.quantize import dequantize as jax_dequantize  # noqa: E402
from tiny_llm_tpu.ops.quantize import quantize, quantize_stacked  # noqa: E402
from tiny_llm_tpu.serving import batch_generate as jax_batch_generate  # noqa: E402
from tiny_llm_tpu_torch.kernels.moe_matmul import grouped_quant_matmul  # noqa: E402
from tiny_llm_tpu_torch.models import (  # noqa: E402
    QWEN3_CONFIGS,
    MoEParams,
    Qwen3Model,
    from_jax_numpy,
    fuse_projections,
    synthetic_quantized_params,
    tiny_test_config,
)
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402
from tiny_llm_tpu_torch.ops.quantize import dequantize, from_codes, unpack_codes  # noqa: E402
from tiny_llm_tpu_torch.serving import batch_generate  # noqa: E402

from .torch_port import bf16_numpy, f32, qt_to_numpy  # noqa: E402
from .utils import FakeTokenizer, assert_allclose  # noqa: E402

# Logit tolerance (bf16 ladder, absolute), as tests/test_torch_model.py.
LOGIT_ATOL = 3e-2
# A position whose k experts differ between the packages is excluded from
# the logit comparison only when the k-th and (k+1)-th probabilities lie
# within this margin (a near-tie that a bf16 ulp of router logit flips),
# and at most MAX_EXCLUDED of all positions may be.
TIE_MARGIN = 1e-3
MAX_EXCLUDED = 0.02


def moe_params_to_numpy(params) -> dict:
    """The JAX package's unfused Qwen3Params (dense or MoE layers) as the
    bridge's nested dict."""
    layers = []
    for layer in params.layers:
        a, m = layer.attn, layer.mlp
        mlp = {name: qt_to_numpy(getattr(m, name)) for name in ("w_gate", "w_up", "w_down")}
        if hasattr(m, "w_router"):
            mlp["w_router"] = qt_to_numpy(m.w_router)
        layers.append({
            "input_layernorm": np.asarray(layer.input_layernorm),
            "post_attention_layernorm": np.asarray(layer.post_attention_layernorm),
            "attn": {
                "wq": qt_to_numpy(a.wq), "wk": qt_to_numpy(a.wk),
                "wv": qt_to_numpy(a.wv), "wo": qt_to_numpy(a.wo),
                "q_norm": np.asarray(a.q_norm), "k_norm": np.asarray(a.k_norm),
            },
            "mlp": mlp,
        })
    return {
        "embedding": qt_to_numpy(params.embedding),
        "lm_head": None if params.lm_head is None else qt_to_numpy(params.lm_head),
        "final_norm": np.asarray(params.final_norm),
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _jax_routing(logits: np.ndarray, k: int, norm: bool):
    """JAX route_topk on exactly these bf16 logits: an identity router in
    f32 reproduces them bit for bit."""
    E = logits.shape[-1]
    x = jnp.asarray(logits, jnp.float32).astype(jnp.bfloat16)
    probs, ids, scores = jax_moe.route_topk(x, jnp.eye(E, dtype=jnp.bfloat16), k, norm)
    return np.asarray(probs), np.asarray(ids), np.asarray(scores)


@pytest.mark.parametrize("norm", [False, True], ids=["raw", "norm_topk"])
def test_select_topk_matches_jax_with_ties(norm):
    """Random bf16 logits with ties built at the k-th place and elsewhere,
    plus the case where torch.topk and jax.lax.top_k disagree."""
    E, k, T = 16, 4, 40
    rng = np.random.default_rng(21)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    for t in range(0, T, 2):  # copy the k-th largest onto the (k+1)-th
        order = np.argsort(-logits[t], kind="stable")
        logits[t, order[k]] = logits[t, order[k - 1]]
    logits[1] = 0.25  # all equal
    logits = np.asarray(jnp.asarray(logits).astype(jnp.bfloat16), np.float32)
    want_p, want_i, want_s = _jax_routing(logits, k, norm)
    p, i, s = port_moe.select_topk(torch.from_numpy(logits).to(torch.bfloat16), k, norm)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-6, atol=0)
    np.testing.assert_allclose(p.numpy(), want_p, rtol=1e-6, atol=0)
    assert s.dtype == torch.float32 and i.shape == (T, k)

    # Where the two libraries' top-k disagree: JAX and the port take [1, 2].
    probs = np.log(np.asarray([[0.1, 0.3, 0.3, 0.2, 0.3, 0.05]], np.float32))
    _, want_i, _ = _jax_routing(probs, 2, norm)
    _, i, _ = port_moe.select_topk(torch.from_numpy(probs).to(torch.bfloat16), 2, norm)
    assert i.tolist() == want_i.tolist() == [[1, 2]]


# ---------------------------------------------------------------------------
# Stacked weights across the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout,bits,gs", [
    pytest.param("magic_t", 4, 128, id="magic_t"),
    pytest.param("sg", 4, 128, id="sg"),
    pytest.param("pair_t", 4, 128, id="pair_t"),
    pytest.param("sg", 2, 64, id="sg-W2g64"),
    pytest.param("sg", 8, 64, id="sg-W8g64"),
    pytest.param("sg", 4, 32, id="sg-W4g32"),
])
def test_stacked_bridge_dequantizes_bit_equal(layout, bits, gs):
    """K = 384 pads to 512 in the JAX magic_t and pair_t layouts (and to
    its sg supergroup, 32 / bits groups) and to 384 in the port's: the
    bridge drops the JAX pad groups, every expert stays bit-equal, and
    from_codes, .to() and expert() keep the stack."""
    E, N, K = 3, 48, 384
    rng = np.random.default_rng(1)
    jqt = quantize_stacked(jnp.asarray(rng.standard_normal((E, N, K)) * 0.1, jnp.float32),
                           group_size=gs, bits=bits, layout=layout)
    port = quantized_from_numpy(qt_to_numpy(jqt))
    assert port.k_padded == 384 and port.num_experts == E
    assert tuple(port.packed.shape) == (E, N, 384 * bits // 32)
    assert tuple(port.scales.shape) == (E, N, 384 // gs)
    want = np.asarray(jax_dequantize(jqt, jnp.float32))
    np.testing.assert_array_equal(f32(dequantize(port, torch.float32)), want)
    np.testing.assert_array_equal(f32(dequantize(port.expert(2), torch.float32)), want[2])
    again = from_codes(unpack_codes(port.packed, bits), port.scales, port.biases, in_features=K,
                       group_size=gs, bits=bits)
    assert torch.equal(again.packed, port.packed)
    assert torch.equal(dequantize(port.to("cpu")), dequantize(port))


# ---------------------------------------------------------------------------
# The grouped matmul: plain version against the Pallas walk and XLA
# ---------------------------------------------------------------------------

SIZES = {
    "one_expert": [0, 0, 37, 0],
    "empty_first_mid_last": [0, 5, 0, 9, 3, 0],
    "tiny_groups": [1, 1, 1, 1, 2],
    "crosses_bm_tiles": [70, 0, 45, 41],  # T = 156: bm = 128, two m-tiles
    "bm_boundaries": [32, 0, 32, 0],  # T = 64: bm = 32, groups end on tiles
}


@pytest.mark.parametrize("sizes", list(SIZES.values()), ids=list(SIZES))
def test_grouped_matmul_plain_matches_pallas_and_xla(sizes):
    E, N, K = len(sizes), 256, 384
    rng = np.random.default_rng(sum(sizes) + E)
    jqt = quantize_stacked(jnp.asarray(rng.standard_normal((E, N, K)) * 0.05, jnp.float32),
                           layout="magic_t")
    xj, xt = bf16_numpy(rng.standard_normal((sum(sizes), K)))
    gs = np.asarray(sizes, np.int32)
    xpad = jnp.pad(xj, ((0, 0), (0, jqt.k_padded - K)))
    want = _gqmm_magic_pallas(xpad, jqt.packed, jqt.scales, jqt.biases, jnp.asarray(gs),
                              group_size=128, bits=4, interpret=True)
    oracle = jax_moe.grouped_matmul(xj, jqt, jnp.asarray(gs), use_ragged=False, impl="xla")
    got = grouped_quant_matmul(xt, quantized_from_numpy(qt_to_numpy(jqt)), torch.from_numpy(gs))
    assert got.dtype == torch.bfloat16 and got.shape == (sum(sizes), N)
    # As K1 holds its decode schedule (tests/test_torch_kernels.py): the
    # plain version dequantizes in f32 and the magic walk folds scale and
    # bias in f32 too (differences: accumulation order and the bf16 round),
    # 2e-2 on the bf16 ladder. The XLA oracle multiplies bf16-rounded
    # weights, within the same bound at K = 384.
    assert_allclose(f32(got), f32(want), precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)
    assert_allclose(f32(got), f32(oracle), precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)


def test_grouped_expert_linear_unsorted_ids_matches_jax():
    E, N, K, R = 5, 128, 256, 30
    rng = np.random.default_rng(8)
    jqt = quantize_stacked(jnp.asarray(rng.standard_normal((E, N, K)) * 0.05, jnp.float32),
                           layout="magic_t")
    ids = rng.integers(0, E, size=R).astype(np.int32)
    ids[:3] = 4  # repeated ids keep their row order
    xj, xt = bf16_numpy(rng.standard_normal((R, K)))
    want = jax_moe.grouped_expert_linear(xj, jqt, jnp.asarray(ids), use_ragged=False,
                                         impl="xla")
    got = port_moe.grouped_expert_linear(xt, quantized_from_numpy(qt_to_numpy(jqt)),
                                         torch.from_numpy(ids))
    assert_allclose(f32(got), f32(want), precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)
    order, sizes = port_moe.sort_by_expert(torch.from_numpy(ids), E)
    assert sizes.dtype == torch.int32 and sizes.tolist() == np.bincount(ids, minlength=E).tolist()
    assert order.tolist() == np.argsort(ids, kind="stable").tolist()


def test_grouped_matmul_refuses_bad_inputs_on_cpu():
    qt = quantized_from_numpy(qt_to_numpy(quantize_stacked(jnp.ones((2, 128, 128)))))
    x, gs = torch.zeros((3, 128), dtype=torch.bfloat16), torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_quant_matmul(x, qt, gs, impl="cuda")
    with pytest.raises(ValueError, match="stacked"):
        grouped_quant_matmul(x, qt.expert(0), gs)
    with pytest.raises(ValueError, match="sum to"):
        grouped_quant_matmul(x, qt, torch.tensor([1, 1], dtype=torch.int32))


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------


def _excluded(records_j, records_p, k):
    """Positions (call index, flat position) whose expert sets differ, each
    checked to be a near-tie of the JAX probabilities."""
    assert len(records_j) == len(records_p)
    out = set()
    for c, ((pj, ij), (_, ip)) in enumerate(zip(records_j, records_p)):
        pj, ij, ip = pj.reshape(-1, pj.shape[-1]), ij.reshape(-1, k), ip.reshape(-1, k)
        for t in range(ij.shape[0]):
            if set(ij[t].tolist()) != set(ip[t].tolist()):
                top = np.sort(pj[t])[::-1]
                margin = top[k - 1] - top[k]
                assert margin < TIE_MARGIN, f"call {c} position {t}: experts differ " \
                    f"{ij[t]} vs {ip[t]} with margin {margin}"
                out.add((c, t))
    return out


@pytest.mark.parametrize("norm", [False, True], ids=["raw", "norm_topk"])
def test_moe_forward_matches_jax(norm):
    B, L, D, E, I, k = 2, 24, 128, 8, 128, 2
    rng = np.random.default_rng(3)

    def stacked(n, kk):
        return quantize_stacked(jnp.asarray(rng.standard_normal((E, n, kk)) * 0.05,
                                            jnp.float32), layout="magic_t")

    wr = quantize(jnp.asarray(rng.standard_normal((E, D)) * 0.2, jnp.float32))
    wg, wu, wd = stacked(I, D), stacked(I, D), stacked(D, I)
    xj, xt = bf16_numpy(rng.standard_normal((B, L, D)))
    want = jax_moe.moe_forward(xj, wr, wg, wu, wd, k, norm, use_ragged=False)
    port = [quantized_from_numpy(qt_to_numpy(w)) for w in (wr, wg, wu, wd)]
    got = port_moe.moe_forward(xt, *port, k, norm)
    assert got.dtype == torch.bfloat16 and got.shape == (B, L, D)
    pj, ij, _ = jax_moe.route_topk(xj, wr, k, norm)
    pp, ip, _ = port_moe.route_topk(xt, port[0], k, norm)
    skip = {t for _, t in _excluded([(np.asarray(pj), np.asarray(ij))],
                                    [(pp.numpy(), ip.numpy())], k)}
    assert len(skip) <= MAX_EXCLUDED * B * L
    keep = [t for t in range(B * L) if t not in skip]
    # bf16 ladder: the router logits and every expert output differ by the
    # packages' dequantization (bf16 weights in JAX's XLA route, f32 here).
    assert_allclose(f32(got).reshape(B * L, D)[keep], f32(want).reshape(B * L, D)[keep],
                    precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# 2-layer MoE models against JAX's
# ---------------------------------------------------------------------------

MOE_CONFIGS = {
    # layer 0 dense, layer 1 sparse: both MLP kinds run
    "moe": dict(num_hidden_layers=2, num_experts=8, num_experts_per_tok=2,
                moe_intermediate_size=128, norm_topk_prob=True, mlp_only_layers=(0,)),
    # Qwen3-30B-A3B's n_rep = 8 at D = 128, 16 experts, top-4
    "moe_nrep8_d128": dict(num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=1,
                           head_dim=128, num_experts=16, num_experts_per_tok=4,
                           moe_intermediate_size=128, norm_topk_prob=True,
                           mlp_only_layers=(0,)),
}


@pytest.fixture(scope="module")
def routing_log():
    """Record every route_topk call of both packages, in call order, as
    numpy (probs, ids): the JAX package's through jax.debug.callback, so
    the jitted steps traced after this fixture record too."""
    log = {"jax": [], "port": []}
    orig_j, orig_p = jax_moe.route_topk, port_moe.route_topk

    def jax_route(*a, **kw):
        probs, ids, scores = orig_j(*a, **kw)
        jax.debug.callback(lambda p, i: log["jax"].append((np.asarray(p), np.asarray(i))),
                           probs, ids)
        return probs, ids, scores

    def port_route(*a, **kw):
        probs, ids, scores = orig_p(*a, **kw)
        log["port"].append((probs.numpy().copy(), ids.numpy().copy()))
        return probs, ids, scores

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_moe, "route_topk", jax_route)
        mp.setattr(port_moe, "route_topk", port_route)
        yield log


def _pair(name, paged: bool, seed: int = 3):
    over = MOE_CONFIGS[name]
    jcfg, pcfg = jax_tiny_config(**over), tiny_test_config(**over)
    params = random_params(jcfg, key=seed)
    jm = JaxQwen3Model(params, jcfg, max_seq_len=128)
    pm = Qwen3Model(from_jax_numpy(moe_params_to_numpy(params), pcfg, device="cpu"), pcfg,
                    max_seq_len=128, device="cpu")
    if paged:
        jm.enable_paged_attention(num_pages=40, page_size=8)
        pm.enable_paged_attention(num_pages=40, page_size=8)
    return jm, pm, pcfg


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("name", list(MOE_CONFIGS))
def test_moe_model_teacher_forced_logits_match_jax(name, paged, routing_log):
    """Chunks (one of 64 dense; 32 at offset 0, 24 and 8 at offset > 0
    paged) and 8 decode steps, both fed the JAX model's greedy tokens: 72
    positions, so the 2 % bound admits one near-tie flip. Logits within
    LOGIT_ATOL and top-1 equal where decided, except at the near-tie
    routing flips (_excluded). The JAX model takes its XLA route: the
    64-row chunk runs K1's staged tile, whose dequantized weights
    bf16(q * s + b) are that route's."""
    _moe_teacher_forced(name, paged, routing_log)


def _moe_teacher_forced(name, paged, routing_log):
    jm, pm, cfg = _pair(name, paged)
    rng = np.random.default_rng(11)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, size=64)]
    chunks = (32, 24, 8) if paged else (64,)
    cj, cp = jm.create_kv_cache(), pm.create_kv_cache()
    routing_log["jax"].clear()
    routing_log["port"].clear()
    logits, off = [], 0
    for L in chunks:
        chunk = [prompt[off : off + L]]
        logits.append((np.asarray(jm(jnp.asarray(chunk, jnp.int32), off, cj), np.float32)[0],
                       f32(pm(chunk, off, cp)[0])))
        off += L
    for _ in range(8):
        tok = int(np.argmax(logits[-1][0][-1]))
        logits.append((np.asarray(jm(jnp.asarray([[tok]], jnp.int32), off, cj), np.float32)[0],
                       f32(pm([[tok]], off, cp)[0])))
        off += 1
    jax.effects_barrier()
    assert len(routing_log["port"]) == len(logits)  # one MoE layer per call
    skip = _excluded(routing_log["jax"], routing_log["port"], cfg.num_experts_per_tok)
    positions = sum(w.shape[0] for w, _ in logits)
    assert len(skip) <= MAX_EXCLUDED * positions, f"{len(skip)} of {positions} excluded"
    for c, (want, got) in enumerate(logits):
        keep = [t for t in range(want.shape[0]) if (c, t) not in skip]
        want, got = want[keep], got[keep]
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
        top2 = np.sort(want, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_ATOL
        np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])
    if paged:
        cp.release()
        assert pm.page_pool.live_pages == 0


def test_moe_paged_batch_generate_matches_jax():
    """bench.py-style serving on the tiny MoE model: 5 prompts over 2 slots,
    decode bursts of 4, the same (prompt_idx, text) list as JAX."""
    jm, pm, _ = _pair("moe", paged=True, seed=4)
    prompts = [f"moe prompt {i} {'xy' * i}" for i in range(5)]
    kw = dict(max_seq_len=48, batch_size=2, prefill_step=8, max_output_tokens=5,
              decode_burst=4)
    tok = FakeTokenizer()
    got = batch_generate(pm, tok, prompts, **kw)
    assert got == jax_batch_generate(jm, tok, prompts, **kw)
    assert sorted(i for i, _ in got) == list(range(5))
    assert pm.page_pool.live_pages == 0


def test_synthetic_moe_params_and_model_on_cpu():
    cfg = tiny_test_config(num_hidden_layers=3, num_experts=8, num_experts_per_tok=2,
                           moe_intermediate_size=256, mlp_only_layers=(1,))
    params = synthetic_quantized_params(cfg, seed=5, device="cpu")
    assert [isinstance(layer.mlp, MoEParams) for layer in params.layers] == [True, False, True]
    moe = params.layers[0].mlp
    assert (moe.w_router.out_features, moe.w_router.in_features) == (8, 128)
    assert moe.w_router.num_experts is None
    for w, (N, K) in ((moe.w_gate, (256, 128)), (moe.w_up, (256, 128)),
                      (moe.w_down, (128, 256))):
        assert tuple(w.packed.shape) == (8, N, K // 8) and w.packed.dtype == torch.int32
        assert tuple(w.scales.shape) == (8, N, K // 128) and w.scales.dtype == torch.bfloat16
        s = w.scales.float()
        # uniform in [0.001, 0.005), then rounded to bf16 (half an ulp: 2^-9)
        assert float(s.min()) >= 0.001 * (1 - 2**-9) and float(s.max()) <= 0.005 * (1 + 2**-9)
        assert torch.equal(w.biases, (-7.5 * s).to(torch.bfloat16))
    assert fuse_projections(params).layers[0].mlp is moe  # experts stay unfused
    m = Qwen3Model(params, cfg, max_seq_len=64, device="cpu")
    c = m.create_kv_cache()
    first = m([[1, 2, 3, 4, 5]], 0, c, logits_to_keep=1)[0, -1].float().argmax()
    toks = m.decode_burst_dense(c, [int(first)], 3)
    assert toks.shape == (3, 1) and ((0 <= toks) & (toks < cfg.vocab_size)).all()


def test_qwen3_30b_a3b_layers_are_all_sparse_as_in_jax():
    from tiny_llm_tpu.models.registry import QWEN3_CONFIGS as JAX_CONFIGS

    cfg = QWEN3_CONFIGS["qwen3-30b-a3b"]
    jcfg = JAX_CONFIGS["qwen3-30b-a3b"]
    sparse = [cfg.is_moe_layer(i) for i in range(cfg.num_hidden_layers)]
    assert sparse == [jcfg.is_moe_layer(i) for i in range(jcfg.num_hidden_layers)]
    assert all(sparse) and cfg.num_attention_heads // cfg.num_key_value_heads == 8
    for over in ({"mlp_only_layers": (0, 5)}, {"decoder_sparse_step": 2}):
        a, b = dataclasses.replace(cfg, **over), dataclasses.replace(jcfg, **over)
        assert [a.is_moe_layer(i) for i in range(8)] == [b.is_moe_layer(i) for i in range(8)]
