"""The port's sequence-parallel attention (tiny_llm_tpu_torch.parallel, on the
CPU) against the JAX package's: the two shard decode-state kernels' plain
versions against the Pallas kernels in interpret mode, the chunk-state plain
version at the virtual lengths sharded prefill gives it, SPAttention's
flash and paged routes against JAX's SPAttention on tests/conftest.py's 8
virtual devices and against unsharded attention, the striped page pool's
bookkeeping, and 2-layer SP models (dense, paged, batch_generate) against
JAX's, all on the same numpy inputs. The port's 8 shards are views of one
tensor on the CPU."""

from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from tiny_llm_tpu.kernels.flash_attention_pallas import (  # noqa: E402
    flash_decode_state_pallas,
    flash_prefill_state_pallas,
)
from tiny_llm_tpu.kernels.paged_attention import paged_attention as jax_paged  # noqa: E402
from tiny_llm_tpu.kernels.paged_attention_pallas import (  # noqa: E402
    paged_decode_state as jax_paged_decode_state,
)
from tiny_llm_tpu.kv.paged import PagePool as JaxPagePool  # noqa: E402
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu.parallel import SPAttention as JaxSPAttention  # noqa: E402
from tiny_llm_tpu.parallel import ShardingConfig as JaxShardingConfig  # noqa: E402
from tiny_llm_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tiny_llm_tpu.parallel.sp_attention import paged_decode_state_xla  # noqa: E402
from tiny_llm_tpu.serving import batch_generate as jax_batch_generate  # noqa: E402
from tiny_llm_tpu_torch.kernels.flash_attention import (  # noqa: E402
    NEG_INF,
    flash_attention,
    flash_decode_state,
    flash_prefill_state,
)
from tiny_llm_tpu_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention,
    paged_decode_state,
)
from tiny_llm_tpu_torch.kv import PagePool  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Model, from_jax_numpy, tiny_test_config  # noqa: E402
from tiny_llm_tpu_torch.parallel import ShardingConfig, SPAttention, make_mesh  # noqa: E402
from tiny_llm_tpu_torch.serving import batch_generate  # noqa: E402

from .torch_port import assert_logit_calls, bf16_numpy, f32, params_to_numpy  # noqa: E402
from .torch_port import teacher_forced  # noqa: E402
from .utils import FakeTokenizer, assert_allclose  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

N_SHARDS = 8
CPU8 = [torch.device("cpu")] * N_SHARDS
# m and l where l > 0: f32 sums of the same products in another order.
STATE_TOL = 1e-3
# SPAttention against JAX's and against unsharded attention, as
# tests/test_sharding.py's SP cases.
SP_ATOL = 5e-2


def _port_sp(impl=None) -> SPAttention:
    return SPAttention(ShardingConfig(make_mesh(dp=1, tp=N_SHARDS, devices=CPU8)), impl=impl)


def _jax_sp(inner="xla") -> JaxSPAttention:
    return JaxSPAttention(JaxShardingConfig(jax_make_mesh(dp=1, tp=N_SHARDS)), inner=inner)


@functools.cache
def _jax_sp_jit(route: str, inner: str):
    """JAX's SPAttention.<route> under one jit per (route, inner), so cases
    of one shape compile once."""
    sp = _jax_sp(inner)
    if route == "flash":
        return jax.jit(lambda q, k, v, lens: sp.flash(q, k, v, mask="causal", lens=lens))
    return jax.jit(sp.paged)


def _jax_sp_call(route: str, inner: str, *args):
    return _jax_sp_jit(route, inner)(*args)


def _assert_state(got, want, what=""):
    """o at the bf16 ladder; m and l within STATE_TOL where the reference's
    l > 0; elsewhere the port gives the identity (0, NEG_INF, 0) and no
    NaN."""
    o, m, l = (f32(x) for x in got)
    o_w, m_w, l_w = (np.asarray(x, np.float32) for x in want)
    assert np.isfinite(o).all() and np.isfinite(m).all() and np.isfinite(l).all(), what
    assert_allclose(o, o_w, jnp.bfloat16, message=what)
    live = l_w > 0
    np.testing.assert_allclose(m[live], m_w[live], rtol=STATE_TOL, atol=STATE_TOL, err_msg=what)
    np.testing.assert_allclose(l[live], l_w[live], rtol=STATE_TOL, atol=STATE_TOL, err_msg=what)
    assert (o[~live] == 0).all() and (m[~live] == NEG_INF).all() and (l[~live] == 0).all(), what


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
def test_decode_state_plain_matches_pallas(n_rep, D, L):
    """Row 6 on every shard of a 64-position slab in 4 shards of 16, rows of
    37 and 5 keys: full shards, a partial one, rows shorter than L, and
    empty shards; the port's shards are strided views of the slab."""
    rng = np.random.default_rng(10 * n_rep + D + L)
    B, Hkv, S, n = 2, 2, 64, 4
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = (bf16_numpy(rng.standard_normal(s)) for s in (
        (B, Hkv * n_rep, L, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    lens, S_loc, scale = np.asarray([37, 5], np.int32), S // n, D**-0.5
    for s in range(n):
        lens_loc = np.clip(lens - s * S_loc, 0, S_loc)
        cut = slice(s * S_loc, (s + 1) * S_loc)
        want = flash_decode_state_pallas(q_j, k_j[:, :, cut], v_j[:, :, cut],
                                         jnp.asarray(lens_loc), scale=scale, interpret=True)
        k_s = k_t[:, :, cut]
        assert not k_s.is_contiguous()
        got = flash_decode_state(q_t, k_s, v_t[:, :, cut], torch.from_numpy(lens_loc), scale)
        assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
        _assert_state(got, want, f"shard {s}")


def _paged_case(rng, L, P=16, Hq=4, Hkv=2, ps=8, D=64):
    """tests/test_sharding.py's SP pool: row 0 on pages 5, 2, 7, 9 (19 tokens
    + L), row 1 on pages 1, 12 and two -1 entries (10 + L)."""
    q = rng.standard_normal((2, Hq, L, D))
    kp, vp = rng.standard_normal((P, Hkv, ps, D)), rng.standard_normal((P, Hkv, ps, D))
    table = np.asarray([[5, 2, 7, 9], [1, 12, -1, -1]], np.int32)
    return q, kp, vp, table, np.asarray([19 + L, 10 + L], np.int32)


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("base", [0, 4, 12])
def test_paged_decode_state_plain_matches_pallas_and_xla(base, L):
    """Row 14 on the shard holding global pages [base, base + 4): its own
    pages only (-1 entries and other shards' pages contribute nothing),
    against _paged_decode_state_kernel in interpret mode and against
    paged_decode_state_xla (which rounds neither q nor p to bf16, hence the
    looser state tolerance there)."""
    rng = np.random.default_rng(base + 10 * L)
    q, kp, vp, table, lens = _paged_case(rng, L)
    (q_j, q_t), (kp_j, kp_t), (vp_j, vp_t) = bf16_numpy(q), bf16_numpy(kp), bf16_numpy(vp)
    loc = slice(base, base + 4)
    scale = q.shape[-1] ** -0.5
    got = paged_decode_state(q_t, kp_t[loc], vp_t[loc], torch.from_numpy(table),
                             torch.from_numpy(lens), base, scale)
    want = jax_paged_decode_state(q_j, kp_j[loc], vp_j[loc], jnp.asarray(table),
                                  jnp.asarray(lens), jnp.int32(base), scale=scale, interpret=True)
    _assert_state(got, want, f"pallas base {base}")
    xla = paged_decode_state_xla(q_j, kp_j[loc], vp_j[loc], jnp.asarray(table),
                                 jnp.asarray(lens), base, scale)
    assert_allclose(f32(got[0]), f32(xla[0]), jnp.bfloat16)
    live = np.asarray(xla[2]) > 0
    for part in (1, 2):
        np.testing.assert_allclose(f32(got[part])[live], np.asarray(xla[part])[live], rtol=2e-2,
                                   atol=2e-2)


def test_chunk_state_plain_at_virtual_lengths():
    """Row 7 as sharded prefill calls it: a 16-token chunk over one 16-key
    shard at virtual lengths below 0 (the shard is after every query: the
    identity), inside the shard (causal), and past its end (every key
    visible), against _prefill_state_kernel in interpret mode at whole
    16-row tiles."""
    rng = np.random.default_rng(21)
    B, Hkv, n_rep, L, S, D = 4, 1, 4, 16, 16, 64
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = (bf16_numpy(rng.standard_normal(s)) for s in (
        (B, Hkv * n_rep, L, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    lens = np.asarray([-5, 9, 23, 40], np.int32)
    want = flash_prefill_state_pallas(q_j, k_j, v_j, jnp.asarray(lens), scale=D**-0.5,
                                      causal=True, bq=16, bs=16, interpret=True)
    got = flash_prefill_state(q_t, k_t, v_t, torch.from_numpy(lens), D**-0.5)
    _assert_state(got, want)
    assert (f32(got[2])[0] == 0).all() and (f32(got[2])[3] > 0).all()


def _dense_inputs(L, S=64):
    """tests/test_sharding.py's _sp_setup shapes (B 2, Hq 8, Hkv 4, D 64)."""
    rng = np.random.default_rng(11 + L)
    return [bf16_numpy(rng.standard_normal(s)) for s in ((2, 8, L, 64), (2, 4, S, 64),
                                                         (2, 4, S, 64))]


# tests/test_sharding.py:422-500: (L, lens, the port's impl, JAX's inner).
FLASH_CASES = {
    "decode": (1, [61, 31], None, "xla"),
    "decode_plain": (1, [61, 31], "torch", "xla"),
    "zero_length_shards": (1, [5, 2], None, "xla"),
    "prefill_across_shards": (8, [61, 31], None, "xla"),
    "prefill_inside_first_shard": (4, [7, 5], None, "xla"),
    "gather": (8, [61, 31], "gather", "gather"),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_sp_flash_matches_jax_and_unsharded(case):
    L, lens, impl, inner = FLASH_CASES[case]
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = _dense_inputs(L)
    lens_j, lens_t = jnp.asarray(lens, jnp.int32), torch.tensor(lens, dtype=torch.int32)
    got = flash_attention(q_t, k_t, v_t, lens_t, impl=_port_sp(impl))
    assert got.dtype == torch.bfloat16 and np.isfinite(f32(got)).all()
    want = _jax_sp_call("flash", inner, q_j, k_j, v_j, lens_j)
    assert_allclose(f32(got), f32(want), jnp.bfloat16, atol=SP_ATOL)
    unsharded = jax_flash(q_j, k_j, v_j, mask="causal", lens=lens_j, impl="xla")
    assert_allclose(f32(got), f32(unsharded), jnp.bfloat16, atol=SP_ATOL)
    assert_allclose(f32(got), f32(flash_attention(q_t, k_t, v_t, lens_t)), jnp.bfloat16,
                    atol=SP_ATOL)


def test_sp_flash_and_paged_refuse_what_does_not_divide():
    sp = _port_sp()
    (_, q), (_, k), (_, v) = _dense_inputs(1, S=60)
    with pytest.raises(ValueError, match="divide over 8 shards"):
        sp.flash(q, k, v, torch.tensor([5, 5], dtype=torch.int32))
    kp = torch.zeros((12, 4, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="num_pages 12 must divide over 8 shards"):
        sp.paged(q, kp, kp, torch.tensor([[1], [2]]), torch.tensor([3, 3]))


# tests/test_sharding.py:545-600: (L, table, lens; None = _paged_case's).
PAGED_CASES = {
    "decode": (1, None, None),
    "single_shard_row": (1, [[2, 3, -1]], [13]),
    "prefill_gathers": (24, None, None),
}


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_sp_paged_matches_jax_and_unsharded(case):
    L, table, lens = PAGED_CASES[case]
    rng = np.random.default_rng(13 + L)
    q, kp, vp, table0, lens0 = _paged_case(rng, L)
    table = table0 if table is None else np.asarray(table, np.int32)
    lens = lens0 if lens is None else np.asarray(lens, np.int32)
    q = q[: len(table)]
    (q_j, q_t), (kp_j, kp_t), (vp_j, vp_t) = bf16_numpy(q), bf16_numpy(kp), bf16_numpy(vp)
    got = paged_attention(q_t, kp_t, vp_t, torch.from_numpy(table), torch.from_numpy(lens),
                          impl=_port_sp())
    assert np.isfinite(f32(got)).all()
    want = _jax_sp_call("paged", "xla", q_j, kp_j, vp_j, jnp.asarray(table), jnp.asarray(lens))
    assert_allclose(f32(got), f32(want), jnp.bfloat16, atol=SP_ATOL)
    unsharded = jax_paged(q_j, kp_j, vp_j, jnp.asarray(table), jnp.asarray(lens), impl="xla")
    assert_allclose(f32(got), f32(unsharded), jnp.bfloat16, atol=SP_ATOL)


def test_striped_pool_matches_jax():
    """PagePool(stripe_shards=8) against the JAX package's pure-Python
    striped pool over allocations, frees and a reset: the same page ids in
    the same order, free counts and reuse ledger."""
    dims = dict(num_layers=1, num_pages=32, num_kv_heads=1, page_size=8, head_dim=64)
    jp = JaxPagePool(**dims, native=False, stripe_shards=N_SHARDS)
    pp = PagePool(**dims, device="cpu", stripe_shards=N_SHARDS)

    def both(fn):
        a, b = fn(jp), fn(pp)
        assert a == b
        return a

    first = both(lambda p: [p.allocate_page() for _ in range(12)])
    assert sorted({page // 4 for page in first}) == list(range(N_SHARDS))  # spread over shards
    for page in first[3:9]:
        both(lambda p: p.free_page(page))
    both(lambda p: [p.allocate_page() for _ in range(20)])
    both(lambda p: (p.free_pages, p.live_pages, p.reused_page_allocations))
    both(lambda p: p.reset())
    both(lambda p: ([p.allocate_page() for _ in range(31)], p.free_pages))
    with pytest.raises(Exception, match="exhausted"):
        jp.allocate_page()
    with pytest.raises(Exception, match="exhausted"):
        pp.allocate_page()
    with pytest.raises(ValueError, match="must divide over 8 shards"):
        PagePool(**dict(dims, num_pages=30), device="cpu", stripe_shards=N_SHARDS)


def _sp_models(params, paged=False):
    """The JAX SP model (XLA inner route on the 8 virtual devices) and the
    port's (8 shards on the CPU) on the same 2-layer weights, n_rep 4.
    max_seq_len 128: the JAX slab window is then the whole slab, so both
    packages cut the same shards. Paged: 16 pages of 8, striped over 8."""
    jm = JaxQwen3Model(params, jax_tiny_config(**MODEL_KW), max_seq_len=128,
                       attn_impl=_jax_sp())
    if paged:
        jm.enable_paged_attention(num_pages=16, page_size=8)
        jm.page_pool = JaxPagePool(**POOL_DIMS, native=False, stripe_shards=N_SHARDS)
    return jm, _port_model(params, attn_impl=_port_sp(), paged=paged)


MODEL_KW = dict(num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1)
POOL_DIMS = dict(num_layers=2, num_pages=16, num_kv_heads=1, page_size=8, head_dim=64)


def _port_model(params, attn_impl=None, paged=False):
    pcfg = tiny_test_config(**MODEL_KW)
    pm = Qwen3Model(from_jax_numpy(params_to_numpy(params), pcfg, device="cpu"), pcfg,
                    max_seq_len=128, device="cpu", attn_impl=attn_impl)
    if paged:
        pm.enable_paged_attention(num_pages=16, page_size=8)
        pm.page_pool = PagePool(**POOL_DIMS, device="cpu", stripe_shards=N_SHARDS)
    return pm


@pytest.fixture(scope="module")
def sp_params():
    return random_params(jax_tiny_config(**MODEL_KW), key=5)


def test_sp_dense_model_matches_jax(sp_params, monkeypatch):
    """Teacher-forced logits of a 40-token chunk, a 30-token chunk at offset
    40 (row 7 per shard at virtual lengths) and 6 decode steps (row 6 per
    shard) within the ladder, top-1 equal where decided; the SP model
    against the unsharded port model too; a burst equal to its steps."""
    import tiny_llm_tpu_torch.kernels.flash_attention as fa

    jm, pm = _sp_models(sp_params)
    calls = []
    for name in ("flash_decode_state", "flash_prefill_state"):
        orig = getattr(fa, name + "_plain")
        monkeypatch.setattr(fa, name + "_plain",
                            lambda *a, _n=name, _o=orig: calls.append(_n) or _o(*a))
    runs = teacher_forced(jm, pm, (40, 30), 6)
    assert_logit_calls(runs)
    assert calls.count("flash_prefill_state") == 2 * 2 * N_SHARDS  # chunks x layers x shards
    assert calls.count("flash_decode_state") == 6 * 2 * N_SHARDS
    unsharded = _port_model(sp_params)
    cu, cs = unsharded.create_kv_cache(), pm.create_kv_cache()
    prompt = [[int(t) for t in np.random.default_rng(3).integers(0, 128, size=50)]]
    assert_logit_calls([(f32(unsharded(prompt, 0, cu)[0]), f32(pm(prompt, 0, cs)[0]))])
    first = [int(f32(pm([[7]], 50, cs))[0, -1].argmax())]
    burst = pm.decode_burst_dense(cs, first, 5)
    cs.rewind(5)
    steps, tok = [], first[0]
    for i in range(5):
        tok = int(f32(pm([[tok]], 51 + i, cs))[0, -1].argmax())
        steps.append(tok)
    assert burst[:, 0].tolist() == steps


def test_sp_paged_model_matches_jax(sp_params):
    """Over the striped pool: a 24-token chunk at offset 0 (its own k/v
    sharded: row 7 per shard), 20 at offset 24 (paged attention over the
    pool), 5 at offset 44 (row 14 per shard, causal) and 6 decode steps
    (row 14), teacher-forced, within the ladder; the request holds 7 pages."""
    jm, pm = _sp_models(sp_params, paged=True)
    assert not pm.supports_mixed and not jm.supports_mixed
    runs = teacher_forced(jm, pm, (24, 20, 5), 6)
    assert_logit_calls(runs)
    assert pm.page_pool.free_pages == 15 - 7  # one 55-token request on pages of 8


def test_sp_paged_batch_generate_matches_jax(sp_params):
    """One campaign over the striped pool: the same (prompt_idx, text) list,
    and the pool full again after it."""
    jm, pm = _sp_models(sp_params, paged=True)
    # 24 = 16 + 8 tokens: every chunk a first chunk's shape (JAX compiles each).
    prompts = ["hello sequence parallel!", "abcdefgh", "the page pool is striped", "xyzzy plugh 1234"]
    kw = dict(max_seq_len=64, batch_size=2, prefill_step=16, max_output_tokens=10)
    tok = FakeTokenizer()
    want = jax_batch_generate(jm, tok, prompts, **kw)
    got = batch_generate(pm, tok, prompts, **kw)
    assert got == want and len(got) == len(prompts)
    assert pm.page_pool.free_pages == pm.page_pool.num_pages - 1


def test_strategy_model_refuses_mixed_bursts_and_non_strategies(sp_params):
    """A model with an attention strategy has no mixed bursts (as JAX's
    supports_mixed), and attn_impl must be a strategy object."""
    pm = _port_model(sp_params, attn_impl=_port_sp(), paged=True)
    assert not pm.supports_mixed
    with pytest.raises(ValueError, match="no mixed bursts"):
        pm.mixed_burst(pm.create_batching_kv_cache(2), [1, 2], 1, [None], 8)
    with pytest.raises(TypeError, match="strategy"):
        _port_model(sp_params, attn_impl="torch")
