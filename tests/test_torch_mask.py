"""The port's explicit-mask flash attention (tiny_llm_tpu_torch.kernels.
flash_attention, mask=<tensor> and mask=None) against the JAX package's, on
the CPU: every case of tests/test_flash_mask.py through the port's plain
version, held against the Pallas masked kernels in interpret mode
(`_decode_kernel_masked` for L <= 16, `_prefill_kernel_masked` above) and
against the XLA twin, on the same numpy inputs. The Pallas kernels and the
port give a row that sees no key 0; the XLA twin gives such a row the
uniform average, so it is compared only on rows that see a key."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from tiny_llm_tpu.kernels.flash_attention_pallas import flash_attention_pallas  # noqa: E402
from tiny_llm_tpu_torch.kernels.flash_attention import flash_attention  # noqa: E402
from tiny_llm_tpu_torch.kernels.flash_attention import normalize_mask  # noqa: E402
from tiny_llm_tpu_torch.parallel import ShardingConfig, SPAttention, make_mesh  # noqa: E402

from .torch_port import bf16_numpy, f32  # noqa: E402

NEG = -1e30
# The port's plain version and the Pallas kernels round at the same points
# (q * scale to bf16, f32 scores and softmax, bf16 probabilities in PV) and
# differ in summation order and tiling: 1e-2 on outputs of magnitude ~1,
# the bf16 ladder's. The XLA twin rounds elsewhere (a bf16 softmax input):
# test_flash_mask.py's 5e-2.
PALLAS_ATOL, XLA_ATOL = 1e-2, 5e-2


def _inputs(B=2, Hq=8, Hkv=4, L=1, S=64, D=64, seed=0):
    """q/k/v from a seed as (JAX bf16, port bf16) pairs of the same values."""
    rng = np.random.default_rng(seed)
    out = [bf16_numpy(rng.normal(size=shape).astype(np.float32))
           for shape in ((B, Hq, L, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    return out, rng


def _window(L, S, window, offset):
    """Additive [L, S]: query row l (absolute position offset + l) sees the
    keys in (pos - window, pos]."""
    q_pos = offset + np.arange(L)[:, None]
    k_pos = np.arange(S)[None, :]
    visible = (k_pos <= q_pos) & (k_pos > q_pos - window)
    return np.where(visible, 0.0, NEG).astype(np.float32)


def _head_mask(B, Hq, L, S, seed, lens=None):
    """test_flash_mask.py's per-head masks: a window per head plus a
    random bias, each row's window trailing its own last valid key."""
    rng = np.random.default_rng(seed)
    m = np.empty((B, Hq, L, S), np.float32)
    for b in range(B):
        off = (S if lens is None else int(lens[b])) - L
        for h in range(Hq):
            m[b, h] = _window(L, S, 8 + 4 * h, off) + rng.normal(size=(L, S)) * 0.3
    return m


def _document_mask(L, S):
    doc = np.zeros(S, np.int64)
    doc[32:] = 1
    causal = np.tril(np.ones((L, S), bool))
    return np.where(causal & (doc[:, None] == doc[None, :]), 0.0, NEG).astype(np.float32)


def _padding_mask():
    m = np.zeros((3, 1, 48), np.float32)
    for b, p in enumerate([0, 7, 23]):
        m[b, :, :p] = NEG
    return m


def _fully_masked_row():
    m = np.zeros((1, 32, 32), np.float32)
    m[0, 5, :] = NEG  # row 5 sees nothing
    return m


# Each case of tests/test_flash_mask.py: (setup kwargs, mask builder, lens).
CASES = {
    "decode_sliding_window": (dict(L=1, S=64), lambda: np.stack(
        [_window(1, 64, 16, 63), _window(1, 64, 16, 39)]), [64, 40]),
    "decode_per_row_padding": (dict(B=3, L=1, S=48, seed=1), _padding_mask, None),
    "decode_random_bias": (dict(L=1, S=64, seed=2), lambda: (np.random.default_rng(99).normal(
        size=(2, 1, 64)) * 2.0).astype(np.float32), None),
    "decode_2d_mask_broadcasts": (dict(L=1, S=64, seed=3), lambda: _window(1, 64, 8, 63), None),
    "prefill_sliding_window": (dict(L=64, S=64, seed=4), lambda: np.broadcast_to(
        _window(64, 64, 16, 0)[None], (2, 64, 64)).copy(), None),
    "prefill_document": (dict(L=64, S=64, seed=5), lambda: np.broadcast_to(
        _document_mask(64, 64)[None], (2, 64, 64)).copy(), None),
    "prefill_4d_unit_head": (dict(L=32, S=64, seed=6), lambda: np.broadcast_to(
        _window(32, 64, 24, 32)[None, None], (2, 1, 32, 64)).copy(), None),
    "prefill_fully_masked_row": (dict(B=1, L=32, S=32, seed=7), _fully_masked_row, None),
    "prefill_uneven_tiles": (dict(L=48, S=80, seed=8), lambda: np.broadcast_to(
        _window(48, 80, 20, 32)[None], (2, 48, 80)).copy(), None),
    "per_head_prefill": (dict(L=32, S=64, seed=9), lambda: _head_mask(2, 8, 32, 64, 10), None),
    "per_head_decode": (dict(L=1, S=64, seed=11),
                        lambda: _head_mask(2, 8, 1, 64, 12, lens=[64, 48]), [64, 48]),
    "per_head_decode_multiquery": (dict(L=4, S=64, seed=13),
                                   lambda: _head_mask(2, 8, 4, 64, 14), None),
    "per_head_uneven_tiles": (dict(L=48, S=80, seed=15), lambda: _head_mask(2, 8, 48, 80, 16),
                              None),
}


def _seen(mask4: np.ndarray, lens, S: int) -> np.ndarray:
    """[B, 1 or H, L]: rows that see at least one key (mask above -1e29 at a
    position below the row's length)."""
    lens = np.full(mask4.shape[0], S) if lens is None else np.asarray(lens)
    below = np.arange(S)[None, :] < lens[:, None]  # [B, S]
    return ((mask4 > NEG / 10) & below[:, None, None, :]).any(-1)


@pytest.mark.parametrize("name", list(CASES))
def test_masked_plain_matches_pallas_and_xla(name):
    kw, build, lens = CASES[name]
    (qp, kp, vp), _ = _inputs(**kw)
    mask = build()
    lj = None if lens is None else jnp.asarray(lens, jnp.int32)
    lt = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    got = f32(flash_attention(qp[1], kp[1], vp[1], lt, mask=torch.from_numpy(mask)))
    pallas = f32(flash_attention_pallas(qp[0], kp[0], vp[0], mask=jnp.asarray(mask), lens=lj,
                                        interpret=True))
    xla = f32(jax_flash(qp[0], kp[0], vp[0], mask=jnp.asarray(mask), lens=lj, impl="xla"))
    np.testing.assert_allclose(got, pallas, atol=PALLAS_ATOL, rtol=0)
    B, Hq, L, _ = got.shape
    S = kp[1].shape[2]
    seen = np.broadcast_to(
        _seen(np.asarray(normalize_mask(torch.from_numpy(mask), B, L, S)), lens, S), (B, Hq, L))
    np.testing.assert_allclose(got[seen], xla[seen], atol=XLA_ATOL, rtol=0)
    # A row that sees no key is exactly 0, with no NaN (the Pallas convention).
    assert np.isfinite(got).all()
    assert not got[~seen].any()
    if name == "prefill_fully_masked_row":
        assert (~seen).sum() == Hq and not got[0, :, 5].any()


def test_mask_none_is_length_bound_only():
    """An explicit mask=None: no causality, the lengths still bound the keys
    (the XLA twin's and ops/attention.py's meaning), at L = 1 and L = 24."""
    for L, seed in ((1, 20), (24, 21)):
        (qp, kp, vp), _ = _inputs(L=L, S=40, seed=seed)
        lens = [40, 17]
        got = f32(flash_attention(qp[1], kp[1], vp[1], torch.tensor(lens, dtype=torch.int32),
                                  mask=None))
        want = f32(jax_flash(qp[0], kp[0], vp[0], mask=None,
                             lens=jnp.asarray(lens, jnp.int32), impl="xla"))
        np.testing.assert_allclose(got, want, atol=XLA_ATOL, rtol=0)
        # The same as an all-zero explicit mask, and not causal.
        zero = f32(flash_attention(qp[1], kp[1], vp[1], torch.tensor(lens, dtype=torch.int32),
                                   mask=torch.zeros(L, 40)))
        np.testing.assert_array_equal(got, zero)
    causal = f32(flash_attention(qp[1], kp[1], vp[1], torch.tensor(lens, dtype=torch.int32)))
    assert np.abs(causal - got).max() > 0.1


def test_bf16_mask_equals_its_f32_values():
    """A bf16 mask runs as its f32 values (exactly), as the Pallas wrapper
    casts it; against the Pallas kernels on those values."""
    (qp, kp, vp), rng = _inputs(L=4, S=64, seed=30)
    m = (rng.normal(size=(2, 4, 64)) * 2.0).astype(np.float32)
    m[:, :, 50:] = NEG
    mb = torch.from_numpy(m).to(torch.bfloat16)
    got = f32(flash_attention(qp[1], kp[1], vp[1], mask=mb))
    same = f32(flash_attention(qp[1], kp[1], vp[1], mask=mb.to(torch.float32)))
    np.testing.assert_array_equal(got, same)
    want = f32(flash_attention_pallas(qp[0], kp[0], vp[0], mask=jnp.asarray(f32(mb)),
                                      interpret=True))
    np.testing.assert_allclose(got, want, atol=PALLAS_ATOL, rtol=0)


def test_mask_shapes_rejected():
    (qp, kp, vp), _ = _inputs(L=8, S=64, seed=17)
    q, k, v = qp[1], kp[1], vp[1]
    with pytest.raises(ValueError, match="head axis"):  # 3 != Hq = 8
        flash_attention(q, k, v, mask=torch.zeros(2, 3, 8, 64))
    with pytest.raises(ValueError, match="mask"):  # batch 3 != 2
        flash_attention(q, k, v, mask=torch.zeros(3, 8, 64))
    with pytest.raises(ValueError, match="mask"):
        flash_attention(q, k, v, mask=torch.zeros(8, 63))
    with pytest.raises(ValueError, match="mask"):
        flash_attention(q, k, v, mask="sliding")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v, mask=torch.zeros(8, 64), impl="cuda")


def test_mask_with_a_strategy_raises():
    """A strategy object takes causal attention only (as the JAX package's
    TPAttention refuses masks): a mask or mask=None raises, causal runs."""
    sp = SPAttention(ShardingConfig(make_mesh(tp=2, devices=[torch.device("cpu")] * 2)))
    (qp, kp, vp), _ = _inputs(L=1, S=64, seed=18)
    lens = torch.tensor([64, 40], dtype=torch.int32)
    with pytest.raises(ValueError, match="strategy"):
        flash_attention(qp[1], kp[1], vp[1], lens, impl=sp, mask=torch.zeros(1, 64))
    with pytest.raises(ValueError, match="strategy"):
        flash_attention(qp[1], kp[1], vp[1], lens, impl=sp, mask=None)
    got = flash_attention(qp[1], kp[1], vp[1], lens, impl=sp)
    want = flash_attention(qp[1], kp[1], vp[1], lens)
    np.testing.assert_allclose(f32(got), f32(want), atol=PALLAS_ATOL, rtol=0)
