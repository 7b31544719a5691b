"""The port's quantize, quantize_stacked and MLX ingest (ops/quantize.py)
against the JAX package's: codes, scales, biases and dequantized weights
bit-equal at bits 2 / 4 / 8 and groups 32 / 64 / 128, with a zero-range
group, exact .5 ties, stacked [E, N, K] experts and a K that needs padding."""

from __future__ import annotations

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402
from tiny_llm_tpu_torch.ops import quantize as PQ  # noqa: E402

from .torch_port import qt_to_numpy, torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

JQ = importlib.import_module("tiny_llm_tpu.ops.quantize")  # the package re-exports `quantize`

WIDTHS = [(b, g) for b in (2, 4, 8) for g in (32, 64, 128)]


def _weight(shape, group_size, bits, seed=0) -> np.ndarray:
    """Normal weights with a zero-range group (row 1's first) and a group of
    exact ties (row 2's first: codes k + 0.5 at scale 1, min 0)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * 0.05).astype(np.float32)
    levels = (1 << bits) - 1
    w[..., 1, :group_size] = 0.375
    tie = np.arange(group_size, dtype=np.float32) % levels + 0.5
    tie[0], tie[-1] = 0.0, float(levels)  # min 0, max = levels: scale exactly 1
    w[..., 2, :group_size] = tie
    return w


def _port_fields(qt):
    return {k: getattr(qt, k) for k in ("packed", "scales", "biases")}


def _assert_same(jax_qt, port_qt):
    """The JAX weight carried to the port's layout (codes through the
    bridge's unpackers) bit-equal to the port's own, and both dequantized."""
    want = quantized_from_numpy(qt_to_numpy(jax_qt))
    for k, v in _port_fields(want).items():
        assert torch.equal(getattr(port_qt, k), v), k
    assert (port_qt.in_features, port_qt.k_padded) == (want.in_features, want.k_padded)
    got = PQ.dequantize(port_qt, torch.float32).numpy()
    ref = np.asarray(JQ.dequantize(jax_qt, jnp.float32), np.float32)[..., : jax_qt.in_features]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bits,group_size", WIDTHS)
def test_quantize_bit_equal(bits, group_size):
    w = _weight((24, 384), group_size, bits)
    pq = PQ.quantize(torch.from_numpy(w), group_size, bits)
    _assert_same(JQ.quantize(jnp.asarray(w), group_size=group_size, bits=bits), pq)
    # The zero-range group: scale 1, bias its value, codes 0.
    assert float(pq.scales[1, 0]) == 1.0 and float(pq.biases[1, 0]) == 0.375
    # The ties round half to even.
    codes = PQ.unpack_codes(pq.packed, bits)[2, :group_size]
    tie = np.arange(group_size) % ((1 << bits) - 1) + 0.5
    want = np.round(tie)
    want[0], want[-1] = 0, (1 << bits) - 1
    np.testing.assert_array_equal(codes.numpy(), want)


@pytest.mark.parametrize("bits,group_size", [(4, 128), (2, 32), (8, 64)])
def test_quantize_stacked_bit_equal(bits, group_size):
    w = _weight((3, 16, 256), group_size, bits, seed=1)
    pq = PQ.quantize_stacked(torch.from_numpy(w), group_size, bits)
    assert pq.num_experts == 3
    _assert_same(JQ.quantize_stacked(jnp.asarray(w), group_size=group_size, bits=bits), pq)
    for e in range(3):  # each expert as it quantizes alone
        alone = PQ.quantize(torch.from_numpy(w[e]), group_size, bits)
        assert all(torch.equal(a, b) for a, b in zip(_port_fields(alone).values(),
                                                     _port_fields(pq.expert(e)).values()))


def test_quantize_pads_k():
    """K = 96 at g32: the port pads to 128 with zero-dequantizing groups."""
    w = _weight((8, 96), 32, 4, seed=2)
    pq = PQ.quantize(torch.from_numpy(w), 32, 4)
    assert pq.k_padded == 128 and pq.in_features == 96
    _assert_same(JQ.quantize(jnp.asarray(w), group_size=32, bits=4), pq)


def test_quantize_rejects_other_widths():
    w = torch.zeros((4, 64))
    with pytest.raises(ValueError):
        PQ.quantize(w, 0, 4)  # a group size below 1 (any other that divides K is taken)
    with pytest.raises(ValueError):
        PQ.quantize(w, 32, 3)
    with pytest.raises(ValueError):
        PQ.quantize(torch.zeros((4, 48)), 32, 4)  # K not a multiple of the group
    with pytest.raises(ValueError):
        PQ.quantize_stacked(w, 32, 4)


def _mlx_export(w: np.ndarray, group_size: int, bits: int, scale_dtype):
    """An MLX-style export of w [..., N, K]: consecutive little-endian codes
    in uint32 words, scales and biases (the group minima) in `scale_dtype`."""
    *lead, K = w.shape
    levels = (1 << bits) - 1
    wg = w.reshape(*lead, K // group_size, group_size)
    mx, mn = wg.max(-1), wg.min(-1)
    scale = np.where(mx > mn, (mx - mn) / levels, 1.0).astype(np.float32)
    q = np.clip(np.round((wg - mn[..., None]) / scale[..., None]), 0, levels)
    q = q.reshape(*lead, K // (32 // bits), 32 // bits).astype(np.uint32)
    words = np.zeros(q.shape[:-1], np.uint32)
    for i in range(32 // bits):
        words |= q[..., i] << np.uint32(bits * i)
    return words, scale.astype(scale_dtype), mn.astype(scale_dtype)


@pytest.mark.parametrize("bits,group_size", WIDTHS)
def test_unpack_mlx_bit_equal(bits, group_size):
    words = np.random.default_rng(bits * group_size).integers(0, 2**32, size=(5, 12),
                                                              dtype=np.uint32)
    got = PQ.unpack_mlx(torch.from_numpy(words.view(np.int32)), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JQ.unpack_mlx(jnp.asarray(words),
                                                                        bits)))


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,group_size", [(4, 128), (4, 64), (2, 32), (8, 128)])
def test_from_mlx_packing_bit_equal(bits, group_size, scale_dtype):
    w = _weight((16, 256), group_size, bits, seed=3)
    dt = jnp.bfloat16 if scale_dtype == "bfloat16" else np.float32
    words, s, b = _mlx_export(w, group_size, bits, dt)
    jq = JQ.from_mlx_packing(jnp.asarray(words), jnp.asarray(s), jnp.asarray(b), group_size, bits)

    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)

    pq = PQ.from_mlx_packing(t(words), t(s), t(b), group_size, bits)
    _assert_same(jq, pq)
    # uint32 words take the same route as their int32 view.
    pu = PQ.from_mlx_packing(t(words).view(torch.uint32), t(s), t(b), group_size, bits)
    assert torch.equal(pu.packed, pq.packed)
    # Stacked experts (the switch_mlp export) keep their leading dim.
    ws = np.stack([w, w[::-1].copy(), w * 2])
    sw, ss, sb = _mlx_export(ws, group_size, bits, dt)
    jqs = JQ.from_mlx_packing_stacked(jnp.asarray(sw), jnp.asarray(ss), jnp.asarray(sb),
                                      group_size, bits)
    _assert_same(jqs, PQ.from_mlx_packing_stacked(t(sw), t(ss), t(sb), group_size, bits))
