"""The port's two W4A8 plain versions where the int8 tensor-core tile's
edges fall (csrc/qmm_tile.cuh a8::: 16-row mma tiles, a 32-row block,
grouped 32-row blocks from each expert's first row), against the JAX
package: the dense matmul at M = 5, 9, 16, 17, 31 and 32 against
`_qmm_pair_pallas` in interpret mode and `_quantized_matmul_xla(a8=True)`,
with and without the residual, every x holding an all-zero row (sx = 1)
and a row of ties at k + 0.5; the grouped matmul against
`_gqmm_pair_pallas(a8=True)` in interpret mode over 8 experts, with
segments that start inside a 16-row tile. Tolerances as
tests/test_torch_w4a8.py states them. Then the launchers' refusals: CPU
tensors and rows above the JAX package's gates raise, with no fallback."""

from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels import quantized_matmul  # noqa: E402
from tiny_llm_tpu.kernels.moe_matmul import _gqmm_pair_pallas  # noqa: E402
from tiny_llm_tpu.ops.quantize import convert_layout, quantize, quantize_stacked  # noqa: E402
from tiny_llm_tpu_torch.kernels import moe_matmul as km  # noqa: E402
from tiny_llm_tpu_torch.kernels import quant_matmul as qm  # noqa: E402
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402

from .torch_port import bf16_numpy, f32, qt_to_numpy  # noqa: E402

N, K = 256, 640  # five 128-code groups (the JAX pair_t layout pads K to 1024)
E = 8


@functools.lru_cache(maxsize=None)
def _dense_weight():
    rng = np.random.default_rng(100)
    jqt = convert_layout(quantize(jnp.asarray(rng.standard_normal((N, K)) * 0.05,
                                              jnp.float32)), "pair_t")
    return jqt, quantized_from_numpy(qt_to_numpy(jqt))


@functools.lru_cache(maxsize=None)
def _stacked_weight():
    rng = np.random.default_rng(101)
    jqt = quantize_stacked(jnp.asarray(rng.standard_normal((E, N, K)) * 0.05, jnp.float32),
                           layout="pair_t")
    return jqt, quantized_from_numpy(qt_to_numpy(jqt))


def _x(rows, seed):
    """Random rows with row 0 all zero (sx = 1, every code 0) and row 1 a
    row of ties: max |x| = 127 makes sx = 1, so 2.5, -3.5, 0.5, -0.5 and
    126.5 land on k + 0.5 (round half to even)."""
    x = np.random.default_rng(seed).standard_normal((rows, K)).astype(np.float32) * 3
    x[0] = 0.0
    x[1] = np.clip(x[1] * 20, -100, 100)
    x[1, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]
    return bf16_numpy(x)


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("M", [5, 9, 16, 17, 31, 32])
def test_a8_dense_edges_match_pallas_and_xla(M, residual):
    jqt, port = _dense_weight()
    xj, xt = _x(M, seed=M)
    rj, rt = bf16_numpy(np.random.default_rng(50 + M).standard_normal((M, N))) \
        if residual else (None, None)
    got = f32(qm.quant_matmul(xt, port, residual=rt))
    np.testing.assert_array_equal(got, f32(qm.quant_matmul_a8_plain(xt, port, rt)))
    if not residual:
        assert not got[0].any()  # the zero row: codes 0, sx 1
    for impl in ("pallas", "xla"):
        want = np.asarray(quantized_matmul(xj, jqt, residual=rj, impl=impl, act="int8",
                                           interpret=True), np.float32)
        if residual:
            np.testing.assert_allclose(got, want, atol=0.06, rtol=0.02, err_msg=impl)
        else:
            assert np.abs(got - want).max() / np.abs(want).max() < 1e-2, impl


GROUPED = {
    "one_17": [17],
    "one_128": [128],
    "split_65_63": [65, 63],
    "mid_tile_1_16_0_111": [1, 16, 0, 111],
    "expert_3_holds_128": [0, 0, 0, 128],
}


@pytest.mark.parametrize("name", list(GROUPED))
def test_a8_grouped_edges_match_pallas(name):
    """Per expert segment, relative max error < 1e-2, as
    tests/test_torch_w4a8.py holds the grouped plain version."""
    jqt, port = _stacked_weight()
    sizes = GROUPED[name] + [0] * (E - len(GROUPED[name]))
    T = sum(sizes)
    xj, xt = _x(T, seed=200 + T + len(GROUPED[name]))
    gs = np.asarray(sizes, np.int32)
    got = f32(km.grouped_quant_matmul(xt, port, torch.from_numpy(gs)))
    np.testing.assert_array_equal(
        got, f32(km.grouped_quant_matmul_a8_plain(xt, port, torch.from_numpy(gs))))
    x_pad = jnp.pad(xj, ((0, 0), (0, jqt.k_padded - K)))  # the kernel takes padded rows
    want = np.asarray(_gqmm_pair_pallas(x_pad, jqt.packed, jqt.scales, jqt.biases,
                                        jnp.asarray(gs), group_size=128, bits=4, a8=True,
                                        interpret=True), np.float32)
    assert not got[0].any() and not want[0].any()  # the zero row
    start = 0
    for s in sizes:
        seg = slice(start, start + s)
        if np.abs(want[seg]).max(initial=0) > 0:  # not the zero row alone
            err = np.abs(got[seg] - want[seg]).max() / np.abs(want[seg]).max()
            assert err < 1e-2, (name, start, s, err)
        start += s


def _launcher(kind, rows, device="cpu"):
    """The W4A8 launcher of `kind` ("dense" or "grouped") on `rows` zero
    rows, as a thunk."""
    x = torch.zeros((rows, K), dtype=torch.bfloat16, device=device)
    if kind == "dense":
        return lambda: qm.quant_matmul_a8_cuda(x, _dense_weight()[1])
    sizes = torch.tensor([rows] + [0] * (E - 1), dtype=torch.int32, device=device)
    return lambda: km.grouped_quant_matmul_a8_cuda(x, _stacked_weight()[1], sizes)


@pytest.mark.parametrize("rows", [1, 2, 3, 32])
@pytest.mark.parametrize("kind", ["dense", "grouped"])
def test_a8_launchers_refuse_cpu_tensors(kind, rows):
    """On the CPU the wrappers run the plain versions; the launchers
    themselves never fall back, on either side of the GEMV / tile
    crossover: a CPU tensor raises before any build, and nothing is
    counted."""
    before = (qm.A8_LAUNCHES, km.A8_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        _launcher(kind, rows)()
    assert (qm.A8_LAUNCHES, km.A8_LAUNCHES) == before


@pytest.mark.parametrize("over", [1, 32])
@pytest.mark.parametrize("kind", ["dense", "grouped"])
def test_a8_launchers_refuse_rows_above_the_gate(kind, over):
    """Above the JAX package's row gates (32 dense, 128 grouped) the W4A8
    kernels take no rows: the launchers raise rather than run them."""
    rows = {"dense": qm.A8_MAX_ROWS, "grouped": km.A8_MAX_ROWS}[kind] + over
    with pytest.raises(ValueError, match="at most"):
        _launcher(kind, rows)()
