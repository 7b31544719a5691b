"""The grouped W4A16 expert matmul where its two CUDA routes meet, on the
CPU: the plain version (`grouped_quant_matmul_plain`, which both routes
compute: the f32 fold of the Pallas kernel) against the JAX package's
Pallas walk `_gqmm_magic_pallas` in interpret mode, and the gate that
picks the route.

The card runs the per-expert GEMV walk below B16_MIN_T rows (a decode
step: one token's top-8) and K1's bf16 tensor-core tile over (expert,
16- or 32-row block) tiles from there, so the cases sit on the tile's
edges: one expert holding 15, 16, 17, 32 or 33 rows, eight experts with
a row each, T = 9 at the gate, empty experts at both ends. One small
weight set serves every case."""

from __future__ import annotations

import functools
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import tiny_llm_tpu_torch.kernels.moe_matmul as km  # noqa: E402
from tiny_llm_tpu.kernels.moe_matmul import _gqmm_magic_pallas  # noqa: E402
from tiny_llm_tpu.ops.quantize import quantize_stacked  # noqa: E402
from tiny_llm_tpu_torch.kernels import qmm_crossover  # noqa: E402
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402

from .torch_port import bf16_numpy, f32, qt_to_numpy  # noqa: E402
from .utils import assert_allclose  # noqa: E402

E, N, K = 10, 256, 384
CU = Path(km.__file__).resolve().parent.parent / "csrc" / "moe_matmul.cu"


def _one(rows: int, e: int = 4) -> list[int]:
    sizes = [0] * E
    sizes[e] = rows
    return sizes


SIZES = {
    "one_expert_15": _one(15),
    "one_expert_16": _one(16),
    "one_expert_17": _one(17),
    "one_expert_32": _one(32),
    "one_expert_33": _one(33),
    "eight_experts_one_row_each": [0, 1, 1, 1, 1, 0, 1, 1, 1, 1],
    "nine_rows_at_the_gate": [0, 2, 1, 1, 1, 0, 1, 1, 1, 1],
    "empty_experts_at_both_ends": [0, 0, 7, 1, 19, 0, 3, 12, 0, 0],
}


@functools.lru_cache(maxsize=None)
def _weights():
    rng = np.random.default_rng(14)
    jqt = quantize_stacked(jnp.asarray(rng.standard_normal((E, N, K)) * 0.05, jnp.float32),
                           layout="magic_t")
    return jqt, quantized_from_numpy(qt_to_numpy(jqt))


@pytest.mark.parametrize("sizes", list(SIZES.values()), ids=list(SIZES))
def test_grouped_plain_matches_pallas_at_the_tile_edges(sizes):
    jqt, port = _weights()
    rng = np.random.default_rng(sum(sizes))
    xj, xt = bf16_numpy(rng.standard_normal((sum(sizes), K)))
    gs = np.asarray(sizes, np.int32)
    xpad = jnp.pad(xj, ((0, 0), (0, jqt.k_padded - K)))
    want = _gqmm_magic_pallas(xpad, jqt.packed, jqt.scales, jqt.biases, jnp.asarray(gs),
                              group_size=128, bits=4, interpret=True)
    got = km.grouped_quant_matmul(xt, port, torch.from_numpy(gs))
    assert got.dtype == torch.bfloat16 and got.shape == (sum(sizes), N)
    assert torch.equal(got, km.grouped_quant_matmul_plain(xt, port, torch.from_numpy(gs)))
    # As tests/test_torch_moe.py holds the plain version: f32 dequant and
    # f32 fold on both sides, accumulation order and the bf16 round apart.
    assert_allclose(f32(got), f32(want), precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)


def test_route_gate_is_one_line_constant_the_crossover_rewrites():
    """B16_MIN_T lives in csrc/moe_matmul.cu alone, on one line in the form
    `qmm_crossover --kind moe` rewrites; the decode step (T <= 8) stays on
    the GEMV walk, which reads every weight once for its rows there; the
    wrapper keeps no mirror of it (it asks the library, w4a16_route)."""
    text = CU.read_text()
    found = re.findall(r"^constexpr int B16_MIN_T = (\d+);$", text, flags=re.M)
    assert len(found) == 1
    assert len(re.findall(r"constexpr int B16_MIN_T = \d+;", text)) == 1
    gate = int(found[0])
    assert gate >= 9
    assert getattr(km, "B16_MIN_T", gate) == gate
    copies = qmm_crossover.MOE_COPIES
    assert set(copies) == {"moe_gemv", "moe_b16"}
    assert copies["moe_gemv"]["moe_matmul"]["B16_MIN_T"] > max(qmm_crossover.MOE_ROWS)
    assert copies["moe_b16"]["moe_matmul"]["B16_MIN_T"] <= min(qmm_crossover.MOE_ROWS)
