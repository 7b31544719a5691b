"""The grouped any-width expert matmul where its two CUDA routes meet, on
the CPU: the plain version (`grouped_quant_matmul_plain`, which both
routes compute: the f32 fold of the Pallas kernel) against the JAX
package's Pallas walk `_gqmm_pallas` in interpret mode at W4 g64 and W8
g64, and the constants that pick the route and shape the GEMV walk.

The card runs a GEMV walk over (expert, column block) units below
SG_B16_MIN_T rows (decode steps: one token's top-8 is 8 rows) and row 18's
bf16 tensor-core tile walk over (expert, 16-row block) tiles from there, so
the cases sit on the 16-row tile's and the GEMV's 4-row passes' edges (one
expert holding 15, 16, 17 or 33 rows), on the gate (T at SG_B16_MIN_T - 1
and at it), on eight experts of a row each and on empty experts at both
ends. One small weight set a width. The crossover's routings are held to
what a top-8 router can send."""

from __future__ import annotations

import functools
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import tiny_llm_tpu_torch.kernels.moe_matmul as km  # noqa: E402
from tiny_llm_tpu.kernels.moe_matmul import _gqmm_pallas  # noqa: E402
from tiny_llm_tpu.ops.quantize import quantize_stacked  # noqa: E402
from tiny_llm_tpu_torch.kernels import qmm_crossover  # noqa: E402
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402

from .torch_port import bf16_numpy, f32, qt_to_numpy  # noqa: E402
from .utils import assert_allclose  # noqa: E402

E, N, K = 10, 128, 384
CU = Path(km.__file__).resolve().parent.parent / "csrc" / "moe_matmul_sg.cu"
# tests/test_torch_sg.py's tolerance: the bf16 ladder (tests/utils.py),
# absolute and relative 2e-2 (the port folds in f32; the Pallas kernel
# rounds q * s, then + b, to bf16).
ATOL = RTOL = 2e-2


def _gate() -> int:
    found = re.findall(r"^constexpr int SG_B16_MIN_T = (\d+);$", CU.read_text(), flags=re.M)
    assert len(found) == 1
    return int(found[0])


def _one(rows: int, e: int = 4) -> list[int]:
    sizes = [0] * E
    sizes[e] = rows
    return sizes


def _spread(T: int) -> list[int]:
    """T rows over experts 1-8, a row each and the rest from expert 1 on."""
    sizes = [0] * E
    for t in range(T):
        sizes[1 + t % 8] += 1
    return sizes


SIZES = {
    "one_expert_15": _one(15),
    "one_expert_16": _one(16),
    "one_expert_17": _one(17),
    "one_expert_33": _one(33),
    "eight_experts_one_row_each": [0, 1, 1, 1, 1, 0, 1, 1, 1, 1],
    "below_the_gate": _spread(_gate() - 1),
    "at_the_gate": _spread(_gate()),
    "empty_experts_at_both_ends": [0, 0, 7, 1, 9, 0, 0, 0, 0, 0],
}
WIDTHS = [(4, 64), (8, 64)]


@functools.lru_cache(maxsize=None)
def _weights(bits: int, group_size: int):
    rng = np.random.default_rng(bits * 100 + group_size)
    jqt = quantize_stacked(jnp.asarray(rng.standard_normal((E, N, K)) * 0.05, jnp.float32),
                           group_size=group_size, bits=bits, layout="sg")
    return jqt, quantized_from_numpy(qt_to_numpy(jqt))


@pytest.mark.parametrize("bits,group_size", WIDTHS, ids=[f"W{b}g{g}" for b, g in WIDTHS])
@pytest.mark.parametrize("sizes", list(SIZES.values()), ids=list(SIZES))
def test_grouped_sg_plain_matches_pallas_at_the_route_edges(sizes, bits, group_size):
    jqt, port = _weights(bits, group_size)
    assert (port.bits, port.group_size, port.num_experts) == (bits, group_size, E)
    rng = np.random.default_rng(sum(sizes))
    xj, xt = bf16_numpy(rng.standard_normal((sum(sizes), K)))
    gs = np.asarray(sizes, np.int32)
    xpad = jnp.pad(xj, ((0, 0), (0, jqt.k_padded - K)))  # the JAX layout's supergroups
    want = _gqmm_pallas(xpad, jqt.packed, jqt.scales, jqt.biases, jnp.asarray(gs),
                        group_size=group_size, bits=bits, interpret=True)
    got = km.grouped_quant_matmul(xt, port, torch.from_numpy(gs))
    assert got.dtype == torch.bfloat16 and got.shape == (sum(sizes), N)
    assert torch.equal(got, km.grouped_quant_matmul_plain(xt, port, torch.from_numpy(gs)))
    assert_allclose(f32(got), f32(want), precision=jnp.bfloat16, rtol=RTOL, atol=ATOL)


def test_route_gate_is_one_line_constant_the_crossover_rewrites():
    """SG_B16_MIN_T lives in csrc/moe_matmul_sg.cu alone, on one line in the
    form `qmm_crossover --kind moe_sg` rewrites; the decode step (T = 8)
    stays on the GEMV walk; the wrapper keeps no mirror of it (it asks the
    library, sg_route). The GEMV walk's shape constants are one line each,
    as `--kind moe_sg_gemv` rewrites them."""
    text = CU.read_text()
    gate = _gate()
    assert len(re.findall(r"constexpr int SG_B16_MIN_T = \d+;", text)) == 1
    assert gate >= 9
    assert not hasattr(km, "SG_B16_MIN_T")
    copies = qmm_crossover.MOE_SG_COPIES
    assert set(copies) == {"sg_moe_gemv", "sg_moe_b16"}
    rows = qmm_crossover.MOE_SG_ROWS
    assert copies["sg_moe_gemv"]["moe_matmul_sg"]["SG_B16_MIN_T"] > max(rows)
    assert copies["sg_moe_b16"]["moe_matmul_sg"]["SG_B16_MIN_T"] <= min(rows)
    assert gate in rows  # one of the row counts the sweep measured
    shape = {"GEMV_THREADS", "GEMV_CHUNKS", "PASS_ROWS"}
    for const in shape:
        assert len(re.findall(rf"^constexpr int {const} = \d+;$", text, flags=re.M)) == 1
    swept = {c for v in qmm_crossover.GEMV_SWEEP.values() for c in v["moe_matmul_sg"]}
    assert swept <= shape | {"SG_B16_MIN_T"}
    assert all(v["moe_matmul_sg"]["SG_B16_MIN_T"] > max(rows)
               for v in qmm_crossover.GEMV_SWEEP.values())
    # The old design is gone: no 64-row tile, no T <= 64 GEMV gate.
    walk = (CU.parent / "moe_walk.cuh").read_text() + (CU.parent / "qmm_tile.cuh").read_text()
    assert not re.search(r"tile_expert|RowTiles|GEMV_MAX_T|mma_bf16_16816|moe_sg_tiled",
                         walk + text)


@pytest.mark.parametrize("T", [8, 192, 1024])
def test_crossover_hot_routing_is_the_most_a_top8_router_gives_one_expert(T):
    """`--kind moe_sg`'s skewed routing: T / 8 tokens' top-8 with the hot
    expert in every one, so T / 8 rows on it (a token routes a row to an
    expert at most once) and the other rows a token each."""
    sz = qmm_crossover._hot_sizes(np.random.default_rng(T), T)
    tokens = T // qmm_crossover.TOP_K
    assert sz.shape == (qmm_crossover.E,) and sz.sum() == T
    assert sz[qmm_crossover.HOT] == tokens and sz.max() == tokens


def test_crossover_gate_line_takes_the_least_worst_loss():
    rows = [{"T": 8, "g": 1.0, "t": 2.5}, {"T": 64, "g": 1.0, "t": 1.2},
            {"T": 192, "g": 1.1, "t": 1.0}, {"T": 1024, "g": 3.0, "t": 1.0}]
    line = qmm_crossover.gate_line(rows, ("g", "t"))
    assert line["gate"] == 192 and line["worst_loss"] == pytest.approx(1.0)
    assert line["loss_by_gate"][8] == pytest.approx(2.5)
    assert line["loss_by_gate"][64] == pytest.approx(1.2)
    assert line["loss_by_gate"][qmm_crossover.BIG] == pytest.approx(3.0)
