"""The any-width matmul's plain versions where its three CUDA routes meet
(csrc/quant_matmul_sg.cu: the GEMV below B16_MIN_ROWS, the bf16
tensor-core tile up to 32 rows, the staged wgmma tile from
STAGED_MIN_ROWS), at each of its eight widths (bits 2, 4, 8; groups 32, 64,
128; W4 g128 is K1's; N = 200, a column block and a ragged one): the
port's CPU route, bit-equal to the plain version
of the route the card takes for those rows (`quant_matmul_plain` below the
staged gate, `quant_matmul_staged_plain` from it), against the JAX
package's `_qmm_pallas` in interpret mode and its XLA twin on the same
numpy inputs, at tests/test_torch_sg.py's tolerances; the CPU route's gate
against the CUDA source's; the launcher's refusal of CPU tensors."""

from __future__ import annotations

import functools
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.quant_matmul import _qmm_pallas, _quantized_matmul_xla  # noqa: E402
from tiny_llm_tpu.ops.quantize import quantize  # noqa: E402
from tiny_llm_tpu_torch.kernels import quant_matmul as qm  # noqa: E402
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402

from .test_torch_sg import ATOL, RTOL  # noqa: E402
from .torch_port import bf16_numpy, f32, qt_to_numpy  # noqa: E402
from .utils import assert_allclose  # noqa: E402

WIDTHS = [(b, g) for b in (2, 4, 8) for g in (32, 64, 128) if (b, g) != (4, 128)]
K, N = 256, 200  # two 128-code stages; a 128-column block and a ragged one of 72
ROWS = [1, 2, 3, 4, 32, 33, 36]  # both sides of both gates


@functools.lru_cache(maxsize=None)
def _width(bits, gs):
    """A weight [N, K] quantized at the width, x of max(ROWS) rows (a case
    takes its first M), and the JAX package's two routes over all of them:
    each output row depends on its x row alone."""
    rng = np.random.default_rng(bits * 1000 + gs)
    jqt = quantize(jnp.asarray(rng.standard_normal((N, K)) * 0.05, jnp.float32),
                   group_size=gs, bits=bits, layout="sg")
    port = quantized_from_numpy(qt_to_numpy(jqt))
    xj, xt = bf16_numpy(rng.standard_normal((max(ROWS), K)))
    xpad = jnp.pad(xj, ((0, 0), (0, jqt.k_padded - K)))  # the JAX layout's supergroups
    pallas = _qmm_pallas(xpad, jqt.packed, jqt.scales, jqt.biases, group_size=gs, bits=bits,
                         interpret=True)
    xla = _quantized_matmul_xla(xj, jqt, None)
    return port, xt, f32(pallas), f32(xla)


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("bits,gs", WIDTHS, ids=[f"W{b}g{g}" for b, g in WIDTHS])
def test_sg_cpu_route_at_the_gates_matches_its_plain_pallas_and_xla(bits, gs, M):
    """The CPU route is bit-equal to the plain version of the card's route
    for M rows (the f32 fold below SG_STAGED_MIN_ROWS, bf16(q s) staged
    from there) and within ATOL / RTOL of the Pallas kernel (q s + b staged
    in bf16) and of its XLA twin (the dequantized weight rounded once)."""
    port, xt, pallas, xla = _width(bits, gs)
    x = xt[:M]
    got = qm.quant_matmul(x, port)
    plain = (qm.quant_matmul_staged_plain if M >= qm.SG_STAGED_MIN_ROWS
             else qm.quant_matmul_plain)
    np.testing.assert_array_equal(f32(got), f32(plain(x, port)))
    for name, want in (("pallas", pallas), ("xla", xla)):
        assert_allclose(f32(got), want[:M], precision=jnp.bfloat16, rtol=RTOL, atol=ATOL,
                        message=name)


def test_sg_cpu_route_gate_is_the_cuda_sources():
    """The CPU route changes its plain version where csrc/quant_matmul_sg.cu
    moves the any-width matmul to its staged tile."""
    src = (Path(qm.__file__).resolve().parents[1] / "csrc" / "quant_matmul_sg.cu").read_text()
    gate = re.search(r"constexpr int STAGED_MIN_ROWS = (\d+);", src)
    assert gate and int(gate.group(1)) == qm.SG_STAGED_MIN_ROWS
    assert re.search(r"constexpr int B16_MIN_ROWS = (\d+);", src)


@pytest.mark.parametrize("M", [1, 3, 33])
def test_sg_launcher_refuses_cpu_tensors(M):
    """On the CPU the wrapper runs the plain version; the launcher itself
    never falls back, on any route: a CPU tensor raises before any build,
    and nothing is counted."""
    port = _width(8, 64)[0]
    before = qm.SG_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        qm.quant_matmul_sg_cuda(torch.zeros((M, K), dtype=torch.bfloat16), port)
    assert qm.SG_LAUNCHES == before
