"""K1's plain versions where its three CUDA routes meet (csrc/quant_matmul.cu:
the GEMV at M <= 2, the bf16 tensor-core tile for decode and serving rows in
16- and 32-row blocks, the staged wgmma tile in 128-row tiles from M = 33),
against the JAX package on the same numpy inputs: `quant_matmul_plain` (the
GEMV's and the bf16 tile's arithmetic) against
`quantized_matmul(impl="pallas", interpret=True)` and the XLA route at M =
2 ... 129, and `quant_matmul_staged_plain` (the staged tile's: the
dequantized weight bf16(q * s + b)) against the XLA route, which computes
with the same weight, per element. Then the launcher's refusal of CPU
tensors."""

from __future__ import annotations

import functools
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels import quantized_matmul  # noqa: E402
from tiny_llm_tpu.ops.quantize import quantize  # noqa: E402
from tiny_llm_tpu_torch.kernels import quant_matmul as qm  # noqa: E402
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402
from tiny_llm_tpu_torch.ops.quantize import dequantize  # noqa: E402

from .torch_port import bf16_numpy, f32, qt_to_numpy  # noqa: E402
from .utils import assert_allclose  # noqa: E402

N, K = 256, 1024  # eight 128-code groups


@functools.lru_cache(maxsize=None)
def _weight():
    rng = np.random.default_rng(300)
    jqt = quantize(jnp.asarray(rng.standard_normal((N, K)) * 0.05, jnp.float32))
    return jqt, quantized_from_numpy(qt_to_numpy(jqt))


def _inputs(M, residual):
    rng = np.random.default_rng(1000 + M)
    xj, xt = bf16_numpy(rng.standard_normal((M, K)))
    rj, rt = bf16_numpy(rng.standard_normal((M, N))) if residual else (None, None)
    return xj, xt, rj, rt


def _staged_tol(x, qt, want):
    """Per element, how far two computations of the staged arithmetic may
    differ: each rounds its f32 result to bf16 once (one bf16 ulp of the
    value between them at most: 2^(e - 7) for |want| in [2^e, 2^(e + 1)),
    doubled to cover a sum that lands at a rounding boundary), plus the f32
    sums taken in another order, at most K 2^-24 times the sum of the
    terms' magnitudes, sum_k |x_k| |bf16(q s + b)_k|."""
    mag = x.float().abs() @ dequantize(qt, torch.bfloat16).float().abs().T
    return 2 * _ulp(want) + K * 2.0**-24 * mag


def _ulp(v):
    """One bf16 ulp of each element: 2^(e - 8) for |v| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v.float()), e - 8)


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("M", [2, 3, 16, 17, 32, 33, 64, 65, 128, 129])
def test_k1_plain_at_route_edges_matches_pallas_and_xla(M, residual):
    """The port's CPU route is bit-equal to the plain version of the route
    the card takes for M rows (the f32 fold below STAGED_MIN_ROWS, the
    staged arithmetic from there), and within the tolerances of
    tests/test_torch_kernels.py of both JAX routes: 2e-2 where the Pallas
    kernel folds in f32 (M <= 32), 6e-2 where it stages q * s in bf16."""
    jqt, port = _weight()
    xj, xt, rj, rt = _inputs(M, residual)
    got = qm.quant_matmul(xt, port, residual=rt)
    plain = qm.quant_matmul_staged_plain if M >= qm.STAGED_MIN_ROWS else qm.quant_matmul_plain
    np.testing.assert_array_equal(f32(got), f32(plain(xt, port, rt)))
    atol = 6e-2 if M > 32 else 2e-2
    for impl in ("pallas", "xla"):
        want = quantized_matmul(xj, jqt, residual=rj, impl=impl, interpret=True)
        assert_allclose(f32(got), f32(want), precision=jnp.bfloat16, rtol=2e-2, atol=atol,
                        message=impl)


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("M", [33, 64, 65, 128, 129])
def test_k1_staged_plain_matches_the_pallas_staged_schedule(M, residual):
    """The staged tile's arithmetic is the JAX package's XLA route's (the
    dequantized weight bf16(q * s + b), an f32 dot, the residual in f32),
    so per element they differ only by summation order and the final
    rounding (_staged_tol); the f32 plain version, which never rounds the
    weight, misses that bound. The XLA route adds a residual after its
    product's rounding, so there the bound takes one more ulp of that
    product. (Until the staged tile staged the bias too, this case held it
    against the Pallas staged schedule.)"""
    jqt, port = _weight()
    xj, xt, rj, rt = _inputs(M, residual)
    got = qm.quant_matmul_staged_plain(xt, port, rt)

    def xla(r):
        return torch.from_numpy(np.asarray(
            quantized_matmul(xj, jqt, residual=r, impl="xla"), np.float32))

    want = xla(rj)
    tol = _staged_tol(xt, port, want)
    if residual:
        tol = tol + _ulp(xla(None))
    assert bool(((got.float() - want).abs() <= tol).all())
    f32_plain = qm.quant_matmul_plain(xt, port, rt).float()
    assert bool(((f32_plain - want).abs() > tol).any())


def test_cpu_route_gate_is_the_cuda_sources():
    """The CPU route changes its plain version where csrc/quant_matmul.cu
    moves K1 to the staged tile: the same constant, M > A8_MAX_ROWS."""
    src = (Path(qm.__file__).resolve().parents[1] / "csrc" / "quant_matmul.cu").read_text()
    gate = re.search(r"constexpr int STAGED_MIN_ROWS = (\d+);", src)
    assert gate and int(gate.group(1)) == qm.STAGED_MIN_ROWS == qm.A8_MAX_ROWS + 1


@pytest.mark.parametrize("M", [1, 3, 33, 1024])
def test_k1_launcher_refuses_cpu_tensors(M):
    """On the CPU the wrapper runs the plain version; the launcher itself
    never falls back, on any route: a CPU tensor raises before any build,
    and nothing is counted."""
    before = qm.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        qm.quant_matmul_cuda(torch.zeros((M, K), dtype=torch.bfloat16), _weight()[1])
    assert qm.LAUNCHES == before
