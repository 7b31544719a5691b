"""The port's tutorial kernel, axpby (tiny_llm_tpu_torch.kernels.axpby, its
plain version on the CPU), against the JAX package's `axpby`: the Pallas
kernel in interpret mode and the XLA expression, in bf16 and f32, at shapes
that cross the Pallas kernel's (256, 1024) tiles, on the same numpy inputs.

Result: the port equals the XLA expression bit for bit in both dtypes, and
the Pallas kernel bit for bit in bf16. JAX rounds `alpha * x + beta * y` at
every op in x's dtype (the Python scalars first become that dtype), and so
does the port's plain version; a single rounding at the end, or f32
scalars in bf16, would miss on a large share of elements. In f32 the
Pallas kernel in interpret mode contracts alpha * x into a fused
multiply-add with the rounded beta * y, so it sits within one rounding of
alpha * x (2^-23 of |alpha * x| + |beta * y|) of the port."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.axpby import axpby as jax_axpby  # noqa: E402
from tiny_llm_tpu_torch.kernels.axpby import axpby  # noqa: E402

from .torch_port import f32  # noqa: E402

SHAPES = [(8, 128), (300, 1100), (513, 2049)]  # aligned; ragged tiles in both axes
SCALARS = [(2.5, -0.5), (0.1, 0.7)]  # exact in bf16; rounded to bf16 first


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{m}x{n}" for m, n in SHAPES])
def test_axpby_matches_jax_bit_for_bit(shape, dtype):
    rng = np.random.default_rng(shape[0] + shape[1])
    x, y = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    xj, yj = (jnp.asarray(t).astype(getattr(jnp, dtype)) for t in (x, y))
    xt, yt = (torch.from_numpy(t).to(getattr(torch, dtype)) for t in (x, y))
    for alpha, beta in SCALARS:
        got = axpby(xt, yt, alpha=alpha, beta=beta)
        assert got.dtype == xt.dtype and got.shape == xt.shape
        xla = jax_axpby(xj, yj, alpha=alpha, beta=beta, impl="xla")
        np.testing.assert_array_equal(f32(got), f32(xla), err_msg=f"xla {alpha} {beta}")
        pallas = f32(jax_axpby(xj, yj, alpha=alpha, beta=beta, impl="pallas", interpret=True))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(f32(got), pallas, err_msg=f"pallas {alpha} {beta}")
        else:
            one_rounding = 2.0**-23 * (abs(alpha) * np.abs(x) + abs(beta) * np.abs(y))
            assert (np.abs(f32(got) - pallas) <= one_rounding).all(), (alpha, beta)


def test_axpby_defaults_and_refusals():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert torch.equal(axpby(x, x), 2 * x)  # alpha = beta = 1
    assert torch.equal(axpby(x, x, impl="torch"), 2 * x)
    with pytest.raises(ValueError, match="2-D"):
        axpby(x.reshape(-1), x.reshape(-1))
    with pytest.raises(ValueError, match="2-D"):
        axpby(x, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        axpby(x, x, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        axpby(x, x, impl="pallas")
