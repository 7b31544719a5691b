"""The JAX package's expert-gather schedule (`_gqmm_gather_kernel`, through
`_gqmm_gather_pallas`, which TLT_MOE_DECODE=gather selects at T <= 256)
computes the grouped W4A16 matmul's function, so the port covers it with
that kernel (tiny_llm_tpu_torch.kernels.moe_matmul, `grouped_quant_matmul`)
rather than porting it. Here, on the CPU: the port's grouped plain version
against the gather kernel in interpret mode at T = 8, 64, 200 and 256,
with empty experts and with one expert holding every row, on the same
numpy inputs. The gather kernel takes W4 magic_t weights whose padded K is
a whole number of 512-value supergroups, rows sorted by expert.

The gather kernel keeps `depth` expert blocks in flight and, in each
visit, starts the fetch of visit i + depth into the slot visit i is about
to read before it reads it. In interpret mode that copy lands at once, so
with more logical tiles than slots (T = 64 routed over 8 experts at the
default depth 8) the early tiles compute on a later expert's weights. The
comparison therefore runs the kernel at a depth no smaller than its
logical tiles (at most T / 16 + E), where no slot is refilled: the same
function, the schedule's hazard out of the way."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.moe_matmul import GATHER_MAX_T, _gqmm_gather_pallas  # noqa: E402
from tiny_llm_tpu.ops.quantize import quantize_stacked  # noqa: E402
from tiny_llm_tpu_torch.kernels import moe_matmul  # noqa: E402
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402

from .torch_port import bf16_numpy, f32, qt_to_numpy  # noqa: E402
from .utils import assert_allclose  # noqa: E402

E, N, K = 8, 128, 512
DEPTH = GATHER_MAX_T // 16 + E  # >= the gather kernel's logical tiles at any T <= 256


def _sizes(T: int, how: str, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    if how == "one_expert":
        return [T if e == 5 else 0 for e in range(E)]
    if how == "ends_empty":  # experts 0, 1 and 7 empty
        inner = rng.multinomial(T, np.full(E - 3, 1 / (E - 3)))
        return [0, 0, *inner.tolist(), 0]
    # top-2 of E per token under random router logits, as a MoE layer routes
    ids = np.argsort(-rng.standard_normal((T // 2, E)), axis=1, kind="stable")[:, :2]
    return np.bincount(ids.reshape(-1), minlength=E).tolist()


CASES = [(8, "routed"), (64, "routed"), (200, "routed"), (256, "routed"),
         (64, "ends_empty"), (256, "one_expert")]


@pytest.mark.parametrize("T,how", CASES, ids=[f"T{t}-{h}" for t, h in CASES])
def test_grouped_plain_matches_gather_kernel(T, how):
    assert T <= GATHER_MAX_T
    sizes = _sizes(T, how, seed=T)
    assert sum(sizes) == T
    rng = np.random.default_rng(T + len(how))
    jqt = quantize_stacked(jnp.asarray(rng.standard_normal((E, N, K)) * 0.05, jnp.float32),
                           layout="magic_t")
    assert jqt.k_padded % 512 == 0 and jqt.bits == 4
    xj, xt = bf16_numpy(rng.standard_normal((T, K)))
    gs = np.asarray(sizes, np.int32)
    want = _gqmm_gather_pallas(xj, jqt.packed, jqt.scales, jqt.biases, jnp.asarray(gs),
                               group_size=128, bits=4, interpret=True, depth=DEPTH)
    port = quantized_from_numpy(qt_to_numpy(jqt))
    got = moe_matmul.grouped_quant_matmul(xt, port, torch.from_numpy(gs))
    assert got.dtype == torch.bfloat16 and got.shape == (T, N)
    # The tolerance of tests/test_torch_moe.py's walk comparison: both fold
    # scale and bias in f32 and differ in accumulation order and the bf16
    # round, 2e-2 on the bf16 ladder.
    assert_allclose(f32(got), f32(want), precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)


def test_gather_schedule_is_recorded_as_covered():
    """The port names the gather kernel beside its own TPU-kernel constants
    and has no kernel entry of its own for it."""
    from tiny_llm_tpu_torch import kernels

    assert moe_matmul.TPU_KERNEL_GATHER.endswith(":533 _gqmm_gather_kernel")
    assert "tlt_grouped_quant_matmul" in moe_matmul.COVERED_GATHER
    assert not any("gather" in name for name in kernels.KERNELS)
