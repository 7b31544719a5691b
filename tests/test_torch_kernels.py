"""The port's kernels (plain PyTorch versions, on the CPU) against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.

On a CUDA host the same wrappers launch the CUDA kernels instead; those are
held against these plain versions on the card by chip_smoke.py."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels import quantized_matmul  # noqa: E402
from tiny_llm_tpu.kernels.flash_attention_pallas import flash_attention_pallas  # noqa: E402
from tiny_llm_tpu.kernels.fused_decode_attention import (  # noqa: E402
    fused_decode_attention as jax_fused_decode_attention,
)
from tiny_llm_tpu.ops.quantize import quantize  # noqa: E402
from tiny_llm_tpu.ops.rope import rope_tables as jax_rope_tables  # noqa: E402
from tiny_llm_tpu_torch.kernels.flash_attention import flash_attention  # noqa: E402
from tiny_llm_tpu_torch.kernels.fused_decode_attention import (  # noqa: E402
    fused_decode_attention,
)
from tiny_llm_tpu_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from tiny_llm_tpu_torch.kernels.dispatch import resolve  # noqa: E402
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402

from .torch_port import bf16_numpy, f32, qt_to_numpy  # noqa: E402
from .utils import assert_allclose  # noqa: E402


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def test_resolve_follows_the_tensor_and_refuses_contradictions():
    t = torch.zeros(2)
    assert resolve(None, t) == "torch"
    assert resolve("torch", t) == "torch"
    with pytest.raises(ValueError):
        resolve("cuda", t)
    with pytest.raises(ValueError):
        resolve("pallas", t)


# ---------------------------------------------------------------------------
# K1: dequant-fused matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("K", [128, 1024])
@pytest.mark.parametrize("M", [1, 4, 128])
def test_quant_matmul_plain_matches_pallas(M, K, residual):
    """M = 1, 4 take the Pallas decode schedule, M = 128 the staged one;
    K = 128 is padded to 512 in the JAX layout and to 128 in the port's."""
    N = 256
    rng = np.random.default_rng(M * 7 + K)
    w = rng.standard_normal((N, K)).astype(np.float32) * 0.05
    qt = quantize(jnp.asarray(w))
    xj, xt = bf16_numpy(rng.standard_normal((M, K)))
    rj, rt = bf16_numpy(rng.standard_normal((M, N))) if residual else (None, None)
    want = quantized_matmul(xj, qt, residual=rj, impl="pallas", interpret=True)
    got = quant_matmul(xt, quantized_from_numpy(qt_to_numpy(qt)), residual=rt)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    # bf16 ladder. The plain version dequantizes in f32; the Pallas decode
    # schedule folds scales in f32 too (differences: accumulation order and
    # the final bf16 round), so it holds to 2e-2. The staged schedule
    # (M = 128) rounds q*s to bf16 before its dot: over K = 1024 that moves
    # outputs of magnitude ~3 by up to ~0.04 (the JAX package measured a
    # max error of 0.06 for it against its own oracle), hence 6e-2 there.
    atol = 6e-2 if M >= 128 else 2e-2
    assert_allclose(f32(got), f32(want), precision=jnp.bfloat16, rtol=2e-2, atol=atol)


def test_quant_matmul_cuda_impl_refused_on_cpu():
    qt = quantized_from_numpy(qt_to_numpy(quantize(jnp.ones((128, 128), jnp.float32))))
    with pytest.raises(ValueError):
        quant_matmul(torch.zeros((1, 128), dtype=torch.bfloat16), qt, impl="cuda")


# ---------------------------------------------------------------------------
# K2: fused decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("offs", [[0], [5], [17, 0, 40, 63]], ids=["off0", "off5", "mixed"])
def test_fused_decode_attention_plain_matches_pallas(offs, D):
    B, Hkv, n_rep, S, layers, layer_idx = len(offs), 2, 2, 64, 3, 1
    rng = np.random.default_rng(D + sum(offs))
    qkv_j, qkv_t = bf16_numpy(rng.standard_normal((B, Hkv, n_rep + 2, D)))
    k_j, k_t = bf16_numpy(rng.standard_normal((layers, B, Hkv, S, D)))
    v_j, v_t = bf16_numpy(rng.standard_normal((layers, B, Hkv, S, D)))
    qw_j, qw_t = bf16_numpy(rng.standard_normal(D) * 0.1 + 1.0)
    kw_j, kw_t = bf16_numpy(rng.standard_normal(D) * 0.1 + 1.0)
    cos, sin = (np.asarray(t) for t in jax_rope_tables(D, S))
    off = np.asarray(offs, np.int32)
    scale, eps = D**-0.5, 1e-6
    want = jax_fused_decode_attention(
        qkv_j, k_j, v_j, jnp.asarray(off), jnp.asarray(cos[off]), jnp.asarray(sin[off]),
        qw_j, kw_j, layer_idx=layer_idx, scale=scale, eps=eps, window=S, bs=32,
        interpret=True,
    )
    got = fused_decode_attention(
        qkv_t, k_t, v_t, torch.from_numpy(off), torch.from_numpy(cos[off]),
        torch.from_numpy(sin[off]), qw_t, kw_t, layer_idx=layer_idx, scale=scale, eps=eps,
    )
    # Attention rows: bf16 ladder; the plain version takes one softmax where
    # the kernel rescales per 32-key tile, and rounds p to bf16 at another
    # max, so single outputs move by a few bf16 ulps.
    assert_allclose(f32(got[0]), f32(want[0]), precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)
    # k row: within one bf16 ulp (2^-7 relative at most) — the two frameworks
    # may round rsqrt and the rotation's products differently.
    np.testing.assert_allclose(f32(got[1]), f32(want[1]), rtol=2**-7, atol=2**-7)
    # v row: the input row itself, bit for bit.
    np.testing.assert_array_equal(f32(got[2]), f32(want[2]))


# ---------------------------------------------------------------------------
# K3: causal flash attention with lengths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [8, 40])
def test_flash_attention_plain_matches_pallas(L):
    """L = 8 reaches the Pallas L <= 16 kernel, L = 40 the prefill kernel."""
    B, Hkv, n_rep, S, D = 2, 2, 2, 64, 64
    rng = np.random.default_rng(L)
    q_j, q_t = bf16_numpy(rng.standard_normal((B, Hkv * n_rep, L, D)))
    k_j, k_t = bf16_numpy(rng.standard_normal((B, Hkv, S, D)))
    v_j, v_t = bf16_numpy(rng.standard_normal((B, Hkv, S, D)))
    lens = np.asarray([L + 3, S], np.int32)
    want = flash_attention_pallas(q_j, k_j, v_j, lens=jnp.asarray(lens), interpret=True)
    got = flash_attention(q_t, k_t, v_t, torch.from_numpy(lens))
    # bf16 ladder: one softmax against per-tile rescaling (see K2).
    assert_allclose(f32(got), f32(want), precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)


def test_flash_attention_plain_row_that_sees_nothing_is_zero():
    """A query before the start of its row (lens < L) emits 0, not NaN."""
    q = torch.randn(1, 2, 4, 64).to(torch.bfloat16)
    k = torch.randn(1, 1, 8, 64).to(torch.bfloat16)
    out = flash_attention(q, k, k.clone(), torch.tensor([2], dtype=torch.int32))
    assert torch.isfinite(out.float()).all()
    assert (out[:, :, :2].float() == 0).all()  # positions -2, -1
    assert (out[:, :, 2:].float().abs().sum() > 0)
