"""K2's CPU route (the plain version of `fused_decode_attention`) where the
card's split-key walk over the slab has edges, against the JAX package's
Pallas kernel in interpret mode, on the same numpy inputs.

On the card K2 cuts each row's cached keys [0, offset) into splits of
whole 64-key tiles (`decode_split`: 128 keys at these shapes) and merges
them with the current token in the same launch. The cases, B = 4 rows of
mixed offsets in each call: 0 (the current token alone: the output is its
v row, exactly), 1, a split's last key, its first and the one after
(127, 128, 129) and a context that fills the slab (S - 1); at n_rep 1, 2,
4 and 8 and head dims 64 and 128. Tolerances as tests/test_torch_kernels.py
holds K2: attention on the bf16 ladder (2e-2), the k row within 2^-7, the
v row bit for bit."""

from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.fused_decode_attention import (  # noqa: E402
    fused_decode_attention as jax_fused_decode_attention,
)
from tiny_llm_tpu.ops.rope import rope_tables as jax_rope_tables  # noqa: E402
from tiny_llm_tpu_torch.kernels import fused_decode_attention as kf  # noqa: E402
from tiny_llm_tpu_torch.kernels.paged_attention import decode_split  # noqa: E402

from .torch_port import bf16_numpy, f32  # noqa: E402
from .utils import assert_allclose  # noqa: E402

HKV, S, LAYERS, LAYER, SMS = 2, 256, 2, 1, 132  # SMS: an H100's
OFFSETS = [(0, 127, 128, S - 1), (1, 129, 0, 128)]


@functools.lru_cache(maxsize=None)
def _slab(D: int):
    """One slab per head dim: every position noise, so a read past a row's
    offset would disagree."""
    rng = np.random.default_rng(D)
    k = bf16_numpy(rng.standard_normal((LAYERS, 4, HKV, S, D)))
    v = bf16_numpy(rng.standard_normal((LAYERS, 4, HKV, S, D)))
    cos, sin = (np.asarray(t) for t in jax_rope_tables(D, S))
    return k, v, cos, sin


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
def test_fused_dense_step_plain_matches_pallas_at_split_edges(n_rep, D):
    assert decode_split(4, HKV, S, 1, SMS) == 128  # the split boundary the offsets sit on
    (k_j, k_t), (v_j, v_t), cos, sin = _slab(D)
    rng = np.random.default_rng(10 * n_rep + D)
    qw_j, qw_t = bf16_numpy(rng.standard_normal(D) * 0.1 + 1.0)
    kw_j, kw_t = bf16_numpy(rng.standard_normal(D) * 0.1 + 1.0)
    scale, eps = D**-0.5, 1e-6
    for offs in OFFSETS:
        qkv_j, qkv_t = bf16_numpy(rng.standard_normal((4, HKV, n_rep + 2, D)))
        off = np.asarray(offs, np.int32)
        want = jax_fused_decode_attention(
            qkv_j, k_j, v_j, jnp.asarray(off), jnp.asarray(cos[off]), jnp.asarray(sin[off]),
            qw_j, kw_j, layer_idx=LAYER, scale=scale, eps=eps, window=S, interpret=True,
        )
        got = kf.fused_decode_attention(
            qkv_t, k_t, v_t, torch.from_numpy(off), torch.from_numpy(cos[off]),
            torch.from_numpy(sin[off]), qw_t, kw_t, layer_idx=LAYER, scale=scale, eps=eps,
        )
        assert got[0].shape == (4, HKV, n_rep, D) and got[0].dtype == torch.bfloat16
        assert_allclose(f32(got[0]), f32(want[0]), precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(f32(got[1]), f32(want[1]), rtol=2**-7, atol=2**-7)
        np.testing.assert_array_equal(f32(got[2]), f32(want[2]))
        # A row at offset 0: the current token alone, its output its own v
        # row exactly (on the card every split of that row is empty).
        v_row = qkv_t[:, :, n_rep + 1 :].expand(4, HKV, n_rep, D)
        for b in np.flatnonzero(off == 0):
            assert torch.equal(got[0][b], v_row[b])


def test_fused_dense_cuda_refused_on_cpu_tensors():
    D, n_rep = 64, 2
    qkv = torch.zeros((1, HKV, n_rep + 2, D), dtype=torch.bfloat16)
    slab = torch.zeros((1, 1, HKV, 16, D), dtype=torch.bfloat16)
    args = (qkv, slab, slab, torch.tensor([3], dtype=torch.int32), torch.zeros((1, D // 2)),
            torch.zeros((1, D // 2)), torch.ones(D), torch.ones(D))
    with pytest.raises(ValueError):
        kf.fused_decode_attention(*args, layer_idx=0, scale=0.125, eps=1e-6, impl="cuda")
    with pytest.raises(ValueError):
        kf.fused_decode_attention_cuda(*args, layer_idx=0, scale=0.125, eps=1e-6)
