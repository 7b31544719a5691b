"""The fused paged decode step's plain version (the CPU route of
`fused_paged_decode_attention`) where the card's split-key walk has edges,
against the JAX package's Pallas kernel in interpret mode, on the same
numpy inputs.

The card cuts each row's cached keys [0, offset) into splits of whole key
tiles, which may end inside a page, and merges them with the current
token in the same launch. The cases: offset 0 (the current token alone:
the output is its v row, exactly), 1, a page's last slot, first slot
and the slot after (PS - 1, PS, PS + 1), and a context whose current
token fills its last page (3 PS - 1); at n_rep 1, 2, 4 and 8 and head
dims 64 and 128, beside an idle row (table all -1, offset 0) whose output
the model discards and which is not compared. Tolerances as
tests/test_torch_paged.py holds the step: attention on the bf16 ladder
(2e-2), the k row within 2^-7, the v row bit for bit."""

from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.fused_decode_attention import (  # noqa: E402
    fused_paged_decode_attention as jax_fused_paged,
)
from tiny_llm_tpu.ops.rope import rope_tables as jax_rope_tables  # noqa: E402
from tiny_llm_tpu_torch.kernels.fused_decode_attention import (  # noqa: E402
    fused_paged_decode_attention,
)

from .torch_port import bf16_numpy, f32  # noqa: E402
from .utils import assert_allclose  # noqa: E402

HKV, PS, MAXP = 2, 16, 4
OFFSETS = {"zero": 0, "one": 1, "page_last_slot": PS - 1, "page_boundary": PS,
           "page_boundary_plus_1": PS + 1, "fills_last_page": 3 * PS - 1}


@functools.lru_cache(maxsize=None)
def _pool(D: int):
    """One shuffled pool per head dim: row 0's pages, the trash page 0 and
    free pages all noise, so a read past the offset or of the wrong page
    would disagree."""
    rng = np.random.default_rng(D)
    P = MAXP + 3
    kp = rng.standard_normal((P, HKV, PS, D))
    vp = rng.standard_normal((P, HKV, PS, D))
    return rng.permutation(np.arange(1, P)), kp, vp


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("offset", list(OFFSETS.values()), ids=list(OFFSETS))
def test_fused_paged_step_plain_matches_pallas_at_split_edges(offset, n_rep, D):
    perm, kp, vp = _pool(D)
    rng = np.random.default_rng(1000 * offset + 10 * n_rep + D)
    bt = np.full((2, MAXP), -1, np.int32)
    used = offset // PS + 1  # the current token's page too, as the model reserves it
    bt[0, :used] = perm[:used]
    off = np.asarray([offset, 0], np.int32)  # row 1 idle
    qkv_j, qkv_t = bf16_numpy(rng.standard_normal((2, HKV, n_rep + 2, D)))
    kp_j, kp_t = bf16_numpy(kp)
    vp_j, vp_t = bf16_numpy(vp)
    qw_j, qw_t = bf16_numpy(rng.standard_normal(D) * 0.1 + 1.0)
    kw_j, kw_t = bf16_numpy(rng.standard_normal(D) * 0.1 + 1.0)
    cos, sin = (np.asarray(t) for t in jax_rope_tables(D, MAXP * PS))
    scale, eps = D**-0.5, 1e-6
    want = jax_fused_paged(
        qkv_j, kp_j, vp_j, jnp.asarray(bt), jnp.asarray(off), jnp.asarray(cos[off]),
        jnp.asarray(sin[off]), qw_j, kw_j, scale=scale, eps=eps, interpret=True,
    )
    got = fused_paged_decode_attention(
        qkv_t, kp_t, vp_t, torch.from_numpy(bt), torch.from_numpy(off),
        torch.from_numpy(cos[off]), torch.from_numpy(sin[off]), qw_t, kw_t, scale=scale, eps=eps,
    )
    assert got[0].shape == (2, HKV, n_rep, D) and got[0].dtype == torch.bfloat16
    live = slice(0, 1)
    assert_allclose(f32(got[0])[live], f32(want[0])[live], precision=jnp.bfloat16,
                    rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(f32(got[1])[live], f32(want[1])[live], rtol=2**-7, atol=2**-7)
    np.testing.assert_array_equal(f32(got[2])[live], f32(want[2])[live])
    # The idle row, and row 0 at offset 0: the current token alone, whose
    # output is its own v row exactly (the card's walk has no split then).
    v_row = qkv_t[:, :, n_rep + 1 :].expand(2, HKV, n_rep, D)
    assert torch.equal(got[0][1], v_row[1])
    if offset == 0:
        assert torch.equal(got[0][0], v_row[0])
