"""The prep kernel's writing route (row 8 with the page write folded in,
`fused_qkv_prep(..., pages=...)`, the three-launch paged decode's first
launch) on the CPU: its plain version against the JAX package's
`fused_qkv_prep` in interpret mode followed by the JAX three-launch
route's page write (a dynamic_update_slice per row), at n_rep 1, 2, 4 and 8
and D 64 and 128; B = 4, one row idle (its block-table row all -1: the
trash page 0), the others at offsets on a page's boundary +-1. q within
one bf16 ulp of JAX's (tests/test_torch_paged3.py's tolerance), the written
k slots within it too, the written v slots bit-equal, every other slot of
the pools bit-equal to before. One pool shape a D."""

from __future__ import annotations

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import tiny_llm_tpu_torch.kernels.fused_decode_attention as kf  # noqa: E402
from tiny_llm_tpu.kernels.fused_decode_attention import (  # noqa: E402
    fused_qkv_prep as jax_fused_qkv_prep,
)
from tiny_llm_tpu.ops.rope import rope_tables as jax_rope_tables  # noqa: E402
from tiny_llm_tpu_torch.kernels import qmm_crossover  # noqa: E402
from tiny_llm_tpu_torch.models.qwen3 import _page_targets  # noqa: E402

from .torch_port import bf16_numpy, f32  # noqa: E402

PS, PAGES, HKV, EPS = 8, 12, 2, 1e-6
TOL = 2**-7  # one bf16 ulp, relative and absolute (tests/test_torch_paged3.py)
IDLE = 3
OFFSETS = np.asarray([PS - 1, PS, PS + 1, 2 * PS + 5], np.int32)  # row IDLE: its own table row
CU = Path(kf.__file__).resolve().parent.parent / "csrc" / "fused_decode_attention.cu"


def _jax_route(qkv, cos, sin, qw, kw, kp, vp, page_idx, slot):
    """JAX's three-launch route for one layer: the prep kernel in interpret
    mode, then the rows written into the pages one row at a time."""
    q, k_row, v_row = jax_fused_qkv_prep(qkv, jnp.asarray(OFFSETS), cos, sin, qw, kw, eps=EPS,
                                         interpret=True)
    zero = jnp.int32(0)
    for b in range(q.shape[0]):
        at = (jnp.int32(page_idx[b]), zero, jnp.int32(slot[b]), zero)
        kp = jax.lax.dynamic_update_slice(kp, k_row[b][None], at)
        vp = jax.lax.dynamic_update_slice(vp, v_row[b][None], at)
    return q, kp, vp


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
def test_prep_write_plain_matches_jax_prep_and_scatter(n_rep, D):
    rng = np.random.default_rng(n_rep * 1000 + D)
    B = len(OFFSETS)
    qkv_j, qkv_t = bf16_numpy(rng.standard_normal((B, HKV, n_rep + 2, D)) * 3.0)
    qw_j, qw_t = bf16_numpy(rng.standard_normal(D) * 0.1 + 1.0)
    kw_j, kw_t = bf16_numpy(rng.standard_normal(D) * 0.1 + 1.0)
    kp_j, kp_t = bf16_numpy(rng.standard_normal((PAGES, HKV, PS, D)))
    vp_j, vp_t = bf16_numpy(rng.standard_normal((PAGES, HKV, PS, D)))
    cos, sin = (np.asarray(t) for t in jax_rope_tables(D, 64))
    table = np.full((B, 3), -1, np.int32)
    table[:IDLE] = 1 + rng.permutation(PAGES - 1)[: 3 * IDLE].reshape(IDLE, 3)
    page_idx, slot = _page_targets(torch.from_numpy(table), torch.from_numpy(OFFSETS)[:, None]
                                   .long(), PS)
    assert page_idx[IDLE, 0] == 0  # the idle row lands on the trash page

    want_q, want_kp, want_vp = _jax_route(
        qkv_j, jnp.asarray(cos[OFFSETS]), jnp.asarray(sin[OFFSETS]), qw_j, kw_j, kp_j, vp_j,
        page_idx[:, 0].numpy(), slot[:, 0].numpy())
    kp0, vp0 = kp_t.clone(), vp_t.clone()
    got_q = kf.fused_qkv_prep(qkv_t, torch.from_numpy(OFFSETS), torch.from_numpy(cos[OFFSETS]),
                              torch.from_numpy(sin[OFFSETS]), qw_t, kw_t, eps=EPS,
                              pages=(kp_t, vp_t, page_idx, slot))
    assert got_q.shape == (B, HKV, n_rep, D) and got_q.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got_q), f32(want_q), rtol=TOL, atol=TOL)

    written = torch.zeros((PAGES, PS), dtype=torch.bool)
    written[page_idx[:, 0], slot[:, 0]] = True
    assert int(written.sum()) == B  # distinct targets
    for got, before, want in ((kp_t, kp0, want_kp), (vp_t, vp0, want_vp)):
        moved = got.transpose(1, 2)  # [P, ps, Hkv, D]
        assert torch.equal(moved[~written], before.transpose(1, 2)[~written])
        want_rows = f32(want).transpose(0, 2, 1, 3)[written.numpy()]
        if got is kp_t:
            np.testing.assert_allclose(f32(moved[written]), want_rows, rtol=TOL, atol=TOL)
        else:
            np.testing.assert_array_equal(f32(moved[written]), want_rows)
    # The writing route's rows are the returning route's, bit for bit.
    _, k_row, v_row = kf.fused_qkv_prep(
        qkv_t, torch.from_numpy(OFFSETS), torch.from_numpy(cos[OFFSETS]),
        torch.from_numpy(sin[OFFSETS]), qw_t, kw_t, eps=EPS)
    assert torch.equal(kp_t[page_idx[:, 0], :, slot[:, 0]], k_row[:, :, 0])
    assert torch.equal(vp_t[page_idx[:, 0], :, slot[:, 0]], v_row[:, :, 0])


def test_prep_block_rows_is_one_line_constant_the_sweep_rewrites():
    """PREP_ROWS (rows of the fused qkv row a block takes) lives in
    csrc/fused_decode_attention.cu on one line in the form `qmm_crossover
    --kind prep` rewrites, and every copy of that sweep rewrites it alone."""
    text = CU.read_text()
    found = re.findall(r"^constexpr int PREP_ROWS = (\d+);$", text, flags=re.M)
    assert len(found) == 1 and int(found[0]) >= 1
    assert all(set(v) == {"fused_decode_attention"} and set(v["fused_decode_attention"])
               == {"PREP_ROWS"} for v in qmm_crossover.PREP_COPIES.values())
