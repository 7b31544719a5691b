"""The split paged prefill's two state kernels at the edges their CUDA tile
meets (a 128-row q tile, 64-key tiles, pages of any size): the plain
versions that the card check holds the kernels to, against the JAX package
on the same numpy inputs. Prefixes of 1, 63, 64, 65 and 129 keys (one key,
either side of a key tile, past two) over pages of 16 and 64, chunk
lengths that leave a ragged last tile, and virtual lengths below 0 and past
the slab. Whole 16-row tiles go against the Pallas kernels in interpret
mode; ragged ones against the XLA oracles `chunk_state_xla` and
`prefix_state_xla` (interpret mode reads a ragged tile's rows past the end
as NaN). The oracles give m = -inf for a row that sees no key where the
port gives NEG_INF (-1e30): those rows are held to the exact identity."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.flash_attention_pallas import flash_prefill_state_pallas  # noqa: E402
from tiny_llm_tpu.kernels.paged_attention_pallas import (  # noqa: E402
    paged_prefix_state as jax_paged_prefix_state,
)
from tiny_llm_tpu.kernels.split_prefill import chunk_state_xla, prefix_state_xla  # noqa: E402
from tiny_llm_tpu_torch.kernels.flash_attention import NEG_INF, flash_prefill_state  # noqa: E402
from tiny_llm_tpu_torch.kernels.paged_attention import paged_prefix_state  # noqa: E402

from .test_torch_split_prefill import O_TOL, STATE_ATOL, STATE_RTOL, _assert_state  # noqa: E402
from .torch_port import bf16_numpy, f32  # noqa: E402

# One key, either side of a 64-key tile, and past two; 0: the identity.
PREFIXES = (1, 63, 64, 65, 129, 0)
# D 64: scale 1/8 is a power of two, so q * scale is exact in bf16 and the
# XLA oracles (which do not round it) see the port's scores.
D = 64


def _pool(rng, prefixes, L, ps, n_rep, Hkv=1):
    """Pages holding each row's prefix and then its chunk over a shuffled
    pool (the tables -1 padded, one spare column), q for the chunk."""
    used = [-(-(p + L) // ps) for p in prefixes]
    P = sum(used) + 2
    bt = np.full((len(prefixes), max(used) + 1), -1, np.int32)
    perm = rng.permutation(np.arange(1, P))
    k = 0
    for b, n in enumerate(used):
        bt[b, :n] = perm[k : k + n]
        k += n
    kp, vp = (bf16_numpy(rng.standard_normal((P, Hkv, ps, D))) for _ in range(2))
    q = bf16_numpy(rng.standard_normal((len(prefixes), Hkv * n_rep, L, D)))
    return q, kp, vp, bt, np.asarray(prefixes, np.int32)


def _assert_identity(got, empty):
    """Rows that see no key: exactly (0, NEG_INF, 0)."""
    o, m, l = got
    assert not bool(o[empty].any())
    assert bool((m[empty] == NEG_INF).all()) and not bool(l[empty].any())


def _assert_state_xla(got, want):
    """o within the bf16 ladder (the oracle keeps p in f32), m and l within
    f32 sums in another order where a key is seen, the identity elsewhere."""
    o_w, m_w, l_w = (np.asarray(x, np.float32) for x in want)
    np.testing.assert_allclose(f32(got[0]), o_w, rtol=O_TOL, atol=O_TOL)
    live = l_w > 0
    for part, w in ((1, m_w), (2, l_w)):
        np.testing.assert_allclose(f32(got[part])[live], w[live], rtol=STATE_RTOL,
                                   atol=STATE_ATOL)
    assert np.isneginf(m_w[~live]).all()
    _assert_identity(got, torch.from_numpy(~live))


@pytest.mark.parametrize("ps", [16, 64])
def test_prefix_state_edges_match_pallas(ps):
    """Row 15 at whole 16-row q tiles: prefixes of 1, 63, 64, 65, 129 and 0
    over pages of `ps`, n_rep 2, against _paged_prefix_state_kernel."""
    rng = np.random.default_rng(ps)
    (q_j, q_t), (kp_j, kp_t), (vp_j, vp_t), bt, pre = _pool(rng, PREFIXES, 16, ps, n_rep=2)
    want = jax_paged_prefix_state(q_j, kp_j, vp_j, jnp.asarray(bt), jnp.asarray(pre),
                                  scale=D**-0.5, bq=16, interpret=True)
    got = paged_prefix_state(q_t, kp_t, vp_t, torch.from_numpy(bt), torch.from_numpy(pre),
                             D**-0.5)
    _assert_state(got, want)
    _assert_identity(got, torch.from_numpy(pre == 0))


@pytest.mark.parametrize("n_rep", [1, 8])
@pytest.mark.parametrize("ps", [16, 64])
def test_prefix_state_ragged_chunk_matches_xla(ps, n_rep):
    """Row 15 with a 40-token chunk (a ragged last tile), the same prefixes,
    against prefix_state_xla."""
    rng = np.random.default_rng(7 * ps + n_rep)
    (q_j, q_t), (kp_j, kp_t), (vp_j, vp_t), bt, pre = _pool(rng, PREFIXES, 40, ps, n_rep)
    want = prefix_state_xla(q_j, kp_j, vp_j, jnp.asarray(bt), jnp.asarray(pre), D**-0.5)
    got = paged_prefix_state(q_t, kp_t, vp_t, torch.from_numpy(bt), torch.from_numpy(pre),
                             D**-0.5)
    _assert_state_xla(got, want)


@pytest.mark.parametrize("L", [40, 100])
@pytest.mark.parametrize("n_rep", [1, 4])
def test_chunk_state_ragged_matches_xla(n_rep, L):
    """Row 7 on a chunk of L tokens over its own k/v (lens = L): 40 leaves a
    ragged 16-row tile, 100 a ragged 64-key tile; against chunk_state_xla."""
    rng = np.random.default_rng(L + n_rep)
    B, Hkv = 2, 2
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = (bf16_numpy(rng.standard_normal(s)) for s in (
        (B, Hkv * n_rep, L, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    want = chunk_state_xla(q_j, k_j, v_j, D**-0.5)
    got = flash_prefill_state(q_t, k_t, v_t, torch.full((B,), L, dtype=torch.int32), D**-0.5)
    _assert_state_xla(got, want)


def test_chunk_state_virtual_lengths_match_pallas():
    """Row 7 at virtual lengths around the slab (32 queries over 32 keys,
    two tiles each): below 0 (-40, -1: the identity), inside (1, 31), one
    past the end (33) and far past it (70: every key visible), against
    _prefill_state_kernel at whole 16-row tiles."""
    rng = np.random.default_rng(33)
    lens = np.asarray([-40, -1, 1, 31, 33, 70], np.int32)
    B, Hkv, n_rep, L, S = len(lens), 1, 2, 32, 32
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = (bf16_numpy(rng.standard_normal(s)) for s in (
        (B, Hkv * n_rep, L, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    want = flash_prefill_state_pallas(q_j, k_j, v_j, jnp.asarray(lens), scale=D**-0.5,
                                      causal=True, bq=16, bs=16, interpret=True)
    got = flash_prefill_state(q_t, k_t, v_t, torch.from_numpy(lens), D**-0.5)
    _assert_state(got, want)
    _assert_identity(got, torch.from_numpy(np.asarray(want[2]) == 0))
    assert bool((got[2][:2] == 0).all()) and bool((got[2][4:] > 0).all())
