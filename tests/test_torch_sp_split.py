"""The paged decode-state walk's split and combine (csrc/paged_attention.cu
paged_state_walk and state_combine: each row's block table cut into splits
of table entries, a partial state per split, merged in f32) in plain
PyTorch, `paged_decode_state_split_plain`, against the unsplit plain
version (bit-equal at one split) and against the JAX package's
`paged_decode_state` in interpret mode, on every shard of a striped pool;
the host's split chooser; and the launcher's refusal of CPU tensors."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.paged_attention_pallas import (  # noqa: E402
    paged_decode_state as jax_paged_decode_state,
)
from tiny_llm_tpu_torch.kernels import paged_attention as pa  # noqa: E402
from tiny_llm_tpu_torch.kernels.flash_attention import NEG_INF  # noqa: E402
from tiny_llm_tpu_torch.kv import PagedKVCache, PagePool  # noqa: E402

from .torch_port import bf16_numpy, f32  # noqa: E402
from .utils import assert_allclose  # noqa: E402

SHARDS, P, PS, D, HKV = 4, 32, 8, 64, 2
P_LOC = P // SHARDS
STATE_TOL = 1e-3  # m and l where l > 0: f32 sums of the same terms in another order


def _striped_table(L):
    """Block tables of a pool striped over 4 shards, requests admitted in
    turn as the port's PagePool places them, then two rows built by hand:
    row 4's pages all on shard 1 and in its table's first two entries (one
    split of the shard's keys at splits >= 2), row 5 on shard 0 alone (the
    other shards own nothing of it: the identity)."""
    pool = PagePool(1, P, HKV, PS, D, device="cpu", stripe_shards=SHARDS)
    ctxs = [45 + L, 20 + L, 7 + L, 30 + L]
    reqs = [PagedKVCache(pool) for _ in ctxs]
    for r, c in zip(reqs, ctxs):
        r.ensure_capacity(c)
    width = 12
    rows = [r.block_table_row(width) for r in reqs]
    rows.append([P_LOC + 6, P_LOC + 7] + [-1] * (width - 2))
    rows.append([1, 2, 3] + [-1] * (width - 3))
    lens = ctxs + [2 * PS - 3, 3 * PS]
    return np.asarray(rows, np.int32), np.asarray(lens, np.int32)


def _case(n_rep, L, seed):
    rng = np.random.default_rng(seed)
    table, lens = _striped_table(L)
    q = bf16_numpy(rng.standard_normal((len(lens), HKV * n_rep, L, D)))
    kp = bf16_numpy(rng.standard_normal((P, HKV, PS, D)))
    vp = bf16_numpy(rng.standard_normal((P, HKV, PS, D)))
    return q, kp, vp, table, lens


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("n_rep,L", [(1, 1), (4, 1), (8, 1), (1, 16), (4, 16), (8, 16)])
def test_split_walk_matches_unsplit_and_pallas(n_rep, L, splits):
    """On every shard: the split model against the unsplit plain version
    (o at the bf16 ladder: p is rounded against each split's max; bit-equal
    at one split) and against
    _paged_decode_state_kernel in interpret mode (o at the bf16 ladder, m
    and l within STATE_TOL where l > 0); rows none of whose visible keys the
    shard owns are exactly (0, NEG_INF, 0), with no NaN."""
    (q_j, q_t), (kp_j, kp_t), (vp_j, vp_t), table, lens = _case(n_rep, L, 10 * n_rep + L)
    scale = D**-0.5
    bt, lt = torch.from_numpy(table), torch.from_numpy(lens)
    owners = []
    for s in range(SHARDS):
        base, loc = s * P_LOC, slice(s * P_LOC, (s + 1) * P_LOC)
        got = pa.paged_decode_state_split_plain(q_t, kp_t[loc], vp_t[loc], bt, lt, base, scale,
                                                splits)
        unsplit = pa.paged_decode_state_plain(q_t, kp_t[loc], vp_t[loc], bt, lt, base, scale)
        if splits == 1:
            for a, b in zip(got, unsplit):
                np.testing.assert_array_equal(f32(a), f32(b))
        o, m, l = (f32(t) for t in got)
        assert_allclose(o, f32(unsplit[0]), jnp.bfloat16, message=f"unsplit, shard {s}")
        want = jax_paged_decode_state(q_j, kp_j[loc], vp_j[loc], jnp.asarray(table),
                                      jnp.asarray(lens), jnp.int32(base), scale=scale,
                                      interpret=True)
        o_w, m_w, l_w = (np.asarray(t, np.float32) for t in want)
        assert np.isfinite(o).all() and np.isfinite(m).all() and np.isfinite(l).all()
        assert_allclose(o, o_w, jnp.bfloat16, message=f"shard {s}")
        live = l_w > 0
        np.testing.assert_allclose(m[live], m_w[live], rtol=STATE_TOL, atol=STATE_TOL)
        np.testing.assert_allclose(l[live], l_w[live], rtol=STATE_TOL, atol=STATE_TOL)
        assert (o[~live] == 0).all() and (m[~live] == NEG_INF).all() and (l[~live] == 0).all()
        owners.append(live.any(axis=(1, 2)))
    owners = np.stack(owners)  # [shard, batch row]: the shard owns a key some row sees
    assert owners[:, 5].tolist() == [True, False, False, False]  # row 5 on shard 0 alone
    assert owners[:, 4].tolist() == [False, True, False, False]  # row 4 on shard 1 alone
    assert owners[:, 0].all()  # a striped row spreads over every shard


def test_split_chooser_covers_the_card():
    """Table entries a split: from B, Hkv, the table's width and the page
    size alone; at the card's 132 SMs the grid (splits, Hkv, B) covers them
    at least twice where the width holds splits of STATE_MIN_KEYS keys, and
    no split exceeds STATE_MAX_ENTRIES entries."""
    for b, hkv, width, ps in [(4, 8, 64, 128), (1, 8, 64, 128), (4, 4, 64, 128), (8, 8, 64, 128),
                              (4, 8, 512, 16), (1, 8, 8192, 16), (2, 4, 3, 128), (1, 1, 1, 8),
                              (16, 8, 64, 128), (1, 8, 4096, 64)]:
        per = pa.decode_state_split(b, hkv, width, ps, 132)
        splits = -(-width // per)
        assert 1 <= per <= pa.STATE_MAX_ENTRIES
        assert per * ps >= min(pa.STATE_MIN_KEYS, width * ps) or per == width
        least = -(-pa.STATE_MIN_KEYS // ps)
        assert splits * b * hkv >= 264 or per == max(least, 1) or per == pa.STATE_MAX_ENTRIES
    # sp_kernels' case: B = 4, Hkv 8, 64 entries of 128: 7 entries, 10 splits, 320 blocks.
    assert pa.decode_state_split(4, 8, 64, 128, 132) == 7


def test_decode_state_launcher_refuses_cpu_tensors():
    """On the CPU the wrapper runs the plain version; the launcher itself
    never falls back: a CPU tensor raises before any build, and nothing is
    counted."""
    (_, q), (_, kp), (_, vp), table, lens = _case(4, 1, 0)
    before = pa.DECODE_STATE_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_decode_state_cuda(q, kp[:P_LOC], vp[:P_LOC], torch.from_numpy(table),
                                   torch.from_numpy(lens), 0, D**-0.5)
    assert pa.DECODE_STATE_LAUNCHES == before
