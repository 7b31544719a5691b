"""The port's explicit-mask attention where its CUDA kernel's designs have
edges (tiny_llm_tpu_torch.kernels.flash_attention), on the CPU, against the
JAX package's: the plain version on the same numpy inputs, held against the
Pallas masked kernels in interpret mode (`_decode_kernel_masked` at L <= 16,
`_prefill_kernel_masked` above) and against the XLA twin on the rows that see
a key. The kernel splits decode keys over blocks in chunks of 64-key tiles,
walks a prefill over the 64-key tiles a live-tile map marks, and skips a tile
the mask hides from every row; so the cases put window edges on keys 63, 64
and 65, lengths below 64, L = 16 and 17 (the last decode-shaped and the first
prefill-shaped rows), n_rep 1 and 2, a row at -1e29 everywhere (visible: the
uniform average) and a row mixing -inf and -1e30 (hidden: exactly 0), and
large finite values in every V row no query may see. The two pieces the
kernel adds are held too: the split-and-combine walk against the unsplit
plain version, and the live-tile map against numpy."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from tiny_llm_tpu.kernels.flash_attention_pallas import flash_attention_pallas  # noqa: E402
from tiny_llm_tpu_torch.kernels import flash_attention as ka  # noqa: E402

from .torch_port import bf16_numpy, f32  # noqa: E402

NEG = -1e30
# As tests/test_torch_mask.py: the same rounding points as the Pallas
# kernels, another summation order (1e-2); the XLA twin rounds elsewhere.
PALLAS_ATOL, XLA_ATOL = 1e-2, 5e-2
# V rows no query may see hold this: any weight on them shows at once.
HIDDEN_V = 1e15
B, HQ, S, D = 2, 4, 320, 64


def _window_rows(L, lo, hi):
    """Additive [L, S]: row i sees keys lo[i] .. hi[i] (inclusive)."""
    k = np.arange(S)[None, :]
    ok = (k >= np.asarray(lo)[:, None]) & (k <= np.asarray(hi)[:, None])
    return np.where(ok, 0.0, NEG).astype(np.float32)


def _edges(L):
    """Windows that start or end on keys 63, 64, 65 of the first tile
    boundary, 127 / 128 / 129 of the next, and the last key."""
    lo = np.resize([0, 64, 65, 63, 128, 129, 1, 190], L)
    hi = np.resize([63, 128, 191, 64, 129, 255, 65, 319], L)
    return _window_rows(L, lo, hi)


def _special_rows(L, Hq, rng):
    """Per-head [B, Hq, L, S]: a random bias over edge windows; in every
    batch row, head 0's row 1 is -1e29 everywhere (visible, equal scores:
    the uniform average) and head 1's row 0 mixes -inf and -1e30 (hidden:
    exactly 0)."""
    m = np.broadcast_to(_edges(L), (B, Hq, L, S)).copy()
    m += np.where(m > NEG, rng.normal(size=m.shape) * 0.5, 0.0).astype(np.float32)
    m[:, 0, min(1, L - 1)] = -1e29
    m[:, 1, 0] = np.where(np.arange(S) % 2, -np.inf, NEG)
    return m


# name: (Hkv, L, lens, mask builder(L, Hq, rng) -> [B, 1 or Hq, L, S])
CASES = {
    "decode_edges_nrep2_L4": (2, 4, [320, 200], lambda L, Hq, rng: _edges(L)),
    "decode_edges_nrep1_L16": (4, 16, [320, 129], lambda L, Hq, rng: np.stack(
        [_edges(L), _edges(L)[::-1]])[:, None]),
    "prefill_edges_nrep2_L17": (2, 17, [320, 65], lambda L, Hq, rng: _edges(L)),
    "prefill_edges_nrep1_L17": (4, 17, [300, 64], lambda L, Hq, rng: np.stack(
        [_edges(L), _edges(L)[::-1]])[:, None]),
    "decode_lens_below_64": (2, 1, [40, 63], lambda L, Hq, rng: np.stack(
        [_window_rows(1, [20], [319]), _window_rows(1, [0], [62])])[:, None]),
    "prefill_lens_below_64": (2, 32, [40, 320], lambda L, Hq, rng: _edges(L)),
    "decode_special_rows_per_head": (2, 4, [320, 250], _special_rows),
    "prefill_special_rows_per_head": (4, 17, [320, 250], _special_rows),
}


def _inputs(Hkv, L, lens, build, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, HQ, L, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    mask = build(L, HQ, rng).astype(np.float32)
    # Keys no query row of a KV head may see: past the length, or hidden by
    # the mask from every row of every head sharing the KV head.
    below = np.arange(S)[None, :] < np.asarray(lens)[:, None]  # [B, S]
    seen = (np.broadcast_to(mask, (B, HQ, L, S)) > NEG) & below[:, None, None]
    seen_kv = seen.reshape(B, Hkv, HQ // Hkv, L, S).any((2, 3))  # [B, Hkv, S]
    v[~seen_kv] = HIDDEN_V
    return [bf16_numpy(x) for x in (q, k, v)], mask


@pytest.mark.parametrize("name", list(CASES))
def test_mask_edges_match_pallas_and_xla(name):
    Hkv, L, lens, build = CASES[name]
    (qp, kp, vp), mask = _inputs(Hkv, L, lens, build, seed=len(name))
    lt = torch.tensor(lens, dtype=torch.int32)
    got = f32(ka.flash_attention(qp[1], kp[1], vp[1], lt, mask=torch.from_numpy(mask)))
    lj = jnp.asarray(lens, jnp.int32)
    pallas = f32(flash_attention_pallas(qp[0], kp[0], vp[0], mask=jnp.asarray(mask), lens=lj,
                                        interpret=True))
    np.testing.assert_allclose(got, pallas, atol=PALLAS_ATOL, rtol=0)
    below = np.arange(S)[None, :] < np.asarray(lens)[:, None]
    seen = np.broadcast_to(((mask > NEG) & below[:, None, None]).any(-1), (B, HQ, L))
    xla = f32(jax_flash(qp[0], kp[0], vp[0], mask=jnp.asarray(mask), lens=lj, impl="xla"))
    np.testing.assert_allclose(got[seen], xla[seen], atol=XLA_ATOL, rtol=0)
    # No hidden V row leaks in; a row that sees no key is exactly 0.
    assert np.isfinite(got).all() and np.abs(got).max() < 10
    assert not got[~seen].any()
    if "special" in name:
        assert (~seen).sum() == B  # head 1's row 0 in each batch row
        # The -1e29 row: the uniform average of the V rows below the length
        # (none of them hidden: that row sees every one).
        v = f32(vp[1]).reshape(B, Hkv, S, D)
        for b, n in enumerate(lens):
            np.testing.assert_allclose(got[b, 0, 1], v[b, 0, :n].mean(0), atol=PALLAS_ATOL)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("name", ["decode_edges_nrep1_L16", "decode_special_rows_per_head"])
def test_split_walk_matches_unsplit(name, splits):
    """The decode walk's split and combine (any split count; 7 cuts keys
    46, 92, ... inside tiles) against the unsplit plain version, and a row
    whose splits are all the identity exactly 0."""
    Hkv, L, lens, build = CASES[name]
    (qp, kp, vp), mask = _inputs(Hkv, L, lens, build, seed=splits)
    q, k, v, lt = qp[1], kp[1], vp[1], torch.tensor(lens, dtype=torch.int32)
    m4 = ka._mask_planes(torch.from_numpy(mask), B, HQ, L, S, torch.device("cpu"))
    want = f32(ka.flash_attention_masked_plain(q, k, v, lt, m4, D**-0.5))
    got = f32(ka.flash_attention_masked_split_plain(q, k, v, lt, m4, D**-0.5, splits))
    np.testing.assert_allclose(got, want, atol=PALLAS_ATOL, rtol=0)
    hidden = want == 0
    hidden &= (want == 0).all(-1, keepdims=True)
    assert np.isfinite(got).all() and not got[hidden].any()
    if splits == 1:  # one split is the unsplit walk itself
        np.testing.assert_array_equal(got, want)


def test_mask_tile_map_matches_numpy():
    """The live-tile map of 16-row groups and 64-key tiles against numpy's
    any(mask > -1e30) over the same blocks, below L and each row's length:
    -1e29 is live, -inf and -1e30 are not."""
    rng = np.random.default_rng(3)
    L, S_, lens = 37, 300, [300, 100, 64]
    m = np.full((3, 2, L, S_), NEG, np.float32)
    m[:, 1] = -np.inf
    m[0, 0, 5, 63] = -1e29  # live: tile 0, group 0
    m[0, 1, 36, 64] = 0.0  # live: tile 1, group 2 (the ragged last group)
    m[1, 0, 16, 99] = 2.0  # live: key 99 < lens 100
    m[1, 1, 16, 100] = 2.0  # dead: key 100 at the length
    m[2, 0, 0, 63] = np.nextafter(np.float32(NEG), np.float32(0))  # live: just above -1e30
    m[2, 1, 20, 64] = 1.0  # dead: past lens 64
    m[2, 0, 10, 200] = rng.normal()  # dead: past lens 64
    got = ka.mask_tile_map_plain(torch.from_numpy(m), torch.tensor(lens)).numpy()
    G, NT = -(-L // 16), -(-S_ // 64)
    want = np.zeros((3, 2, G, NT), bool)
    for b in range(3):
        for p in range(2):
            for g in range(G):
                for t in range(NT):
                    blk = m[b, p, 16 * g:16 * g + 16, 64 * t:min(64 * t + 64, lens[b])]
                    want[b, p, g, t] = blk.size > 0 and bool((blk > NEG).any())
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 4 and got[0, 0, 0, 0] and got[0, 1, 2, 1] and got[1, 0, 1, 1]
    assert got[2, 0, 0, 0] and not got[1, 1].any() and not got[2, 1].any()


def test_decode_chunk_covers_the_card():
    """Keys a decode split: a multiple of 64 from 256 to 4096, from B, Hkv
    and S alone; at the card's 132 SMs the grid covers them at least twice
    where S has the keys for splits of 256."""
    for b, hkv, s in [(4, 8, 8192), (4, 4, 8192), (2, 8, 4096), (2, 4, 4096), (2, 8, 1000),
                      (1, 8, 100), (1, 1, 1 << 20), (8, 8, 64), (3, 8, 2048)]:
        chunk = ka.decode_chunk(b, hkv, s, 132)
        splits = -(-s // chunk)
        assert chunk % 64 == 0 and ka.MIN_CHUNK <= chunk <= ka.MAX_CHUNK
        assert splits * b * hkv >= 264 or chunk == ka.MIN_CHUNK
    assert ka.decode_chunk(4, 8, 8192, 132) == 896  # case (a): 10 splits, 320 blocks
