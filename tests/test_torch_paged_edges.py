"""The paged decode and prefill kernels' plain versions where their CUDA
designs have edges (csrc/paged_attention.cu): the decode's split-key walk
(each row's keys in splits of `decode_split` keys, which may start and end
inside a page, and a combine) and the prefill's causal tensor-core tile
(64-key tiles that straddle pages, 128-row q tiles). `paged_attention_plain`
(the port's CPU route) and `paged_attention_split_plain` (both kernels'
split and combine) against the JAX package's Pallas kernels in interpret mode on the
same numpy inputs: L = 1, 2, 16 (decode) and 17, 32, 128 (prefill);
contexts ending mid-page and at a split boundary +-1; pages of 16, 32 and
128 tokens; lens = L; an idle row (table all -1, lens 0); n_rep 1 / 2 / 4 /
8 and D 64 / 128. Every V row no query may see (past a row's length, the
trash page, the free pages) holds 1e15, so a key read where it must not be
shows. Then the host's split chooser and the launchers' refusal of CPU
tensors."""

from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.paged_attention_pallas import (  # noqa: E402
    paged_flash_decode,
    paged_flash_decode_gather,
    paged_flash_decode_pages,
    paged_flash_prefill,
)
from tiny_llm_tpu_torch.kernels import paged_attention as pa  # noqa: E402

from .torch_port import bf16_numpy, f32  # noqa: E402
from .utils import assert_allclose  # noqa: E402

HKV, SMS = 2, 132  # KV heads of every case; the H100's SM count for the split chooser
POOL = 64  # pages of each shared pool
HIDDEN = 1e15  # V of every key no query may see
# Against the Pallas kernels: the bf16 ladder of tests/test_torch_paged.py
# (one softmax where the kernels rescale per tile; bf16 probabilities on
# both sides, rounded against other maxima).
RTOL = ATOL = 2e-2


@functools.lru_cache(maxsize=None)
def _pool(ps: int, d: int):
    """One shared pool per page shape, POOL pages of noise (K and V N(0, 1);
    page 0 is the trash page), and its shuffled order."""
    rng = np.random.default_rng(1000 * ps + d)
    kp = rng.standard_normal((POOL, HKV, ps, d))
    vp = rng.standard_normal((POOL, HKV, ps, d))
    return kp, vp, rng.permutation(np.arange(1, POOL))


def _case(ps: int, d: int, n_rep: int, L: int, ctxs, width: int, seed: int):
    """Rows of contexts `ctxs` (0: idle, table all -1) over the shared pool,
    pages taken in turn from its shuffled order; V at HIDDEN on every key
    row no query may see. Returns numpy-bf16 pairs (JAX, torch) for q, the
    pages, then the table and lens."""
    kp, vp, perm = _pool(ps, d)
    vp = vp.copy()
    used = set()
    bt = np.full((len(ctxs), width), -1, np.int32)
    k = 0
    for b, n in enumerate(ctxs):
        pages = perm[k : k + -(-n // ps)]
        bt[b, : len(pages)] = pages
        k += len(pages)
        used.update(int(p) for p in pages)
        if n % ps:
            vp[pages[-1], :, n % ps :] = HIDDEN  # past the row's length
    assert k <= len(perm), "the shared pool is too small for these contexts"
    for p in set(range(POOL)) - used:  # the trash page and the free pages
        vp[p] = HIDDEN
    rng = np.random.default_rng(seed)
    q = bf16_numpy(rng.standard_normal((len(ctxs), HKV * n_rep, L, d)))
    return q, bf16_numpy(kp), bf16_numpy(vp), bt, np.asarray(ctxs, np.int32)


def _port(q, kp, vp, bt, lens, scale, kps=None):
    """The CPU route (paged_attention_plain) and, given `kps`, the kernels'
    split-and-combine model at `kps` keys a split."""
    args = (q[1], kp[1], vp[1], torch.from_numpy(bt), torch.from_numpy(lens))
    got = pa.paged_attention(*args, scale=scale)
    assert got.dtype == torch.bfloat16 and got.shape == q[1].shape
    np.testing.assert_array_equal(f32(got), f32(pa.paged_attention_plain(*args, scale)))
    split = None if kps is None else pa.paged_attention_split_plain(*args, scale, kps)
    return f32(got), None if split is None else f32(split)


def _check_rows(got, want, lens, message):
    """Every value finite, the idle rows exactly 0, the live rows held to
    the Pallas kernel (whose idle rows are not its contract: the whole-page
    walk averages the trash page's V there)."""
    assert np.isfinite(got).all(), message
    assert (got[lens == 0] == 0).all(), message
    live = lens > 0
    assert_allclose(got[live], want[live], jnp.bfloat16, rtol=RTOL, atol=ATOL, message=message)


# (page size, D, n_rep, L): every page size, head dim, n_rep and L at least
# twice, the split boundaries on both sides of a page's edge.
DECODE_CASES = [(16, 128, 1, 1), (16, 128, 8, 16), (16, 64, 4, 2), (16, 64, 2, 1),
                (32, 128, 2, 16), (32, 64, 8, 1), (32, 128, 4, 2),
                (128, 128, 4, 1), (128, 128, 8, 2), (128, 64, 1, 16)]


@pytest.mark.parametrize("ps,d,n_rep,L", DECODE_CASES,
                         ids=[f"ps{p}_d{d}_nrep{r}_L{L}" for p, d, r, L in DECODE_CASES])
def test_decode_at_split_and_page_edges_matches_pallas(ps, d, n_rep, L):
    """L <= 16: rows of context L (no prefix), one key either side of the
    host split's first and second boundaries, one mid-page and an idle
    row, against paged_flash_decode_gather in interpret mode; the split
    walk's plain model at the host's split and at 64 keys (inside a page
    of 128) within the bf16 ladder of the unsplit version."""
    width = 384 // ps
    B = 7
    kps = pa.decode_split(B, HKV, width, ps, SMS)
    assert kps == pa.DECODE_MIN_KEYS  # few rows and heads: the floor sets the split
    ctxs = [L, kps - 1, kps + 1, 2 * kps - 1, 2 * kps + 1, ps + ps // 2 + 1, 0]
    q, kp, vp, bt, lens = _case(ps, d, n_rep, L, ctxs, width, seed=ps + d + n_rep + L)
    scale = d**-0.5
    want = f32(paged_flash_decode_gather(q[0], kp[0], vp[0], jnp.asarray(bt), jnp.asarray(lens),
                                         scale=scale, pages_per_tile=2, interpret=True))
    got, split = _port(q, kp, vp, bt, lens, scale, kps)
    _check_rows(got, want, lens, "plain")
    _check_rows(split, want, lens, f"split of {kps}")
    assert_allclose(split, got, jnp.bfloat16, message="split against unsplit")
    _, split64 = _port(q, kp, vp, bt, lens, scale, 64)
    _check_rows(split64, want, lens, "split of 64")


@pytest.mark.parametrize("d", [64, 128])
def test_decode_whole_pages_and_walk_kernels_match_pallas(d):
    """Rows 10 and 11's Pallas kernels compute the decode's function too:
    L = 1 over whole pages (paged_flash_decode_pages) and, at D = 64 where
    the TPU takes it, the per-(page, head) walk (paged_flash_decode) at
    L = 8 over contexts ending mid-page; n_rep 8."""
    ps, width = 32, 12
    q, kp, vp, bt, lens = _case(ps, d, 8, 1, [ps, 4 * ps, 8 * ps, 0, 12 * ps], width, seed=d)
    scale = d**-0.5
    kps = pa.decode_split(5, HKV, width, ps, SMS)
    want = f32(paged_flash_decode_pages(q[0], kp[0], vp[0], jnp.asarray(bt), jnp.asarray(lens),
                                        scale=scale, interpret=True))
    got, split = _port(q, kp, vp, bt, lens, scale, kps)
    _check_rows(got, want, lens, "whole pages, plain")
    _check_rows(split, want, lens, "whole pages, split")
    if d == 64:
        q, kp, vp, bt, lens = _case(ps, d, 8, 8, [8, 45, 200, 0], width, seed=d + 1)
        want = f32(paged_flash_decode(q[0], kp[0], vp[0], jnp.asarray(bt), jnp.asarray(lens),
                                      scale=scale, interpret=True))
        got, split = _port(q, kp, vp, bt, lens, scale, kps)
        _check_rows(got, want, lens, "walk, plain")
        _check_rows(split, want, lens, "walk, split")


PREFILL_CASES = [(16, 128, 4, 17), (16, 64, 2, 128), (32, 64, 8, 32), (32, 128, 1, 17),
                 (128, 128, 8, 32), (128, 128, 1, 128)]


@pytest.mark.parametrize("ps,d,n_rep,L", PREFILL_CASES,
                         ids=[f"ps{p}_d{d}_nrep{r}_L{L}" for p, d, r, L in PREFILL_CASES])
def test_prefill_at_tile_and_page_edges_matches_pallas(ps, d, n_rep, L):
    """L > 16: rows of context L (no prefix), a chunk ending mid-page, one
    ending a key past a 64-key tile and an idle row, against
    paged_flash_prefill in interpret mode (one q block of L rows: interpret
    mode reads a ragged block's rows past the end as NaN); the key split's
    plain model at the host's split (a split boundary inside the chunk at
    L = 128) and at 64 keys within the bf16 ladder of the unsplit version."""
    width = 384 // ps
    ctxs = [L, L + ps + 5, 257, 0]
    q, kp, vp, bt, lens = _case(ps, d, n_rep, L, ctxs, width, seed=ps * d + n_rep + L)
    scale = d**-0.5
    want = f32(paged_flash_prefill(q[0], kp[0], vp[0], jnp.asarray(bt), jnp.asarray(lens),
                                   scale=scale, bq=L, interpret=True))
    kps = pa.prefill_split(len(ctxs), HKV, L, n_rep, width, ps, SMS)
    assert kps < width * ps  # few q tiles: the keys split
    got, split = _port(q, kp, vp, bt, lens, scale, kps)
    _check_rows(got, want, lens, "prefill")
    _check_rows(split, want, lens, f"prefill, split of {kps}")
    assert_allclose(split, got, jnp.bfloat16, message="split against unsplit")
    _, split64 = _port(q, kp, vp, bt, lens, scale, 64)
    _check_rows(split64, want, lens, "prefill, split of 64")


@pytest.mark.parametrize("L", [16, 17])
def test_dispatch_gate_at_16(L):
    """paged_attention sends L <= 16 to the decode kernel and L > 16 to the
    prefill, as the TPU dispatcher (paged_attention_pallas.py:862): the
    launchers refuse CPU tensors before any build and count nothing; the
    decode launcher refuses L > 16."""
    q, kp, vp, bt, lens = _case(16, 64, 2, L, [40], 4, seed=L)
    args = (q[1], kp[1], vp[1], torch.from_numpy(bt), torch.from_numpy(lens), 0.125)
    before = (pa.DECODE_LAUNCHES, pa.PREFILL_LAUNCHES)
    launcher = pa.paged_decode_cuda if L <= pa.DECODE_MAX_L else pa.paged_prefill_cuda
    with pytest.raises(ValueError, match="CUDA"):
        launcher(*args)
    if L > pa.DECODE_MAX_L:
        with pytest.raises(ValueError, match="L <= 16"):
            pa.paged_decode_cuda(*args)
    assert (pa.DECODE_LAUNCHES, pa.PREFILL_LAUNCHES) == before


def test_decode_split_is_a_function_of_shapes_that_covers_the_card():
    """Keys a split of the decode walk: whole 64-key tiles, at least
    DECODE_MIN_KEYS, from (B, Hkv, table width, page size, SMs) alone (the
    same integers give the same split, and no tensor is an argument); where
    the table is wide enough the grid (splits, Hkv, B) covers the SMs at
    least twice. Row 14's chooser is unchanged."""
    for b, hkv, width, ps in [(1, 8, 8, 128), (4, 8, 8, 128), (1, 4, 8, 128), (4, 4, 8, 128),
                              (1, 8, 64, 128), (4, 8, 64, 16), (16, 8, 8, 128), (1, 1, 1, 16),
                              (2, 2, 24, 16), (1, 8, 512, 16), (64, 8, 8, 128)]:
        kps = pa.decode_split(b, hkv, width, ps, SMS)
        assert kps == pa.decode_split(b, hkv, width, ps, SMS)
        assert kps % pa.KEY_TILE == 0 and kps >= pa.DECODE_MIN_KEYS
        keys = width * ps
        splits = -(-keys // kps)
        if kps > pa.DECODE_MIN_KEYS:  # not at the floor: as many splits as cover 2 x SMs
            assert splits * b * hkv >= 2 * SMS
    # The serving table (1024 keys in pages of 128) at 4B's 8 KV heads:
    # 8 splits of 128 keys, a (8, 8, B) grid.
    assert pa.decode_split(1, 8, 8, 128, SMS) == 128
    assert pa.decode_split(4, 8, 8, 128, SMS) == 128
    # A long table at B = 1: 8192 keys for 33 splits, at most 248 keys each,
    # in whole tiles 192: 43 splits, 344 blocks.
    assert pa.decode_split(1, 8, 64, 128, SMS) == 192
    assert pa.decode_state_split(4, 8, 64, 128, SMS) == 7


def test_prefill_split_is_a_function_of_shapes_that_fills_the_card():
    """Keys a split of the paged prefill: the table's width (unsplit) where
    the q tiles alone leave fewer than half the SMs to a second split;
    else whole 64-key tiles, at least PREFILL_MIN_KEYS, and no more splits
    than fill the SMs with one block each."""
    for b, hkv, L, n_rep, width, ps in [(1, 8, 128, 4, 8, 128), (1, 8, 32, 4, 8, 128),
                                        (1, 4, 32, 8, 8, 128), (1, 8, 17, 4, 8, 128),
                                        (4, 8, 128, 4, 8, 128), (1, 8, 1024, 4, 8, 128),
                                        (1, 8, 256, 4, 64, 128), (2, 2, 17, 1, 24, 16)]:
        kps = pa.prefill_split(b, hkv, L, n_rep, width, ps, SMS)
        assert kps == pa.prefill_split(b, hkv, L, n_rep, width, ps, SMS)
        keys, blocks = width * ps, -(-L // (pa.PREFILL_ROWS // n_rep)) * hkv * b
        if kps == keys:
            assert 2 * blocks > SMS or keys <= pa.PREFILL_MIN_KEYS
        else:
            assert kps % pa.KEY_TILE == 0 and kps >= pa.PREFILL_MIN_KEYS
            assert -(-keys // kps) * blocks <= SMS or kps == pa.PREFILL_MIN_KEYS
    # 4B's serving chunk (L = 128 over 1024 keys): 32 q-tile blocks, 4
    # splits of 256; the mixed sub-chunk (L = 32): 8 blocks, 8 splits of
    # 128 (the floor); a 1024-token chunk: 256 blocks, unsplit.
    assert pa.prefill_split(1, 8, 128, 4, 8, 128, SMS) == 256
    assert pa.prefill_split(1, 8, 32, 4, 8, 128, SMS) == 128
    assert pa.prefill_split(1, 8, 1024, 4, 8, 128, SMS) == 1024
