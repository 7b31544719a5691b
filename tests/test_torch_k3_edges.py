"""K3's CPU route (the plain version of `flash_attention`) where the card's
two routes have edges, against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs; and K3's split and combine in
plain PyTorch (`flash_attention_split_plain`) against the unsplit plain
version there.

On the card K3 takes L <= 16 through a split-key walk over the slab (the
TPU's `_decode_kernel` regime) and L > 16 through the causal tensor-core
tile, its keys split where its q tiles leave SMs idle; both merge the
splits with an o-only combine. The cases: L = 16 and 17 (the route gate),
8, 40 and 128; rows whose lengths end on a 64-key tile's edge (63, 64,
65) and on a split's boundary (127, 128, 129: splits of 128 keys here);
rows with lens < L, whose first queries see no key and emit exactly 0;
two batch rows of unequal lengths; n_rep 1, 2, 4 and 8; head dims 64 and
128. Tolerance as tests/test_torch_kernels.py holds K3: the bf16 ladder,
rtol = atol = 2e-2. The Pallas L <= 16 kernel in interpret mode gives NaN
on a row that sees no key, so such rows are compared with the port's
exact 0 alone."""

from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.flash_attention_pallas import flash_attention_pallas  # noqa: E402
from tiny_llm_tpu_torch.kernels import flash_attention as ka  # noqa: E402

from .torch_port import bf16_numpy, f32  # noqa: E402
from .utils import assert_allclose  # noqa: E402

HKV, S, SMS = 2, 320, 132  # SMS: an H100's, for the launcher's split sizes
# Pairs of batch-row lengths at each L: a row before its start (lens < L),
# a 64-key tile's edges, a split's boundary (128 keys: the L <= 16 walk's
# at these shapes), the whole slab.
LENS = {8: [(3, 63), (64, 65), (127, 128), (129, S)],
        16: [(5, 64), (63, 65), (128, 129), (16, S)],
        17: [(5, 63), (64, 65), (127, 129), (17, S)],
        40: [(20, 64), (63, 128), (129, S)],
        128: [(100, 128), (127, 129), (128, S)]}
# Each n_rep at both head dims, each L at least once at each (a Pallas
# compile a case).
CASES = [(1, 64, 17), (1, 128, 8), (2, 64, 16), (2, 128, 40), (4, 64, 128), (4, 128, 17),
         (8, 64, 8), (8, 128, 16), (8, 128, 17), (2, 64, 128)]


@functools.lru_cache(maxsize=None)
def _inputs(D: int):
    """One input set per head dim: q for the largest n_rep and L (each case
    takes a slice) and one slab of K/V."""
    rng = np.random.default_rng(D)
    q = bf16_numpy(rng.standard_normal((2, HKV * 8, 128, D)))
    k = bf16_numpy(rng.standard_normal((2, HKV, S, D)))
    v = bf16_numpy(rng.standard_normal((2, HKV, S, D)))
    return q, k, v


def _case(n_rep: int, D: int, L: int):
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = _inputs(D)
    Hq = HKV * n_rep
    return (q_j[:, :Hq, :L], q_t[:, :Hq, :L].contiguous()), (k_j, k_t), (v_j, v_t)


def _dead(lens, L):
    """[B, L] True where the query sits before position 0 (sees no key)."""
    return np.asarray(lens)[:, None] - L + np.arange(L)[None, :] < 0


@pytest.mark.parametrize("n_rep,D,L", CASES)
def test_k3_plain_matches_pallas_at_route_edges(n_rep, D, L):
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = _case(n_rep, D, L)
    for lens in LENS[L]:
        lens_np = np.asarray(lens, np.int32)
        got = f32(ka.flash_attention(q_t, k_t, v_t, torch.from_numpy(lens_np)))
        want = np.asarray(flash_attention_pallas(q_j, k_j, v_j, lens=jnp.asarray(lens_np),
                                                 interpret=True), np.float32)
        assert np.isfinite(got).all()
        dead = _dead(lens, L)  # [B, L]
        got_t, want_t = got.transpose(0, 2, 1, 3), want.transpose(0, 2, 1, 3)  # [B, L, Hq, D]
        assert (got_t[dead] == 0).all(), f"lens {lens}: a row that sees no key is not 0"
        assert_allclose(got_t[~dead], want_t[~dead], precision=jnp.bfloat16, rtol=2e-2,
                        atol=2e-2)


@pytest.mark.parametrize("n_rep,D,L", CASES[::2])
def test_k3_split_plain_matches_unsplit_at_route_edges(n_rep, D, L):
    """The split and combine at the launcher's split size, one tile (64
    keys) and two (128), against the unsplit plain version: the bf16 ladder
    (p is rounded against each split's max), rows that see no key exactly
    0; one split covering every key is bit-equal."""
    _, (_, k), (_, v) = _case(n_rep, D, L)
    q = _case(n_rep, D, L)[0][1]
    kps = ka.flash_split(2, HKV, L, n_rep, S, SMS)
    for lens in LENS[L]:
        lens_t = torch.tensor(lens, dtype=torch.int32)
        unsplit = ka.flash_attention_plain(q, k, v, lens_t, D**-0.5)
        for keys in sorted({kps, 64, 128}):
            split = ka.flash_attention_split_plain(q, k, v, lens_t, D**-0.5, keys)
            dead = torch.from_numpy(_dead(lens, L))
            assert (split.transpose(1, 2)[dead] == 0).all()
            assert_allclose(f32(split), f32(unsplit), precision=jnp.bfloat16, rtol=2e-2,
                            atol=2e-2)
        whole = ka.flash_attention_split_plain(q, k, v, lens_t, D**-0.5, S)
        assert torch.equal(whole, unsplit)


def test_k3_split_sizes():
    """The launcher's split sizes come from the shapes alone: the L <= 16
    route takes decode_split's keys; the tile splits the keys only where its
    q tiles leave SMs idle, in whole 64-key tiles."""
    from tiny_llm_tpu_torch.kernels.paged_attention import decode_split

    for L in (1, 8, 16):
        assert ka.flash_split(1, 8, L, 4, 1024, SMS) == decode_split(1, 8, 1024, 1, SMS)
    # Serving's first chunk (B = 4, L = S = 128) and long_prefill's (L = S =
    # 1024) fill the SMs with q tiles: one split, the tile alone.
    assert ka.flash_split(4, 8, 128, 4, 128, SMS) == 128
    assert ka.flash_split(1, 8, 1024, 4, 1024, SMS) == 1024
    # A dense prompt chunk over the 1024-slot slab: one split (a combine
    # launch costs a first chunk, whose rows see only its own keys, as much
    # as the splits save at the slab's end); over longer slabs the keys
    # split into the SMs' worth.
    assert ka.flash_split(1, 8, 128, 4, 1024, SMS) == 1024
    assert ka.flash_split(1, 8, 128, 4, 2048, SMS) == 512
    assert ka.flash_split(1, 8, 128, 4, 8192, SMS) == 2048
    for B, Hkv, L, n_rep, S_ in ((1, 8, 128, 4, 1024), (1, 4, 128, 8, 1024), (2, 2, 40, 4, S)):
        kps = ka.flash_split(B, Hkv, L, n_rep, S_, SMS)
        assert 1 <= kps <= S_ and (kps == S_ or kps % 64 == 0)


def test_k3_cuda_refused_on_cpu_tensors():
    q = torch.zeros((1, 2, 17, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ka.flash_attention(q, k, k, torch.tensor([17]), impl="cuda")
    with pytest.raises(ValueError):
        ka.flash_attention_cuda(q, k, k, torch.tensor([17]), 0.125)
