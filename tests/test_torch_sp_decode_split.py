"""The shard decode-state walk's split and combine (csrc/flash_attention.cu
flash_decode_walk and state_combine: one shard of a dense slab, each row's
keys cut into splits of decode_split keys, a partial state per split,
merged in f32) in plain PyTorch, `flash_decode_state_split_plain`, against
the unsplit plain version (bit-equal at one split) and against the JAX
package's `flash_decode_state_pallas` in interpret mode, with rows whose
keys end at a split's boundary (127, 128, 129), at L = 1, 8, 16, n_rep 1-8
and D 64 and 128; an empty shard; the host's split chooser; and the
launcher's refusal of CPU tensors."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.flash_attention_pallas import flash_decode_state_pallas  # noqa: E402
from tiny_llm_tpu_torch.kernels import flash_attention as ka  # noqa: E402
from tiny_llm_tpu_torch.kernels import paged_attention as pa  # noqa: E402

from .torch_port import bf16_numpy, f32  # noqa: E402
from .utils import assert_allclose  # noqa: E402

HKV, S_LOC = 2, 256  # one shard of 256 keys: two splits of 128
LENS = np.asarray([127, 128, 129, 256], np.int32)  # a split's last key, its first, one past
STATE_TOL = 1e-3  # m and l where l > 0: f32 sums of the same terms in another order
KPS = pa.decode_split(len(LENS), HKV, S_LOC, 1, 132)  # the launcher's split on an H100


def _case(n_rep, D, L, seed):
    """q, and K/V as a strided shard (shard 1 of a slab of 3 shards)."""
    rng = np.random.default_rng(seed)
    B = len(LENS)
    q = bf16_numpy(rng.standard_normal((B, HKV * n_rep, L, D)))
    k = bf16_numpy(rng.standard_normal((B, HKV, 3 * S_LOC, D)))
    v = bf16_numpy(rng.standard_normal((B, HKV, 3 * S_LOC, D)))
    cut = slice(S_LOC, 2 * S_LOC)
    return q, (k[0][:, :, cut], k[1][:, :, cut]), (v[0][:, :, cut], v[1][:, :, cut])


# Each n_rep at both head dims, each L at least twice (a Pallas compile a case).
CASES = [(1, 64, 1), (1, 128, 8), (2, 64, 16), (2, 128, 1), (4, 64, 8), (4, 128, 16),
         (8, 64, 1), (8, 128, 16), (8, 128, 8)]


@pytest.mark.parametrize("n_rep,D,L", CASES)
def test_split_walk_matches_pallas_at_split_boundaries(n_rep, D, L):
    """The split model (splits of 128 keys) against
    _decode_state_kernel in interpret mode: o at the bf16 ladder (p is
    rounded against each split's max), m and l within STATE_TOL where l > 0,
    rows that see no key exactly (0, NEG_INF, 0) with no NaN."""
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = _case(n_rep, D, L, 100 * n_rep + D + L)
    assert not k_t.is_contiguous()
    scale, kps = D**-0.5, KPS
    assert kps == 128
    got = ka.flash_decode_state_split_plain(q_t, k_t, v_t, torch.from_numpy(LENS), scale, kps)
    want = flash_decode_state_pallas(q_j, k_j, v_j, jnp.asarray(LENS), scale=scale,
                                     interpret=True)
    o, m, l = (f32(t) for t in got)
    o_w, m_w, l_w = (np.asarray(t, np.float32) for t in want)
    assert np.isfinite(o).all() and np.isfinite(m).all() and np.isfinite(l).all()
    assert_allclose(o, o_w, jnp.bfloat16)
    live = l_w > 0
    assert live.all()  # every row sees a key: lens >= L here
    np.testing.assert_allclose(m, m_w, rtol=STATE_TOL, atol=STATE_TOL)
    np.testing.assert_allclose(l, l_w, rtol=STATE_TOL, atol=STATE_TOL)


@pytest.mark.parametrize("n_rep,L", [(1, 1), (4, 8), (8, 16)])
def test_one_split_is_the_unsplit_plain_version(n_rep, L):
    """With every key in one split the combine's weight is exactly 1: the
    split model is bit-equal to flash_decode_state_plain, and within the
    bf16 ladder of it at the launcher's split."""
    (_, q), (_, k), (_, v) = _case(n_rep, 64, L, 7 + n_rep + L)
    lens = torch.from_numpy(np.asarray([0, 3, 200, 256], np.int32))
    scale = 64**-0.5
    unsplit = ka.flash_decode_state_plain(q, k, v, lens, scale)
    for a, b in zip(ka.flash_decode_state_split_plain(q, k, v, lens, scale, S_LOC), unsplit):
        np.testing.assert_array_equal(f32(a), f32(b))
    split = ka.flash_decode_state_split_plain(q, k, v, lens, scale, KPS)
    assert_allclose(f32(split[0]), f32(unsplit[0]), jnp.bfloat16)


def test_empty_shard_is_exactly_the_identity():
    """A shard past every row's length (lens 0, as every shard past a
    decode row's context gets) and a row shorter than its queries: each
    row that sees no key is (0, NEG_INF, 0), with no NaN."""
    (_, q), (_, k), (_, v) = _case(4, 128, 8, 3)
    for lens in ([0, 0, 0, 0], [0, 2, 129, 0]):
        lt = torch.tensor(lens, dtype=torch.int32)
        o, m, l = ka.flash_decode_state_split_plain(q, k, v, lt, 128**-0.5, 128)
        want = ka.flash_decode_state_plain(q, k, v, lt, 128**-0.5)
        empty = want[2] == 0
        assert bool(empty.any())
        assert not bool(o[empty].any()) and bool((m[empty] == ka.NEG_INF).all())
        assert not bool(l[empty].any())
        assert bool(torch.isfinite(o.float()).all() & torch.isfinite(m).all())


def test_split_chooser_depends_on_shapes_only():
    """The launcher's split, decode_split(B, Hkv, S, 1, SMs): whole 64-key
    tiles, at least DECODE_MIN_KEYS, from the shapes alone (the function
    takes no lengths); Qwen3-4B's full shard of 1024 keys at B = 1 gives 8
    splits of 128 (a 64-block grid), and a shard of 8192 keys fills the
    132 SMs twice."""
    assert pa.decode_split(1, 8, 1024, 1, 132) == 128
    assert pa.decode_split(4, 8, 1024, 1, 132) == 128
    for b, hkv, s in [(1, 8, 1024), (4, 8, 1024), (1, 4, 1024), (1, 8, 8192), (2, 2, 256),
                      (16, 8, 1024), (1, 8, 16)]:
        kps = pa.decode_split(b, hkv, s, 1, 132)
        assert kps % pa.KEY_TILE == 0 and kps >= pa.DECODE_MIN_KEYS
        splits = -(-s // kps)
        assert splits * b * hkv >= 264 or kps == pa.DECODE_MIN_KEYS


def test_decode_state_launcher_refuses_cpu_tensors():
    """On the CPU the wrapper runs the plain version; the launcher itself
    never falls back: a CPU tensor raises before any build, and nothing is
    counted."""
    (_, q), (_, k), (_, v) = _case(4, 128, 1, 0)
    before = ka.DECODE_STATE_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ka.flash_decode_state_cuda(q, k, v, torch.from_numpy(LENS), 128**-0.5)
    assert ka.DECODE_STATE_LAUNCHES == before
