"""The port's split paged prefill (kernels/split_prefill.py and the two state
kernels' plain versions, on the CPU) against the JAX package: the chunk-state
and prefix-state plain versions against the Pallas kernels in interpret mode,
the combine and the whole split against the JAX package's, the split against
the port's own unsplit paged attention, and a paged model whose offset > 0
chunk of 1024 tokens takes the split route against JAX's, all on the same
numpy inputs."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.flash_attention_pallas import flash_prefill_state_pallas  # noqa: E402
from tiny_llm_tpu.kernels.paged_attention_pallas import (  # noqa: E402
    paged_prefix_state as jax_paged_prefix_state,
)
from tiny_llm_tpu.kernels.split_prefill import (  # noqa: E402
    combine_state_pair as jax_combine,
)
from tiny_llm_tpu.kernels.split_prefill import (  # noqa: E402
    split_paged_prefill as jax_split,
)
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu_torch.kernels.flash_attention import (  # noqa: E402
    NEG_INF,
    flash_prefill_state,
)
from tiny_llm_tpu_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention,
    paged_prefix_state,
)
from tiny_llm_tpu_torch.kernels.split_prefill import (  # noqa: E402
    combine_state_pair,
    split_paged_prefill,
)
from tiny_llm_tpu_torch.models import Qwen3Model, from_jax_numpy, tiny_test_config  # noqa: E402

from .torch_port import bf16_numpy, f32, params_to_numpy  # noqa: E402
from .utils import assert_allclose  # noqa: E402

# Logit tolerance (bf16 ladder, absolute), as tests/test_torch_paged.py.
LOGIT_ATOL = 3e-2
# o: the bf16 ladder (one softmax where the kernels rescale per tile, bf16
# probabilities in the PV product), as tests/test_torch_paged.py. m and l
# are f32 sums of the same products in another order.
O_TOL = 2e-2
STATE_RTOL, STATE_ATOL = 1e-4, 1e-5

N_REPS = [1, 4, 8]
HEAD_DIMS = [64, 128]


def _chunk_case(rng, n_rep, D, B=2, Hkv=1, L=48):
    q_j, q_t = bf16_numpy(rng.standard_normal((B, Hkv * n_rep, L, D)))
    k_j, k_t = bf16_numpy(rng.standard_normal((B, Hkv, L, D)))
    v_j, v_t = bf16_numpy(rng.standard_normal((B, Hkv, L, D)))
    return (q_j, k_j, v_j), (q_t, k_t, v_t)


def _prefix_case(rng, n_rep, D, offsets, Hkv=1, ps=16, L=24):
    """Pages holding each row's prefix and then its chunk, as
    forward_step_paged leaves them (the chunk's k/v written first), over a
    shuffled pool whose free pages and trash page hold noise."""
    B = len(offsets)
    total = [o + L for o in offsets]
    used = [-(-n // ps) for n in total]
    P = sum(used) + 3
    maxp = max(used) + 1
    perm = rng.permutation(np.arange(1, P))
    bt = np.full((B, maxp), -1, np.int32)
    k = 0
    for b, n in enumerate(used):
        bt[b, :n] = perm[k : k + n]
        k += n
    kp = rng.standard_normal((P, Hkv, ps, D))
    vp = rng.standard_normal((P, Hkv, ps, D))
    q = rng.standard_normal((B, Hkv * n_rep, L, D))
    kc = np.zeros((B, Hkv, L, D))
    vc = np.zeros((B, Hkv, L, D))
    for b, o in enumerate(offsets):
        for t in range(L):
            page, slot = bt[b, (o + t) // ps], (o + t) % ps
            kc[b, :, t], vc[b, :, t] = kp[page, :, slot], vp[page, :, slot]
    return q, kc, vc, kp, vp, bt, np.asarray(offsets, np.int32)


def _assert_state(got, want):
    o, m, l = got
    o_w, m_w, l_w = (np.asarray(x, np.float32) for x in want)
    np.testing.assert_allclose(f32(o), o_w, rtol=O_TOL, atol=O_TOL)
    np.testing.assert_allclose(f32(m), m_w, rtol=STATE_RTOL, atol=STATE_ATOL)
    np.testing.assert_allclose(f32(l), l_w, rtol=STATE_RTOL, atol=STATE_ATOL)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("n_rep", N_REPS)
def test_chunk_state_plain_matches_pallas(n_rep, D):
    """Row 7: causal attention of a 48-token chunk over its own k/v (lens =
    L), against _prefill_state_kernel at 16-row tiles (three q and three k
    tiles; interpret mode reads a ragged tile's rows past the end as NaN)."""
    rng = np.random.default_rng(10 * n_rep + D)
    (q_j, k_j, v_j), (q_t, k_t, v_t) = _chunk_case(rng, n_rep, D)
    L = q_t.shape[2]
    scale = D**-0.5
    want = flash_prefill_state_pallas(q_j, k_j, v_j, jnp.full((2,), L, jnp.int32), scale=scale,
                                      causal=True, bq=16, bs=16, interpret=True)
    got = flash_prefill_state(q_t, k_t, v_t, torch.full((2,), L, dtype=torch.int32), scale)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    _assert_state(got, want)


@pytest.mark.parametrize("offsets", [(17, 0), (32, 16)], ids=["offset17_and_0", "page_aligned"])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("n_rep", N_REPS)
def test_prefix_state_plain_matches_pallas(n_rep, D, offsets):
    """Row 15: the chunk's queries over each row's prefix pages, against
    _paged_prefix_state_kernel; the chunk's own rows sit in the prefix's
    tail page and stay unread, and a prefix-0 row is exactly the identity."""
    rng = np.random.default_rng(100 * n_rep + D + offsets[0])
    q, _, _, kp, vp, bt, offs = _prefix_case(rng, n_rep, D, offsets)
    (q_j, q_t), (kp_j, kp_t), (vp_j, vp_t) = bf16_numpy(q), bf16_numpy(kp), bf16_numpy(vp)
    scale = D**-0.5
    want = jax_paged_prefix_state(q_j, kp_j, vp_j, jnp.asarray(bt), jnp.asarray(offs),
                                  scale=scale, bq=16, interpret=True)
    got = paged_prefix_state(q_t, kp_t, vp_t, torch.from_numpy(bt), torch.from_numpy(offs),
                             scale)
    _assert_state(got, want)
    for b in np.nonzero(offs == 0)[0]:
        assert torch.equal(got[0][b], torch.zeros_like(got[0][b]))
        assert bool((got[1][b] == NEG_INF).all()) and bool((got[2][b] == 0).all())


def test_combine_state_pair_matches_jax():
    """The f32 combine on the same bf16 halves and f32 states, with rows
    where one half is empty (the identity state) and one where both are."""
    rng = np.random.default_rng(3)
    shape = (2, 4, 8)
    o1_j, o1_t = bf16_numpy(rng.standard_normal(shape + (64,)))
    o2_j, o2_t = bf16_numpy(rng.standard_normal(shape + (64,)))
    m1, m2 = rng.standard_normal(shape) * 3, rng.standard_normal(shape) * 3
    l1, l2 = rng.uniform(0.5, 20, shape), rng.uniform(0.5, 20, shape)
    m1[0, 0], l1[0, 0] = NEG_INF, 0.0  # empty first half
    m2[1, 2], l2[1, 2] = NEG_INF, 0.0  # empty second half
    m1[1, 3, 5], l1[1, 3, 5], m2[1, 3, 5], l2[1, 3, 5] = NEG_INF, 0.0, NEG_INF, 0.0
    states = [x.astype(np.float32) for x in (m1, l1, m2, l2)]
    want = jax_combine(o1_j, *map(jnp.asarray, states[:2]), o2_j, *map(jnp.asarray, states[2:]))
    got = combine_state_pair(o1_t, *map(torch.from_numpy, states[:2]), o2_t,
                             *map(torch.from_numpy, states[2:]))
    assert got.dtype == torch.bfloat16
    assert_allclose(f32(got), f32(want), precision=jnp.bfloat16)
    assert torch.equal(got[1, 3, 5], torch.zeros_like(got[1, 3, 5]))


@pytest.mark.parametrize("offsets", [(17, 0), (32, 16)], ids=["offset17_and_0", "page_aligned"])
def test_split_paged_prefill_matches_jax_and_unsplit(offsets):
    """The whole split against the JAX package's (XLA route on the CPU) and
    against the port's own unsplit causal paged attention over the same
    pages."""
    rng = np.random.default_rng(offsets[0] + 7)
    q, kc, vc, kp, vp, bt, offs = _prefix_case(rng, 4, 64, offsets, Hkv=2)
    (q_j, q_t), (kc_j, kc_t), (vc_j, vc_t) = bf16_numpy(q), bf16_numpy(kc), bf16_numpy(vc)
    (kp_j, kp_t), (vp_j, vp_t) = bf16_numpy(kp), bf16_numpy(vp)
    L = q.shape[2]
    want = jax_split(q_j, kc_j, vc_j, kp_j, vp_j, jnp.asarray(bt), jnp.asarray(offs))
    got = split_paged_prefill(q_t, kc_t, vc_t, kp_t, vp_t, torch.from_numpy(bt),
                              torch.from_numpy(offs))
    assert got.dtype == torch.bfloat16 and got.shape == q_t.shape
    assert_allclose(f32(got), f32(want), precision=jnp.bfloat16, rtol=O_TOL, atol=O_TOL)
    unsplit = paged_attention(q_t, kp_t, vp_t, torch.from_numpy(bt), torch.from_numpy(offs + L))
    assert_allclose(f32(got), f32(unsplit), precision=jnp.bfloat16, rtol=O_TOL, atol=O_TOL)


def _assert_logits(got, want):
    got, want = f32(got), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


def test_paged_model_long_prompt_takes_split_and_matches_jax(monkeypatch):
    """A 2560-token prompt in chunks of 1024 (offset 0: K3 on the chunk),
    1024 (offset 1024: the split route, in both packages) and 512 (offset
    2048: paged attention), then 4 greedy decode steps: every logit row
    within the ladder and the greedy tokens equal."""
    import tiny_llm_tpu_torch.models.qwen3 as port_qwen3

    calls = []
    orig = port_qwen3.split_paged_prefill
    monkeypatch.setattr(port_qwen3, "split_paged_prefill",
                        lambda *a, **k: calls.append(a[0].shape) or orig(*a, **k))
    jcfg, pcfg = jax_tiny_config(num_hidden_layers=2), tiny_test_config(num_hidden_layers=2)
    params = random_params(jcfg, key=6)
    kw = dict(max_seq_len=2600)
    jm = JaxQwen3Model(params, jcfg, **kw).enable_paged_attention(num_pages=24, page_size=128)
    pm = Qwen3Model(from_jax_numpy(params_to_numpy(params), pcfg, device="cpu"), pcfg,
                    device="cpu", **kw).enable_paged_attention(num_pages=24, page_size=128)
    prompt = [int(t) for t in np.random.default_rng(2).integers(0, 128, size=2560)]
    cj, cp = jm.create_kv_cache(), pm.create_kv_cache()
    off = 0
    for L in (1024, 1024, 512):
        chunk = [prompt[off : off + L]]
        _assert_logits(pm(chunk, off, cp), jm(jnp.asarray(chunk, jnp.int32), off, cj))
        off += L
    assert calls == [(1, pcfg.num_attention_heads, 1024, pcfg.head_dim)] * 2  # one per layer
    want, got = [], []
    tj = tp = prompt[-1]
    for _ in range(4):
        lj = np.asarray(jm(jnp.asarray([[tj]], jnp.int32), off, cj), np.float32)
        lp = f32(pm([[tp]], off, cp))
        tj, tp = int(lj[0, -1].argmax()), int(lp[0, -1].argmax())
        want.append(tj)
        got.append(tp)
        off += 1
    assert got == want
    cp.release()
    assert pm.page_pool.live_pages == 0
