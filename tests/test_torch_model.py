"""The port's Qwen3 slice (CPU, plain kernel versions) against the JAX
package's Qwen3Model (CPU, XLA route) on the same bridged weights, plus
the port's own invariants and its independence from JAX."""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu.ops.quantize import dequantize as jax_dequantize  # noqa: E402
from tiny_llm_tpu_torch.models import (  # noqa: E402
    Qwen3Config,
    Qwen3Model,
    from_jax_numpy,
    tiny_test_config,
)
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402
from tiny_llm_tpu_torch.ops import dequantize  # noqa: E402

from .torch_port import (  # noqa: E402
    f32,
    one_torch_thread,
    params_to_numpy,
    qt_to_numpy,
    real_checkpoint,
)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tiny_llm_tpu_torch"

# Logit tolerance (bf16 ladder, absolute): the JAX XLA route multiplies by
# bf16-rounded dequantized weights and takes an f32 softmax, the port's
# plain versions use f32 dequantized weights and the kernels' bf16
# probabilities. Random-init tiny logits are O(0.1-1).
LOGIT_ATOL = 3e-2


def _configs():
    return {
        "tiny": dict(num_hidden_layers=2),
        "gqa_d128": dict(num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, head_dim=128),
    }


def _pair(name: str, seed: int = 3):
    over = _configs()[name]
    jcfg = jax_tiny_config(**over)
    pcfg = tiny_test_config(**over)
    params = random_params(jcfg, key=seed)
    jm = JaxQwen3Model(params, jcfg, max_seq_len=128)
    pm = Qwen3Model(from_jax_numpy(params_to_numpy(params), pcfg, device="cpu"), pcfg,
                    max_seq_len=128, device="cpu")
    return params, jm, pm, jcfg


def _teacher_forced(jm, pm, prompt, steps):
    """Logits of both models over the prompt and `steps` decode steps, both
    fed the JAX model's greedy tokens."""
    cj, cp = jm.create_kv_cache(), pm.create_kv_cache()
    out = [(np.asarray(jm(jnp.asarray([prompt], jnp.int32), 0, cj), np.float32)[0],
            f32(pm([prompt], 0, cp)[0]))]
    offset = len(prompt)
    for _ in range(steps):
        tok = int(np.argmax(out[-1][0][-1]))
        out.append((np.asarray(jm(jnp.asarray([[tok]], jnp.int32), offset, cj),
                               np.float32)[0],
                    f32(pm([[tok]], offset, cp)[0])))
        offset += 1
    return out


def test_config_matches_jax_registry():
    from tiny_llm_tpu.models.registry import QWEN3_CONFIGS as JAX_CONFIGS

    from tiny_llm_tpu_torch.models import QWEN3_CONFIGS

    assert set(QWEN3_CONFIGS) == set(JAX_CONFIGS)
    for k, c in QWEN3_CONFIGS.items():
        assert vars(c) == vars(JAX_CONFIGS[k])
    assert vars(tiny_test_config(3)) == vars(jax_tiny_config(3))


def test_bridge_roundtrip_every_weight_bit_equal():
    params, _, pm, cfg = _pair("tiny")
    tree = params_to_numpy(params)
    layer = params.layers[0]
    for jqt in (params.embedding, params.lm_head, layer.attn.wq, layer.attn.wo,
                layer.mlp.w_gate, layer.mlp.w_down):
        port = quantized_from_numpy(qt_to_numpy(jqt))
        np.testing.assert_array_equal(
            f32(dequantize(port, torch.float32)), f32(jax_dequantize(jqt, jnp.float32))
        )
    # The tied head reads the embedding; the fused, interleaved qkv keeps
    # every bit of the three projections it is made of.
    from tiny_llm_tpu_torch.models.qwen3 import _qkv_interleave_perm

    assert pm.params.lm_head is None
    attn = from_jax_numpy(tree, cfg, device="cpu").layers[1].attn
    want = torch.cat([dequantize(w) for w in (attn.wq, attn.wk, attn.wv)])
    perm = _qkv_interleave_perm(attn)
    assert torch.equal(dequantize(pm.params.layers[1].attn.wqkv), want[perm])


@pytest.mark.parametrize("name", ["tiny", "gqa_d128"])
def test_slice_teacher_forced_logits_match_jax(name):
    _, jm, pm, _ = _pair(name)
    rng = np.random.default_rng(11)
    prompt = [int(t) for t in rng.integers(0, 128, size=21)]
    for want, got in _teacher_forced(jm, pm, prompt, steps=8):
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
        top2 = np.sort(want, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_ATOL
        np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


@pytest.mark.parametrize("name", ["tiny", "gqa_d128"])
def test_burst_matches_per_step_calls(name):
    _, _, pm, _ = _pair(name, seed=5)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    c = pm.create_kv_cache()
    first = int(pm([prompt], 0, c, logits_to_keep=1)[0, -1].float().argmax())
    burst = pm.decode_burst_dense(c, [first], 10)[:, 0].tolist()
    assert c.offset == len(prompt) + 10
    c2 = pm.create_kv_cache()
    logits = pm([prompt], 0, c2, logits_to_keep=1)
    tok = int(logits[0, -1].float().argmax())
    assert tok == first
    per_step = []
    for i in range(10):
        logits = pm([[tok]], len(prompt) + i, c2, logits_to_keep=1)
        tok = int(logits[0, -1].float().argmax())
        per_step.append(tok)
    assert burst == per_step


def test_sampled_burst_and_generate_loops():
    """A sampled burst forced to top-1 equals the greedy burst; the no-cache
    and cached generation loops emit the same text."""
    from tiny_llm_tpu_torch.generate import simple_generate, simple_generate_with_kv_cache
    from tiny_llm_tpu_torch.tokenizer import ByteTokenizer

    _, _, pm, _ = _pair("tiny", seed=7)
    runs = []
    for kw in ({}, {"temp": 0.7, "top_k": 1, "generator": torch.Generator().manual_seed(0)}):
        c = pm.create_kv_cache()
        pm([[5, 6, 7]], 0, c)
        runs.append(pm.decode_burst_dense(c, [9], 6, **kw))
    np.testing.assert_array_equal(runs[0], runs[1])
    with pytest.raises(ValueError):
        pm.decode_burst_dense(pm.create_kv_cache(), [9], 2, temp=0.5)
    tok = ByteTokenizer()
    assert simple_generate(pm, tok, "hey", max_tokens=6) == simple_generate_with_kv_cache(
        pm, tok, "hey", max_tokens=6
    )


def test_no_cache_call_matches_cached_prefill():
    _, _, pm, _ = _pair("tiny")
    prompt = [[7, 8, 9, 10, 11]]
    c = pm.create_kv_cache()
    torch.testing.assert_close(pm(prompt), pm(prompt, 0, c), rtol=0, atol=0)


def _real_checkpoint_teacher_forced(port_loads: bool):
    """The tiny real checkpoint (tests/torch_port.py real_checkpoint: the JAX
    suite's build when complete, else the port tests' own copy; not in the
    repository), loaded by the JAX package, and by the JAX package or the
    port for the port's model; teacher-forced logits of both models."""
    pytest.importorskip("transformers")
    pytest.importorskip("safetensors")
    real = Path(real_checkpoint("qwen3-tiny-real"))
    with one_torch_thread():
        _teacher_forced_on(real, port_loads)


def _teacher_forced_on(real: Path, port_loads: bool):
    import json

    from tiny_llm_tpu.models.loader import load_params
    from tiny_llm_tpu_torch.models import load_params as port_load_params

    params, jcfg = load_params(str(real), quantized=True)
    pcfg = Qwen3Config(**vars(jcfg))
    if port_loads:
        pparams, lcfg = port_load_params(str(real), device="cpu")
        assert lcfg == pcfg
    else:
        pparams = from_jax_numpy(params_to_numpy(params), pcfg, device="cpu")
    pm = Qwen3Model(pparams, pcfg, max_seq_len=256, device="cpu")
    with open(real / "oracle" / "greedy.json") as f:
        prompt = json.load(f)["prompt_ids"]
    # The prompt's rows take K1's staged route, which stages the dequantized
    # weight bf16(q * s + b): the JAX model's XLA route on the CPU.
    jm = JaxQwen3Model(params, jcfg, max_seq_len=256)
    for want, got in _teacher_forced(jm, pm, prompt, steps=8):
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


def test_real_checkpoint_teacher_forced_when_present():
    _real_checkpoint_teacher_forced(port_loads=False)


def test_real_checkpoint_teacher_forced_port_loaded():
    _real_checkpoint_teacher_forced(port_loads=True)


# ---------------------------------------------------------------------------
# Hygiene: the port stands without JAX.
# ---------------------------------------------------------------------------


def test_port_imports_and_runs_with_jax_unimportable():
    code = """
import sys
for name in list(sys.modules):
    if name == "jax" or name.startswith(("jax.", "jaxlib")):
        sys.modules[name] = None
sys.modules["jax"] = None
import tiny_llm_tpu_torch
from tiny_llm_tpu_torch.models import Qwen3Model, synthetic_quantized_params, tiny_test_config
from tiny_llm_tpu_torch.generate import simple_generate_with_kv_cache
from tiny_llm_tpu_torch.serving import batch_generate
from tiny_llm_tpu_torch.tokenizer import ByteTokenizer
cfg = tiny_test_config(num_hidden_layers=1, vocab_size=300)
m = Qwen3Model(synthetic_quantized_params(cfg, device="cpu"), cfg, max_seq_len=64, device="cpu")
text = simple_generate_with_kv_cache(m, ByteTokenizer(), "hi", max_tokens=3)
m.enable_paged_attention(num_pages=8, page_size=16)
served = batch_generate(m, ByteTokenizer(), ["hi", "there"], max_seq_len=64, batch_size=2,
                        max_output_tokens=3)
assert sorted(i for i, _ in served) == [0, 1]
assert not any(n == "tiny_llm_tpu" or n.startswith("tiny_llm_tpu.") for n in sys.modules)
print("OK", len(text))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("OK")


def test_port_sources_import_no_jax_and_no_jax_package():
    bad = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+tiny_llm_tpu(\.|\s|$)"
                     r"|from\s+tiny_llm_tpu(\.|\s))", re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    scanned = {f.relative_to(PORT).as_posix() for f in files if PORT in f.parents}
    assert {"kv/cache.py", "kv/paged.py", "serving/batch.py", "serving/metrics.py",
            "kernels/paged_attention.py", "kernels/fused_decode_attention.py",
            "models/qwen3.py"} <= scanned
    for f in files:
        assert not bad.search(f.read_text()), f


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    from tiny_llm_tpu_torch.kv import BatchingKVCache, DenseKVCache, PagePool
    from tiny_llm_tpu_torch.models import synthetic_quantized_params

    cfg = tiny_test_config()
    params = synthetic_quantized_params(cfg, device="cpu")
    for call in (lambda: Qwen3Model(params, cfg),
                 lambda: synthetic_quantized_params(cfg),
                 lambda: DenseKVCache(1, 1, 1, 8, 64),
                 lambda: BatchingKVCache(1, 2, 1, 8, 64),
                 lambda: PagePool(1, 4, 1, 8, 64)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert jax.default_backend() == "cpu"
