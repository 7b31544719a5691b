"""Helpers for the tests that hold tiny_llm_tpu_torch against tiny_llm_tpu.

Only tests import both packages; data crosses between them as numpy."""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tiny_llm_tpu.ops.quantize import QuantizedTensor as JaxQT


def qt_to_numpy(qt: JaxQT) -> dict:
    """A JAX QuantizedTensor as the bridge's dict of numpy arrays + static fields."""
    return {
        "packed": np.asarray(qt.packed),
        "scales": np.asarray(qt.scales),
        "biases": np.asarray(qt.biases),
        "layout": qt.layout,
        "group_size": qt.group_size,
        "bits": qt.bits,
        "out_features": qt.out_features,
        "in_features": qt.in_features,
        "k_padded": qt.k_padded,
    }


def params_to_numpy(params) -> dict:
    """The JAX package's unfused Qwen3Params as the bridge's nested dict."""
    layers = []
    for layer in params.layers:
        a, m = layer.attn, layer.mlp
        layers.append({
            "input_layernorm": np.asarray(layer.input_layernorm),
            "post_attention_layernorm": np.asarray(layer.post_attention_layernorm),
            "attn": {
                "wq": qt_to_numpy(a.wq), "wk": qt_to_numpy(a.wk),
                "wv": qt_to_numpy(a.wv), "wo": qt_to_numpy(a.wo),
                "q_norm": np.asarray(a.q_norm), "k_norm": np.asarray(a.k_norm),
            },
            "mlp": {
                "w_gate": qt_to_numpy(m.w_gate), "w_up": qt_to_numpy(m.w_up),
                "w_down": qt_to_numpy(m.w_down),
            },
        })
    return {
        "embedding": qt_to_numpy(params.embedding),
        "lm_head": None if params.lm_head is None else qt_to_numpy(params.lm_head),
        "final_norm": np.asarray(params.final_norm),
        "layers": layers,
    }


def f32(x) -> np.ndarray:
    """Any JAX array or torch tensor as a float32 numpy array."""
    if hasattr(x, "detach"):
        return x.detach().to("cpu").float().numpy()
    return np.asarray(x, dtype=np.float32)


def bf16_numpy(x: np.ndarray):
    """The same values as a JAX bf16 array and a torch bf16 tensor."""
    import jax.numpy as jnp
    import torch

    j = jnp.asarray(x, dtype=jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(torch.bfloat16)
    return j, t


# Logit tolerance (bf16 ladder, absolute), as tests/test_torch_model.py.
LOGIT_ATOL = 3e-2


def teacher_forced(jm, pm, chunks, steps, seed: int = 11):
    """Logits of a JAX and a port model over prompt chunks (one cache each)
    then `steps` decode steps, both fed the JAX model's greedy tokens:
    [(jax, port)] float32 numpy [L, V] per call."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    prompt = [int(t) for t in rng.integers(0, pm.vocab_size, size=sum(chunks))]
    cj, cp = jm.create_kv_cache(), pm.create_kv_cache()
    calls, off = [], 0
    for L in chunks:
        chunk = [prompt[off : off + L]]
        calls.append((np.asarray(jm(jnp.asarray(chunk, jnp.int32), off, cj), np.float32)[0],
                      f32(pm(chunk, off, cp)[0])))
        off += L
    for _ in range(steps):
        tok = int(np.argmax(calls[-1][0][-1]))
        calls.append((np.asarray(jm(jnp.asarray([[tok]], jnp.int32), off, cj), np.float32)[0],
                      f32(pm([[tok]], off, cp)[0])))
        off += 1
    return calls


def assert_logit_calls(calls, skip=frozenset(), atol: float = LOGIT_ATOL):
    """Each call's port logits within `atol` of JAX's and top-1 equal where
    JAX's top-2 gap exceeds 2 * atol; positions (call, row) in `skip` are
    left out."""
    for c, (want, got) in enumerate(calls):
        keep = [t for t in range(want.shape[0]) if (c, t) not in skip]
        want, got = want[keep], got[keep]
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)
        top2 = np.sort(want, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * atol
        np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


@contextlib.contextmanager
def one_torch_thread():
    """torch at one intra-op thread inside the block, restored after: the
    port tests' tensors are small, and under the suite's parallel workers
    torch's per-op thread pool spends more time waiting than computing."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def torch_one_thread():
    """one_torch_thread around a whole module's tests."""
    with one_torch_thread():
        yield


REPO = Path(__file__).resolve().parents[1]
ARTIFACTS = REPO / ".artifacts"
BUILD_SCRIPT = REPO / "scripts" / "make_real_checkpoint.py"


def _complete(d: Path, digest: str) -> bool:
    """A checkpoint whose build ran to its end: the build script writes its
    oracle, then the digest of its inputs is stamped."""
    stamp = d / ".builder-sha256"
    return (stamp.exists() and stamp.read_text().strip() == digest
            and (d / "oracle" / "greedy.json").exists())


# The root markdown files of the port's checkpoints' tokenizer corpus: of
# the root *.md files the build script's rule takes in, those no change
# edits. The documents each change edits (README.md, ROADMAP.md, CHANGES.md,
# PERF.md) and the task files written for each change stay out, so that
# their text never moves a prompt id.
FROZEN_ROOT_MD = ("ADVICE.md", "BASELINE.md", "PAPER.md", "PAPERS.md", "PERFORMANCE.md",
                  "SNIPPETS.md", "SURVEY.md", "VERDICT.md")


def _script():
    spec = importlib.util.spec_from_file_location("_make_real_checkpoint", BUILD_SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def frozen_corpus(repo: Path = REPO) -> list[str]:
    """The tokenizer corpus of the port's checkpoints, as paths relative to
    `repo`: the build script's own rule (root *.md, docs/*.md, the JAX
    package's sources, scripts/*.py), its root files limited to
    FROZEN_ROOT_MD."""
    rels = (os.path.relpath(f, repo) for f in _script()._corpus_files(str(repo)))
    return sorted(r for r in rels if "/" in r or r in FROZEN_ROOT_MD)


def stage_build_root(dest: Path, repo: Path = REPO) -> Path:
    """A build root at `dest` holding a copy of the build script under
    scripts/ (so that the script takes `dest` as its repo root) and copies
    of frozen_corpus(repo), nothing else; an earlier `dest` is replaced."""
    if dest.exists():
        shutil.rmtree(dest)
    for rel in frozen_corpus(repo) + [os.path.relpath(BUILD_SCRIPT, REPO)]:
        (dest / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(repo / rel, dest / rel)
    return dest


def _build_digest(root: Path) -> str:
    """sha256 over what a build from the staged `root` reads: its build
    script and the corpus the script finds there."""
    script = root / os.path.relpath(BUILD_SCRIPT, REPO)
    h = hashlib.sha256(script.read_bytes())
    for f in _script()._corpus_files(str(root)):
        h.update(os.path.relpath(f, root).encode() + b"\0")
        h.update(Path(f).read_bytes())
    return h.hexdigest()


def real_checkpoint(variant: str, extra: tuple[str, ...] = ()) -> str:
    """The HF checkpoint `variant` of scripts/make_real_checkpoint.py, as a
    private copy `.artifacts/torch-<variant>` built from a staged root
    (stage_build_root: the script and the frozen corpus), stamped with that
    root's _build_digest and built anew when the stamp differs, once under
    a file lock (xdist workers may ask at the same time). The JAX suite's
    `.artifacts/<variant>` is not used: its stamp covers the script alone,
    and its tokenizer trains on every root *.md file of its tree."""
    own = ARTIFACTS / f"torch-{variant}"
    ARTIFACTS.mkdir(exist_ok=True)
    with open(ARTIFACTS / f".torch-{variant}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        root = stage_build_root(ARTIFACTS / f"torch-{variant}.root")
        digest = _build_digest(root)
        if not _complete(own, digest):
            env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
            script = root / os.path.relpath(BUILD_SCRIPT, REPO)
            subprocess.run([sys.executable, str(script), "--out", str(own), *extra],
                           check=True, env=env, timeout=600, capture_output=True)
            (own / ".builder-sha256").write_text(digest)
    return str(own)


def _dequant_f32(w) -> np.ndarray:
    """A weight of either package, dequantized (or dense) as float32 numpy."""
    import torch

    from tiny_llm_tpu.ops.quantize import dequantize as jax_dequantize
    from tiny_llm_tpu_torch.ops.quantize import QuantizedTensor as PortQT
    from tiny_llm_tpu_torch.ops.quantize import dequantize as port_dequantize

    if isinstance(w, JaxQT):
        import jax.numpy as jnp

        return np.asarray(jax_dequantize(w, jnp.float32), np.float32)[..., : w.in_features]
    if isinstance(w, PortQT):
        return port_dequantize(w, torch.float32).numpy()
    return f32(w)


def assert_loaded_equal(jp, pp) -> None:
    """Every weight of the JAX package's params `jp` and the port's `pp`
    (both unfused, as the loaders return them) bit-equal once dequantized to
    f32, each weight quantized on both sides or dense on both; a tied head
    is the port's None (the JAX package keeps a copy of the embedding)."""
    from tiny_llm_tpu_torch.ops.quantize import QuantizedTensor as PortQT

    def same(a, b, what):
        assert isinstance(a, JaxQT) == isinstance(b, PortQT), what
        if not isinstance(a, JaxQT):
            assert np.dtype(str(np.asarray(a).dtype)).itemsize == b.element_size(), what
        x, y = _dequant_f32(a), _dequant_f32(b)
        assert x.shape == y.shape, (what, x.shape, y.shape)
        np.testing.assert_array_equal(y, x, err_msg=what)

    same(jp.embedding, pp.embedding, "embedding")
    same(jp.final_norm, pp.final_norm, "final_norm")
    if pp.lm_head is not None:
        same(jp.lm_head, pp.lm_head, "lm_head")
    elif jp.lm_head is not None:
        same(jp.lm_head, pp.embedding, "tied lm_head")
    assert len(jp.layers) == len(pp.layers)
    for i, (a, b) in enumerate(zip(jp.layers, pp.layers)):
        for name in ("input_layernorm", "post_attention_layernorm"):
            same(getattr(a, name), getattr(b, name), f"layer {i} {name}")
        for name in ("wq", "wk", "wv", "wo", "q_norm", "k_norm"):
            same(getattr(a.attn, name), getattr(b.attn, name), f"layer {i} attn.{name}")
        names = ("w_router", "w_gate", "w_up", "w_down") if hasattr(a.mlp, "w_router") else (
            "w_gate", "w_up", "w_down")
        for name in names:
            same(getattr(a.mlp, name), getattr(b.mlp, name), f"layer {i} mlp.{name}")


def port_params(params, cfg, device: str = "cpu"):
    """The JAX package's unfused Qwen3Params, quantized or dense, dense or
    MoE layers, as the port's (dense arrays keep their dtype; a tied head
    is the embedding)."""
    import torch

    from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy
    from tiny_llm_tpu_torch.models.qwen3 import (AttentionParams, BlockParams, MLPParams,
                                                 MoEParams, Qwen3Params)

    def w(x):
        if isinstance(x, JaxQT):
            return quantized_from_numpy(qt_to_numpy(x)).to(device)
        t = torch.from_numpy(np.asarray(x, np.float32))
        return t.to(device=device, dtype=torch.bfloat16 if str(x.dtype) == "bfloat16"
                    else torch.float32)

    layers = []
    for layer in params.layers:
        a, m = layer.attn, layer.mlp
        mlp = (MoEParams(w_router=w(m.w_router), w_gate=w(m.w_gate), w_up=w(m.w_up),
                         w_down=w(m.w_down)) if hasattr(m, "w_router") else
               MLPParams(w_gate=w(m.w_gate), w_up=w(m.w_up), w_down=w(m.w_down)))
        layers.append(BlockParams(
            input_layernorm=w(layer.input_layernorm),
            post_attention_layernorm=w(layer.post_attention_layernorm),
            attn=AttentionParams(wq=w(a.wq), wk=w(a.wk), wv=w(a.wv), wo=w(a.wo),
                                 q_norm=w(a.q_norm), k_norm=w(a.k_norm)),
            mlp=mlp))
    lm_head = None if cfg.tie_word_embeddings else w(params.lm_head)
    return Qwen3Params(embedding=w(params.embedding), layers=layers,
                       final_norm=w(params.final_norm), lm_head=lm_head)
