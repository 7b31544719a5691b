"""The port's checkpoint loading (models/safetensors_io.py,
models/loader.py) against `safetensors` and the JAX package's load_params:
the reader on every dtype and over two shards; the checkpoints that
tests/test_loader.py writes (float and MLX 4-bit exports, dense and MoE,
HF per-expert and switch_mlp) loaded by both packages, every weight
dequantized bit-equal and the config equal, quantized and dense (bf16,
f32); and teacher-forced logits of the loaded models against the JAX
models'."""

from __future__ import annotations

import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import load_params as jax_load_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Model, load_config, load_params  # noqa: E402
from tiny_llm_tpu_torch.models import safetensors_io  # noqa: E402
from tiny_llm_tpu_torch.ops.quantize import QuantizedTensor  # noqa: E402

from .torch_port import torch_one_thread  # noqa: E402,F401
from .torch_port import assert_loaded_equal, assert_logit_calls, teacher_forced  # noqa: E402

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _st():
    return pytest.importorskip("safetensors.numpy")


def _arrays(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "f16": rng.normal(size=(7,)).astype(np.float16),
        "bf16": rng.normal(size=(4, 3)).astype(ml_dtypes.bfloat16),
        "u32": rng.integers(0, 2**32, size=(2, 3), dtype=np.uint32),
        "i32": rng.integers(-9, 9, size=(3,), dtype=np.int32),
        "i64": rng.integers(-9, 9, size=(3, 1), dtype=np.int64),
        "u8": rng.integers(0, 255, size=(5,), dtype=np.uint8),  # odd size: misaligns the next
        "after_u8": rng.normal(size=(2, 2)).astype(np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def test_reader_matches_safetensors_on_every_dtype_and_two_shards(tmp_path):
    st = _st()
    a, b = _arrays(0), {f"second.{k}": v for k, v in _arrays(1).items()}
    st.save_file(a, str(tmp_path / "model-00002-of-00002.safetensors"))
    st.save_file(b, str(tmp_path / "model-00001-of-00002.safetensors"))
    got = safetensors_io.load_dir(str(tmp_path))
    assert set(got) == set(a) | set(b)
    for name, want in {**a, **b}.items():
        ref = st.load_file(str(tmp_path / ("model-00001-of-00002.safetensors" if name in b else
                                           "model-00002-of-00002.safetensors")))[name]
        t = got[name]
        assert tuple(t.shape) == want.shape, name
        np.testing.assert_array_equal(_bits(t), np.ascontiguousarray(ref).view(np.uint8).ravel()
                                      if ref.size else np.zeros(0, np.uint8), err_msg=name)
        assert t.dtype == {"bf16": torch.bfloat16, "u32": torch.int32, "f16": torch.float16,
                           "i64": torch.int64, "u8": torch.uint8}.get(name.split(".")[-1],
                                                                       t.dtype)
    # The writer's files read back the same through `safetensors`.
    safetensors_io.save_file({k: got[k] for k in a}, str(tmp_path / "again.bin"))
    back = st.load_file(str(tmp_path / "again.bin"))
    for name, want in a.items():
        if name == "u32":  # written as the I32 view it was read as
            want = want.view(np.int32)
        np.testing.assert_array_equal(back[name].view(np.uint8), want.view(np.uint8))
    (tmp_path / "nothing").mkdir()
    with pytest.raises(FileNotFoundError):
        safetensors_io.load_dir(str(tmp_path / "nothing"))


# ---------------------------------------------------------------------------
# tests/test_loader.py's checkpoints, loaded by both packages.
# ---------------------------------------------------------------------------


def _write(kind: str, d) -> None:
    _st()
    from .test_loader import _moe_cfg, _write_moe_checkpoint, write_checkpoint

    os.makedirs(d, exist_ok=True)
    if kind in ("float", "mlx4bit"):
        write_checkpoint(d, jax_tiny_config(num_hidden_layers=2), kind == "mlx4bit")
    else:
        _write_moe_checkpoint(str(d), _moe_cfg(), kind.split("_")[1])


KINDS = ["float", "mlx4bit", "moe_hf", "moe_mlx"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    for kind in KINDS:
        _write(kind, root / kind)
    return {k: str(root / k) for k in KINDS}


def _jax_dtype(dtype):
    return {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("quantized,dtype", [(True, torch.bfloat16), (False, torch.bfloat16),
                                             (False, torch.float32)],
                         ids=["w4a16", "bf16", "f32"])
def test_load_params_bit_equal_to_jax(checkpoints, kind, quantized, dtype):
    d = checkpoints[kind]
    jp, jcfg = jax_load_params(d, quantized=quantized, dtype=_jax_dtype(dtype))
    pp, pcfg = load_params(d, quantized=quantized, dtype=dtype, device="cpu")
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pcfg == load_config(d)
    assert_loaded_equal(jp, pp)
    if kind == "mlx4bit" or quantized:
        assert isinstance(pp.layers[0].attn.wq, QuantizedTensor)
    if kind == "moe_hf":  # a float router stays dense, quantized or not
        assert not isinstance(pp.layers[0].mlp.w_router, QuantizedTensor)


@pytest.mark.parametrize("kind,quantized,dtype", [
    ("float", True, torch.bfloat16), ("mlx4bit", True, torch.bfloat16),
    ("float", False, torch.bfloat16), ("moe_hf", True, torch.bfloat16),
    ("moe_mlx", True, torch.bfloat16), ("float", False, torch.float32),
    ("moe_hf", False, torch.float32),
])
def test_loaded_models_teacher_forced_against_jax(checkpoints, kind, quantized, dtype):
    """Logits over a 12-token prompt in two chunks and 4 decode steps (at most
    12 rows through K1's plain route: K1's <= 32-row arithmetic, which the
    JAX XLA route matches within the bf16 ladder)."""
    d = checkpoints[kind]
    jp, jcfg = jax_load_params(d, quantized=quantized, dtype=_jax_dtype(dtype))
    pp, pcfg = load_params(d, quantized=quantized, dtype=dtype, device="cpu")
    jm = JaxQwen3Model(jp, jcfg, max_seq_len=64)
    pm = Qwen3Model(pp, pcfg, max_seq_len=64, device="cpu")
    assert pm.dtype == dtype
    calls = teacher_forced(jm, pm, chunks=(8, 4), steps=4, seed=5)
    if dtype == torch.float32:
        for want, got in calls:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        assert_logit_calls(calls)


def test_f32_model_stays_off_the_card(checkpoints):
    pp, pcfg = load_params(checkpoints["float"], quantized=False, dtype=torch.float32,
                           device="cpu")
    m = Qwen3Model(pp, pcfg, max_seq_len=64, device="cpu")
    assert m.dtype == torch.float32 and m.create_kv_cache().keys.dtype == torch.float32
    if torch.cuda.is_available():
        pc = load_params(checkpoints["float"], quantized=False, dtype=torch.float32,
                         device="cuda")[0]
        with pytest.raises(ValueError, match="CPU only"):
            Qwen3Model(pc, pcfg, device="cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_params(checkpoints["float"])


def test_random_params_registry_and_the_card():
    from tiny_llm_tpu.models import registry as jax_registry
    from tiny_llm_tpu_torch.models import (
        MODEL_SHORTCUTS,
        QWEN3_CONFIGS,
        dispatch_model,
        random_params,
        tiny_test_config,
    )

    assert MODEL_SHORTCUTS == jax_registry.MODEL_SHORTCUTS
    cfg = tiny_test_config(num_hidden_layers=1)
    q = random_params(cfg, seed=1, device="cpu")
    again = random_params(cfg, seed=1, device="cpu")
    assert isinstance(q.layers[0].attn.wq, QuantizedTensor) and q.lm_head is None
    assert torch.equal(q.layers[0].attn.wq.packed, again.layers[0].attn.wq.packed)
    d = random_params(cfg, seed=1, quantized=False, dtype=torch.float32, device="cpu")
    assert d.embedding.dtype == torch.float32 and tuple(d.embedding.shape) == (128, 128)
    m = dispatch_model("ignored", d, cfg, max_seq_len=32, device="cpu")
    assert tuple(m([[1, 2, 3]]).shape) == (1, 3, 128)
    with pytest.raises(ValueError, match="unknown model"):
        dispatch_model("qwen9", d)
    assert set(QWEN3_CONFIGS) == set(MODEL_SHORTCUTS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            random_params(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dispatch_model("qwen3-0.6b", d)
