"""The port's share of the JAX package's public API, read from
docs/api-manifest.json as JSON (no JAX import): every parallel name of the
manifest resolves on tiny_llm_tpu_torch.parallel, and the models names the
port added last (forward_full) on tiny_llm_tpu_torch.models."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import tiny_llm_tpu_torch.models as port_models  # noqa: E402
import tiny_llm_tpu_torch.parallel as port_parallel  # noqa: E402

MANIFEST = Path(__file__).resolve().parents[1] / "docs" / "api-manifest.json"
PREFIX = "tiny_llm_tpu.parallel."

# Ported: the mesh and SP (6 names), then TP, DP and EP (15 names), then
# pipeline.py, overlap.py and distributed.py (14 names).
PORTED = [
    "make_mesh", "ShardingConfig", "SPAttention", "SPAttention.flash", "SPAttention.paged",
    "combine_softmax_states",
    "param_shardings", "shard_params", "shard_kv_cache", "TPAttention", "TPAttention.flash",
    "TPAttention.paged", "paged_pool_spec", "DPPagedAttention", "DPPagedAttention.flash",
    "DPPagedAttention.paged", "DPPagedAttention.paged_update", "DPServing",
    "DPServing.create_batching_kv_cache", "DPServing.slot_replica", "EPMoE",
    "DecodePipeline", "DecodePipeline.decode", "DecodePipeline.prefill",
    "MicrobatchedPipeline", "PipelinedQwen3", "split_stages",
    "allgather_matmul", "matmul_reducescatter", "overlapped_tp_matmuls",
    "barrier", "host_local_requests", "initialize", "make_multihost_mesh", "runtime_topology",
]
MODELS_PREFIX = "tiny_llm_tpu.models."
# The models names the port added with the pipelines (the rest: ROADMAP.md).
MODELS = ["forward_full", "Qwen3Model.forward_full"]


def _resolve(name: str, module=port_parallel):
    obj = module
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _manifest_parallel() -> list[str]:
    names = json.loads(MANIFEST.read_text())
    return sorted(n[len(PREFIX):] for n in names if n.startswith(PREFIX))


def test_manifest_parallel_names_are_split_into_ported_and_missing():
    """Every parallel name of the manifest is ported: 35 of 35."""
    assert sorted(PORTED) == _manifest_parallel()
    assert len(PORTED) == 35


@pytest.mark.parametrize("name", PORTED)
def test_ported_parallel_name_resolves(name):
    assert callable(_resolve(name))


@pytest.mark.parametrize("name", MODELS)
def test_ported_models_name_resolves(name):
    names = json.loads(MANIFEST.read_text())
    assert MODELS_PREFIX + name in names
    assert callable(_resolve(name, port_models))
