"""The port's share of the JAX package's public API, read from
docs/api-manifest.json as JSON (no JAX import): each parallel name that the
port has ported resolves on tiny_llm_tpu_torch.parallel, and each that it
has not does not yet (the next slice turns those on, moving them across)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import tiny_llm_tpu_torch.parallel as port_parallel  # noqa: E402

MANIFEST = Path(__file__).resolve().parents[1] / "docs" / "api-manifest.json"
PREFIX = "tiny_llm_tpu.parallel."

# Ported: the mesh and SP (6 names), then TP, DP and EP (15 names).
PORTED = [
    "make_mesh", "ShardingConfig", "SPAttention", "SPAttention.flash", "SPAttention.paged",
    "combine_softmax_states",
    "param_shardings", "shard_params", "shard_kv_cache", "TPAttention", "TPAttention.flash",
    "TPAttention.paged", "paged_pool_spec", "DPPagedAttention", "DPPagedAttention.flash",
    "DPPagedAttention.paged", "DPPagedAttention.paged_update", "DPServing",
    "DPServing.create_batching_kv_cache", "DPServing.slot_replica", "EPMoE",
]
# Still missing: pipeline.py, overlap.py and distributed.py.
MISSING = [
    "DecodePipeline", "DecodePipeline.decode", "DecodePipeline.prefill",
    "MicrobatchedPipeline", "PipelinedQwen3", "split_stages",
    "allgather_matmul", "matmul_reducescatter", "overlapped_tp_matmuls",
    "barrier", "host_local_requests", "initialize", "make_multihost_mesh", "runtime_topology",
]


def _resolve(name: str):
    obj = port_parallel
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _manifest_parallel() -> list[str]:
    names = json.loads(MANIFEST.read_text())
    return sorted(n[len(PREFIX):] for n in names if n.startswith(PREFIX))


def test_manifest_parallel_names_are_split_into_ported_and_missing():
    assert sorted(PORTED + MISSING) == _manifest_parallel()
    assert len(PORTED) == 21 and len(MISSING) == 14


@pytest.mark.parametrize("name", PORTED)
def test_ported_parallel_name_resolves(name):
    assert callable(_resolve(name))


@pytest.mark.parametrize("name", MISSING)
def test_missing_parallel_name_is_not_there_yet(name):
    with pytest.raises(AttributeError):
        _resolve(name)
