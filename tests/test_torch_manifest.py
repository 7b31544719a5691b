"""The port against the JAX package's public API, read from
docs/api-manifest.json as JSON (no JAX import): every name
`tiny_llm_tpu.X.rest` of the manifest resolves as `tiny_llm_tpu_torch.X.rest`,
a class where the manifest lists a class and a callable elsewhere."""

from __future__ import annotations

import importlib
import inspect
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

MANIFEST = Path(__file__).resolve().parents[1] / "docs" / "api-manifest.json"
NAMES = json.loads(MANIFEST.read_text())

# Manifest functions whose name the port gives to the module that holds
# them (tests and tools import these modules, as `kernels.quant_matmul`):
# the module's attribute of the same name is the function.
MODULE_NAMED = {"tiny_llm_tpu.ops.quantize", "tiny_llm_tpu.kernels.axpby",
                "tiny_llm_tpu.kernels.flash_attention", "tiny_llm_tpu.kernels.paged_attention"}


def _resolve(name: str):
    """The port's object for the manifest's `name`."""
    _, package, *rest = name.split(".")
    obj = importlib.import_module(f"tiny_llm_tpu_torch.{package}")
    for part in rest:
        obj = getattr(obj, part)
    if inspect.ismodule(obj) and name in MODULE_NAMED:
        obj = getattr(obj, rest[-1])
    return obj


def _missing() -> list[str]:
    out = []
    for name in NAMES:
        try:
            _resolve(name)
        except AttributeError:
            out.append(name)
    return out


def test_manifest_parallel_names_are_split_into_ported_and_missing():
    """Every name of the manifest is ported: 242 of 242 (the 35 parallel
    names among them), none missing."""
    assert len(NAMES) == 242
    assert sum(n.startswith("tiny_llm_tpu.parallel.") for n in NAMES) == 35
    assert _missing() == []


@pytest.mark.parametrize("name", sorted(NAMES))
def test_manifest_name_resolves(name):
    obj = _resolve(name)
    if NAMES[name].startswith("class("):
        assert inspect.isclass(obj), (name, obj)
    else:
        assert callable(obj) and not inspect.isclass(obj), (name, obj)
