"""The JAX package's agent tests, run against the port's agent.

`load_cases(namespace, name)` reads tests/<name>.py, points every
`tiny_llm_tpu.agent` name at `tiny_llm_tpu_torch.agent` (imports, the
child processes' code, monkeypatch targets) and every
`from tiny_llm_tpu.models import` at tests/torch_agent_models.py, and
executes the result
in the calling test module's namespace, where pytest collects its cases
under their own names. The JAX test files stay as they are; a port test
module is two lines. This module imports nothing of JAX.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from _pytest.assertion.rewrite import rewrite_asserts

TESTS = Path(__file__).resolve().parent

# What the 12 test files of the pure-Python modules may import besides the
# standard library, pytest and the port's agent: nothing of JAX.
_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|tiny_llm_tpu(?!_torch)|\.utils)\b", re.M)


def port_source(name: str) -> str:
    """tests/<name>.py with the agent and model imports pointed at the port."""
    src = (TESTS / f"{name}.py").read_text()
    src = src.replace("from tiny_llm_tpu.models import", "from .torch_agent_models import")
    return re.sub(r"\btiny_llm_tpu\.agent\b", "tiny_llm_tpu_torch.agent", src)


def imports_jax(src: str) -> bool:
    return bool(_JAX_IMPORT.search(src))


def load_cases(namespace: dict, name: str, pure: bool = True) -> None:
    """Execute port_source(name) in `namespace` (a test module's globals),
    its asserts rewritten as pytest rewrites a test module's. `pure`: the
    file tests the pure-Python modules and must import nothing of JAX."""
    src = port_source(name)
    if pure and imports_jax(src):
        raise AssertionError(f"{name}: the port's copy still imports JAX")
    path = TESTS / f"{name}.py"
    tree = ast.parse(src, filename=str(path))
    rewrite_asserts(tree, src.encode(), module_path=path)
    exec(compile(tree, str(path), "exec"), namespace)

