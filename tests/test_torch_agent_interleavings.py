"""tests/test_agent_interleavings.py's cases against the port's agent
(tests/torch_agent_port.py), its GenerationSession cases on the port's
Qwen3Model over the JAX package's random_params (tests/torch_agent_models.py)."""

import pytest

torch = pytest.importorskip("torch")

from .torch_agent_port import load_cases  # noqa: E402
from .torch_port import torch_one_thread  # noqa: E402,F401

load_cases(globals(), "test_agent_interleavings", pure=False)
pytestmark = pytest.mark.usefixtures("torch_one_thread")
