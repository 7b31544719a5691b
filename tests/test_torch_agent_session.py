"""tests/test_agent_session.py's cases against the port's agent
(tests/torch_agent_port.py); the copy imports nothing of JAX."""

from .torch_agent_port import load_cases

load_cases(globals(), "test_agent_session")
