"""The models of the JAX package's generation tests, as the port's: the
JAX test files' `from tiny_llm_tpu.models import Qwen3Model, random_params,
tiny_test_config` reads this module in their port copies
(tests/torch_agent_port.py), so `Qwen3Model(random_params(cfg, key=0), cfg,
max_seq_len=256)` is the port's model on the CPU over the JAX package's
params, bridged through numpy."""

from __future__ import annotations

import dataclasses

from tiny_llm_tpu.models import random_params, tiny_test_config  # noqa: F401

from .torch_port import params_to_numpy


def Qwen3Model(params, cfg, max_seq_len: int | None = None):
    """The port's Qwen3Model on the CPU over the JAX package's `params`
    and config `cfg` (the signature the JAX tests call)."""
    from tiny_llm_tpu_torch.models import Qwen3Config
    from tiny_llm_tpu_torch.models import Qwen3Model as PortModel
    from tiny_llm_tpu_torch.models.bridge import from_jax_numpy

    pcfg = Qwen3Config(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(Qwen3Config)})
    return PortModel(from_jax_numpy(params_to_numpy(params), pcfg, device="cpu"), pcfg,
                     max_seq_len=max_seq_len, device="cpu")
