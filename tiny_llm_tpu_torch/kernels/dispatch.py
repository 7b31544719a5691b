"""Kernel implementation dispatch for the PyTorch/CUDA port.

Counterpart of tiny_llm_tpu/kernels/dispatch.py. There the backend picks
"pallas" (TPU) or "xla"; here the tensor picks: a CUDA tensor runs the
hand-written kernel, a CPU tensor runs the kernel's plain PyTorch version.
An explicit "torch" asks for the plain version on either device (the
oracle the kernels are held against); an explicit "cuda" on a CPU tensor
is a contradiction and raises. There is no environment override;
`set_default_impl` sets a process-wide one, which an explicit `impl` still
overrides.
"""

from __future__ import annotations

import torch

IMPLS = ("cuda", "torch")

_OVERRIDE: str | None = None


def default_impl() -> str:
    """What a call with impl=None runs on the card's tensors: "cuda" on a
    host with a card, "torch" without one, unless set_default_impl set
    another answer. (A CPU tensor always runs the plain version.)"""
    if _OVERRIDE is not None:
        return _OVERRIDE
    return "cuda" if torch.cuda.is_available() else "torch"


def set_default_impl(impl: str | None) -> None:
    """Force an implementation for every call with impl=None ("torch": the
    plain versions on either device; "cuda": the kernels, a CPU tensor
    then raises); None restores the choice by tensor."""
    global _OVERRIDE
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected None or one of {IMPLS}")
    _OVERRIDE = impl


def resolve(impl: str | None, tensor: torch.Tensor) -> str:
    """Return "cuda" or "torch" for `tensor` under the requested `impl`."""
    if impl is None:
        impl = _OVERRIDE
    if impl is None:
        return "cuda" if tensor.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "cuda" and not tensor.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {tensor.device}")
    return impl


def check_device(device: str | torch.device) -> torch.device:
    """Validate an entry point's `device` argument.

    Entry points default to the card; on a host without one they raise
    rather than fall back to the CPU, which the caller must ask for.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
