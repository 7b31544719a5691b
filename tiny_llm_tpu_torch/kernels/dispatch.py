"""Kernel implementation dispatch for the PyTorch/CUDA port.

Counterpart of tiny_llm_tpu/kernels/dispatch.py. There the backend picks
"pallas" (TPU) or "xla"; here the tensor picks: a CUDA tensor runs the
hand-written kernel, a CPU tensor runs the kernel's plain PyTorch version.
An explicit "torch" asks for the plain version on either device (the
oracle the kernels are held against); an explicit "cuda" on a CPU tensor
is a contradiction and raises. There is no environment override.
"""

from __future__ import annotations

import torch

IMPLS = ("cuda", "torch")


def resolve(impl: str | None, tensor: torch.Tensor) -> str:
    """Return "cuda" or "torch" for `tensor` under the requested `impl`."""
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
