"""The port's kernels: hand-written CUDA for Hopper, each beside its plain
PyTorch version and a launch counter (counterparts of tiny_llm_tpu/kernels).

Importing this package builds nothing; a kernel is compiled at its first
launch (kernels/build.py)."""

from . import flash_attention, fused_decode_attention, quant_matmul

# Each module holds a wrapper of the same name, its plain version, its CUDA
# launcher and its LAUNCHES counter.
KERNEL_MODULES = {
    "quant_matmul": quant_matmul,
    "fused_decode_attention": fused_decode_attention,
    "flash_attention": flash_attention,
}


def reset_launches() -> None:
    for mod in KERNEL_MODULES.values():
        mod.LAUNCHES = 0


def launches() -> dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in KERNEL_MODULES.items()}


__all__ = ["KERNEL_MODULES", "launches", "reset_launches"]
