"""The port's kernels: hand-written CUDA for Hopper, each beside its plain
PyTorch version and a launch counter (counterparts of tiny_llm_tpu/kernels).

Importing this package builds nothing; a kernel is compiled at its first
launch (kernels/build.py)."""

from . import (
    axpby,
    flash_attention,
    fused_decode_attention,
    moe_matmul,
    paged_attention,
    quant_matmul,
)

# Each kernel's name -> (its module, the name of its launch counter there).
# A module holds its wrapper(s), plain version(s), CUDA launcher(s) and
# counter(s); the CUDA launcher adds one to its counter per launch. The split
# paged prefill (kernels/split_prefill.py) combines the two state kernels
# and has no kernel of its own. The JAX package's expert-gather schedule
# (moe_matmul.TPU_KERNEL_GATHER) computes grouped_quant_matmul's function
# and has no entry: that kernel covers it.
KERNELS = {
    "quant_matmul": (quant_matmul, "LAUNCHES"),
    "fused_decode_attention": (fused_decode_attention, "LAUNCHES"),
    "flash_attention": (flash_attention, "LAUNCHES"),
    "fused_paged_decode_attention": (fused_decode_attention, "PAGED_LAUNCHES"),
    "paged_decode": (paged_attention, "DECODE_LAUNCHES"),
    "paged_prefill": (paged_attention, "PREFILL_LAUNCHES"),
    "grouped_quant_matmul": (moe_matmul, "LAUNCHES"),
    "flash_prefill_state": (flash_attention, "STATE_LAUNCHES"),
    "paged_prefix_state": (paged_attention, "PREFIX_LAUNCHES"),
    "quant_matmul_a8": (quant_matmul, "A8_LAUNCHES"),
    "quant_matmul_sg": (quant_matmul, "SG_LAUNCHES"),
    "grouped_quant_matmul_a8": (moe_matmul, "A8_LAUNCHES"),
    "grouped_quant_matmul_sg": (moe_matmul, "SG_LAUNCHES"),
    "flash_decode_state": (flash_attention, "DECODE_STATE_LAUNCHES"),
    "paged_decode_state": (paged_attention, "DECODE_STATE_LAUNCHES"),
    "flash_attention_masked": (flash_attention, "MASKED_LAUNCHES"),
    "fused_qkv_prep": (fused_decode_attention, "PREP_LAUNCHES"),
    "axpby": (axpby, "LAUNCHES"),
}


def reset_launches() -> None:
    for mod, counter in KERNELS.values():
        setattr(mod, counter, 0)


def launches() -> dict[str, int]:
    return {name: getattr(mod, counter) for name, (mod, counter) in KERNELS.items()}


__all__ = ["KERNELS", "launches", "reset_launches"]
