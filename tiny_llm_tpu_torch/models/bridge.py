"""Carry the JAX package's weights across to the port, through numpy only.

`from_jax_numpy` takes the JAX package's (unfused) `Qwen3Params` flattened
to a nested dict of numpy arrays and static fields:

    {"embedding": QT, "lm_head": QT | None, "final_norm": array,
     "layers": [{"input_layernorm": array, "post_attention_layernorm": array,
                 "attn": {"wq": QT, "wk": QT, "wv": QT, "wo": QT,
                          "q_norm": array, "k_norm": array},
                 "mlp": {"w_gate": QT, "w_up": QT, "w_down": QT}}, ...]}

or, for a MoE layer, "mlp": {"w_router": QT, "w_gate": QT, "w_up": QT,
"w_down": QT} with a 2-D router [E, D] and stacked experts [E, N, K],

where QT is {"packed", "scales", "biases"} arrays plus "layout",
"group_size", "bits", "out_features", "in_features", "k_padded". bf16
arrays arrive with numpy dtype name "bfloat16" (ml_dtypes) and are
reinterpreted bit for bit. The port never sees a JAX type.

Packed words go through integer codes: the JAX layout ("magic_t",
"pair_t" or "sg") is unpacked with this package's numpy unpackers and the
codes repacked in the port's layout at the weight's own bits (2, 4 or 8)
and group size (32, 64 or 128). Scales and biases are copied exactly, in
their source dtype. A "pair_t" weight (the JAX package's W4A8 tier)
arrives marked act="int8". A tied LM head is dropped: the JAX package
keeps a second copy of the embedding's codes for it, the port reads the
embedding itself.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.dispatch import check_device
from ..ops.quantize import (
    QuantizedTensor,
    check_width,
    from_codes,
    unpack_magic_t,
    unpack_pair_t,
    unpack_supergroup,
)
from .qwen3 import AttentionParams, BlockParams, MLPParams, MoEParams, Qwen3Config, Qwen3Params


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor, keeping bf16 (ml_dtypes) bits exactly."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def quantized_from_numpy(d: dict) -> QuantizedTensor:
    """One JAX QuantizedTensor (as numpy) -> the port's QuantizedTensor (CPU).

    A stacked expert weight (packed [E, Kp/8, N] and scales [E, G, N] in
    magic_t and pair_t, [E, N, Kp/vpw] and [E, N, G] in sg) keeps its
    leading E; the codes are unpacked expert by expert and the JAX pad
    groups past in_features are dropped."""
    layout, kp = d["layout"], int(d["k_padded"])
    bits, group_size = int(d["bits"]), int(d["group_size"])
    check_width(bits, group_size)
    packed = np.asarray(d["packed"])
    if packed.ndim not in (2, 3):
        raise ValueError(f"packed weight of rank {packed.ndim}")
    scales, biases = np.asarray(d["scales"]), np.asarray(d["biases"])
    if layout in ("magic_t", "pair_t"):  # W4 g128 only in the JAX package
        unpack = functools.partial(unpack_magic_t if layout == "magic_t" else unpack_pair_t,
                                   k_padded=kp)
        scales, biases = scales.swapaxes(-1, -2), biases.swapaxes(-1, -2)  # [G, N] -> [N, G]
    elif layout == "sg":
        unpack = functools.partial(unpack_supergroup, k_padded=kp, group_size=group_size,
                                   bits=bits)
    else:
        raise ValueError(f"layout {layout!r} is not ported yet")
    codes = unpack(packed) if packed.ndim == 2 else np.stack([unpack(p) for p in packed])
    qt = from_codes(
        torch.from_numpy(codes),
        tensor_from_numpy(scales),
        tensor_from_numpy(biases),
        in_features=int(d["in_features"]),
        group_size=group_size,
        bits=bits,
    )
    if layout == "pair_t":
        qt.act = "int8"
    return qt


def from_jax_numpy(
    tree: dict, cfg: Qwen3Config, device: str | torch.device = "cuda"
) -> Qwen3Params:
    """The port's params on `device` from the JAX params as numpy (see
    module docstring). Unfused, as the loaders return them; the port's
    Qwen3Model fuses them."""
    dev = check_device(device)

    def qt(d):
        return quantized_from_numpy(d).to(dev)

    def arr(a):
        return tensor_from_numpy(np.asarray(a)).to(dev)

    layers = []
    for layer in tree["layers"]:
        a, m = layer["attn"], layer["mlp"]
        layers.append(BlockParams(
            input_layernorm=arr(layer["input_layernorm"]),
            post_attention_layernorm=arr(layer["post_attention_layernorm"]),
            attn=AttentionParams(
                wq=qt(a["wq"]), wk=qt(a["wk"]), wv=qt(a["wv"]), wo=qt(a["wo"]),
                q_norm=arr(a["q_norm"]), k_norm=arr(a["k_norm"]),
            ),
            mlp=MoEParams(w_router=qt(m["w_router"]), w_gate=qt(m["w_gate"]),
                          w_up=qt(m["w_up"]), w_down=qt(m["w_down"]))
            if "w_router" in m else
            MLPParams(w_gate=qt(m["w_gate"]), w_up=qt(m["w_up"]), w_down=qt(m["w_down"])),
        ))
    lm_head = None
    if not cfg.tie_word_embeddings:
        lm_head = qt(tree["lm_head"])
    return Qwen3Params(
        embedding=qt(tree["embedding"]),
        layers=layers,
        final_norm=arr(tree["final_norm"]),
        lm_head=lm_head,
    )
