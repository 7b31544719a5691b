"""Weight-only affine group quantization (W4A16, group 128) in the port's layout.

Semantics are those of tiny_llm_tpu/ops/quantize.py: weights split into
groups of `group_size` along the input dimension, each group with a scale
and a bias, `w = q * scale + bias`, q an unsigned 4-bit code.

Storage layout (the port's own, chosen for Hopper; the JAX package's
"magic_t" is a TPU sublane trick and "sg" a TPU lane trick):

  packed  int32 [N, K_pad / 8], row-major. Word w of row n holds the codes
          of k = 8w .. 8w + 7, code k = 8w + j in bits [4j, 4j + 4) — the
          same consecutive little-endian packing MLX uses.
  scales  bf16 [N, G], G = K_pad / group_size.
  biases  bf16 [N, G].

MoE expert weights stack E such matrices with a leading expert dim:
packed [E, N, K_pad / 8], scales and biases [E, N, G]. K_pad stays the
port's own (a multiple of 128), where the JAX "magic_t" layout pads K to
a multiple of 512.

Why: every output row's K is one contiguous run of bytes, so a warp that
owns a row streams it with 16-byte loads (four words, 32 codes, which never
straddle a group since 32 divides 128), and one 16-code fragment of a
tensor-core tile is two adjacent words. K pads to a multiple of the group
size (every Qwen3 K already is), and padded groups dequantize to 0 (code 0,
scale 1, bias 0). The tied embedding and the LM head share one tensor: a
row gather for the embedding and the matmul for the head both read rows.
The words are stored as int32 because torch has few uint32 operations; the
bits are the same.

`dequantize` is bit-equal to the JAX package's: q * s is exact in f32
(4-bit times 8-bit significands), so the f32 multiply-add rounds once,
wherever it runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

GROUP_SIZE = 128
BITS = 4
MAGIC_SUPERGROUP = 512  # the JAX "magic_t"/"pair_t" K padding unit


@dataclasses.dataclass
class QuantizedTensor:
    """Group-quantized weight, logical shape [out_features, in_features],
    or [E, out_features, in_features] for stacked experts."""

    packed: torch.Tensor  # int32 [(E,) N, k_padded // 8]
    scales: torch.Tensor  # bf16 [(E,) N, G]
    biases: torch.Tensor  # bf16 [(E,) N, G]
    out_features: int
    in_features: int
    k_padded: int
    group_size: int = GROUP_SIZE
    bits: int = BITS

    @property
    def device(self) -> torch.device:
        return self.packed.device

    @property
    def num_experts(self) -> int | None:
        """E of a stacked expert weight, None for a 2-D weight."""
        return self.packed.shape[0] if self.packed.ndim == 3 else None

    def expert(self, e: int) -> "QuantizedTensor":
        """Expert e of a stacked weight as a 2-D weight (views, no copy)."""
        return dataclasses.replace(
            self, packed=self.packed[e], scales=self.scales[e], biases=self.biases[e]
        )

    def to(self, device) -> "QuantizedTensor":
        return dataclasses.replace(
            self,
            packed=self.packed.to(device),
            scales=self.scales.to(device),
            biases=self.biases.to(device),
        )


def padded_k(k: int, group_size: int = GROUP_SIZE) -> int:
    return -(-k // group_size) * group_size


# ---------------------------------------------------------------------------
# numpy unpackers of the JAX package's layouts (bridge input side). Copies
# of tiny_llm_tpu/ops/quantize.py unpack_magic_t / unpack_supergroup.
# ---------------------------------------------------------------------------


def unpack_magic_t(packed_t: np.ndarray, k_padded: int) -> np.ndarray:
    """uint32 [K_pad / 8, N] ("magic_t") -> int32 codes [N, K_pad].

    Logical k = sg*512 + j*128 + 2w + h sits in word row sg*64 + w at bits
    [16h + 4j, 16h + 4j + 4)."""
    n_sg = k_padded // MAGIC_SUPERGROUP
    half = MAGIC_SUPERGROUP // 8
    N = packed_t.shape[1]
    word = np.ascontiguousarray(packed_t.astype(np.uint32).T).reshape(N, n_sg, half)
    planes = []
    for j in range(4):
        lo = (word >> np.uint32(4 * j)) & np.uint32(0xF)
        hi = (word >> np.uint32(16 + 4 * j)) & np.uint32(0xF)
        planes.append(np.stack([lo, hi], axis=-1))  # [N, n_sg, 64, 2]
    vals = np.stack(planes, axis=2)  # [N, n_sg, 4, 64, 2]
    return vals.reshape(N, k_padded).astype(np.int32)


def unpack_supergroup(
    packed: np.ndarray, k_padded: int, group_size: int, bits: int
) -> np.ndarray:
    """uint32 [N, K_pad / vpw] ("sg") -> int32 codes [N, K_pad].

    packed[n, sg * group_size + w] bits [bits*j, bits*(j+1)) holds
    q[n, sg * vpw * group_size + j * group_size + w]."""
    vpw = 32 // bits
    sg_vals = vpw * group_size
    N = packed.shape[0]
    words = packed.astype(np.uint32).reshape(N, k_padded // sg_vals, 1, group_size)
    shifts = (np.arange(vpw, dtype=np.uint32) * np.uint32(bits)).reshape(1, vpw, 1)
    vals = (words >> shifts) & np.uint32((1 << bits) - 1)
    return vals.reshape(N, k_padded).astype(np.int32)


# ---------------------------------------------------------------------------
# The port's layout.
# ---------------------------------------------------------------------------


def pack_codes(q: torch.Tensor) -> torch.Tensor:
    """int codes [..., N, K_pad] in 0..15 -> int32 words [..., N, K_pad / 8]."""
    K = q.shape[-1]
    if K % 8:
        raise ValueError(f"K={K} is not a multiple of 8 codes per word")
    qv = q.to(torch.int64).reshape(*q.shape[:-1], K // 8, 8)
    shifts = torch.arange(0, 32, 4, dtype=torch.int64, device=q.device)
    words = (qv << shifts).sum(-1)  # disjoint bits: the sum is an OR
    # Wrap to the int32 range so the top nibble's bit 31 becomes the sign.
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """int32 words [..., N, K_pad / 8] -> int32 codes [..., N, K_pad]."""
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=packed.device)
    # An arithmetic shift fills with sign bits above the nibble; the mask
    # drops them.
    vals = (packed.unsqueeze(-1) >> shifts) & 0xF
    return vals.reshape(*packed.shape[:-1], -1)


def from_codes(
    codes: torch.Tensor,  # int [(E,) N, >= K]
    scales: torch.Tensor,  # [(E,) N, >= ceil(K / group_size)]
    biases: torch.Tensor,
    in_features: int,
    group_size: int = GROUP_SIZE,
) -> QuantizedTensor:
    """Pack integer codes and per-group scale/bias into the port's layout
    (a leading expert dim, if any, is kept).

    Codes and groups past `in_features` are dropped and the port's own
    padding (to a group multiple) is applied: code 0, scale 1, bias 0."""
    if group_size != GROUP_SIZE:
        raise ValueError("the port's layout is W4 g128 only")
    *lead, N = codes.shape[:-1]
    K = in_features
    kp = padded_k(K, group_size)
    G = kp // group_size
    q = torch.zeros((*lead, N, kp), dtype=torch.int32, device=codes.device)
    q[..., :K] = codes[..., :K].to(torch.int32)
    s = torch.ones((*lead, N, G), dtype=torch.bfloat16, device=codes.device)
    b = torch.zeros((*lead, N, G), dtype=torch.bfloat16, device=codes.device)
    g_real = -(-K // group_size)
    s[..., :g_real] = scales[..., :g_real]
    b[..., :g_real] = biases[..., :g_real]
    return QuantizedTensor(
        packed=pack_codes(q), scales=s, biases=b,
        out_features=N, in_features=K, k_padded=kp, group_size=group_size,
    )


def dequantize(qt: QuantizedTensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dense weight [(E,) N, in_features]: w = q * scale + bias in f32, then cast."""
    G = qt.k_padded // qt.group_size
    lead = qt.packed.shape[:-1]  # ([E,] N)
    vals = unpack_codes(qt.packed).reshape(*lead, G, qt.group_size)
    w = vals.to(torch.float32) * qt.scales.to(torch.float32)[..., None] + qt.biases.to(
        torch.float32
    )[..., None]
    return w.reshape(*lead, qt.k_padded)[..., : qt.in_features].to(dtype)


def concat_out_features(qts: list[QuantizedTensor]) -> QuantizedTensor:
    """Stack weights along out_features — exact: groups run along K, so rows
    never cross a group and every stored bit is kept."""
    head = qts[0]
    for q in qts[1:]:
        if (q.in_features, q.k_padded, q.group_size, q.bits) != (
            head.in_features, head.k_padded, head.group_size, head.bits
        ):
            raise ValueError("concat_out_features needs matching K and quant params")
    return dataclasses.replace(
        head,
        packed=torch.cat([q.packed for q in qts], dim=0),
        scales=torch.cat([q.scales for q in qts], dim=0),
        biases=torch.cat([q.biases for q in qts], dim=0),
        out_features=sum(q.out_features for q in qts),
    )


def permute_out_features(qt: QuantizedTensor, perm) -> QuantizedTensor:
    """Reorder rows (out_features) — exact, a gather of rows and their groups."""
    idx = torch.as_tensor(perm, dtype=torch.long, device=qt.device)
    if idx.shape != (qt.out_features,):
        raise ValueError(f"perm shape {tuple(idx.shape)} != ({qt.out_features},)")
    return dataclasses.replace(
        qt,
        packed=qt.packed.index_select(0, idx),
        scales=qt.scales.index_select(0, idx),
        biases=qt.biases.index_select(0, idx),
    )
