"""Weight-only affine group quantization in the port's layout, and the
per-row int8 activation quantization of the W4A8 tier.

Semantics are those of tiny_llm_tpu/ops/quantize.py: weights split into
groups of `group_size` along the input dimension, each group with a scale
and a bias, `w = q * scale + bias`, q an unsigned `bits`-bit code. The
port takes bits in {2, 4, 8} (the JAX package's `_values_per_word`) and
any group size that divides K, as the JAX package's `quantize` does. The
kernels hold templated instances for groups of 32, 64 and 128 (those of
MLX exports, TEMPLATED_GROUP_SIZES); every other group size runs their
run-time-width walk (kernels/quant_matmul.py, kernels/moe_matmul.py).

Storage layout (the port's own, chosen for Hopper; the JAX package's
"magic_t" and "pair_t" are TPU sublane tricks and "sg" a TPU lane trick):

  packed  int32 [N, K_pad * bits / 32], row-major. Word w of row n holds
          the 32 / bits codes of k = (32 / bits) w .. , code j of the word
          in bits [bits * j, bits * (j + 1)) — the consecutive
          little-endian packing MLX uses.
  scales  bf16 [N, G], G = K_pad / group_size.
  biases  bf16 [N, G].

MoE expert weights stack E such matrices with a leading expert dim:
packed [E, N, K_pad * bits / 32], scales and biases [E, N, G].

Why: every output row's K is one contiguous run of bytes, so a warp that
owns a row streams it with 16-byte loads, and one 16-code fragment of a
tensor-core tile is a few adjacent words. K pads to a multiple of
k_align(group_size) = lcm(128, group_size) (every Qwen3 K already is a
multiple of 128; the JAX "magic_t" layout pads to 512, its "sg" layout to
32 / bits groups): at the templated group sizes, which divide 128, a
16-byte load (16, 32 or 64 codes) lies inside one group or holds whole
groups, and a 128-deep tensor-core stage holds whole groups; at any other
size the padded K still holds whole groups and whole 128-code stages. Padded groups dequantize
to 0 (code 0, scale 1, bias 0). The tied embedding and the LM head share
one tensor: a row gather for the embedding and the matmul for the head
both read rows. The words are stored as int32 because torch has few uint32
operations; the bits are the same.

`act` marks how a matmul treats the activations: "bf16" (W4A16) or "int8"
(W4A8: per-row absmax int8 activations at decode shapes, the JAX
package's "pair_t" tier). It changes no stored bit: the W4A8 model shares
the W4A16 model's tensors.

`dequantize` is bit-equal to the JAX package's: q * s is exact in f32
(8-bit times 8-bit significands), so the f32 multiply-add rounds once,
wherever it runs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

GROUP_SIZE = 128
BITS = 4
SUPPORTED_BITS = (2, 4, 8)
TEMPLATED_GROUP_SIZES = (32, 64, 128)  # the kernels' compiled widths; others run at run time
K_ALIGN = 128  # K pads to a multiple of lcm(K_ALIGN, group_size) (k_align)
MAGIC_SUPERGROUP = 512  # the JAX "magic_t"/"pair_t" K padding unit


def check_width(bits: int, group_size: int) -> None:
    """Raise ValueError for a width the port's layout does not take: bits
    outside {2, 4, 8} or a group size below 1."""
    if bits not in SUPPORTED_BITS or int(group_size) != group_size or group_size < 1:
        raise ValueError(
            f"the port takes bits in {SUPPORTED_BITS} and a positive group size, not "
            f"bits={bits} group_size={group_size}"
        )


def k_align(group_size: int = GROUP_SIZE) -> int:
    """The K padding unit of a group size: lcm(K_ALIGN, group_size), so the
    padded K holds whole groups and whole 128-code tile stages."""
    return math.lcm(K_ALIGN, group_size)


@dataclasses.dataclass
class QuantizedTensor:
    """Group-quantized weight, logical shape [out_features, in_features],
    or [E, out_features, in_features] for stacked experts."""

    packed: torch.Tensor  # int32 [(E,) N, k_padded * bits // 32]
    scales: torch.Tensor  # bf16 [(E,) N, G]
    biases: torch.Tensor  # bf16 [(E,) N, G]
    out_features: int
    in_features: int
    k_padded: int
    group_size: int = GROUP_SIZE
    bits: int = BITS
    act: str = "bf16"  # "int8": W4A8 activations at decode shapes (see module docstring)

    @property
    def device(self) -> torch.device:
        return self.packed.device

    @property
    def num_experts(self) -> int | None:
        """E of a stacked expert weight, None for a 2-D weight."""
        return self.packed.shape[0] if self.packed.ndim == 3 else None

    @property
    def is_templated(self) -> bool:
        """A group size the kernels hold compiled instances for; any other
        runs their run-time-width walk."""
        return self.group_size in TEMPLATED_GROUP_SIZES

    @property
    def is_w4g128(self) -> bool:
        """W4 group 128: the width of K1 and the grouped W4A16 kernel."""
        return (self.bits, self.group_size) == (BITS, GROUP_SIZE)

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
    unit = k_align(group_size)
    return -(-k // unit) * unit


# ---------------------------------------------------------------------------
# numpy unpackers of the JAX package's layouts (bridge input side). Copies
# of tiny_llm_tpu/ops/quantize.py unpack_magic_t / unpack_pair_t /
# unpack_supergroup.
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


def unpack_pair_t(packed_t: np.ndarray, k_padded: int) -> np.ndarray:
    """uint32 [K_pad / 8, N] ("pair_t") -> int32 codes [N, K_pad].

    Logical k = sg*512 + c*256 + 4w + b sits in word row sg*64 + w at bits
    [8b + 4c, 8b + 4c + 4)."""
    n_sg = k_padded // MAGIC_SUPERGROUP
    half = MAGIC_SUPERGROUP // 8
    N = packed_t.shape[1]
    word = np.ascontiguousarray(packed_t.astype(np.uint32).T).reshape(N, n_sg, half)
    planes = []
    for c in range(2):
        planes.append(np.stack([(word >> np.uint32(8 * b + 4 * c)) & np.uint32(0xF)
                                for b in range(4)], axis=-1))  # [N, n_sg, 64, 4]
    vals = np.stack(planes, axis=2)  # [N, n_sg, 2, 64, 4]
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


def pack_codes(q: torch.Tensor, bits: int = BITS) -> torch.Tensor:
    """int codes [..., N, K_pad] in 0 .. 2^bits - 1 -> int32 words
    [..., N, K_pad * bits / 32]."""
    vpw = 32 // bits
    K = q.shape[-1]
    if K % vpw:
        raise ValueError(f"K={K} is not a multiple of {vpw} codes per word")
    qv = q.to(torch.int64).reshape(*q.shape[:-1], K // vpw, vpw)
    shifts = torch.arange(0, 32, bits, dtype=torch.int64, device=q.device)
    words = (qv << shifts).sum(-1)  # disjoint bits: the sum is an OR
    # Wrap to the int32 range so the top code's bit 31 becomes the sign.
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack_codes(packed: torch.Tensor, bits: int = BITS) -> torch.Tensor:
    """int32 words [..., N, K_pad * bits / 32] -> int32 codes [..., N, K_pad]."""
    shifts = torch.arange(0, 32, bits, dtype=torch.int32, device=packed.device)
    # An arithmetic shift fills with sign bits above the code; the mask
    # drops them.
    vals = (packed.unsqueeze(-1) >> shifts) & ((1 << bits) - 1)
    return vals.reshape(*packed.shape[:-1], -1)


def from_codes(
    codes: torch.Tensor,  # int [(E,) N, >= K]
    scales: torch.Tensor,  # [(E,) N, >= ceil(K / group_size)]
    biases: torch.Tensor,
    in_features: int,
    group_size: int = GROUP_SIZE,
    bits: int = BITS,
) -> QuantizedTensor:
    """Pack integer codes and per-group scale/bias into the port's layout
    (a leading expert dim, if any, is kept).

    Codes and groups past `in_features` are dropped and the port's own
    padding (to a multiple of k_align(group_size)) is applied: code 0,
    scale 1, bias 0."""
    check_width(bits, group_size)
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
        packed=pack_codes(q, bits), scales=s, biases=b,
        out_features=N, in_features=K, k_padded=kp, group_size=group_size, bits=bits,
    )


def unpack_mlx(packed: torch.Tensor, bits: int = BITS) -> torch.Tensor:
    """MLX words [..., W] (int32, or uint32 viewed as int32) -> int32 codes
    [..., W * 32 / bits]: MLX packs consecutive codes little-endian in a
    word, which is the port's own packing (tiny_llm_tpu/ops/quantize.py
    unpack_mlx)."""
    if packed.dtype == torch.uint32:
        packed = packed.view(torch.int32)
    return unpack_codes(packed, bits)


def _affine_codes(w: torch.Tensor, group_size: int, bits: int):
    """Affine group quantization of w [..., K] as the JAX package's
    `quantize`: per group scale = (max - min) / (2^bits - 1) in f32 (1 where
    that is 0), bias = min, q = round((w - min) / scale) with the f32 scale,
    half to even. Returns (codes int32 [..., K], scale f32, min f32 [..., G])."""
    *lead, K = w.shape
    if K % group_size:
        raise ValueError(f"K={K} is not a multiple of group_size={group_size}")
    levels = (1 << bits) - 1
    wg = w.to(torch.float32).reshape(*lead, K // group_size, group_size)
    gmax, gmin = wg.amax(dim=-1), wg.amin(dim=-1)
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which moves a scale by an ulp and flips
    # codes against the JAX package's IEEE division.
    scale = (gmax - gmin) / torch.full_like(gmax, float(levels))
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round((wg - gmin[..., None]) / scale[..., None]), 0, levels)
    return q.reshape(*lead, K).to(torch.int32), scale, gmin


def quantize(w: torch.Tensor, group_size: int = GROUP_SIZE, bits: int = BITS) -> QuantizedTensor:
    """Quantize a dense weight [N, K] in the port's layout (codes, bf16
    scales and biases bit-equal to tiny_llm_tpu/ops/quantize.py quantize),
    on w's device."""
    if w.ndim != 2:
        raise ValueError(f"quantize takes a [N, K] weight, not shape {tuple(w.shape)}")
    check_width(bits, group_size)
    q, scale, gmin = _affine_codes(w, group_size, bits)
    return from_codes(q, scale.to(torch.bfloat16), gmin.to(torch.bfloat16), w.shape[-1],
                      group_size, bits)


def quantize_stacked(w: torch.Tensor, group_size: int = GROUP_SIZE,
                     bits: int = BITS) -> QuantizedTensor:
    """Quantize stacked expert weights [E, N, K]: groups lie within a row,
    so every expert quantizes as `quantize` would alone."""
    if w.ndim != 3:
        raise ValueError(f"quantize_stacked takes [E, N, K], not shape {tuple(w.shape)}")
    check_width(bits, group_size)
    q, scale, gmin = _affine_codes(w, group_size, bits)
    return from_codes(q, scale.to(torch.bfloat16), gmin.to(torch.bfloat16), w.shape[-1],
                      group_size, bits)


def from_mlx_packing(
    mlx_weight: torch.Tensor,  # [(E,) N, K * bits / 32] int32 (or uint32) words
    scales: torch.Tensor,  # [(E,) N, K / group_size]
    biases: torch.Tensor,
    group_size: int = GROUP_SIZE,
    bits: int = BITS,
) -> QuantizedTensor:
    """An MLX export's weight/scales/biases triplet in the port's layout,
    on the words' device; scales and biases round to bf16 as the JAX
    package's ingest does. MLX's packing is the port's, so where K needs no
    padding the words are kept as they are; otherwise the codes are
    unpacked and repacked with the padding."""
    check_width(bits, group_size)
    words = mlx_weight.view(torch.int32) if mlx_weight.dtype == torch.uint32 else mlx_weight
    K = words.shape[-1] * (32 // bits)
    s, b = scales.to(torch.bfloat16), biases.to(torch.bfloat16)
    if K != padded_k(K, group_size) or words.dtype != torch.int32:
        return from_codes(unpack_mlx(words.to(torch.int32), bits), s, b, K, group_size, bits)
    return QuantizedTensor(
        packed=words.contiguous(), scales=s.contiguous(), biases=b.contiguous(),
        out_features=words.shape[-2], in_features=K, k_padded=K, group_size=group_size,
        bits=bits,
    )


def from_mlx_packing_stacked(
    mlx_weight: torch.Tensor,  # [E, N, K * bits / 32] (MLX switch_mlp export)
    scales: torch.Tensor,  # [E, N, K / group_size]
    biases: torch.Tensor,
    group_size: int = GROUP_SIZE,
    bits: int = BITS,
) -> QuantizedTensor:
    """A stacked expert triplet: `from_mlx_packing` with the leading expert
    dim kept (groups lie within a row)."""
    if mlx_weight.ndim != 3:
        raise ValueError(f"stacked MLX weight of rank {mlx_weight.ndim}, expected 3")
    return from_mlx_packing(mlx_weight, scales, biases, group_size, bits)


def dequantize(qt: QuantizedTensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dense weight [(E,) N, in_features]: w = q * scale + bias in f32, then cast."""
    G = qt.k_padded // qt.group_size
    lead = qt.packed.shape[:-1]  # ([E,] N)
    vals = unpack_codes(qt.packed, qt.bits).reshape(*lead, G, qt.group_size)
    w = vals.to(torch.float32) * qt.scales.to(torch.float32)[..., None] + qt.biases.to(
        torch.float32
    )[..., None]
    return w.reshape(*lead, qt.k_padded)[..., : qt.in_features].to(dtype)


def concat_out_features(qts: list[QuantizedTensor]) -> QuantizedTensor:
    """Stack weights along out_features — exact: groups run along K, so rows
    never cross a group and every stored bit is kept."""
    head = qts[0]
    for q in qts[1:]:
        if (q.in_features, q.k_padded, q.group_size, q.bits, q.act) != (
            head.in_features, head.k_padded, head.group_size, head.bits, head.act
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


# ---------------------------------------------------------------------------
# W4A8 activations.
# ---------------------------------------------------------------------------


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax int8 quantization, as the JAX package's W4A8 tier
    (kernels/quant_matmul.py _qmm_pair_pallas, kernels/moe_matmul.py
    _gqmm_pair_pallas): sx = max|x| / 127 over the row in f32 (1 where it
    is 0), xq = clip(round(x / sx), -127, 127) with an IEEE division and
    round half to even. x [..., K] -> (xq int8 [..., K], sx f32 [..., 1])."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which moves sx by an ulp in some rows and
    # flips codes against the kernels' (and the JAX package's) IEEE x / 127.
    sx = amax / torch.full_like(amax, 127.0)
    sx = torch.where(sx == 0, torch.ones_like(sx), sx)
    xq = torch.clamp(torch.round(xf / sx), -127.0, 127.0)
    return xq.to(torch.int8), sx


def quantized_linear(
    x: torch.Tensor,
    qt: QuantizedTensor,
    bias: torch.Tensor | None = None,
    impl: str | None = None,
    norm_weight: torch.Tensor | None = None,
    eps: float = 1e-6,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """y = x @ dequant(qt).T (+ bias) (+ residual), in x's dtype: the
    kernels' quantized_matmul (K1 on the card for W4 g128); `norm_weight`
    RMS-normalizes x first."""
    from ..kernels.quant_matmul import quantized_matmul

    return quantized_matmul(x, qt, bias=bias, impl=impl, norm_weight=norm_weight, eps=eps,
                            residual=residual)
