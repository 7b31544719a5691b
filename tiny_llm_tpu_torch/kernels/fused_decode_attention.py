"""K2: fused decode attention step (qkv split + QK-norm + RoPE + attention).

Replaces tiny_llm_tpu/kernels/fused_decode_attention.py::_fused_step_kernel
(wrapper `fused_decode_attention`). The CUDA kernel is
csrc/fused_decode_attention.cu; its header notes what bounds it on the
H100 and what its design does about that.

Layouts are the JAX package's: the fused qkv row [B, Hkv, n_rep + 2, D]
(per KV head: its n_rep q rows, then k, then v), the slab
[layers, B, Hkv, S, D] holding positions [0, offsets[b]) of each row, and
the RoPE rows [B, D/2] at each row's position. The current token is not in
the slab yet; the caller writes the returned k/v rows at `offsets`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .dispatch import resolve

TPU_KERNEL = "tiny_llm_tpu/kernels/fused_decode_attention.py:79 _fused_step_kernel"
SOURCE = "tiny_llm_tpu_torch/csrc/fused_decode_attention.cu"
NEG_INF = -1e30

LAUNCHES = 0  # kernel launches since the last reset (see kernels.reset_launches)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _rms_rope_heads(x, w, cos, sin, eps):
    """RMSNorm + RoPE over [..., D] f32 rows at the TPU kernel's rounding
    points; returns bf16 values held in f32."""
    half = x.shape[-1] // 2
    ms = (x * x).mean(dim=-1, keepdim=True)
    normed = _bf16(x * torch.rsqrt(ms + eps))
    y = _bf16(normed * _bf16(w.to(torch.float32)))
    x1, x2 = y[..., :half], y[..., half:]
    return _bf16(torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1))


def fused_decode_attention_plain(
    qkv_rows, keys, values, offsets, cos_row, sin_row, q_norm_w, k_norm_w,
    *, layer_idx: int, scale: float, eps: float,
):
    """Plain PyTorch version: one softmax over [0, off) plus the current
    token, f32 statistics, bf16 probabilities in the PV product."""
    B, Hkv, rows, D = qkv_rows.shape
    n_rep = rows - 2
    S = keys.shape[3]
    x = qkv_rows.to(torch.float32)
    cos = cos_row.to(torch.float32)[:, None, None, :]
    sin = sin_row.to(torch.float32)[:, None, None, :]
    q = _rms_rope_heads(x[:, :, :n_rep], q_norm_w, cos, sin, eps)
    q = _bf16(q * scale)  # [B, Hkv, n_rep, D]
    k_cur = _rms_rope_heads(x[:, :, n_rep : n_rep + 1], k_norm_w, cos, sin, eps)
    v_cur = qkv_rows[:, :, n_rep + 1 : n_rep + 2]
    kf = keys[layer_idx].to(torch.float32)  # [B, Hkv, S, D]
    vf = values[layer_idx].to(torch.float32)
    s = torch.einsum("bhrd,bhsd->bhrs", q, kf)
    pos = torch.arange(S, device=qkv_rows.device)
    visible = pos[None, :] < offsets.to(pos.device)[:, None]  # [B, S]
    s = torch.where(visible[:, None, None, :], s, NEG_INF)
    s_cur = (q * k_cur).sum(-1, keepdim=True)  # [B, Hkv, n_rep, 1]
    m = torch.maximum(s.amax(-1, keepdim=True), s_cur)
    p = torch.exp(s - m)
    p_cur = torch.exp(s_cur - m)
    l = p.sum(-1, keepdim=True) + p_cur
    acc = torch.einsum("bhrs,bhsd->bhrd", _bf16(p), vf) + _bf16(p_cur) * v_cur.to(torch.float32)
    attn = (acc / l).to(torch.bfloat16)
    return attn, k_cur.to(torch.bfloat16), v_cur.clone()


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_decode_attention")
    fn = lib.tlt_fused_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return lib


def fused_decode_attention_cuda(
    qkv_rows, keys, values, offsets, cos_row, sin_row, q_norm_w, k_norm_w,
    *, layer_idx: int, scale: float, eps: float,
):
    global LAUNCHES
    B, Hkv, rows, D = qkv_rows.shape
    n_rep = rows - 2
    Lyr, Bk, Hk, S, Dk = keys.shape
    if (Bk, Hk, Dk) != (B, Hkv, D) or values.shape != keys.shape:
        raise ValueError(f"slab {tuple(keys.shape)} does not match qkv {tuple(qkv_rows.shape)}")
    if D not in (64, 128) or n_rep not in (1, 2, 4, 8):
        raise ValueError(f"fused_decode_attention_cuda: unsupported D={D}, n_rep={n_rep}")
    if not 0 <= layer_idx < Lyr:
        raise ValueError(f"layer_idx {layer_idx} out of range")
    for t in (qkv_rows, keys, values):
        if t.dtype != torch.bfloat16 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("qkv_rows/keys/values must be contiguous bf16 CUDA tensors")
    dev = qkv_rows.device
    offsets = offsets.to(device=dev, dtype=torch.int32).contiguous()
    cos_row = cos_row.to(device=dev, dtype=torch.float32).contiguous()
    sin_row = sin_row.to(device=dev, dtype=torch.float32).contiguous()
    qw = q_norm_w.to(device=dev, dtype=torch.bfloat16).contiguous()
    kw = k_norm_w.to(device=dev, dtype=torch.bfloat16).contiguous()
    attn = torch.empty((B, Hkv, n_rep, D), dtype=torch.bfloat16, device=dev)
    k_row = torch.empty((B, Hkv, 1, D), dtype=torch.bfloat16, device=dev)
    v_row = torch.empty((B, Hkv, 1, D), dtype=torch.bfloat16, device=dev)
    lib = _lib()
    err = lib.tlt_fused_decode_attention(
        qkv_rows.data_ptr(), keys.data_ptr(), values.data_ptr(), offsets.data_ptr(),
        cos_row.data_ptr(), sin_row.data_ptr(), qw.data_ptr(), kw.data_ptr(),
        attn.data_ptr(), k_row.data_ptr(), v_row.data_ptr(),
        layer_idx, B, Hkv, S, D, n_rep, float(scale), float(eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "fused_decode_attention")
    LAUNCHES += 1
    return attn, k_row, v_row


def fused_decode_attention(
    qkv_rows: torch.Tensor,  # [B, Hkv, n_rep + 2, D] bf16
    keys: torch.Tensor,  # [layers, B, Hkv, S, D]
    values: torch.Tensor,
    offsets: torch.Tensor,  # [B] int32 — context length before this token
    cos_row: torch.Tensor,  # [B, D // 2] f32 — RoPE rows at `offsets`
    sin_row: torch.Tensor,
    q_norm_w: torch.Tensor,  # [D]
    k_norm_w: torch.Tensor,  # [D]
    *,
    layer_idx: int,
    scale: float,
    eps: float,
    impl: str | None = None,
):
    """One layer's decode attention from the fused qkv row.

    Returns (attn [B, Hkv, n_rep, D], k_row [B, Hkv, 1, D], v_row [B, Hkv, 1, D])."""
    fn = (
        fused_decode_attention_cuda
        if resolve(impl, qkv_rows) == "cuda"
        else fused_decode_attention_plain
    )
    return fn(
        qkv_rows, keys, values, offsets, cos_row, sin_row, q_norm_w, k_norm_w,
        layer_idx=layer_idx, scale=scale, eps=eps,
    )
