"""K2 and its paged twin: fused decode attention step (qkv split + QK-norm
+ RoPE + attention), over a dense slab or over a page pool.

Replaces tiny_llm_tpu/kernels/fused_decode_attention.py::_fused_step_kernel
(wrapper `fused_decode_attention`) and ::_fused_paged_step_kernel (wrapper
`fused_paged_decode_attention`). Both CUDA kernels are in
csrc/fused_decode_attention.cu, whose header notes what bounds them on the
H100 and what their design does about that: both run the split-key
tensor-core walk of csrc/split_walk.cuh in splits of `decode_split` keys,
K2 over one layer's slab (S for the table's width), the paged step over
the pool, and merge the splits in the same launch (one launch a call). The
same source holds the prep kernel, which replaces ::_qkv_prep_kernel (wrapper
`fused_qkv_prep`): the qkv split, QK-norm and RoPE alone, for the
three-launch paged decode (models/qwen3.py, `paged_fused_one=False`: the
prep, which writes the k/v rows into the pages itself, then paged
attention).

Layouts are the JAX package's: the fused qkv row [B, Hkv, n_rep + 2, D]
(per KV head: its n_rep q rows, then k, then v), the slab
[layers, B, Hkv, S, D] or one layer's pages [P, Hkv, ps, D] with a -1
padded block table [B, max_pages], holding positions [0, offsets[b]) of
each row, and the RoPE rows [B, D/2] at each row's position. The current
token is not cached yet; the caller writes the returned k/v rows at
`offsets`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .dispatch import resolve
from .flash_attention import kernel_round
from .paged_attention import decode_split, gather_pages_dense

TPU_KERNEL = "tiny_llm_tpu/kernels/fused_decode_attention.py:79 _fused_step_kernel"
TPU_KERNEL_PAGED = "tiny_llm_tpu/kernels/fused_decode_attention.py:275 _fused_paged_step_kernel"
TPU_KERNEL_PREP = "tiny_llm_tpu/kernels/fused_decode_attention.py:183 _qkv_prep_kernel"
SOURCE = "tiny_llm_tpu_torch/csrc/fused_decode_attention.cu"
NEG_INF = -1e30

# Kernel launches since the last reset (see kernels.reset_launches).
LAUNCHES = 0  # dense slab (K2)
PAGED_LAUNCHES = 0  # page pool
PREP_LAUNCHES = 0  # the prep kernel


def _rms_rope_heads(x, w, cos, sin, eps, dtype):
    """RMSNorm + RoPE over [..., D] f32 rows at the TPU kernel's rounding
    points for bf16 inputs (bf16 values held in f32); in f32 throughout for
    f32 inputs (`dtype`), as the JAX XLA route's rms_norm and apply_rope."""
    half = x.shape[-1] // 2
    ms = (x * x).mean(dim=-1, keepdim=True)
    normed = kernel_round(x * torch.rsqrt(ms + eps), dtype)
    y = kernel_round(normed * kernel_round(w.to(torch.float32), dtype), dtype)
    x1, x2 = y[..., :half], y[..., half:]
    return kernel_round(torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1), dtype)


def fused_decode_attention_plain(
    qkv_rows, keys, values, offsets, cos_row, sin_row, q_norm_w, k_norm_w,
    *, layer_idx: int, scale: float, eps: float,
):
    """Plain PyTorch version: one softmax over [0, off) plus the current
    token, f32 statistics, bf16 probabilities in the PV product (f32 inputs
    round nowhere and return f32)."""
    B, Hkv, rows, D = qkv_rows.shape
    n_rep = rows - 2
    S = keys.shape[3]
    dt = qkv_rows.dtype
    x = qkv_rows.to(torch.float32)
    cos = cos_row.to(torch.float32)[:, None, None, :]
    sin = sin_row.to(torch.float32)[:, None, None, :]
    q = _rms_rope_heads(x[:, :, :n_rep], q_norm_w, cos, sin, eps, dt)
    q = kernel_round(q * scale, dt)  # [B, Hkv, n_rep, D]
    k_cur = _rms_rope_heads(x[:, :, n_rep : n_rep + 1], k_norm_w, cos, sin, eps, dt)
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
    acc = (torch.einsum("bhrs,bhsd->bhrd", kernel_round(p, dt), vf)
           + kernel_round(p_cur, dt) * v_cur.to(torch.float32))
    attn = (acc / l).to(dt)
    return attn, k_cur.to(dt), v_cur.clone()


def fused_qkv_prep_plain(qkv_rows, offsets, cos_row, sin_row, q_norm_w, k_norm_w, *, eps,
                         pages=None):
    """Plain PyTorch version of the prep: K2's qkv split, QK-RMSNorm and
    RoPE at the same rounding points, q left unscaled; with `pages`, the
    k/v rows scattered into them as models/qwen3.py's _write_pages does."""
    n_rep = qkv_rows.shape[2] - 2
    dt = qkv_rows.dtype
    x = qkv_rows.to(torch.float32)
    cos = cos_row.to(torch.float32)[:, None, None, :]
    sin = sin_row.to(torch.float32)[:, None, None, :]
    q = _rms_rope_heads(x[:, :, :n_rep], q_norm_w, cos, sin, eps, dt).to(dt)
    k = _rms_rope_heads(x[:, :, n_rep : n_rep + 1], k_norm_w, cos, sin, eps, dt).to(dt)
    v = qkv_rows[:, :, n_rep + 1 :].clone()
    if pages is None:
        return q, k, v
    key_pages, value_pages, page_idx, slot = pages
    page_idx, slot = page_idx.reshape(-1, 1), slot.reshape(-1, 1)
    key_pages[page_idx, :, slot, :] = k.transpose(1, 2)
    value_pages[page_idx, :, slot, :] = v.transpose(1, 2)
    return q


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_decode_attention")
    fn = lib.tlt_fused_qkv_prep
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.tlt_fused_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong, ctypes.c_void_p]
                   + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.tlt_fused_decode_workspace
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    fn = lib.tlt_fused_paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong, ctypes.c_void_p]
                   + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.tlt_fused_paged_decode_workspace
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    return lib


# The fused steps' arrival counters (K2's and the paged step's), one int32
# per (batch row, KV head), by device: zero when made, and each launch
# leaves them zero. A larger batch takes a larger buffer; the earlier ones
# stay alive, since a CUDA graph captured before may still launch on them.
_ARRIVALS: dict[torch.device, list[torch.Tensor]] = {}


def _arrivals(device: torch.device, n: int) -> torch.Tensor:
    bufs = _ARRIVALS.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 256), dtype=torch.int32, device=device))
    return bufs[-1]


def _check_rows(qkv_rows, q_norm_w, k_norm_w, cos_row, sin_row, offsets):
    """Validate the qkv rows; the small side inputs on the rows' device."""
    B, Hkv, rows, D = qkv_rows.shape
    if D not in (64, 128) or rows - 2 not in (1, 2, 4, 8):
        raise ValueError(f"fused decode attention: unsupported D={D}, n_rep={rows - 2}")
    if qkv_rows.dtype != torch.bfloat16 or not qkv_rows.is_cuda or not qkv_rows.is_contiguous():
        raise ValueError("qkv_rows must be a contiguous bf16 CUDA tensor")
    dev = qkv_rows.device
    return (
        offsets.to(device=dev, dtype=torch.int32).contiguous(),
        cos_row.to(device=dev, dtype=torch.float32).contiguous(),
        sin_row.to(device=dev, dtype=torch.float32).contiguous(),
        q_norm_w.to(device=dev, dtype=torch.bfloat16).contiguous(),
        k_norm_w.to(device=dev, dtype=torch.bfloat16).contiguous(),
    )


def _outputs(qkv_rows):
    B, Hkv, rows, D = qkv_rows.shape
    dev = qkv_rows.device
    return (
        torch.empty((B, Hkv, rows - 2, D), dtype=torch.bfloat16, device=dev),
        torch.empty((B, Hkv, 1, D), dtype=torch.bfloat16, device=dev),
        torch.empty((B, Hkv, 1, D), dtype=torch.bfloat16, device=dev),
    )


def _page_rows(pages, B, Hkv, D):
    """The layer's pools and each row's (page, slot) as the prep kernel takes
    them: contiguous bf16 [P, Hkv, ps, D], int64 [B] on the rows' device."""
    key_pages, value_pages, page_idx, slot = pages
    for pool in (key_pages, value_pages):
        if pool.dtype != torch.bfloat16 or not pool.is_contiguous() or pool.ndim != 4 \
                or pool.shape[1] != Hkv or pool.shape[3] != D:
            raise ValueError(f"pages must be contiguous bf16 [P, {Hkv}, ps, {D}]")
    idx = [t.reshape(-1).to(device=key_pages.device, dtype=torch.int64).contiguous()
           for t in (page_idx, slot)]
    if any(t.numel() != B for t in idx):
        raise ValueError(f"page_idx and slot must hold one entry per row ({B})")
    return key_pages, value_pages, idx[0], idx[1]


def fused_qkv_prep_cuda(qkv_rows, offsets, cos_row, sin_row, q_norm_w, k_norm_w, *, eps,
                        pages=None):
    global PREP_LAUNCHES
    B, Hkv, rows, D = qkv_rows.shape
    _, cos_row, sin_row, qw, kw = _check_rows(
        qkv_rows, q_norm_w, k_norm_w, cos_row, sin_row, offsets)
    q, k_row, v_row = _outputs(qkv_rows)
    page = slot = None
    ps = 0
    if pages is not None:
        k_row, v_row, page, slot = _page_rows(pages, B, Hkv, D)
        ps = k_row.shape[2]
    lib = _lib()
    err = lib.tlt_fused_qkv_prep(
        qkv_rows.data_ptr(), cos_row.data_ptr(), sin_row.data_ptr(), qw.data_ptr(),
        kw.data_ptr(), q.data_ptr(), k_row.data_ptr(), v_row.data_ptr(),
        None if page is None else page.data_ptr(), None if slot is None else slot.data_ptr(),
        B, Hkv, D, rows - 2, ps, float(eps),
        torch.cuda.current_stream(qkv_rows.device).cuda_stream,
    )
    build.check(lib, err, "fused_qkv_prep")
    PREP_LAUNCHES += 1
    return q if pages is not None else (q, k_row, v_row)


def fused_qkv_prep(
    qkv_rows: torch.Tensor,  # [B, Hkv, n_rep + 2, D] bf16
    offsets: torch.Tensor,  # [B] int32 — unused by the arithmetic, as in the JAX package
    cos_row: torch.Tensor,  # [B, D // 2] f32 — RoPE rows at `offsets`
    sin_row: torch.Tensor,
    q_norm_w: torch.Tensor,  # [D]
    k_norm_w: torch.Tensor,  # [D]
    *,
    eps: float,
    impl: str | None = None,
    pages: tuple | None = None,
):
    """The qkv split, QK-RMSNorm and RoPE of one layer's decode rows.

    Returns (q [B, Hkv, n_rep, D] normed and roped, unscaled; k_row
    [B, Hkv, 1, D] normed and roped; v_row [B, Hkv, 1, D] raw). With
    `pages` = (key_pages, value_pages, page_idx, slot), one layer's pools
    [P, Hkv, ps, D] and each row's page and slot ([B, 1] or [B], on the
    pools' device), the k and v rows go into pages[page_idx[b], :, slot[b]]
    instead (in place; the same launch on the card) and q alone returns."""
    fn = fused_qkv_prep_cuda if resolve(impl, qkv_rows) == "cuda" else fused_qkv_prep_plain
    return fn(qkv_rows, offsets, cos_row, sin_row, q_norm_w, k_norm_w, eps=eps, pages=pages)


def fused_decode_attention_cuda(
    qkv_rows, keys, values, offsets, cos_row, sin_row, q_norm_w, k_norm_w,
    *, layer_idx: int, scale: float, eps: float,
):
    """K2: one launch a call (the splits' walk and their merge) in splits of
    decode_split keys over the slab's S, counted once."""
    global LAUNCHES
    B, Hkv, rows, D = qkv_rows.shape
    Lyr, Bk, Hk, S, Dk = keys.shape
    if (Bk, Hk, Dk) != (B, Hkv, D) or values.shape != keys.shape:
        raise ValueError(f"slab {tuple(keys.shape)} does not match qkv {tuple(qkv_rows.shape)}")
    if not 0 <= layer_idx < Lyr:
        raise ValueError(f"layer_idx {layer_idx} out of range")
    for t in (keys, values):
        if t.dtype != torch.bfloat16 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("keys/values must be contiguous bf16 CUDA tensors")
    offsets, cos_row, sin_row, qw, kw = _check_rows(
        qkv_rows, q_norm_w, k_norm_w, cos_row, sin_row, offsets)
    attn, k_row, v_row = _outputs(qkv_rows)
    dev = qkv_rows.device
    lib = _lib()
    kps = decode_split(B, Hkv, S, 1, torch.cuda.get_device_properties(dev).multi_processor_count)
    nbytes = lib.tlt_fused_decode_workspace(B, Hkv, S, D, rows - 2, kps)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)  # the splits' partials
    err = lib.tlt_fused_decode_attention(
        qkv_rows.data_ptr(), keys.data_ptr(), values.data_ptr(), offsets.data_ptr(),
        cos_row.data_ptr(), sin_row.data_ptr(), qw.data_ptr(), kw.data_ptr(),
        attn.data_ptr(), k_row.data_ptr(), v_row.data_ptr(), ws.data_ptr(), nbytes,
        _arrivals(dev, B * Hkv).data_ptr(), layer_idx, B, Hkv, S, D, rows - 2, kps,
        float(scale), float(eps), torch.cuda.current_stream(dev).cuda_stream,
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


def fused_paged_decode_attention_plain(
    qkv_rows, key_pages, value_pages, block_table, offsets, cos_row, sin_row, q_norm_w,
    k_norm_w, *, scale: float, eps: float,
):
    """Plain PyTorch version: K2's plain version over the gathered pages,
    with the same rounding points."""
    k, v = gather_pages_dense(key_pages, value_pages, block_table)
    return fused_decode_attention_plain(
        qkv_rows, k[None], v[None], offsets, cos_row, sin_row, q_norm_w, k_norm_w,
        layer_idx=0, scale=scale, eps=eps,
    )


def fused_paged_decode_attention_cuda(
    qkv_rows, key_pages, value_pages, block_table, offsets, cos_row, sin_row, q_norm_w,
    k_norm_w, *, scale: float, eps: float,
):
    global PAGED_LAUNCHES
    B, Hkv, rows, D = qkv_rows.shape
    P, Hk, ps, Dk = key_pages.shape
    if (Hk, Dk) != (Hkv, D) or value_pages.shape != key_pages.shape:
        raise ValueError(
            f"pages {tuple(key_pages.shape)} do not match qkv {tuple(qkv_rows.shape)}")
    if block_table.ndim != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table {tuple(block_table.shape)} does not match B={B}")
    for t in (key_pages, value_pages):
        if t.dtype != torch.bfloat16 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("the pages must be contiguous bf16 CUDA tensors")
    offsets, cos_row, sin_row, qw, kw = _check_rows(
        qkv_rows, q_norm_w, k_norm_w, cos_row, sin_row, offsets)
    dev = qkv_rows.device
    bt = block_table.to(device=dev, dtype=torch.int32).contiguous()
    maxp = bt.shape[1]
    attn, k_row, v_row = _outputs(qkv_rows)
    lib = _lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kps = decode_split(B, Hkv, maxp, ps, sms)
    nbytes = lib.tlt_fused_paged_decode_workspace(B, Hkv, maxp, ps, D, rows - 2, kps)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)  # the splits' partials
    err = lib.tlt_fused_paged_decode_attention(
        qkv_rows.data_ptr(), key_pages.data_ptr(), value_pages.data_ptr(), bt.data_ptr(),
        offsets.data_ptr(), cos_row.data_ptr(), sin_row.data_ptr(), qw.data_ptr(),
        kw.data_ptr(), attn.data_ptr(), k_row.data_ptr(), v_row.data_ptr(), ws.data_ptr(),
        nbytes, _arrivals(dev, B * Hkv).data_ptr(), B, Hkv, ps, maxp, D, rows - 2, kps,
        float(scale), float(eps), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "fused_paged_decode_attention")
    PAGED_LAUNCHES += 1
    return attn, k_row, v_row


def fused_paged_decode_attention(
    qkv_rows: torch.Tensor,  # [B, Hkv, n_rep + 2, D] bf16
    key_pages: torch.Tensor,  # [P, Hkv, ps, D] — one layer's pages
    value_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32, -1 padded
    offsets: torch.Tensor,  # [B] int32 — context length before this token
    cos_row: torch.Tensor,  # [B, D // 2] f32 — RoPE rows at `offsets`
    sin_row: torch.Tensor,
    q_norm_w: torch.Tensor,  # [D]
    k_norm_w: torch.Tensor,  # [D]
    *,
    scale: float,
    eps: float,
    impl: str | None = None,
):
    """One layer's decode attention over the page pool from the fused qkv row.

    Returns (attn [B, Hkv, n_rep, D], k_row [B, Hkv, 1, D], v_row [B, Hkv, 1, D]);
    the caller writes k_row/v_row at each row's (page, slot)."""
    fn = (
        fused_paged_decode_attention_cuda
        if resolve(impl, qkv_rows) == "cuda"
        else fused_paged_decode_attention_plain
    )
    return fn(
        qkv_rows, key_pages, value_pages, block_table, offsets, cos_row, sin_row, q_norm_w,
        k_norm_w, scale=scale, eps=eps,
    )
