"""K3: causal flash attention over dense K/V with per-row lengths, and its
state-emitting twin.

K3 replaces tiny_llm_tpu/kernels/flash_attention_pallas.py::_prefill_kernel
(wrapper `_flash_prefill`, through `flash_attention_pallas` for L > 16)
and covers its L <= 16 sibling `_decode_kernel` (`_flash_decode`): the
CUDA entry, csrc/flash_attention.cu, takes any L >= 1, on two routes. At
L <= 16 it runs the shard decode-state kernel's split-key walk over the
slab and an o-only combine; above, the causal tensor-core tile, its keys
split too where its q tiles leave SMs idle, the splits merged by the same
combine. `flash_split` picks the keys a split holds from the shapes alone;
`flash_attention_split_plain` is the split and combine in plain PyTorch,
for the tests. The state twin,
`flash_prefill_state`, replaces `_prefill_state_kernel`
(`flash_prefill_state_pallas`): the same attention, returning the output
locally normalised with each row's softmax state (m, l), for the split
paged prefill (kernels/split_prefill.py). `flash_decode_state` replaces
`_decode_state_kernel` (`flash_decode_state_pallas`): decode (L <= 16)
over one shard of a sequence-sharded slab, returning (o, m, l) for the
sequence-parallel combine (parallel/sp_attention.py); its k/v may be
strided views of the slab. Its CUDA entry is a split-key walk (the paged
decode's, csrc/split_walk.cuh) in splits of `decode_split` keys, a partial
state per split in a workspace the entry sizes, and a combine kernel;
`flash_decode_state_split_plain` is the split and combine in plain
PyTorch, for the tests. The CUDA source's header notes what bounds them on
the H100 and what their design does about that.

Conventions are the JAX package's: q [B, Hq, L, D], k/v [B, Hkv, S, D]
(GQA, n_rep = Hq // Hkv), lens [B] — row b's valid KV length; query i sits
at position lens[b] - L + i and sees keys at positions <= its own. Keys at
positions >= lens[b] are never read, so k/v may be a whole preallocated
slab layer.

`flash_attention` also takes an explicit additive mask (`mask=<tensor>`,
the JAX package's contract): the mask replaces causality, every query row
sits at position lens[b] - 1 so only the length bounds the keys, and the
mask is added to the scores after that clamp. That route's kernel,
csrc/flash_attention_masked.cu (`flash_attention_masked_cuda`), replaces
`_decode_kernel_masked` (L <= 16) and `_prefill_kernel_masked` (L > 16);
`mask=None` is the same route with no mask (no causality). It has two
designs: at L <= 16 a walk with the keys split over more blocks
(`decode_chunk` keys each), whose f32 partials a second kernel combines;
above, the tensor-core tile walking only the key tiles that the live-tile
map (`mask_tile_map_plain` is its plain twin) marks. The plain twins of
those two pieces serve the tests: the route never calls them.

`flash_attention` also takes an attention-strategy object as `impl` (one
with `.flash`, as parallel.SPAttention): the call is then the strategy's,
as in the JAX package; a strategy takes causal attention only.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .dispatch import resolve

TPU_KERNEL = "tiny_llm_tpu/kernels/flash_attention_pallas.py:450 _prefill_kernel"
TPU_KERNEL_SHORT = "tiny_llm_tpu/kernels/flash_attention_pallas.py:81 _decode_kernel"
TPU_KERNEL_STATE = "tiny_llm_tpu/kernels/flash_attention_pallas.py:597 _prefill_state_kernel"
TPU_KERNEL_DECODE_STATE = "tiny_llm_tpu/kernels/flash_attention_pallas.py:282 _decode_state_kernel"
TPU_KERNEL_MASKED = "tiny_llm_tpu/kernels/flash_attention_pallas.py:401 _prefill_kernel_masked"
TPU_KERNEL_MASKED_SHORT = "tiny_llm_tpu/kernels/flash_attention_pallas.py:133 _decode_kernel_masked"
DECODE_MAX_L = 16
SOURCE = "tiny_llm_tpu_torch/csrc/flash_attention.cu"
SOURCE_MASKED = "tiny_llm_tpu_torch/csrc/flash_attention_masked.cu"
NEG_INF = -1e30

# K3's tile splits its keys only over a slab of at least K3_SPLIT_MIN_S
# keys (flash_split).
K3_SPLIT_MIN_S = 2048

# The masked route's tiles: 16 query rows by 64 keys in the live-tile map
# (64 keys a tile of both walks); a decode split holds 4 to 64 tiles.
MAP_ROWS, MAP_KEYS, MIN_CHUNK, MAX_CHUNK = 16, 64, 256, 4096

LAUNCHES = 0  # kernel launches since the last reset (see kernels.reset_launches)
STATE_LAUNCHES = 0  # the state twin's
DECODE_STATE_LAUNCHES = 0  # the shard decode-state kernel's
MASKED_LAUNCHES = 0  # the explicit-mask kernel's


def kernel_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x (f32) rounded through bf16 where the kernels round, for bf16
    inputs; f32 inputs (an f32 model on the CPU, the JAX package's oracle
    mode) stay f32, as the JAX XLA route computes them."""
    return x.to(torch.bfloat16).to(torch.float32) if dtype == torch.bfloat16 else x


def _attention_sums(q, k, v, ok, scale: float, bias=None):
    """attention_state_plain before its division: (acc, m, l), acc the f32
    sum of the bf16 probabilities times v [B, Hq, L, D] (f32 probabilities
    for f32 inputs), m and l [B, Hq, L] f32."""
    B, Hq, L, D = q.shape
    Hkv = k.shape[1]
    n_rep = Hq // Hkv
    qs = kernel_round(q.to(torch.float32) * scale, q.dtype)
    qs = qs.reshape(B, Hkv, n_rep, L, D)
    s = torch.einsum("bhrld,bhsd->bhrls", qs, k.to(torch.float32))
    s = torch.where(ok[:, None, None], s, NEG_INF)
    if bias is not None:
        heads = (Hkv, n_rep) if bias.shape[1] != 1 else (1, 1)
        s = torch.clamp(s + bias.reshape(B, *heads, L, -1), min=NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.clamp(m, min=NEG_INF / 2))
    l = p.sum(-1, keepdim=True)
    pb = kernel_round(p, q.dtype)
    acc = torch.einsum("bhrls,bhsd->bhrld", pb, v.to(torch.float32))
    return acc.reshape(B, Hq, L, D), m.reshape(B, Hq, L), l.reshape(B, Hq, L)


def _split_state(q, k, v, ok, scale: float, chunk: int):
    """The keys cut into chunks of `chunk`, each chunk's (acc, m, l) at
    attention_state_plain's rounding points (p rounded against the chunk's
    max), merged in f32 with the subtrahend floored at NEG_INF / 2 and o
    rounded to q's dtype once, as the walks' combine kernels do. Returns
    (o, m, l); a row that sees no key gives (0, NEG_INF, 0)."""
    key = torch.arange(k.shape[2], device=q.device)
    parts = [_attention_sums(q, k, v, ok & (key >= k0) & (key < k0 + chunk), scale)
             for k0 in range(0, k.shape[2], chunk)]
    acc, m, l = (torch.stack(t) for t in zip(*parts))
    mx = m.amax(0)
    w = torch.exp(m - torch.clamp(mx, min=NEG_INF / 2))
    l = (w * l).sum(0)
    out = (w[..., None] * acc).sum(0) / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype), mx, l


def attention_state_plain(q, k, v, ok, scale: float, bias=None):
    """Attention of q [B, Hq, L, D] over k/v [B, Hkv, S, D] where ok
    [B, L, S] marks the visible keys, at the TPU kernels' rounding points:
    q*scale rounded to bf16, f32 scores and softmax, bf16 probabilities in
    the PV product, acc / max(l, 1e-30) (f32 inputs round nowhere). `bias` (an additive f32 mask
    [B, 1 or Hq, L, S]) is added after the visibility clamp and the sum
    floored at NEG_INF. Returns (out in q's dtype, m, l [B, Hq, L] f32); a
    row that sees no key gives (0, NEG_INF, 0)."""
    acc, m, l = _attention_sums(q, k, v, ok, scale, bias)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype), m, l


def _causal_mask(lens, L: int, S: int, device):
    """[B, L, S]: query i of row b (at position lens[b] - L + i) sees keys
    at positions <= its own."""
    lens = lens.to(device=device, dtype=torch.int64)
    q_pos = lens[:, None] - L + torch.arange(L, device=device)[None, :]  # [B, L]
    return torch.arange(S, device=device)[None, None, :] <= q_pos[:, :, None]


def flash_attention_plain(q, k, v, lens, scale: float):
    """K3's plain PyTorch version (attention_state_plain's rounding points);
    a row that sees no key gives 0."""
    ok = _causal_mask(lens, q.shape[2], k.shape[2], q.device)
    return attention_state_plain(q, k, v, ok, scale)[0]


def flash_prefill_state_plain(q, k, v, lens, scale: float):
    """The state twin's plain version: K3's attention and each row's (m, l)."""
    ok = _causal_mask(lens, q.shape[2], k.shape[2], q.device)
    return attention_state_plain(q, k, v, ok, scale)


# The shard decode-state kernel computes the state twin's function (a row
# that sees no key of the shard gives (0, NEG_INF, 0)): one plain version.
flash_decode_state_plain = flash_prefill_state_plain


def flash_decode_state_split_plain(q, k, v, lens, scale: float, keys_per_split: int):
    """The shard decode-state walk's split and combine in plain PyTorch
    (tests only): the shard's keys cut into splits of `keys_per_split`, each
    split's state at the kernels' rounding points, merged as state_combine
    does (_split_state). Returns (o, m, l); a row that sees no key of the
    shard gives (0, NEG_INF, 0)."""
    ok = _causal_mask(lens, q.shape[2], k.shape[2], q.device)
    return _split_state(q, k, v, ok, scale, keys_per_split)


def flash_attention_split_plain(q, k, v, lens, scale: float, keys_per_split: int):
    """K3's split and combine in plain PyTorch (tests only): the slab's keys
    cut into splits of `keys_per_split`, each split's (acc, m, l) at the
    kernels' rounding points, merged as flash_combine does (_split_state).
    Returns o; a row that sees no key gives 0."""
    ok = _causal_mask(lens, q.shape[2], k.shape[2], q.device)
    return _split_state(q, k, v, ok, scale, keys_per_split)[0]


def flash_split(B: int, Hkv: int, L: int, n_rep: int, S: int, sms: int) -> int:
    """Keys a split of K3 holds over a slab of S keys, from the shapes and
    the SM count alone, never from lens, which lives on the device (reading
    it would sync and break a CUDA graph's capture). At L <= 16 the shard
    decode-state walk's (decode_split with S for the table's width); above,
    the paged prefill's (prefill_split over S keys: one split where the q
    tiles fill more than half the SMs), but one split over a slab of fewer
    than K3_SPLIT_MIN_S keys. A split costs a combine launch even where
    every row sees only its chunk's own keys (a prompt's first chunk),
    which the shapes cannot tell from a chunk at the slab's end; over 1024
    keys the two lose alike, over 2048 or more the split loses less
    (kernels/row_timing.py --rows K3split)."""
    from .paged_attention import decode_split, prefill_split

    if L <= DECODE_MAX_L:
        return decode_split(B, Hkv, S, 1, sms)
    if S < K3_SPLIT_MIN_S:
        return S
    return prefill_split(B, Hkv, L, n_rep, S, 1, sms)


def normalize_mask(mask: torch.Tensor, B: int, L: int, S: int) -> torch.Tensor:
    """An explicit additive mask as [B, 1 or H, L, S] (a view; the port's
    copy of the JAX package's normalize_mask). Accepted: [L, S] (shared by
    the batch), [B, L, S] (per row), [B, 1 or H, L, S]. A bare rank-3 mask
    never aligns its batch axis with the heads."""
    if mask.ndim == 2 and tuple(mask.shape) == (L, S):
        return mask[None, None].expand(B, 1, L, S)
    if mask.ndim == 3 and tuple(mask.shape) == (B, L, S):
        return mask[:, None]
    if mask.ndim == 4 and mask.shape[0] == B and tuple(mask.shape[2:]) == (L, S):
        return mask
    raise ValueError(f"mask {tuple(mask.shape)}: expected [L, S], [B, L, S] or [B, H, L, S] "
                     f"with B={B}, L={L}, S={S}")


def _mask_planes(mask: torch.Tensor, B: int, Hq: int, L: int, S: int, device) -> torch.Tensor:
    """The mask as f32 [B, 1 or Hq, L, S] on `device` (an [L, S] mask stays
    one plane, batch stride 0)."""
    m4 = normalize_mask(mask.to(device=device, dtype=torch.float32), B, L, S)
    if m4.shape[1] not in (1, Hq):
        raise ValueError(f"per-head mask head axis {m4.shape[1]} != Hq {Hq}")
    return m4


def _visible_keys(lens, B: int, L: int, S: int, device):
    """[B, L, S]: the keys below lens[b], for every query row."""
    lens = lens.to(device=device, dtype=torch.int64)
    ok = torch.arange(S, device=device)[None, :] < lens[:, None]
    return ok[:, None, :].expand(B, L, S)


def flash_attention_masked_plain(q, k, v, lens, mask, scale: float):
    """The explicit-mask kernel's plain version: every query row sees the
    keys below lens[b], plus `mask` (f32 [B, 1 or Hq, L, S], or None for no
    mask), at attention_state_plain's rounding points; a row that sees no
    key gives 0."""
    B, _, L, _ = q.shape
    S = k.shape[2]
    return attention_state_plain(q, k, v, _visible_keys(lens, B, L, S, q.device), scale,
                                 bias=mask)[0]


def flash_attention_masked_split_plain(q, k, v, lens, mask, scale: float, splits: int):
    """The decode walk's split and combine in plain PyTorch (tests only):
    the keys cut into `splits` chunks of ceil(S / splits), each chunk's
    (acc, m, l) at attention_state_plain's rounding points (p rounded
    against the chunk's max), merged in f32 with the subtrahend floored at
    NEG_INF / 2 and rounded to q's dtype once, as combine_splits does. A
    row that sees no key gives 0."""
    B, _, L, _ = q.shape
    S = k.shape[2]
    chunk = -(-S // splits)
    key = torch.arange(S, device=q.device)
    ok = _visible_keys(lens, B, L, S, q.device)
    parts = [_attention_sums(q, k, v, ok & (key >= s0) & (key < s0 + chunk), scale, bias=mask)
             for s0 in range(0, S, chunk)]
    acc, m, l = (torch.stack(t) for t in zip(*parts))
    w = torch.exp(m - torch.clamp(m.amax(0), min=NEG_INF / 2))
    out = (w[..., None] * acc).sum(0) / torch.clamp((w * l).sum(0), min=1e-30)[..., None]
    return out.to(q.dtype)


def mask_tile_map_plain(mask: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The live-tile map of the masked prefill walk (csrc/
    flash_attention_masked.cu mask_tile_map) for an f32 mask [B, P, L, S]
    (P = 1 or Hq): bool [B, P, ceil(L / 16), ceil(S / 64)], True where the
    block of 16 query rows and 64 keys holds an entry above NEG_INF below L
    and below min(lens[b], S). -inf and NEG_INF itself are hidden."""
    B, P, L, S = mask.shape
    G, NT = -(-L // MAP_ROWS), -(-S // MAP_KEYS)
    live = torch.zeros((B, P, G * MAP_ROWS, NT * MAP_KEYS), dtype=torch.bool, device=mask.device)
    live[..., :L, :S] = (mask > NEG_INF) & _visible_keys(lens, B, L, S, mask.device)[:, None]
    return live.reshape(B, P, G, MAP_ROWS, NT, MAP_KEYS).any(5).any(3)


def decode_chunk(B: int, Hkv: int, S: int, sms: int) -> int:
    """Keys a split of the masked decode walk (L <= 16): a multiple of 64
    from MIN_CHUNK to MAX_CHUNK, small enough that the grid (splits, Hkv,
    B) covers `sms` SMs at least twice where S allows splits of MIN_CHUNK
    keys (a block's start, its vote and its first tile's latency, costs
    about as much as three tiles). From the shapes alone, never from lens,
    which lives on the device (reading it would sync and break a CUDA
    graph's capture)."""
    want = -(-2 * sms // (B * Hkv))
    return min(MAX_CHUNK, max(MIN_CHUNK, S // want // MAP_KEYS * MAP_KEYS))


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.tlt_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.tlt_flash_attention_workspace
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    fn = lib.tlt_flash_prefill_state
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.tlt_flash_decode_state
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.tlt_flash_decode_state_workspace
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    return lib


def _lib_masked() -> ctypes.CDLL:
    lib = build.load("flash_attention_masked")
    fn = lib.tlt_flash_attention_masked
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.tlt_flash_attention_masked_workspace
    fn.argtypes = [ctypes.c_int] * 8
    fn.restype = ctypes.c_longlong
    return lib


def _check_args(what, q, k, v, strided_kv: bool = False):
    """(B, Hq, L, D, Hkv, S, n_rep) after the checks every kernel here
    needs. `strided_kv`: k and v may be views with any batch and head
    strides (one shard of a slab), their rows still contiguous."""
    B, Hq, L, D = q.shape
    Bk, Hkv, S, Dk = k.shape
    if (Bk, Dk) != (B, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} do not match")
    n_rep = Hq // Hkv
    if D not in (64, 128) or n_rep not in (1, 2, 4, 8):
        raise ValueError(f"{what}: unsupported D={D}, n_rep={n_rep}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16 or not t.is_cuda:
            raise ValueError("q/k/v must be bf16 CUDA tensors")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if strided_kv:
        if k.stride() != v.stride() or k.stride()[2:] != (D, 1):
            raise ValueError(f"k/v strides {k.stride()} / {v.stride()}: the rows must be "
                             "contiguous and k and v alike")
        if any(x % 8 for x in k.stride()[:2]) or k.data_ptr() % 16 or v.data_ptr() % 16:
            raise ValueError("k/v rows must start 16-byte aligned")
    elif not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("k/v must be contiguous")
    return B, Hq, L, D, Hkv, S, n_rep


def flash_attention_cuda(q, k, v, lens, scale: float):
    """K3: one call of the C entry in splits of flash_split keys (at L <= 16
    the walk and its combine; above, the tile and, where it splits the
    keys, the combine), counted once. k and v may be strided views of a
    slab (a head shard of it), read in place."""
    global LAUNCHES
    B, Hq, L, D, Hkv, S, n_rep = _check_args("flash_attention_cuda", q, k, v, strided_kv=True)
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    kps = flash_split(B, Hkv, L, n_rep, S,
                      torch.cuda.get_device_properties(q.device).multi_processor_count)
    nbytes = lib.tlt_flash_attention_workspace(B, Hkv, L, S, D, n_rep, kps)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
    err = lib.tlt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), nbytes, B, Hkv, L, S, k.stride(0), k.stride(1),
        D, n_rep, kps, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "flash_attention")
    LAUNCHES += 1
    return out


def flash_prefill_state_cuda(q, k, v, lens, scale: float):
    global STATE_LAUNCHES
    B, Hq, L, D, Hkv, S, n_rep = _check_args("flash_prefill_state_cuda", q, k, v)
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    m = torch.empty((B, Hq, L), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    lib = _lib()
    err = lib.tlt_flash_prefill_state(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(), m.data_ptr(),
        l.data_ptr(), B, Hkv, L, S, D, n_rep, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "flash_prefill_state")
    STATE_LAUNCHES += 1
    return out, m, l


def flash_decode_state_cuda(q, k, v, lens, scale: float):
    """The shard decode-state kernel (L <= 16): one call of the C entry,
    the split walk over the shard's keys in splits of decode_split keys
    (from the shapes and the SM count alone) and its combine, counted once."""
    from .paged_attention import decode_split

    global DECODE_STATE_LAUNCHES
    B, Hq, L, D, Hkv, S, n_rep = _check_args("flash_decode_state_cuda", q, k, v,
                                             strided_kv=True)
    if not 1 <= L <= DECODE_MAX_L:
        raise ValueError(f"flash_decode_state takes 1 <= L <= {DECODE_MAX_L}, got L={L}")
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    m = torch.empty((B, Hq, L), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    lib = _lib()
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    kps = decode_split(B, Hkv, S, 1, sms)
    nbytes = lib.tlt_flash_decode_state_workspace(B, Hkv, L, S, D, n_rep, kps)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=q.device)  # the splits' partials
    err = lib.tlt_flash_decode_state(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(), m.data_ptr(),
        l.data_ptr(), ws.data_ptr(), nbytes, B, Hkv, L, S, k.stride(0), k.stride(1), D, n_rep,
        kps, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "flash_decode_state")
    DECODE_STATE_LAUNCHES += 1
    return out, m, l


def flash_attention_masked_cuda(q, k, v, lens, mask, scale: float):
    """Launch the explicit-mask kernel; `mask` f32 [B, 1 or Hq, L, S] on
    q's device (any batch and head strides, rows contiguous), or None. One
    call of the C entry, counted once: at L <= 16 the split walk and its
    combine, above it (with a mask) the live-tile map and the walk."""
    global MASKED_LAUNCHES
    B, Hq, L, D, Hkv, S, n_rep = _check_args("flash_attention_masked_cuda", q, k, v)
    lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
    mode, msb, msh = 0, 0, 0
    if mask is not None:
        if mask.dtype != torch.float32 or mask.device != q.device \
                or tuple(mask.shape) not in ((B, 1, L, S), (B, Hq, L, S)):
            raise ValueError(f"mask must be f32 [B, 1 or Hq, L, S] on {q.device}")
        if mask.stride(-1) != 1 or (L > 1 and mask.stride(-2) != S):
            mask = mask.contiguous()
        mode = 1 if mask.shape[1] == 1 else 2
        msb, msh = mask.stride(0), mask.stride(1)
    out = torch.empty_like(q)
    lib = _lib_masked()
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk = decode_chunk(B, Hkv, S, sms)
    nbytes = lib.tlt_flash_attention_masked_workspace(B, Hkv, L, S, D, n_rep, mode, chunk)
    # The decode partials, or the prefill's map and lists.
    ws = torch.empty(max(1, nbytes), dtype=torch.uint8, device=q.device)
    err = lib.tlt_flash_attention_masked(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), ws.data_ptr(), B, Hkv, L, S,
        D, n_rep, mode, msb, msh, chunk, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "flash_attention_masked")
    MASKED_LAUNCHES += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lens: torch.Tensor | None = None,
    scale: float | None = None,
    impl=None,
    mask: torch.Tensor | str | None = "causal",
) -> torch.Tensor:
    """Attention of the last L positions of each row over k/v; `lens`
    defaults to S. mask "causal": query i at position lens[b] - L + i sees
    the keys at or before it. mask a tensor ([L, S], [B, L, S] or
    [B, 1 or Hq, L, S], additive): every query sees the keys below
    lens[b] plus the mask (a row that sees no key gives 0). mask None: the
    keys below lens[b], no mask."""
    if isinstance(mask, str) and mask != "causal":
        raise ValueError(f"mask {mask!r}: expected 'causal', None or a tensor")
    explicit = not isinstance(mask, str)
    if impl is not None and not isinstance(impl, str):
        if explicit:
            raise ValueError("an attention strategy takes causal attention only, not a mask")
        return impl.flash(q, k, v, lens, scale=scale)
    B, Hq, L, _ = q.shape
    S = k.shape[2]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if lens is None:
        lens = torch.full((B,), S, dtype=torch.int32, device=q.device)
    cuda = resolve(impl, q) == "cuda"
    if not explicit:
        return (flash_attention_cuda if cuda else flash_attention_plain)(q, k, v, lens, scale)
    m4 = None if mask is None else _mask_planes(mask, B, Hq, L, S, q.device)
    fn = flash_attention_masked_cuda if cuda else flash_attention_masked_plain
    return fn(q, k, v, lens, m4, scale)


def flash_prefill_state(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lens: torch.Tensor,
    scale: float | None = None,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flash_attention's attention as (o, m, l): o [B, Hq, L, D] locally
    normalised in q's dtype, m (max scaled score) and l (sum of the f32
    probabilities) [B, Hq, L] f32."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if resolve(impl, q) == "cuda":
        return flash_prefill_state_cuda(q, k, v, lens, scale)
    return flash_prefill_state_plain(q, k, v, lens, scale)


def flash_decode_state(
    q: torch.Tensor,  # [B, Hq, L, D], L <= 16
    k: torch.Tensor,  # [B, Hkv, S_loc, D] — one shard, rows contiguous
    v: torch.Tensor,
    lens: torch.Tensor,  # [B] int — the shard's valid keys per row (0 is fine)
    scale: float | None = None,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode attention over one KV shard as (o, m, l): o [B, Hq, L, D]
    normalised within the shard in q's dtype, m and l [B, Hq, L] f32."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if resolve(impl, q) == "cuda":
        return flash_decode_state_cuda(q, k, v, lens, scale)
    return flash_decode_state_plain(q, k, v, lens, scale)
