"""Paged attention over a block-table-indexed page pool: the paged decode
kernel (L <= 16), the paged prefill kernel (L > 16) and the paged
prefix-state walk of the split paged prefill.

Counterpart of tiny_llm_tpu/kernels/paged_attention.py (`gather_pages_dense`,
`paged_attention`) and of the Pallas kernels the TPU dispatches to
(`paged_attention_pallas`, paged_attention_pallas.py:862, 918):
  * L <= 16: `_paged_decode_gather_kernel` (`paged_flash_decode_gather`;
    `_paged_decode_kernel` and `_paged_decode_page_kernel` compute the same
    function) -> `tlt_paged_decode` in csrc/paged_attention.cu: a split-key
    walk over each row's keys in splits of `decode_split` keys, a partial
    state per split in a workspace the entry sizes, and a combine kernel
    that writes o;
  * L > 16: `_paged_prefill_kernel` (`paged_flash_prefill`)
    -> `tlt_paged_prefill` in the same file: the causal tensor-core tile,
    its grid widened by splitting each row's keys (`prefill_split`) where
    the q tiles alone leave SMs idle, the splits' partials merged by the
    decode's combine;
  * `paged_prefix_state`: `_paged_prefix_state_kernel` (same name,
    paged_attention_pallas.py:771) -> `tlt_paged_prefix_state`: a chunk's
    queries over the prefix pages before it, non-causally, emitting the
    softmax state (o, m, l) that kernels/split_prefill.py combines;
  * `paged_decode_state`: `_paged_decode_state_kernel` (same name,
    paged_attention_pallas.py:640) -> `tlt_paged_decode_state`: decode
    (L <= 16) over the pages ONE shard of a sequence-sharded pool owns,
    emitting (o, m, l) for the sequence-parallel combine
    (parallel/sp_attention.py). A split-key walk: each row's block table
    in splits of `decode_state_split` entries, a partial state per split in
    a workspace the entry sizes, and a combine kernel.
The CUDA source's header notes what bounds them on the H100 and what
their design does about it.

Layout (the JAX package's): one layer's pages [P, Hkv, page_size, D],
block_table int32 [B, max_pages] (-1 padded; -1 reads the trash page 0),
context_lens int32 [B] counting every valid token INCLUDING the current
queries — the chunk's K/V are already written to the pages. Query i of row
b sits at position context_lens[b] - L + i and sees keys at positions <=
its own. The paged decode and prefill kernels also read a head shard of
a pool in place: pages pool[:, h0:h1], whose pages stay a pool's page
apart (parallel/tp_kernels.py TPAttention).

`paged_attention` also takes an attention-strategy object as `impl` (one
with `.paged`, as parallel.SPAttention): the call is then the strategy's,
as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .dispatch import resolve
from .flash_attention import (
    _causal_mask,
    _split_state,
    attention_state_plain,
    flash_attention_plain,
)

TPU_KERNEL_DECODE = "tiny_llm_tpu/kernels/paged_attention_pallas.py:297 _paged_decode_gather_kernel"
TPU_KERNEL_PREFILL = "tiny_llm_tpu/kernels/paged_attention_pallas.py:475 _paged_prefill_kernel"
TPU_KERNEL_PREFIX = "tiny_llm_tpu/kernels/paged_attention_pallas.py:716 _paged_prefix_state_kernel"
TPU_KERNEL_DECODE_STATE = (
    "tiny_llm_tpu/kernels/paged_attention_pallas.py:583 _paged_decode_state_kernel")
SOURCE = "tiny_llm_tpu_torch/csrc/paged_attention.cu"
DECODE_MAX_L = 16  # paged_attention_pallas.py:862
# The decode-state walk's splits: at least STATE_MIN_KEYS keys (a block's
# start, its list of the shard's pages and its first tile's latency cost
# about what three tiles do), at most STATE_MAX_ENTRIES table entries (the
# kernel's list, csrc/paged_attention.cu PDS_MAX_ENTRIES).
STATE_MIN_KEYS, STATE_MAX_ENTRIES = 256, 256
# The paged decode's and prefill's key splits: whole KEY_TILE-key tiles of
# the walks, at least DECODE_MIN_KEYS / PREFILL_MIN_KEYS keys (a block's
# start and its first tile's latency cost about what one more tile does).
# The prefill's q tiles hold PREFILL_ROWS rows (n_rep heads).
KEY_TILE, DECODE_MIN_KEYS = 64, 128
PREFILL_ROWS, PREFILL_MIN_KEYS = 128, 128

# Kernel launches since the last reset (see kernels.reset_launches).
DECODE_LAUNCHES = 0
PREFILL_LAUNCHES = 0
PREFIX_LAUNCHES = 0
DECODE_STATE_LAUNCHES = 0


def gather_pages_dense(key_pages, value_pages, block_table):
    """The logical K/V of each row: -> [B, Hkv, max_pages * page_size, D].
    -1 entries gather page 0; those positions lie past context_lens and are
    masked downstream."""
    table = block_table.to(device=key_pages.device, dtype=torch.long).clamp(min=0)
    B, n_pages = table.shape
    _, H, ps, D = key_pages.shape
    k = key_pages[table].permute(0, 2, 1, 3, 4).reshape(B, H, n_pages * ps, D)
    v = value_pages[table].permute(0, 2, 1, 3, 4).reshape(B, H, n_pages * ps, D)
    return k, v


def paged_attention_plain(q, key_pages, value_pages, block_table, context_lens, scale: float):
    """Plain PyTorch version of both kernels: gather the pages, then causal
    attention with the mask k_pos <= context_lens - L + i at the kernels'
    rounding points (K3's plain version, kernels/flash_attention.py)."""
    k, v = gather_pages_dense(key_pages, value_pages, block_table)
    return flash_attention_plain(q, k, v, context_lens, scale)


def paged_prefix_state_plain(q, key_pages, value_pages, block_table, prefix_lens,
                             scale: float):
    """Plain version of the prefix walk: gather the pages, then every key
    below prefix_lens[b] visible to every query of row b, at the kernels'
    rounding points. Returns (o, m, l); a row with prefix 0 gives
    (0, NEG_INF, 0)."""
    k, v = gather_pages_dense(key_pages, value_pages, block_table)
    B, _, L, _ = q.shape
    lens = prefix_lens.to(device=q.device, dtype=torch.int64)
    ok = torch.arange(k.shape[2], device=q.device)[None, None, :] < lens[:, None, None]
    return attention_state_plain(q, k, v, ok.expand(B, L, k.shape[2]), scale)


def paged_decode_state_plain(q, key_pages_loc, value_pages_loc, block_table, context_lens,
                             page_base: int, scale: float):
    """Plain version of the shard walk: gather the shard's pages through the
    table's owned entries (global ids in [page_base, page_base + P_loc)),
    then causal attention over the keys on those pages only, at the kernels'
    rounding points. Returns (o, m, l); a row none of whose visible keys
    the shard owns gives (0, NEG_INF, 0)."""
    P_loc, _, ps, _ = key_pages_loc.shape
    bt = block_table.to(device=q.device, dtype=torch.long)
    local = bt - page_base
    owned = (local >= 0) & (local < P_loc)  # [B, maxp]; -1 entries are never owned
    k, v = gather_pages_dense(key_pages_loc, value_pages_loc, local.clamp(0, P_loc - 1))
    L = q.shape[2]
    ok = _causal_mask(context_lens, L, k.shape[2], q.device)
    ok = ok & owned.repeat_interleave(ps, dim=1)[:, None, :]
    return attention_state_plain(q, k, v, ok, scale)


def paged_decode_state_split_plain(q, key_pages_loc, value_pages_loc, block_table, context_lens,
                                   page_base: int, scale: float, splits: int):
    """The decode-state walk's split and combine in plain PyTorch (tests
    only): the table cut into `splits` chunks of ceil(max_pages / splits)
    entries, each over the shard's keys in it (_split_state). Returns
    (o, m, l); a row that sees none of the shard's keys gives
    (0, NEG_INF, 0)."""
    P_loc, _, ps, _ = key_pages_loc.shape
    bt = block_table.to(device=q.device, dtype=torch.long)
    local = bt - page_base
    owned = ((local >= 0) & (local < P_loc)).repeat_interleave(ps, dim=1)[:, None, :]
    k, v = gather_pages_dense(key_pages_loc, value_pages_loc, local.clamp(0, P_loc - 1))
    ok = _causal_mask(context_lens, q.shape[2], k.shape[2], q.device) & owned
    return _split_state(q, k, v, ok, scale, -(-bt.shape[1] // splits) * ps)


def paged_attention_split_plain(q, key_pages, value_pages, block_table, context_lens,
                                scale: float, keys_per_split: int):
    """The paged decode walk's and the split paged prefill's split and
    combine in plain PyTorch (tests only): each row's keys cut into splits
    of `keys_per_split` (a split may start inside a page), merged as
    decode_combine does (_split_state). Returns o; a row that sees no key
    gives 0."""
    k, v = gather_pages_dense(key_pages, value_pages, block_table)
    ok = _causal_mask(context_lens, q.shape[2], k.shape[2], q.device)
    return _split_state(q, k, v, ok, scale, keys_per_split)[0]


def decode_state_split(B: int, Hkv: int, max_pages: int, page_size: int, sms: int) -> int:
    """Block-table entries a split of the decode-state walk holds: enough
    splits that the grid (splits, Hkv, B) covers `sms` SMs at least twice
    where the table's width allows splits of STATE_MIN_KEYS keys, at most
    STATE_MAX_ENTRIES entries. From the shapes alone, never from the lengths
    or the table, which live on the device (reading them would sync and
    break a CUDA graph's capture)."""
    want = -(-2 * sms // (B * Hkv))
    least = -(-STATE_MIN_KEYS // page_size)
    return max(1, min(STATE_MAX_ENTRIES, max(max_pages // want, least)))


def decode_split(B: int, Hkv: int, max_pages: int, page_size: int, sms: int) -> int:
    """Keys a split of the paged decode walk holds: whole KEY_TILE-key
    tiles, at least DECODE_MIN_KEYS, and enough splits that the grid
    (splits, Hkv, B) covers `sms` SMs at least twice where the table's
    width (max_pages * page_size keys) allows. The shard decode-state walk
    over a slab of S keys asks with (S, 1). From the shapes alone, never
    from the lengths or the table, which live on the device (reading them
    would sync and break a CUDA graph's capture)."""
    want = -(-2 * sms // (B * Hkv))
    keys = max_pages * page_size // want // KEY_TILE * KEY_TILE
    return max(DECODE_MIN_KEYS, keys)


def prefill_split(B: int, Hkv: int, L: int, n_rep: int, max_pages: int, page_size: int,
                  sms: int) -> int:
    """Keys a split of the paged prefill holds: the table's width (one
    split: the unsplit kernel, no workspace) where the grid's q tiles,
    ceil(L / (PREFILL_ROWS / n_rep)) x Hkv x B blocks of one SM each (the
    tile's shared memory), fill more than half the `sms` SMs; else whole
    KEY_TILE-key tiles, at least PREFILL_MIN_KEYS, in as many splits as
    fill the SMs once. From the shapes alone, as decode_split."""
    keys = max_pages * page_size
    want = sms // (-(-L // (PREFILL_ROWS // n_rep)) * Hkv * B)
    if want < 2:
        return keys
    kps = -(-keys // want // KEY_TILE) * KEY_TILE
    return min(keys, max(PREFILL_MIN_KEYS, kps))


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    for fn in (lib.tlt_paged_decode, lib.tlt_paged_prefill):
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for fn in (lib.tlt_paged_decode_workspace, lib.tlt_paged_prefill_workspace):
        fn.argtypes = [ctypes.c_int] * 8
        fn.restype = ctypes.c_longlong
    fn = lib.tlt_paged_prefix_state
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.tlt_paged_decode_state
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.tlt_paged_decode_state_workspace
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    return lib


def _check_paged(q, key_pages, value_pages, block_table, head_shard: bool = False):
    """n_rep after the checks every paged kernel needs. `head_shard`: the
    pages may be a head shard of a pool, pool[:, h0:h1] (a page every
    hp * ps * D elements; see _heads_a_page)."""
    B, Hq, L, D = q.shape
    P, Hkv, ps, Dk = key_pages.shape
    if Dk != D or value_pages.shape != key_pages.shape or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} / pages {tuple(key_pages.shape)} do not match")
    n_rep = Hq // Hkv
    if D not in (64, 128) or n_rep not in (1, 2, 4, 8):
        raise ValueError(f"paged attention: unsupported D={D}, n_rep={n_rep}")
    if block_table.ndim != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table {tuple(block_table.shape)} does not match B={B}")
    for t in (q, key_pages, value_pages):
        if t.dtype != torch.bfloat16 or not t.is_cuda:
            raise ValueError("q and the pages must be bf16 CUDA tensors")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if head_shard:
        _heads_a_page(key_pages)
        if value_pages.stride() != key_pages.stride():
            raise ValueError("the key and value pages must be laid out alike")
    elif not (key_pages.is_contiguous() and value_pages.is_contiguous()):
        raise ValueError("the pages must be contiguous")
    return n_rep


def _heads_a_page(pages: torch.Tensor) -> int:
    """hp, the KV heads a page of the pool holds, for pages [P, Hkv, ps, D]
    that are the pool itself or its heads [h0, h1) (a view whose pages
    stay hp * ps * D elements apart)."""
    _, Hkv, ps, D = pages.shape
    sp, sh, ss, sd = pages.stride()
    if (sh, ss, sd) != (ps * D, D, 1) or sp % (ps * D) or sp // (ps * D) < Hkv \
            or pages.data_ptr() % 16:
        raise ValueError(f"pages {tuple(pages.shape)} at strides {pages.stride()}: not a pool's "
                         "head shard")
    return sp // (ps * D)


def _split_launch(entry: str, q, key_pages, value_pages, block_table, context_lens,
                  scale: float):
    """The paged decode or prefill entry (`entry`: "decode" or "prefill")
    in splits of decode_split's or prefill_split's keys, on a workspace of
    the size the entry asks for."""
    B, Hq, L, D = q.shape
    Hkv, ps = key_pages.shape[1], key_pages.shape[2]
    n_rep = _check_paged(q, key_pages, value_pages, block_table, head_shard=True)
    dev = q.device
    bt = block_table.to(device=dev, dtype=torch.int32).contiguous()
    lens = context_lens.to(device=dev, dtype=torch.int32).contiguous()
    maxp = bt.shape[1]
    out = torch.empty_like(q)
    lib = _lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kps = (decode_split(B, Hkv, maxp, ps, sms) if entry == "decode"
           else prefill_split(B, Hkv, L, n_rep, maxp, ps, sms))
    nbytes = getattr(lib, f"tlt_paged_{entry}_workspace")(B, Hkv, L, maxp, ps, D, n_rep, kps)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None  # the partials
    err = getattr(lib, f"tlt_paged_{entry}")(
        q.data_ptr(), key_pages.data_ptr(), value_pages.data_ptr(), bt.data_ptr(),
        lens.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(), nbytes, B, Hkv,
        L, ps, maxp, D, n_rep, kps, _heads_a_page(key_pages), float(scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, f"tlt_paged_{entry}")
    return out


def paged_decode_cuda(q, key_pages, value_pages, block_table, context_lens, scale: float):
    """The paged decode kernel (L <= 16): one call of the C entry, the
    split walk and its combine, counted once."""
    global DECODE_LAUNCHES
    if not 1 <= q.shape[2] <= DECODE_MAX_L:
        raise ValueError(f"paged decode takes 1 <= L <= {DECODE_MAX_L}, got L={q.shape[2]}")
    out = _split_launch("decode", q, key_pages, value_pages, block_table, context_lens, scale)
    DECODE_LAUNCHES += 1
    return out


def paged_prefill_cuda(q, key_pages, value_pages, block_table, context_lens, scale: float):
    """The paged prefill kernel (any L >= 1; the dispatch sends L > 16):
    one call of the C entry, the tile and, when it splits the keys, the
    combine, counted once."""
    global PREFILL_LAUNCHES
    out = _split_launch("prefill", q, key_pages, value_pages, block_table, context_lens, scale)
    PREFILL_LAUNCHES += 1
    return out


def paged_prefix_state_cuda(q, key_pages, value_pages, block_table, prefix_lens, scale: float):
    """The paged prefix-state walk: (o, m, l) of q over each row's prefix."""
    global PREFIX_LAUNCHES
    B, Hq, L, D = q.shape
    Hkv, ps = key_pages.shape[1], key_pages.shape[2]
    n_rep = _check_paged(q, key_pages, value_pages, block_table)
    dev = q.device
    bt = block_table.to(device=dev, dtype=torch.int32).contiguous()
    lens = prefix_lens.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    m = torch.empty((B, Hq, L), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    lib = _lib()
    err = lib.tlt_paged_prefix_state(
        q.data_ptr(), key_pages.data_ptr(), value_pages.data_ptr(), bt.data_ptr(),
        lens.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), B, Hkv, L, ps,
        bt.shape[1], D, n_rep, float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "tlt_paged_prefix_state")
    PREFIX_LAUNCHES += 1
    return out, m, l


def paged_decode_state_cuda(q, key_pages_loc, value_pages_loc, block_table, context_lens,
                            page_base: int, scale: float):
    """The paged decode-state walk over one shard's pages (L <= 16): one
    call of the C entry, the split walk and its combine, counted once."""
    global DECODE_STATE_LAUNCHES
    B, Hq, L, D = q.shape
    P_loc, Hkv, ps = key_pages_loc.shape[:3]
    if not 1 <= L <= DECODE_MAX_L:
        raise ValueError(f"paged decode state takes 1 <= L <= {DECODE_MAX_L}, got L={L}")
    n_rep = _check_paged(q, key_pages_loc, value_pages_loc, block_table)
    dev = q.device
    bt = block_table.to(device=dev, dtype=torch.int32).contiguous()
    lens = context_lens.to(device=dev, dtype=torch.int32).contiguous()
    maxp = bt.shape[1]
    out = torch.empty_like(q)
    m = torch.empty((B, Hq, L), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    lib = _lib()
    per = decode_state_split(B, Hkv, maxp, ps,
                             torch.cuda.get_device_properties(dev).multi_processor_count)
    nbytes = lib.tlt_paged_decode_state_workspace(B, Hkv, L, maxp, D, n_rep, per)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)  # the splits' partials
    err = lib.tlt_paged_decode_state(
        q.data_ptr(), key_pages_loc.data_ptr(), value_pages_loc.data_ptr(), bt.data_ptr(),
        lens.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), ws.data_ptr(), nbytes, B,
        Hkv, L, ps, maxp, int(page_base), P_loc, D, n_rep, per, float(scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, err, "tlt_paged_decode_state")
    DECODE_STATE_LAUNCHES += 1
    return out, m, l


def paged_decode_state(
    q: torch.Tensor,  # [B, Hq, L, D], L <= 16
    key_pages_loc: torch.Tensor,  # [P_loc, Hkv, ps, D] — the shard's pages
    value_pages_loc: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32 — GLOBAL ids, -1 padded
    context_lens: torch.Tensor,  # [B] int32 — global context lengths
    page_base: int,  # the first global page id the shard holds
    scale: float | None = None,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(o, m, l) of decode attention over the pages of global ids
    [page_base, page_base + P_loc) only; other entries contribute nothing."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if resolve(impl, q) == "cuda":
        return paged_decode_state_cuda(q, key_pages_loc, value_pages_loc, block_table,
                                       context_lens, page_base, scale)
    return paged_decode_state_plain(q, key_pages_loc, value_pages_loc, block_table,
                                    context_lens, page_base, scale)


def paged_prefix_state(
    q: torch.Tensor,  # [B, Hq, L, D] — one chunk's queries
    key_pages: torch.Tensor,  # [P, Hkv, ps, D] — one layer's pages
    value_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32, -1 padded
    prefix_lens: torch.Tensor,  # [B] int32 — tokens BEFORE the chunk (0 is fine)
    scale: float | None = None,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(o, m, l) of the chunk's queries attending non-causally to the keys
    at positions < prefix_lens[b]; the chunk's own K/V may already sit in
    the pages past them (offsets need not be page-aligned)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if resolve(impl, q) == "cuda":
        return paged_prefix_state_cuda(q, key_pages, value_pages, block_table, prefix_lens,
                                       scale)
    return paged_prefix_state_plain(q, key_pages, value_pages, block_table, prefix_lens, scale)


def paged_attention(
    q: torch.Tensor,  # [B, Hq, L, D] — the last L tokens of each context
    key_pages: torch.Tensor,  # [P, Hkv, ps, D] — one layer's pages
    value_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32, -1 padded
    context_lens: torch.Tensor,  # [B] int32, including the current queries
    scale: float | None = None,
    impl=None,
) -> torch.Tensor:
    """Causal attention of the last L positions of each row over its pages."""
    if impl is not None and not isinstance(impl, str):
        return impl.paged(q, key_pages, value_pages, block_table, context_lens, scale=scale)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if resolve(impl, q) == "torch":
        return paged_attention_plain(q, key_pages, value_pages, block_table, context_lens, scale)
    fn = paged_decode_cuda if q.shape[2] <= DECODE_MAX_L else paged_prefill_cuda
    return fn(q, key_pages, value_pages, block_table, context_lens, scale)
