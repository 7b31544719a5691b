"""ctypes wrapper of the native page index (csrc/page_allocator.cpp) —
counterpart of tiny_llm_tpu/native/page_allocator.py."""

from __future__ import annotations

import ctypes

import numpy as np

from .build import load_library

def _configure(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_tlt_configured", False):
        return
    h, i32 = ctypes.c_void_p, ctypes.c_int32
    sigs = {
        "pa_create": (h, [i32]), "pa_destroy": (None, [h]), "pa_alloc": (i32, [h]),
        "pa_free": (None, [h, i32]), "pa_free_count": (i32, [h]),
        "pa_reused_count": (ctypes.c_int64, [h]), "pa_reset": (None, [h]),
        "pa_request_create": (i32, [h]), "pa_request_release": (None, [h, i32]),
        "pa_request_ensure": (i32, [h, i32, i32, i32]),
        "pa_request_advance": (i32, [h, i32, i32, i32]),
        "pa_request_rewind": (i32, [h, i32, i32, i32]),
        "pa_request_offset": (i32, [h, i32]), "pa_request_num_pages": (i32, [h, i32]),
        "pa_fill_offsets": (None, [h, h, i32, h]),
        "pa_fill_block_table": (None, [h, h, i32, i32, h]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    lib._tlt_configured = True


class NativePageIndex:
    """The free list, each request's pages and offset, and block-table
    assembly of one PagePool, in C++. The same semantics as the pool's
    Python bookkeeping (page 0 the trash page, last-in first-out reuse,
    whole-page rewind)."""

    def __init__(self, num_pages: int):
        lib = load_library("page_allocator")
        _configure(lib)
        self._lib = lib
        self._h = lib.pa_create(num_pages)
        self.num_pages = num_pages

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pa_destroy(h)
            self._h = None

    # -- pool ----------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return int(self._lib.pa_free_count(self._h))

    @property
    def reused_page_allocations(self) -> int:
        return int(self._lib.pa_reused_count(self._h))

    def allocate_page(self) -> int:
        p = int(self._lib.pa_alloc(self._h))
        if p < 0:
            from ..kv.paged import PoolExhausted

            raise PoolExhausted(f"page pool exhausted ({self.num_pages} pages); size the pool "
                                "for max_seq_len * max_active_requests")
        return p

    def free_page(self, page: int) -> None:
        self._lib.pa_free(self._h, page)

    def reset(self) -> None:
        """Every page but the trash page free; the reuse ledger stays."""
        self._lib.pa_reset(self._h)

    # -- requests ------------------------------------------------------------
    def request_create(self) -> int:
        return int(self._lib.pa_request_create(self._h))

    def request_release(self, req: int) -> None:
        self._lib.pa_request_release(self._h, req)

    def request_ensure(self, req: int, new_offset: int, page_size: int) -> None:
        if self._lib.pa_request_ensure(self._h, req, new_offset, page_size) < 0:
            from ..kv.paged import PoolExhausted

            raise PoolExhausted(f"page pool exhausted ({self.num_pages} pages); size the pool "
                                "for max_seq_len * max_active_requests")

    def request_advance(self, req: int, n: int, page_size: int) -> bool:
        """Record n appended tokens; False (nothing recorded) past the
        ensured pages."""
        return self._lib.pa_request_advance(self._h, req, n, page_size) == 0

    def request_rewind(self, req: int, n: int, page_size: int) -> bool:
        """Drop the newest n tokens, freeing whole trailing pages; False
        (nothing dropped) when n passes the offset."""
        return self._lib.pa_request_rewind(self._h, req, n, page_size) == 0

    def request_offset(self, req: int) -> int:
        return int(self._lib.pa_request_offset(self._h, req))

    def request_num_pages(self, req: int) -> int:
        return int(self._lib.pa_request_num_pages(self._h, req))

    def offsets(self, reqs: list[int]) -> np.ndarray:
        """int32 [len(reqs)]: each request's offset, 0 for an entry < 0."""
        out = np.empty(len(reqs), dtype=np.int32)
        self._lib.pa_fill_offsets(self._h, (ctypes.c_int32 * len(reqs))(*reqs), len(reqs),
                                  out.ctypes.data)
        return out

    def block_table(self, reqs: list[int], width: int) -> np.ndarray:
        """The -1-padded int32 [len(reqs), width] block table, assembled in
        C++; an entry < 0 in reqs marks an idle slot (a row of -1)."""
        out = np.empty((len(reqs), width), dtype=np.int32)
        self._lib.pa_fill_block_table(self._h, (ctypes.c_int32 * len(reqs))(*reqs), len(reqs),
                                      width, out.ctypes.data)
        return out
