"""Record the page bookkeeping of a run and replay it on another pool.

`PoolRecorder` (a context manager) logs every call a run makes on the paged
caches — a request created, its pages ensured, tokens advanced or rewound,
its release; a request installed in or removed from a batch slot; a block
table, a row of one, or the slots' offsets read — as a list of plain
tuples. `replay` runs such a log on a fresh pool and returns what each read
returned, so two bookkeeping backends (PagePool(native=None) and
PagePool(native=False)) can be held equal on a real run's sequence and
timed on it in turns. Instrumentation only: nothing in a run depends on it.

Ops (request and batch ids number the objects in creation order):
("new", rid), ("ensure", rid, new_offset), ("advance", rid, n),
("rewind", rid, n), ("release", rid), ("batch", bid, slots),
("add", bid, slot, rid), ("remove", bid, slot), ("table", bid, width),
("offsets", bid), ("row", rid, width).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np

from .paged import PagedBatchingKVCache, PagedKVCache, PagePool


class PoolRecorder:
    """Within `with PoolRecorder() as rec:`, every paged-cache call lands in
    rec.ops (see the module docstring); rec.ops_of(pool) keeps one pool's."""

    _METHODS = {
        PagedKVCache: ("__init__", "ensure_capacity", "advance", "rewind", "release",
                       "block_table_row"),
        PagedBatchingKVCache: ("__init__", "add_request", "remove_request", "block_table"),
    }

    def __init__(self):
        self.ops: list[tuple] = []
        self._op_pools: list = []  # each op's pool
        self._ids: dict[int, int] = {}  # id(object) -> its number (ids of dead objects recur)
        self._numbers = itertools.count()
        self._saved: list[tuple] = []

    def ops_of(self, pool: PagePool) -> list[tuple]:
        """The ops on `pool`'s caches, in order."""
        return [op for op, p in zip(self.ops, self._op_pools) if p is pool]

    def _append(self, obj, op: tuple) -> None:
        self.ops.append(op)
        self._op_pools.append(obj.pool)

    def _id(self, obj) -> int:
        return self._ids[id(obj)]

    def _log(self, cls, name, obj, args):
        if name == "__init__":
            self._ids[id(obj)] = next(self._numbers)
            if cls is PagedBatchingKVCache:
                self._append(obj, ("batch", self._id(obj), args[1]))
            else:
                self._append(obj, ("new", self._id(obj)))
            return
        op = {"ensure_capacity": "ensure", "block_table_row": "row",
              "add_request": "add", "remove_request": "remove", "block_table": "table"}.get(
                  name, name)
        if op == "add":
            self._append(obj, ("add", self._id(obj), args[1], self._id(args[0])))
        elif op == "table":
            self._append(obj, ("table", self._id(obj), args[0] if args else None))
        elif op == "release" and obj._released:
            return
        else:
            self._append(obj, (op, self._id(obj), *args))

    def __enter__(self) -> "PoolRecorder":
        for cls, names in self._METHODS.items():
            for name in names:
                orig = getattr(cls, name)
                self._saved.append((cls, name, orig))

                @functools.wraps(orig)
                def wrapped(obj, *args, _orig=orig, _cls=cls, _name=name, **kwargs):
                    logged = args + tuple(kwargs.values())  # in the parameters' order
                    if _name != "__init__":
                        self._log(_cls, _name, obj, logged)
                    out = _orig(obj, *args, **kwargs)
                    if _name == "__init__":
                        self._log(_cls, _name, obj, logged)
                    return out

                setattr(cls, name, wrapped)
        offsets = PagedBatchingKVCache.offsets
        self._saved.append((PagedBatchingKVCache, "offsets", offsets))
        rec = self

        def read_offsets(obj):
            rec._append(obj, ("offsets", rec._id(obj)))
            return offsets.fget(obj)

        PagedBatchingKVCache.offsets = property(read_offsets)
        return self

    def __exit__(self, *exc) -> None:
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)
        self._saved.clear()


def replay(ops: list[tuple], pool: PagePool) -> list:
    """Run a PoolRecorder log on `pool` (fresh, of the recorded pool's
    size); returns, in order, what each read gave (tables and rows as int32
    arrays, offsets), each followed by the pool's (free pages, reused page
    allocations) at that point."""
    caches: dict[int, PagedKVCache] = {}
    batches: dict[int, PagedBatchingKVCache] = {}
    seen: list = []
    for op in ops:
        kind = op[0]
        if kind == "new":
            caches[op[1]] = PagedKVCache(pool)
        elif kind == "batch":
            batches[op[1]] = PagedBatchingKVCache(pool, op[2])
        elif kind == "ensure":
            caches[op[1]].ensure_capacity(op[2])
        elif kind == "advance":
            caches[op[1]].advance(op[2])
        elif kind == "rewind":
            caches[op[1]].rewind(op[2])
        elif kind == "release":
            caches[op[1]].release()
        elif kind == "add":
            batches[op[1]].add_request(caches[op[3]], op[2])
        elif kind == "remove":
            batches[op[1]].remove_request(op[2])
        elif kind == "table":
            seen.append((batches[op[1]].block_table(op[2]), pool.free_pages,
                         pool.reused_page_allocations))
        elif kind == "offsets":
            seen.append((batches[op[1]].offsets, pool.free_pages, pool.reused_page_allocations))
        elif kind == "row":
            seen.append((np.asarray(caches[op[1]].block_table_row(op[2]), np.int32),
                         pool.free_pages, pool.reused_page_allocations))
        else:
            raise ValueError(f"unknown op {op!r}")
    return seen
