"""Collective matmuls: the TP matmuls with their collective threaded through
a ring — counterpart of tiny_llm_tpu/parallel/overlap.py.

Under tensor parallelism a decode layer has two collective points: qkv and
gate/up consume a gathered activation (all-gather, then a column-split
matmul), o and down produce a partial sum over the split contraction (a
row-split matmul, then a reduce). Both are decomposed into per-shard bands
threaded through the ring hop (parallel/ring.py), so each band's transfer
is in flight while the previous band computes: the "collective matmul"
pattern, with the JAX package's ring schedules. Every band product is a
plain dense matmul (the JAX package computes them with jnp.dot outside any
Pallas kernel): torch.matmul on f32 copies of the operands, which for bf16
operands is exact bf16 products accumulated in f32; the sum is f32 and the
result is cast back to x's dtype once.

The shards run two ways, through one schedule:

  * in one process (a LocalRing over a mesh axis's devices): x_local and
    w_local are lists of the n shards' parts, each on its mesh device, and
    the result is the list of the n output parts;
  * as torch.distributed ranks (a GroupRing): x_local and w_local are this
    rank's parts and the result is this rank's output part.

As in the JAX package, nothing wires them into the TP decode step.
"""

from __future__ import annotations

import torch

from .mesh import Mesh
from .ring import GroupRing, LocalRing


def _held(t) -> tuple[list, bool]:
    """A ring's held parts as a list, and whether they came as one tensor."""
    return ([t], True) if isinstance(t, torch.Tensor) else (list(t), False)


def _band(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.float())


def allgather_matmul(x_local, w_local, ring):
    """y_local = all_gather(x, axis) @ w_local, the gather hidden behind the
    band products (the qkv / gate-up pattern).

    Per position: x_local [B, K/n] (the activation split on its features),
    w_local [K, N/n] (the weight split on its columns). At ring step i the
    position holds global chunk (idx - i) % n of x, multiplies it by that
    row band of its weight, and has the hop of the chunk to the next
    position in flight meanwhile; the gathered [B, K] never exists.
    Returns [B, N/n] per position."""
    xs, one = _held(x_local)
    ws, _ = _held(w_local)
    n, pos = ring.size, list(ring.positions)
    accs = [None] * len(pos)
    chunks = dict(zip(pos, xs))
    for i in range(n):
        hop = ring.start(chunks, {p: (c.shape, c.dtype) for p, c in chunks.items()}) \
            if i < n - 1 else None  # issued before this step's products
        for j, p in enumerate(pos):
            k = xs[j].shape[1]
            src = (p - i) % n  # the global chunk held right now
            part = _band(chunks[p], ws[j][src * k : (src + 1) * k])
            accs[j] = part if accs[j] is None else accs[j] + part
        if hop is not None:
            chunks = hop.wait()
    out = [a.to(x.dtype) for a, x in zip(accs, xs)]
    return out[0] if one else out


def matmul_reducescatter(x_local, w_local, ring):
    """y_local = reduce_scatter(x_local @ w_local, axis), the reduction
    threaded through the ring (the o / down pattern).

    Per position: x_local [B, K/n] (activations split on features),
    w_local [K/n, N] (the weight split on rows); the true product is
    sum_s x_s @ w_s. A running f32 partial for each output column chunk
    rides the ring: at step i a position adds its product for chunk
    (idx - i) % n to the partial that just arrived (the product computed
    while that partial was in flight) and forwards it; after n hops partial
    j is home on position j. Returns y[:, chunk idx] [B, N/n] per
    position."""
    xs, one = _held(x_local)
    ws, _ = _held(w_local)
    n, pos = ring.size, list(ring.positions)
    if ws[0].shape[1] % n:
        raise ValueError(f"N = {ws[0].shape[1]} does not divide over {n} positions")
    c = ws[0].shape[1] // n

    def products(i):
        return {p: _band(xs[j], ws[j][:, ((p - i) % n) * c : ((p - i) % n + 1) * c])
                for j, p in enumerate(pos)}

    acc = products(0)
    for i in range(1, n):
        hop = ring.start(acc, {p: (a.shape, a.dtype) for p, a in acc.items()})
        nxt = products(i)  # computed while the partials travel
        acc = {p: a + nxt[p] for p, a in hop.wait().items()}
    acc = ring.start(acc, {p: (a.shape, a.dtype) for p, a in acc.items()}).wait()
    out = [acc[p].to(x.dtype) for p, x in zip(pos, xs)]
    return out[0] if one else out


def overlapped_tp_matmuls(mesh: Mesh | None = None, axis: str = "tp", *, group=None,
                          device: str | torch.device = "cuda"):
    """(qkv_style, oproj_style): drop-in TP linears over the ring of
    `mesh`'s `axis` (the shards in this process), or over the ranks of
    `group` (a process group; each rank's parts on `device`).

    qkv_style(x split on dim 1, w [K, N] split on dim 1) -> [B, N] split on dim 1
    oproj_style(x split on dim 1, w [K, N] split on dim 0) -> [B, N] split on dim 1

    In one process a split tensor is the list of its parts along the axis;
    over a group it is this rank's part. The first's output is the
    second's input split, so oproj_style(qkv_style(x, w1), w2) chains."""
    if group is not None:
        ring = GroupRing(group, device)
    elif mesh is not None:
        ring = LocalRing(mesh.devices_along(axis))
    else:
        raise ValueError("overlapped_tp_matmuls needs a mesh or a process group")

    def qkv_style(x, w):
        return allgather_matmul(x, w, ring)

    def oproj_style(x, w):
        return matmul_reducescatter(x, w, ring)

    return qkv_style, oproj_style
