"""Sharded weights: the port's counterpart of a jax.Array placed with a
NamedSharding (parallel/sharding.py shard_params builds them).

The JAX package hands GSPMD a sharding per leaf and XLA partitions every
matmul. The port has no partitioner: a `ShardedWeight` holds its parts
(one per shard of a mesh axis, each a copy on its shard's device) and the
model's matmuls run part by part, in one process, one after another:

  * split on out-features (dim "out": q/k/v, gate/up; a stacked expert
    weight's per-expert rows): each part's output, concatenated. A fused
    gate/up (`halves`) holds in part s the s-th slice of each half,
    [gate_s; up_s], so that its parts' outputs are put back half by half
    into [gate; up].
  * split on in-features (dim "in": o, down): each part gets its columns of
    x and the partial products are summed in f32, rounded once, the
    residual added once after the sum (in f32 for a quantized weight,
    after the rounding for a dense one, as the unsharded matmul adds it).
    Each part's kernel rounds its own output to bf16 first (the kernels
    return bf16), so a quantized in-feature split rounds n times where the
    unsharded matmul rounds once; a dense part returns its f32 product.
    A quantized part holds the whole quant groups its columns touch (a
    shard boundary may fall inside a group: Qwen3-4B's down at tp = 8 has
    9.5 groups a shard); x outside the part's own columns is zeroed, and
    a zero column adds nothing, bias included, since every route
    multiplies x by the dequantized weight q * s + b.
  * split on experts (dim "expert": stacked [E, N, K]): contiguous expert
    ranges; ops/moe.py runs each part on its segment of the sorted rows.
    A part may itself be split over another axis (composed EP x TP).
  * replicated over a data-parallel axis (dim "batch"): part s is the
    whole weight (or its split over another axis) on replica s's device,
    and serves the s-th contiguous block of x's rows (replica_rows).

Nothing falls back: a part runs the same kernel the unsharded weight
would, at the part's shape, and a shape the kernel refuses raises.

A weight's axis (`comm`, ops/axis.py) holds its positions in this process
(a LocalAxis, the default: `parts` holds every position's part) or one per
rank of a torch.distributed group (a GroupAxis: `parts` holds this rank's
part alone). The same code runs both: each held part's product, then the
axis's collective in position order (a gather for out-feature parts,
replica blocks and expert segments; an ordered sum for in-feature
partials), so the ranks' result is bit-equal to the in-process one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..kernels.quant_matmul import quant_matmul
from .axis import LocalAxis
from .basics import dense_linear
from .quantize import QuantizedTensor, concat_out_features, padded_k

DIMS = ("out", "in", "expert")  # shard_weight's splits; replicate() makes "batch"


@dataclasses.dataclass
class ShardedWeight:
    """A weight split over mesh axis `axis` on logical dim `dim`.

    Position s lives on devices[s] and covers [bounds[s][0], bounds[s][1])
    of the split dim; `parts` holds the parts of the positions this process
    holds (`held`: every position, or a rank's own under a GroupAxis
    `comm`). For dim "in" a quantized part covers the whole groups from
    column `k0s[s]` (<= bounds[s][0]) and x outside its bounds is zeroed.
    For dim "batch" every part is the whole weight (no bounds)."""

    parts: tuple
    dim: str
    axis: str
    devices: tuple
    bounds: tuple  # ((lo, hi), ...) on the split dim
    shape: tuple  # the logical full shape: (N, K) or (E, N, K)
    k0s: tuple = ()  # dim "in": each part's first column (group-aligned)
    halves: bool = False  # a fused [gate; up]: part s is [gate_s; up_s]
    comm: Any = None  # the axis (ops/axis.py); None: every position in this process

    @property
    def axis_impl(self):
        return self.comm if self.comm is not None else LocalAxis(self.devices)

    @property
    def held(self) -> tuple:
        """The positions whose parts `parts` holds, in order."""
        return tuple(self.axis_impl.positions)

    def part(self, position: int):
        """The part of a held position."""
        return self.parts[self.held.index(position)]

    @property
    def out_features(self) -> int:
        return self.shape[-2]

    @property
    def in_features(self) -> int:
        return self.shape[-1]

    @property
    def num_experts(self) -> int | None:
        return self.shape[0] if len(self.shape) == 3 else None

    def map_parts(self, fn: Callable[[Any], Any]) -> "ShardedWeight":
        """The same split with fn applied to every part (a part that is
        itself sharded gets fn applied to its parts)."""
        return dataclasses.replace(self, parts=tuple(
            p.map_parts(fn) if isinstance(p, ShardedWeight) else fn(p) for p in self.parts))


def out_features_of(w) -> int:
    return w.out_features if isinstance(w, (QuantizedTensor, ShardedWeight)) else w.shape[-2]


def in_features_of(w) -> int:
    return w.in_features if isinstance(w, (QuantizedTensor, ShardedWeight)) else w.shape[-1]


def logical_shape(w) -> tuple:
    """(N, K), or (E, N, K) for a stacked expert weight."""
    if isinstance(w, ShardedWeight):
        return w.shape
    N, K = out_features_of(w), in_features_of(w)
    E = w.num_experts if isinstance(w, QuantizedTensor) else (w.shape[0] if w.ndim == 3 else None)
    return (N, K) if E is None else (E, N, K)


def _rows(w, lo: int, hi: int):
    """Rows [lo, hi) of the out-feature axis (the last but one), a copy."""
    if isinstance(w, QuantizedTensor):
        return dataclasses.replace(
            w, packed=w.packed[..., lo:hi, :].clone(), scales=w.scales[..., lo:hi, :].clone(),
            biases=w.biases[..., lo:hi, :].clone(), out_features=hi - lo)
    return w[..., lo:hi, :].clone()


def _cols(w, lo: int, hi: int) -> tuple[Any, int]:
    """The part of w that covers in-features [lo, hi): a dense weight's
    columns, or a quantized weight's whole groups over them (padded with
    empty groups to the layout's K alignment). Returns (part, k0), k0 the
    part's first column."""
    if not isinstance(w, QuantizedTensor):
        return w[..., lo:hi].clone(), lo
    gs = w.group_size
    if gs * w.bits % 32:
        raise ValueError(f"an in-feature split copies whole words a group: group size {gs} "
                         f"at {w.bits} bits is not")
    g0, g1 = lo // gs, -(-hi // gs)
    k0, k1 = g0 * gs, min(g1 * gs, w.in_features)
    kp = padded_k(k1 - k0, gs)
    wpg = gs * w.bits // 32  # words a group
    G = kp // gs
    packed = w.packed.new_zeros((*w.packed.shape[:-1], kp * w.bits // 32))
    scales = w.scales.new_ones((*w.scales.shape[:-1], G))
    biases = w.biases.new_zeros((*w.biases.shape[:-1], G))
    packed[..., : (g1 - g0) * wpg] = w.packed[..., g0 * wpg : g1 * wpg]
    scales[..., : g1 - g0] = w.scales[..., g0:g1]
    biases[..., : g1 - g0] = w.biases[..., g0:g1]
    return dataclasses.replace(w, packed=packed, scales=scales, biases=biases,
                               in_features=k1 - k0, k_padded=kp), k0


def _experts(w, lo: int, hi: int):
    if isinstance(w, QuantizedTensor):
        return dataclasses.replace(w, packed=w.packed[lo:hi].clone(),
                                   scales=w.scales[lo:hi].clone(), biases=w.biases[lo:hi].clone())
    return w[lo:hi].clone()


def _even(n: int, parts: int, what: str, unit: int = 1) -> list[tuple[int, int]]:
    """[lo, hi) of each of `parts` equal shares of n, each a multiple of unit."""
    if n % (parts * unit):
        raise ValueError(f"{what} ({n}) must divide over {parts} shards of whole units of {unit}")
    step = n // parts
    return [(s * step, (s + 1) * step) for s in range(parts)]


def shard_weight(w, dim: str, axis: str, devices, *, unit: int = 1,
                 halves: bool = False, comm=None) -> ShardedWeight:
    """Split w (QuantizedTensor or dense tensor; [N, K] or stacked
    [E, N, K]) over len(devices) shards on `dim`, each part a copy on its
    device. `unit`: the split dim's granularity (a head's rows: whole heads
    per shard). `halves`: w is a fused [gate; up], split half by half.
    `comm`: the axis (ops/axis.py); a GroupAxis keeps only this rank's
    part."""
    if dim not in DIMS:
        raise ValueError(f"dim {dim!r}: expected one of {DIMS}")
    n = len(devices)
    if comm is not None and comm.size != n:
        raise ValueError(f"{n} shards over an axis of {comm.size} positions")
    if n == 1 and torch.device(devices[0]) == w.device:
        return w  # an axis of one shard on the weight's own device (or rank): nothing to split
    held = range(n) if comm is None else comm.positions
    shape = logical_shape(w)
    stacked, N, K = (None, *shape) if len(shape) == 2 else shape
    k0s: tuple = ()
    if dim == "expert":
        if stacked is None:
            raise ValueError("an expert split needs a stacked [E, N, K] weight")
        bounds = _even(stacked, n, "num_experts")
        parts = [_experts(w, *bounds[p]) for p in held]
    elif dim == "out":
        if halves:
            half = N // 2
            bounds = _even(half, n, "each half's out-features", unit)
            parts = [_cat_rows([_rows(w, lo, hi), _rows(w, half + lo, half + hi)])
                     for lo, hi in (bounds[p] for p in held)]
        else:
            bounds = _even(N, n, "out-features", unit)
            parts = [_rows(w, *bounds[p]) for p in held]
    else:
        bounds = _even(K, n, "in-features")
        gs = w.group_size if isinstance(w, QuantizedTensor) else 1
        k0s = tuple(lo // gs * gs for lo, _ in bounds)
        parts = [_cols(w, *bounds[p])[0] for p in held]
    return ShardedWeight(parts=tuple(part.to(devices[p]) for part, p in zip(parts, held)),
                         dim=dim, axis=axis, devices=tuple(devices), bounds=tuple(bounds),
                         shape=shape, k0s=k0s, halves=halves, comm=comm)


def replicate(parts, axis: str, devices, comm=None) -> ShardedWeight:
    """A weight replicated over the data-parallel mesh axis `axis`: parts[s]
    is replica s's copy on devices[s] (the same tensor where that is its
    own device; or the weight split again over another axis, on that
    replica's devices). Under a GroupAxis `comm`, `parts` is this rank's
    replica alone."""
    return ShardedWeight(parts=tuple(parts), dim="batch", axis=axis, devices=tuple(devices),
                         bounds=(), shape=logical_shape(parts[0]), comm=comm)


def replica_rows(x: torch.Tensor, w: ShardedWeight, fn: Callable, residual=None) -> torch.Tensor:
    """fn(x block, s, residual block) for each held replica s of a weight
    replicated over a data-parallel axis: x's leading dim in contiguous
    equal blocks, block s on replica s's device, the blocks gathered in
    order on x's device; rows that do not divide over the replicas (a
    single pending prefill) run whole on replica 0 (on each rank, on its
    own replica: the same weight)."""
    ax, home, B = w.axis_impl, x.device, x.shape[0]
    n = ax.size
    if B % n:
        s = w.held[0]
        return fn(x.to(w.devices[s]), s, None if residual is None
                  else residual.to(w.devices[s])).to(home)
    step = B // n
    outs = {}
    for s in w.held:
        lo, hi, d = s * step, (s + 1) * step, w.devices[s]
        r = None if residual is None else residual[lo:hi].to(d)
        outs[s] = fn(x[lo:hi].to(d), s, r)
    outs = ax.gather(outs, home)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def replica(w, s: int):
    """Replica s's copy of a weight replicated over a data-parallel axis;
    any other weight as it is."""
    return w.part(s) if isinstance(w, ShardedWeight) and w.dim == "batch" else w


def _cat_rows(ws):
    if isinstance(ws[0], QuantizedTensor):
        return concat_out_features(ws)
    return torch.cat(ws, dim=-2)


def zip_parts(fn: Callable[..., Any], *ws: ShardedWeight, halves: bool = False) -> ShardedWeight:
    """A new out-feature split whose part s is fn(part s of each w): the
    part-wise fusion of weights split alike (fuse_projections). Replicas
    (dim "batch") fuse replica by replica."""
    head = ws[0]
    if isinstance(head, ShardedWeight) and head.dim == "batch":
        parts = tuple(zip_parts(fn, *ps, halves=halves) if isinstance(ps[0], ShardedWeight)
                      else fn(*ps) for ps in zip(*(w.parts for w in ws)))
        return dataclasses.replace(head, parts=parts, shape=logical_shape(parts[0]))
    if any(not isinstance(w, ShardedWeight) or w.dim != "out" or w.axis != head.axis
           or len(w.parts) != len(head.parts) for w in ws):
        raise ValueError("part-wise fusion needs out-feature splits over one axis alike")
    parts = tuple(fn(*ps) for ps in zip(*(w.parts for w in ws)))
    N = sum(w.out_features for w in ws)
    if halves:
        bounds = head.bounds
    else:
        bounds = tuple((sum(w.bounds[s][0] for w in ws), sum(w.bounds[s][1] for w in ws))
                       for s in range(len(head.bounds)))
    return dataclasses.replace(head, parts=parts, bounds=bounds,
                               shape=(*head.shape[:-2], N, head.in_features), halves=halves)


def sharded_apply(x: torch.Tensor, w: ShardedWeight, op: Callable, residual=None) -> torch.Tensor:
    """x [..., K] through a weight split on "out" or "in": op(x_part,
    part, residual_part) per part on the part's device. An in-feature
    split sums the parts' products in f32 (op may return them in f32),
    adds the residual in f32 and rounds to x's dtype once."""
    home, ax = x.device, w.axis_impl
    if w.dim == "out":
        outs = {}
        for s, p in zip(w.held, w.parts):
            d, (lo, hi) = w.devices[s], w.bounds[s]
            r = None
            if residual is not None:
                if w.halves:
                    raise ValueError("a fused gate/up takes no residual")
                r = residual[..., lo:hi].to(d)
            outs[s] = op(x.to(d), p, r)
        outs = ax.gather(outs, home)
        if w.halves:
            halves = [o.chunk(2, dim=-1) for o in outs]
            return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=-1)
        return torch.cat(outs, dim=-1)
    if w.dim != "in":
        raise ValueError(f"a {w.dim!r} split runs through ops/moe.py or replica_rows")
    partial = {}
    for s, p in zip(w.held, w.parts):
        d, (lo, hi), k0 = w.devices[s], w.bounds[s], w.k0s[s]
        xs = x[..., k0 : k0 + in_features_of(p)]
        if lo > k0 or hi < k0 + xs.shape[-1]:
            col = torch.arange(xs.shape[-1], device=xs.device) + k0
            xs = xs * ((col >= lo) & (col < hi)).to(xs.dtype)
        partial[s] = op(xs.to(d), p, None).to(torch.float32)
    acc = ax.sum(partial, home)  # in position order: the ranks' sum is the in-process one
    if residual is not None:
        acc = acc + residual.to(torch.float32)
    return acc.to(x.dtype)


def sharded_linear(x: torch.Tensor, w: ShardedWeight, residual=None, impl=None):
    """x @ w.T (+ residual) for a weight split on out- or in-features: each
    quantized part through quant_matmul (K1, W4A8 or the any-width kernel,
    at the part's shape), each dense part through dense_linear (its f32
    product for an in-feature split, the residual added after the one
    rounding, as the unsharded dense matmul adds it)."""
    if isinstance(w.parts[0], QuantizedTensor):
        return sharded_apply(x, w, lambda xs, p, r: quant_matmul(xs, p, residual=r, impl=impl),
                             residual)
    if w.dim == "in":
        out = sharded_apply(x, w, lambda xs, p, r: dense_linear(xs, p, out_dtype=torch.float32))
        return out if residual is None else out + residual
    return sharded_apply(x, w, lambda xs, p, r: dense_linear(xs, p) if r is None
                         else dense_linear(xs, p) + r, residual)
