"""Pipeline parallelism: layer stages — counterpart of
tiny_llm_tpu/parallel/pipeline.py.

Each stage holds a contiguous range of layers (split_stages) and runs it
through models/qwen3.py forward_layers, the same K1, K2 and K3 calls as the
unsharded step; the residual stream is the only traffic between stages.

* `PipelinedQwen3`: single-controller, sequential: each stage's layers on
  its device, the residual moved with `.to(next device)` (on one device
  `.to` returns the same tensors, so nothing is copied).
* `MicrobatchedPipeline`: the GPipe schedule, M + S - 1 ticks, stage s on
  microbatch t - s at tick t, the residual hopping one stage along the
  ring (parallel/ring.py) after each tick. The schedule is static, so a
  stage with no microbatch at a tick does no work.
* `DecodePipeline`: decode-time PP with per-stage KV. M == S microbatches
  of requests round-robin through the stages; microbatch m enters stage 0
  at tick m, and the last stage's argmax rides the ring's wrap back to
  stage 0 as a device tensor, arriving exactly when that microbatch's next
  step is due, so a decode burst makes no host sync. A stage's KV slabs
  [M, Lper, Bm, Hkv, W, D] stay on its device: microbatch m's slab is the
  contiguous [Lper, Bm, Hkv, W, D] that forward_layers and K2 take.

The last two run two ways through one schedule. In one process (group
None) every stage is built, stage s on devices[s], and the hop is a copy to
the next device (`LocalRing`). With a torch.distributed process group of
num_stages ranks, rank r builds only stage r on its device (devices[0]) and
the hop is `dist.batch_isend_irecv` (`GroupRing`); at the end one broadcast
from the last rank gives every rank the outputs, as the JAX package's
psum(outputs * is_last) does. Every rank builds its stage from the same
full params.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..models.qwen3 import (
    MoEParams,
    Qwen3Config,
    Qwen3Params,
    _embed,
    _lm_head,
    act_dtype,
    forward_layers,
    fuse_projections,
)
from ..ops.norm import rms_norm
from ..ops.quantize import QuantizedTensor
from ..ops.rope import rope_tables
from .ring import GroupRing, LocalRing


def split_stages(params: Qwen3Params, num_stages: int) -> list[tuple]:
    """Contiguous layer ranges, ceil(layers / num_stages) a stage (the
    embedding with stage 0, the final norm and the head with the last)."""
    n = len(params.layers)
    if not 1 <= num_stages <= n:
        raise ValueError(f"{num_stages} stages for {n} layers")
    per = -(-n // num_stages)
    return [tuple(params.layers[i : i + per]) for i in range(0, n, per)]


def _place(obj, device: torch.device):
    """Params (dataclasses of tensors and QuantizedTensors) on `device`; a
    tensor already there is returned as it is."""
    if isinstance(obj, (torch.Tensor, QuantizedTensor)):
        return obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_place(o, device) for o in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(
            obj, **{f.name: _place(getattr(obj, f.name), device) for f in dataclasses.fields(obj)})
    return obj


def _cuda_devices(what: str) -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device; pass devices= (e.g. [cpu] * 4)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _stage_devices(devices, num_stages: int, what: str) -> list[torch.device]:
    devices = [torch.device(d) for d in (devices if devices is not None else _cuda_devices(what))]
    if len(devices) < num_stages:
        raise ValueError(f"{what}: {num_stages} stages need {num_stages} devices, "
                         f"got {len(devices)}")
    return devices[:num_stages]


def _tokens(tokens, device) -> torch.Tensor:
    t = tokens if torch.is_tensor(tokens) else torch.as_tensor(np.asarray(tokens))
    t = t.to(device=device, dtype=torch.long)
    return t[None] if t.ndim == 1 else t


def _refuse(params: Qwen3Params, cfg: Qwen3Config, num_stages: int, what: str) -> None:
    if cfg.num_hidden_layers % num_stages:
        raise ValueError(f"{what}: num_stages must divide num_hidden_layers "
                         f"({num_stages}, {cfg.num_hidden_layers})")
    if any(isinstance(b.mlp, MoEParams) for b in params.layers):
        raise ValueError(f"{what} supports dense-MLP models only")


@dataclasses.dataclass
class _Stage:
    device: torch.device
    layers: tuple  # fused BlockParams on `device`
    rope: tuple  # (cos, sin) on `device`


class PipelinedQwen3:
    """Full-prefix forward over layer stages on `devices` (default: every
    CUDA device), in one process. __call__(tokens [B, L]) -> logits
    [B, L, V]: each stage runs its layers over a scratch slab of the
    prompt's length, as the no-cache call does, so on one device the
    logits are the unsharded forward_full's bit for bit. MoE layers run
    as in the model."""

    def __init__(self, params: Qwen3Params, cfg: Qwen3Config, devices=None,
                 num_stages: int | None = None):
        devices = [torch.device(d) for d in
                   (devices if devices is not None else _cuda_devices("PipelinedQwen3"))]
        num_stages = num_stages or len(devices)
        params = fuse_projections(params)
        ranges = split_stages(params, num_stages)
        self.cfg, self.dtype = cfg, act_dtype(params)
        self.devices = _stage_devices(devices, num_stages, "PipelinedQwen3")[: len(ranges)]
        self._stages = [
            _Stage(dev, _place(layers, dev),
                   rope_tables(cfg.head_dim, cfg.max_position_embeddings, base=cfg.rope_theta,
                               device=dev))
            for dev, layers in zip(self.devices, ranges)]
        self._head = _place(Qwen3Params(params.embedding, [], None), self.devices[0])
        self._tail = _place(Qwen3Params(params.embedding, [], params.final_norm, params.lm_head),
                            self.devices[-1])

    def __call__(self, tokens) -> torch.Tensor:
        cfg = self.cfg
        tokens = _tokens(tokens, self.devices[0])
        B, L = tokens.shape
        h = _embed(self._head, tokens)
        for st in self._stages:
            h = h.to(st.device)  # the hop: the residual moves to the stage's device
            shape = (len(st.layers), B, cfg.num_key_value_heads, L, cfg.head_dim)
            keys = torch.empty(shape, dtype=self.dtype, device=st.device)
            values = torch.empty(shape, dtype=self.dtype, device=st.device)
            h = forward_layers(st.layers, cfg, st.rope, h, [0] * B, keys, values)
        h = rms_norm(h, self._tail.final_norm, cfg.rms_norm_eps)
        return _lm_head(self._tail, h)


class _Stages:
    """The stages this process holds and the ring between them: all S in
    one process (group None), or stage r on rank r of `group`."""

    def __init__(self, params: Qwen3Params, cfg: Qwen3Config, num_stages: int, devices, group,
                 rope_len: int, what: str):
        ranges = split_stages(params, num_stages)
        if group is None:
            devs = _stage_devices(devices, num_stages, what)
            self.ring = LocalRing(devs)
            held = dict(enumerate(devs))
        else:
            dev = torch.device(devices[0]) if devices else _cuda_devices(what)[
                torch.cuda.current_device()]
            self.ring = GroupRing(group, dev)
            if self.ring.size != num_stages:
                raise ValueError(f"{what}: {num_stages} stages over a group of {self.ring.size}")
            held = {self.ring.rank: dev}
        self.S, self.group = num_stages, group
        self.held = {s: _Stage(d, _place(ranges[s], d),
                               rope_tables(cfg.head_dim, rope_len, base=cfg.rope_theta, device=d))
                     for s, d in held.items()}
        self.first = _place(Qwen3Params(params.embedding, [], None), held[0]) \
            if 0 in held else None
        last = num_stages - 1
        self.last = _place(Qwen3Params(params.embedding, [], params.final_norm, params.lm_head),
                           held[last]) if last in held else None

    def gather(self, t: torch.Tensor | None, shape, dtype) -> torch.Tensor:
        """The last stage's tensor on every rank (one broadcast); in one
        process the tensor itself."""
        if self.group is None:
            return t
        last = self.S - 1
        dev = self.held[self.ring.rank].device
        buf = t.contiguous() if self.ring.rank == last else torch.empty(shape, dtype=dtype,
                                                                        device=dev)
        dist.broadcast(buf, self.ring.peer(last), group=self.group)
        return buf


class MicrobatchedPipeline:
    """GPipe-scheduled prefill over num_stages stages. __call__(tokens
    [B, L]) -> logits [B, L, V]; B must divide into num_microbatches.
    The embedding and the head run outside the stage schedule (in one
    process on the first and last stage's device; over a group on every
    rank, after the broadcast of the last stage's residual)."""

    def __init__(self, params: Qwen3Params, cfg: Qwen3Config, num_stages: int,
                 num_microbatches: int, devices=None, group=None):
        _refuse(params, cfg, num_stages, "MicrobatchedPipeline")
        params = fuse_projections(params)
        self.cfg, self.dtype = cfg, act_dtype(params)
        self.num_stages, self.num_microbatches = num_stages, num_microbatches
        self._st = _Stages(params, cfg, num_stages, devices, group, cfg.max_position_embeddings,
                           "MicrobatchedPipeline")
        if group is not None:  # the embedding and head on every rank, as in the JAX package
            dev = self._st.held[self._st.ring.rank].device
            self._st.first = _place(Qwen3Params(params.embedding, [], None), dev)
            self._st.last = _place(Qwen3Params(params.embedding, [], params.final_norm,
                                               params.lm_head), dev)

    def __call__(self, tokens) -> torch.Tensor:
        cfg, st = self.cfg, self._st
        M, S = self.num_microbatches, self.num_stages
        held, ring = st.held, st.ring
        tokens = _tokens(tokens, next(iter(held.values())).device)
        B, L = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} does not divide into {M} microbatches")
        Bm, D = B // M, cfg.hidden_size
        h_mb = _embed(st.first, tokens).split(Bm) if 0 in held else None
        slabs = {}
        for s, stage in held.items():
            shape = (len(stage.layers), Bm, cfg.num_key_value_heads, L, cfg.head_dim)
            slabs[s] = (torch.empty(shape, dtype=self.dtype, device=stage.device),
                        torch.empty(shape, dtype=self.dtype, device=stage.device))
        outputs, recv = [None] * M, {}
        for t in range(M + S - 1):
            sends = {}
            for s, stage in held.items():
                m = t - s
                if not 0 <= m < M:
                    continue  # no microbatch here at this tick
                h = h_mb[m] if s == 0 else recv[s]
                h = forward_layers(stage.layers, cfg, stage.rope, h, [0] * Bm, *slabs[s])
                if s == S - 1:
                    outputs[m] = h
                else:
                    sends[s] = h
            expect = {s: ((Bm, L, D), self.dtype) for s in held if s > 0 and 0 <= t + 1 - s < M}
            recv = ring.start(sends, expect).wait()
        h = st.gather(torch.cat(outputs) if S - 1 in held else None, (B, L, D), self.dtype)
        h = h.to(st.last.final_norm.device)
        return _lm_head(st.last, rms_norm(h, st.last.final_norm, cfg.rms_norm_eps))


class DecodePipeline:
    """Decode-time pipeline parallelism: stages own contiguous layer ranges
    AND the KV of those layers; M == S microbatches of Bm requests
    round-robin through the stages, one decode step of one microbatch per
    stage and tick. prefill(tokens [B, L]) fills every stage's slabs and
    returns the first greedy token per row (int32 [B], on the device);
    decode(first_tokens, steps) returns int32 [steps, B] (numpy), a second
    call continuing from the first's KV. Uniform prompt length per prefill
    call. Token for token the single-device dense-cache greedy decode,
    where the rounding of M = Bm rows matches that of M = B."""

    def __init__(self, params: Qwen3Params, cfg: Qwen3Config, num_stages: int,
                 max_seq_len: int = 256, devices=None, group=None):
        _refuse(params, cfg, num_stages, "DecodePipeline")
        params = fuse_projections(params)
        self.cfg, self.dtype = cfg, act_dtype(params)
        self.S = self.M = num_stages  # the fully packed schedule
        self.Lper = cfg.num_hidden_layers // num_stages
        self.W = max_seq_len
        self._st = _Stages(params, cfg, num_stages, devices, group, max_seq_len, "DecodePipeline")
        self.keys: dict = {}  # stage -> [M, Lper, Bm, Hkv, W, D] on its device
        self.values: dict = {}
        self.offsets: list[int] | None = None  # per microbatch

    def prefill(self, tokens) -> torch.Tensor:
        cfg, st = self.cfg, self._st
        M, S = self.M, self.S
        held = st.held
        tokens = _tokens(tokens, next(iter(held.values())).device)
        B, L = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} does not divide into {M} microbatches")
        if L > self.W:
            raise ValueError(f"prompt of {L} exceeds max_seq_len {self.W}")
        Bm, D = B // M, cfg.hidden_size
        shape = (M, self.Lper, Bm, cfg.num_key_value_heads, self.W, cfg.head_dim)
        for s, stage in held.items():
            self.keys[s] = torch.zeros(shape, dtype=self.dtype, device=stage.device)
            self.values[s] = torch.zeros(shape, dtype=self.dtype, device=stage.device)
        h_mb = _embed(st.first, tokens).split(Bm) if 0 in held else None
        h_last, recv = [None] * M, {}
        for t in range(M + S - 1):
            sends = {}
            for s, stage in held.items():
                m = t - s
                if not 0 <= m < M:
                    continue
                h = h_mb[m] if s == 0 else recv[s]
                h = forward_layers(stage.layers, cfg, stage.rope, h, [0] * Bm, self.keys[s][m],
                                   self.values[s][m])
                if s == S - 1:
                    h_last[m] = h[:, -1:]
                else:
                    sends[s] = h
            recv = st.ring.start(sends, {s: ((Bm, L, D), self.dtype) for s in held
                                         if s > 0 and 0 <= t + 1 - s < M}).wait()
        tok0 = None
        if S - 1 in held:
            h = rms_norm(torch.cat(h_last), st.last.final_norm, cfg.rms_norm_eps)
            logits = _lm_head(st.last, h)[:, 0]
            tok0 = logits.float().argmax(-1).to(torch.int32)
        self.offsets = [L] * M
        return st.gather(tok0, (B,), torch.int32)

    def decode_device(self, first_tokens, steps: int) -> torch.Tensor:
        """`steps` greedy tokens for every row, int32 [steps, B] on the
        device; nothing here waits for the device (over a group, the last
        step is one broadcast)."""
        cfg, st = self.cfg, self._st
        M, S = self.M, self.S
        held = st.held
        if self.offsets is None:
            raise ValueError("prefill first")
        if max(self.offsets) + steps > self.W:
            raise ValueError(f"{steps} steps past max_seq_len {self.W}")
        Bm, D = self.keys[next(iter(held))].shape[2], cfg.hidden_size
        total = M * steps
        tokens0 = _tokens(first_tokens, held[0].device).reshape(M, Bm) if 0 in held else None
        out = torch.zeros((steps, M, Bm), dtype=torch.int32,
                          device=held[S - 1].device) if S - 1 in held else None

        def ring_token(t: int) -> bool:  # stage 0 takes the ring's token at tick t
            return 0 <= t < total and t // M >= 1

        h_recv, tok_recv = {}, None
        for t in range(total + S - 1):
            h_sends, tok_sends = {}, {}
            for s, stage in held.items():
                rel = t - s
                if not 0 <= rel < total:
                    continue
                m, k = rel % M, rel // M
                if s == 0:
                    h = _embed(st.first, (tokens0[m] if k == 0 else tok_recv)[:, None])
                else:
                    h = h_recv[s]
                h = forward_layers(stage.layers, cfg, stage.rope, h, [self.offsets[m] + k] * Bm,
                                   self.keys[s][m], self.values[s][m])
                if s < S - 1:
                    h_sends[s] = h
                    continue
                h = rms_norm(h, st.last.final_norm, cfg.rms_norm_eps)
                tok = _lm_head(st.last, h)[:, -1].float().argmax(-1)
                out[k, m] = tok
                if ring_token(t + 1):
                    tok_sends[s] = tok  # around the ring's wrap to stage 0
            hop_h = st.ring.start(h_sends, {s: ((Bm, 1, D), self.dtype) for s in held
                                            if s > 0 and 0 <= t + 1 - s < total})
            hop_t = st.ring.start(tok_sends, {0: ((Bm,), torch.long)}
                                  if 0 in held and ring_token(t + 1) else {})
            h_recv, tok_recv = hop_h.wait(), hop_t.wait().get(0)
        self.offsets = [o + steps for o in self.offsets]
        return st.gather(out, (steps, M, Bm), torch.int32).reshape(steps, M * Bm)

    def decode(self, first_tokens, steps: int) -> np.ndarray:
        """`steps` greedy tokens for every row, int32 [steps, B], with one
        host sync at the end."""
        return self.decode_device(first_tokens, steps).cpu().numpy().astype(np.int32)
