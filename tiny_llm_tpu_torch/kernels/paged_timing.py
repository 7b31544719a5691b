"""Time the paged decode and paged prefill kernels (csrc/paged_attention.cu)
at `chip_smoke.py`'s paged cases (PAGED_CASES), beside SDPA over the same
keys, for whichever tree's `tiny_llm_tpu_torch` Python imports.

    PYTHONPATH=. python3 tiny_llm_tpu_torch/kernels/paged_timing.py [--label NAME] [--profile]

Run it as a file: its package is the one on PYTHONPATH (the tree's own
with PYTHONPATH=. from its root), so with PYTHONPATH set to a parent's
checkout (`git archive`) it times the parent's kernels through the same wrappers
(`paged_decode_cuda`, `paged_prefill_cuda`), with this tree's cases and
timers (`chip_smoke.py` beside this file's package: `PAGED_CASES`,
`paged_times`, `_device_profile`). Compare two trees only in one call, in
turns: parent, tree, tree, parent.

Each case runs at two models' heads (Qwen3-4B: 8 KV heads, n_rep 4; n_rep
8: Qwen3-30B-A3B's 4 KV heads) over chip_smoke's pool (POOL_PAGES pages of
PAGE_SIZE tokens, shuffled page ids), one pool per layer (36), the kernel
replayed over the layers in a CUDA graph; the printed ms is a layer's.
Prints one JSON line per case (kernel and SDPA ms, max |kernel - plain|),
then the card's name and power limit. `--profile` first builds Qwen3-4B
(synthetic W4A16 weights from seed 0, full width and depth, the serving
pool) and prints the device time by kernel (torch.profiler) of a serving
prefill (a 512-token prompt in chunks of 128, as `bench.py --mode serving`
prefills) and of one mixed burst (4 decode slots, 16 steps each
prefilling a 32-token sub-chunk, as `--mixed`).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path

import torch

LAYERS = 36
HEADS = {"qwen3-4b": (8, 4), "n_rep 8": (4, 8)}  # (KV heads, n_rep)


def _chip_smoke():
    """This tree's chip_smoke.py, loaded from its file (PYTHONPATH may name
    another tree, whose package the cases then run)."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profile(cs, label: str) -> None:
    """The serving prefill's and a mixed burst's device time by kernel."""
    import numpy as np

    from tiny_llm_tpu_torch.models import QWEN3_CONFIGS, Qwen3Model, synthetic_quantized_params
    from tiny_llm_tpu_torch.models.qwen3 import MixedStep

    cfg = QWEN3_CONFIGS["qwen3-4b"]
    model = Qwen3Model(synthetic_quantized_params(cfg, seed=0), cfg, max_seq_len=cs.MAX_SEQ)
    model.enable_paged_attention(num_pages=cs.POOL_PAGES, page_size=cs.PAGE_SIZE)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=512).tolist()

    def prefill():
        c = model.create_kv_cache()
        for off in range(0, len(toks), 128):
            model([toks[off : off + 128]], off, c, logits_to_keep=1)
        c.release()

    def by_kernel(run, steps):
        out = cs._device_profile(run, steps, top=12)
        out["paged_attention_ms_per_step"] = sum(
            ms for k, (ms, _) in out["top_kernels_ms_per_step"].items()
            if "paged" in k and "fused" not in k)
        return out

    prefill()  # warm: builds, the first launches
    out = {"label": label, "serving_prefill_512_in_128": by_kernel(prefill, 1)}
    batch = model.create_batching_kv_cache(4)
    for slot, n in enumerate((300, 500, 700, 900)):
        c = model.create_kv_cache()
        model([toks[:1] * n], 0, c, logits_to_keep=1)
        batch.add_request(c, slot)
    first = np.full((4,), toks[0], np.int32)
    chunk = cs.MIXED_CHUNK

    def mixed():
        c = model.create_kv_cache()
        model.mixed_burst(batch, first, 16, [
            MixedStep(cache=c, tokens=toks[chunk * t : chunk * (t + 1)], offset=chunk * t)
            for t in range(16)], chunk)
        c.release()

    mixed()
    out["mixed_burst_per_step"] = by_kernel(mixed, 16)
    batch.release()
    print(json.dumps(out), flush=True)
    del model
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--profile", action="store_true",
                    help="first the serving prefill's and a mixed burst's device time by kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("paged_timing needs a CUDA device")
    from tiny_llm_tpu_torch.kernels import paged_attention as pa

    cs = _chip_smoke()
    if args.profile:
        _profile(cs, args.label)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    perm = (torch.randperm(cs.POOL_PAGES - 1, generator=torch.Generator().manual_seed(2))
            + 1).numpy()
    width = cs.MAX_SEQ // cs.PAGE_SIZE
    for model, (hkv, n_rep) in HEADS.items():
        pools = {}
        for what, B, L, ctxs, d, _ in cs.PAGED_CASES:
            if d not in pools:
                shape = (LAYERS, cs.POOL_PAGES, hkv, cs.PAGE_SIZE, d)
                pools = {d: tuple(torch.randn(shape, generator=gen, device=dev)
                                  .to(torch.bfloat16) for _ in range(2))}
            kps, vps = pools[d]
            q = torch.randn((B, hkv * n_rep, L, d), generator=gen, device=dev).to(torch.bfloat16)
            bt, lens = cs._tables(perm, ctxs, width), torch.tensor(ctxs, dtype=torch.int32,
                                                                   device=dev)
            sc = d**-0.5
            fn = pa.paged_decode_cuda if L <= pa.DECODE_MAX_L else pa.paged_prefill_cuda
            live = lens > 0
            err = cs.max_err(fn(q, kps[3], vps[3], bt, lens, sc)[live],
                             pa.paged_attention_plain(q, kps[3], vps[3], bt, lens, sc)[live])
            kern, lib, _ = cs.paged_times(fn, q, kps, vps, bt, lens, max(ctxs), sc)
            print(json.dumps({"label": args.label, "model": model, "case": what, "B": B, "L": L,
                              "ctx": list(ctxs), "D": d, "kernel_ms": kern, "sdpa_ms": lib,
                              "max_err": err}), flush=True)
        del pools
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "gpu": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
