"""Time the any-width matmul (Pallas row 17, csrc/quant_matmul_sg.cu) and
the shard decode-state kernel (row 6, csrc/flash_attention.cu) at
`chip_smoke.py`'s shapes, beside one PyTorch call computing the same
function, for whichever tree's `tiny_llm_tpu_torch` Python imports.

    PYTHONPATH=. python3 tiny_llm_tpu_torch/kernels/row_timing.py [--label NAME]

Run it as a file, as kernels/paged_timing.py: with PYTHONPATH at a parent's
checkout (`git archive`) it times the parent's kernels through the same
wrappers (`quant_matmul_sg_cuda`, `flash_decode_state_cuda`,
`SPAttention.flash`), with this tree's cases and timers (`chip_smoke.py`
beside this file's package). Compare two trees only in one call, in turns:
parent, tree, tree, parent.

Row 17: Qwen3-4B's qkv, down + res and LM head at W8 g64 (4B W8 g64's
widths) at M = 1, 4, 20, 128 and 1024 (the LM head to 128), and qkv at W2 g32
and W4 g32 at M = 1 and 128; random weights as chip_smoke draws them
(`_random_qt`), the kernel replayed over 8 of them (the LM head 2) in a
CUDA graph; library: a bf16 matmul on the dequantized weights. Row 6:
Qwen3-4B's heads (and n_rep 8 beside) over one layer's slab of SP_MAX_SEQ
positions in SP_SHARDS shards: shard 0 full at B = 1 and B = 4 (L = 1 and
16); library: SDPA over the shard's keys; then the whole SP attention of
one layer (SPAttention.flash: the shards and the combine) at B = 1 over
SP_PROMPT keys and B = 4 over SP_BATCH_PROMPTS, beside K3 unsharded.
Prints one JSON line per case, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path

import torch


def _chip_smoke():
    """This tree's chip_smoke.py, loaded from its file (PYTHONPATH may name
    another tree, whose package the cases then run)."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row17(cs, label: str) -> None:
    from tiny_llm_tpu_torch.kernels import quant_matmul as qm
    from tiny_llm_tpu_torch.models import QWEN3_CONFIGS
    from tiny_llm_tpu_torch.ops.quantize import dequantize

    cfg = QWEN3_CONFIGS["qwen3-4b"]
    shapes = cs._k1_shapes(cfg)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(8, 64, name, (1, 4, 20, 128) + ((1024,) if name != "lm_head" else ()))
             for name in ("qkv", "down", "lm_head")]
    cases += [(bits, 32, "qkv", (1, 128)) for bits in (2, 4)]
    for bits, gs, name, Ms in cases:
        N, K, _, residual = shapes[name]
        ws = cs._random_qt(gen, N, K, bits, gs, copies=2 if name == "lm_head" else 8)
        dense = [dequantize(w) for w in ws]
        for M in Ms:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            r = torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16) \
                if residual else None
            err = cs.max_err(qm.quant_matmul_sg_cuda(x, ws[0], r),
                             qm.quant_matmul_plain(x, ws[0], r))
            kern = cs.graph_ms(lambda: [qm.quant_matmul_sg_cuda(x, w, r) for w in ws]) / len(ws)
            lib = cs.graph_ms(lambda: [torch.addmm(r, x, d.T) if residual
                                       else torch.matmul(x, d.T) for d in dense]) / len(ws)
            print(json.dumps({"label": label, "row": 17, "width": f"W{bits} g{gs}",
                              "shape": name + (" +res" if residual else ""), "N": N, "K": K,
                              "M": M, "kernel_ms": kern, "library_ms": lib,
                              "max_err_vs_f32_plain": err}), flush=True)
        del ws, dense
        torch.cuda.empty_cache()


def _row6(cs, label: str) -> None:
    from tiny_llm_tpu_torch.kernels import flash_attention as ka
    from tiny_llm_tpu_torch.models import QWEN3_CONFIGS

    cfg = QWEN3_CONFIGS["qwen3-4b"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    D, n, S = cfg.head_dim, cs.SP_SHARDS, cs.SP_MAX_SEQ
    S_loc, sc = S // n, D**-0.5
    sp = cs._sp()
    heads_of = {"qwen3-4b": (cfg.num_key_value_heads, 4), "n_rep 8": (4, 8)}
    for heads, (Hkv, n_rep) in heads_of.items():
        k = torch.randn((4, Hkv, S, D), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((4, Hkv, S, D), generator=gen, device=dev).to(torch.bfloat16)
        for B, L in ((1, 1), (4, 1), (4, 16)):
            q = torch.randn((B, Hkv * n_rep, L, D), generator=gen, device=dev).to(torch.bfloat16)
            ks, vs = k[:B, :, :S_loc], v[:B, :, :S_loc]
            lens = torch.full((B,), S_loc, dtype=torch.int32, device=dev)
            err = cs.max_err(ka.flash_decode_state_cuda(q, ks, vs, lens, sc)[0],
                             ka.flash_decode_state_plain(q, ks, vs, lens, sc)[0])
            kern = cs.graph_ms(lambda: ka.flash_decode_state_cuda(q, ks, vs, lens, sc))
            mask = torch.ones((L, S_loc), dtype=torch.bool, device=dev).tril(S_loc - L)
            lib = cs.graph_ms(lambda: sdpa(q, ks, vs, attn_mask=mask, scale=sc, enable_gqa=True))
            print(json.dumps({"label": label, "row": 6, "heads": heads, "case": "one full shard",
                              "B": B, "L": L, "keys": S_loc, "kernel_ms": kern, "sdpa_ms": lib,
                              "max_err_vs_plain": err}), flush=True)
        for lens_l in ([cs.SP_PROMPT], list(cs.SP_BATCH_PROMPTS)):
            B = len(lens_l)
            q = torch.randn((B, Hkv * n_rep, 1, D), generator=gen, device=dev).to(torch.bfloat16)
            lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
            kb, vb = k[:B], v[:B]
            err = cs.max_err(sp.flash(q, kb, vb, lens, sc),
                             ka.flash_attention_cuda(q, kb, vb, lens, sc))
            sp_ms = cs.graph_ms(lambda: sp.flash(q, kb, vb, lens, sc))
            k3_ms = cs.graph_ms(lambda: ka.flash_attention_cuda(q, kb, vb, lens, sc))
            print(json.dumps({"label": label, "row": 6, "heads": heads,
                              "case": "whole SP attention of one layer", "B": B, "lens": lens_l,
                              "sp_attention_ms": sp_ms, "k3_unsharded_ms": k3_ms,
                              "max_err_vs_k3": err}), flush=True)
        del k, v
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("row_timing needs a CUDA device")
    cs = _chip_smoke()
    _row17(cs, args.label)
    _row6(cs, args.label)
    print(json.dumps({"label": args.label, "gpu": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
