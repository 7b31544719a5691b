"""Time rows of the kernel table at `chip_smoke.py`'s shapes, beside one
PyTorch call computing the same function, for whichever tree's
`tiny_llm_tpu_torch` Python imports: the any-width matmul (Pallas row 17,
csrc/quant_matmul_sg.cu), the shard decode-state kernel (row 6,
csrc/flash_attention.cu), the fused paged decode step (row 9,
csrc/fused_decode_attention.cu) and the grouped W4A16 expert matmul (row
18, csrc/moe_matmul.cu).

    PYTHONPATH=. python3 tiny_llm_tpu_torch/kernels/row_timing.py [--label NAME] [--rows 17,6,9,18]

Run it as a file, as kernels/paged_timing.py: with PYTHONPATH at a parent's
checkout (`git archive`) it times the parent's kernels through the same
wrappers (`quant_matmul_sg_cuda`, `flash_decode_state_cuda`,
`SPAttention.flash`, `fused_paged_decode_attention_cuda`,
`grouped_quant_matmul_cuda`), with this tree's cases and timers
(`chip_smoke.py` beside this file's package). Compare two trees only in one
call, in turns: parent, tree, tree, parent.

Row 17: Qwen3-4B's qkv, down + res and LM head at W8 g64 (4B W8 g64's
widths) at M = 1, 4, 20, 128 and 1024 (the LM head to 128), and qkv at W2 g32
and W4 g32 at M = 1 and 128; random weights as chip_smoke draws them
(`_random_qt`), the kernel replayed over 8 of them (the LM head 2) in a
CUDA graph; library: a bf16 matmul on the dequantized weights. Row 6:
Qwen3-4B's heads (and n_rep 8 beside) over one layer's slab of SP_MAX_SEQ
positions in SP_SHARDS shards: shard 0 full at B = 1 and B = 4 (L = 1 and
16); library: SDPA over the shard's keys; then the whole SP attention of
one layer (SPAttention.flash: the shards and the combine) at B = 1 over
SP_PROMPT keys and B = 4 over SP_BATCH_PROMPTS, beside K3 unsharded. Row 9:
`FUSED_PAGED_CASES` at Qwen3-4B's heads and at n_rep 8 (Qwen3-30B-A3B's)
over 8 layers' pools of POOL_PAGES pages, shuffled; library: SDPA over the
same keys gathered contiguous. Row 18: Qwen3-30B-A3B's gate and down over
128 experts at T = 8, 9, 32 and 1024 under random top-8 routing, one expert
holding 15, 16, 17, 32, 33 or 128 rows, and row 21's T = 64, 128 and 256;
replayed over 8 random weights; library: torch._grouped_mm on the active
experts' bf16-dequantized weights. Prints one JSON line per case, then the
card's name and power limit.
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


def _row9(cs, label: str) -> None:
    from tiny_llm_tpu_torch.kernels import fused_decode_attention as kf
    from tiny_llm_tpu_torch.kernels import paged_attention as pa
    from tiny_llm_tpu_torch.models import QWEN3_CONFIGS
    from tiny_llm_tpu_torch.ops.rope import rope_tables

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    width, Ly = cs.MAX_SEQ // cs.PAGE_SIZE, 8
    perm = (torch.randperm(cs.POOL_PAGES - 1, generator=torch.Generator().manual_seed(2))
            + 1).numpy()
    for heads, name in (("qwen3-4b", "qwen3-4b"), ("n_rep 8", "qwen3-30b-a3b")):
        cfg = QWEN3_CONFIGS[name]
        Hkv, D = cfg.num_key_value_heads, cfg.head_dim
        n_rep, sc, eps = cfg.num_attention_heads // Hkv, D**-0.5, cfg.rms_norm_eps
        cos_t, sin_t = rope_tables(D, cs.MAX_SEQ, cfg.rope_theta, device=dev)
        shape = (Ly, cs.POOL_PAGES, Hkv, cs.PAGE_SIZE, D)
        kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        qw = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
        kw = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
        for what, offs, idle in cs.FUSED_PAGED_CASES:
            B = len(offs)
            bt = cs._tables(perm, [0 if b == idle else o + 1 for b, o in enumerate(offs)], width)
            qkv = torch.randn((B, Hkv, n_rep + 2, D), generator=gen, device=dev).to(torch.bfloat16)
            off = torch.tensor(offs, dtype=torch.int32, device=dev)
            cr, sr = cos_t[off.long()], sin_t[off.long()]
            live = [b for b in range(B) if b != idle]
            args = lambda i: (qkv, kp[i], vp[i], bt, off, cr, sr, qw, kw)  # noqa: E731
            got = kf.fused_paged_decode_attention_cuda(*args(3), scale=sc, eps=eps)[0]
            want = kf.fused_paged_decode_attention_plain(*args(3), scale=sc, eps=eps)[0]
            err = cs.max_err(got[live], want[live])
            kern = cs.graph_ms(lambda: [kf.fused_paged_decode_attention_cuda(
                *args(i), scale=sc, eps=eps) for i in range(Ly)]) / Ly
            q = torch.randn((B, Hkv * n_rep, 1, D), generator=gen, device=dev).to(torch.bfloat16)
            gathered = [pa.gather_pages_dense(kp[i], vp[i], bt) for i in range(Ly)]
            mask = (torch.arange(width * cs.PAGE_SIZE, device=dev)[None, :]
                    <= off[:, None])[:, None, None]
            lib = cs.graph_ms(lambda: [sdpa(q, k, v, attn_mask=mask, scale=sc, enable_gqa=True)
                                       for k, v in gathered]) / Ly
            del gathered
            print(json.dumps({"label": label, "row": 9, "heads": heads, "case": what, "B": B,
                              "offsets": list(offs), "kernel_ms": kern, "sdpa_ms": lib,
                              "max_err_vs_plain": err}), flush=True)
        del kp, vp
        torch.cuda.empty_cache()


def _row18(cs, label: str) -> None:
    import numpy as np

    from tiny_llm_tpu_torch.kernels import moe_matmul as km
    from tiny_llm_tpu_torch.models import QWEN3_CONFIGS

    cfg = QWEN3_CONFIGS["qwen3-30b-a3b"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    rng = np.random.default_rng(18)
    one = lambda T: np.bincount([17] * T, minlength=E)  # noqa: E731
    nine = cs._routing(rng, 1, E, k)
    nine[int(np.flatnonzero(nine == 0)[0])] += 1
    specs = [("T=8: one token's top-8", cs._routing(rng, 1, E, k)),
             ("T=9: one token's top-8 and a row of a ninth expert", nine),
             ("T=32: four tokens' top-8", cs._routing(rng, 4, E, k)),
             ("T=1024: 128 tokens' top-8", cs._routing(rng, 128, E, k))]
    specs += [(f"T={T}, one expert holds every row", one(T)) for T in (15, 16, 17, 32, 33, 128)]
    specs += [(f"T={8 * n}: {n} tokens' top-8 (row 21's regime)", cs._routing(rng, n, E, k))
              for n in (8, 16, 32)]
    for proj, (N, K) in (("gate", (cfg.moe_intermediate_size, cfg.hidden_size)),
                         ("down", (cfg.hidden_size, cfg.moe_intermediate_size))):
        flat = cs._random_qt(gen, E * N, K, 4, 128, copies=8)
        ws = [type(q)(q.packed.view(E, N, -1), q.scales.view(E, N, -1), q.biases.view(E, N, -1),
                      N, K, q.k_padded, 128, 4) for q in flat]
        for what, sizes in specs:
            T = int(sizes.sum())
            sizes_t = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
            x = torch.randn((T, K), generator=gen, device=dev).to(torch.bfloat16)
            err = cs.max_err(km.grouped_quant_matmul_cuda(x, ws[0], sizes_t),
                             km.grouped_quant_matmul_plain(x, ws[0], sizes_t))
            kern = cs.graph_ms(lambda: [km.grouped_quant_matmul_cuda(x, w, sizes_t)
                                        for w in ws]) / len(ws)
            lib_fn, _, _ = cs._grouped_library(x, ws, sizes)
            lib = cs.graph_ms(lambda: [lib_fn(i) for i in range(len(ws))]) / len(ws)
            del lib_fn
            print(json.dumps({"label": label, "row": 18, "proj": proj, "N": N, "K": K,
                              "case": what, "T": T, "experts": int((sizes > 0).sum()),
                              "kernel_ms": kern, "grouped_mm_ms": lib,
                              "max_err_vs_plain": err}), flush=True)
            torch.cuda.empty_cache()
        del ws, flat
        torch.cuda.empty_cache()


ROWS = {"17": _row17, "6": _row6, "9": _row9, "18": _row18}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rows", default=",".join(ROWS), help="comma-separated rows to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("row_timing needs a CUDA device")
    cs = _chip_smoke()
    for row in args.rows.split(","):
        ROWS[row](cs, args.label)
    print(json.dumps({"label": args.label, "gpu": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
