"""Time rows of the kernel table at `chip_smoke.py`'s shapes, beside one
PyTorch call computing the same function, for whichever tree's
`tiny_llm_tpu_torch` Python imports: the any-width matmul (Pallas row 17,
csrc/quant_matmul_sg.cu), the shard decode-state kernel (row 6,
csrc/flash_attention.cu), the fused paged decode step (row 9,
csrc/fused_decode_attention.cu), the grouped W4A16 expert matmul (row
18, csrc/moe_matmul.cu), K3 with row 4 (csrc/flash_attention.cu) and K2
(csrc/fused_decode_attention.cu), the grouped any-width expert matmul
(row 20, csrc/moe_matmul_sg.cu) and the prep kernel (row 8,
csrc/fused_decode_attention.cu); and the split sweeps of K3, K2 and row
9 (rows K3split, K2split, 9split: this tree only).

    PYTHONPATH=. python3 tiny_llm_tpu_torch/kernels/row_timing.py [--label NAME] [--rows 17,6,9,18,K3,K2]

Run it as a file, as kernels/paged_timing.py: with PYTHONPATH at a parent's
checkout (`git archive`) it times the parent's kernels through the same
wrappers (`quant_matmul_sg_cuda`, `flash_decode_state_cuda`,
`SPAttention.flash`, `fused_paged_decode_attention_cuda`,
`grouped_quant_matmul_cuda`, `grouped_quant_matmul_sg_cuda`,
`fused_qkv_prep_cuda`), with this tree's cases and timers
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
same keys gathered contiguous. K3: `K3_CASES` at Qwen3-4B's heads and at
n_rep 8 (Qwen3-30B-A3B's), each over 8 layers' slabs; library: SDPA over
the keys below lens, causal where lens = L, else with the offset-causal
boolean mask. K2: `K2_CASES` at both heads over the 8 layers of a slab of
MAX_SEQ positions; library: SDPA over the slab with a per-row boolean mask
(keys at or below each row's offset: K2's function, the current token's
key taken from the slab). The sweeps time the same cases through each
wrapper with its module's split chooser patched (`_split_at`) to each size
of `SWEEP_KPS` (K3 at L <= 16 and K2, row 9 at `FUSED_PAGED_CASES`) or
`SWEEP_TILE_KPS` (K3 above L = 16), beside the size the tree's own chooser
picks. Row 18: Qwen3-30B-A3B's gate and down over
128 experts at T = 8, 9, 32 and 1024 under random top-8 routing, one expert
holding 15, 16, 17, 32, 33 or 128 rows, and row 21's T = 64, 128 and 256;
replayed over 8 random weights; library: torch._grouped_mm on the active
experts' bf16-dequantized weights. Row 20: the same projections at W4 g64
and W8 g64, T = 8, 16, 32, 192 and 1024 under random top-8 routing and one
expert holding 8, 15, 16, 17, 33 or 128 rows, beside torch._grouped_mm as row 18;
then one decode step (MOE_LAYERS x gate, up, down at T = 8, each layer its
own top-8). Row 8: the prep kernel at B = 1 and 4, Qwen3-4B's heads and
n_rep 8, over 8 layers' pools of POOL_PAGES pages: with the page write
(the tree's one launch with pages, or, through a parent's wrapper, which
takes none, the prep then models.qwen3._write_pages twice) and the prep
alone. Row 8step: one full-depth Qwen3-4B decode step on the three-launch
route over 4 slots, profiled: its device ms and device ops (the parent's
route launches two scatters a layer beside its prep). Row K1staged: the
staged tiles at M = 1024: K1 on Qwen3-4B's qkv, gate_up and down + res,
and row 17 at W8 g64 on qkv and down + res, replayed over 4 random weights,
each beside a bf16 matmul on the dequantized weights and its error against
the tree's own `quant_matmul_staged_plain`. Prints one JSON line per case,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
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


def _stacked(cs, gen, E, N, K, bits, group_size, copies=8):
    flat = cs._random_qt(gen, E * N, K, bits, group_size, copies=copies)
    return [type(q)(q.packed.view(E, N, -1), q.scales.view(E, N, -1), q.biases.view(E, N, -1),
                    N, K, q.k_padded, group_size, bits) for q in flat]


def _row20(cs, label: str) -> None:
    import numpy as np

    from tiny_llm_tpu_torch.kernels import moe_matmul as km
    from tiny_llm_tpu_torch.models import QWEN3_CONFIGS

    cfg = QWEN3_CONFIGS["qwen3-30b-a3b"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    rng = np.random.default_rng(20)
    one = lambda T: np.bincount([17] * T, minlength=E)  # noqa: E731
    specs = [("T=8: one token's top-8", cs._routing(rng, 1, E, k)),
             ("T=32: four tokens' top-8", cs._routing(rng, 4, E, k)),
             ("T=1024: 128 tokens' top-8", cs._routing(rng, 128, E, k))]
    specs += [(f"T={T}, one expert holds every row", one(T)) for T in (8, 15, 16, 17, 33, 128)]
    specs += [("T=16: two tokens' top-8", cs._routing(rng, 2, E, k)),
              ("T=192: 24 tokens' top-8", cs._routing(rng, 24, E, k))]
    shapes = {"gate": (cfg.moe_intermediate_size, cfg.hidden_size),
              "down": (cfg.hidden_size, cfg.moe_intermediate_size)}
    for bits, gs in ((4, 64), (8, 64)):
        ws = {proj: _stacked(cs, gen, E, N, K, bits, gs) for proj, (N, K) in shapes.items()}
        for proj, (N, K) in shapes.items():
            for what, sizes in specs:
                T = int(sizes.sum())
                sizes_t = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
                x = torch.randn((T, K), generator=gen, device=dev).to(torch.bfloat16)
                w = ws[proj]
                err = cs.max_err(km.grouped_quant_matmul_sg_cuda(x, w[0], sizes_t),
                                 km.grouped_quant_matmul_plain(x, w[0], sizes_t))
                kern = cs.graph_ms(lambda: [km.grouped_quant_matmul_sg_cuda(x, q, sizes_t)
                                            for q in w]) / len(w)
                lib_fn, _, _ = cs._grouped_library(x, w, sizes)
                lib = cs.graph_ms(lambda: [lib_fn(i) for i in range(len(w))]) / len(w)
                del lib_fn
                print(json.dumps({"label": label, "row": 20, "width": f"W{bits} g{gs}",
                                  "proj": proj, "N": N, "K": K, "case": what, "T": T,
                                  "experts": int((sizes > 0).sum()), "kernel_ms": kern,
                                  "grouped_mm_ms": lib, "max_err_vs_plain": err}), flush=True)
                torch.cuda.empty_cache()
        # One decode step at MOE_LAYERS layers: gate, up and down at T = 8,
        # each layer its own top-8, the 8 weight copies in turn.
        steps = [torch.as_tensor(cs._routing(rng, 1, E, k), dtype=torch.int32, device=dev)
                 for _ in range(cs.MOE_LAYERS)]
        xs = {K: torch.randn((8, K), generator=gen, device=dev).to(torch.bfloat16)
              for _, K in shapes.values()}
        calls = [(xs[shapes[p][1]], ws[p][(i + j) % 8], steps[i])
                 for i in range(cs.MOE_LAYERS) for j, p in enumerate(("gate", "gate", "down"))]
        step = cs.graph_ms(lambda: [km.grouped_quant_matmul_sg_cuda(*c) for c in calls],
                           replays=3)
        print(json.dumps({"label": label, "row": 20, "width": f"W{bits} g{gs}",
                          "case": f"one decode step: {len(calls)} calls at T=8 "
                                  f"({cs.MOE_LAYERS} x gate, up, down)", "kernel_ms": step}),
              flush=True)
        del ws, calls
        torch.cuda.empty_cache()


def _row8(cs, label: str) -> None:
    """The prep kernel with the page write (this tree: one launch, pages
    given) or, where the wrapper takes no pages (a parent), the prep kernel
    then the two page writes (models.qwen3._write_pages); and the prep alone
    (no pages) on either; over 8 layers' pools."""
    import inspect

    from tiny_llm_tpu_torch.kernels import fused_decode_attention as kf
    from tiny_llm_tpu_torch.models import qwen3 as mq
    from tiny_llm_tpu_torch.ops.rope import rope_tables

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    writes = "pages" in inspect.signature(kf.fused_qkv_prep_cuda).parameters
    D, eps, Ly = 128, 1e-6, 8
    cos_t, sin_t = rope_tables(D, cs.MAX_SEQ, base=1e6, device=dev)
    for Hkv, n_rep in ((8, 4), (4, 8)):
        shape = (Ly, cs.POOL_PAGES, Hkv, cs.PAGE_SIZE, D)
        kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        qw, kw = (1 + 0.1 * torch.randn((2, D), generator=gen, device=dev)).to(torch.bfloat16)
        for offs in ([700], [100, 700, 37, 999]):
            B = len(offs)
            qkv = (3 * torch.randn((B, Hkv, n_rep + 2, D), generator=gen, device=dev)).to(
                torch.bfloat16)
            off = torch.tensor(offs, dtype=torch.int32, device=dev)
            args = (qkv, off, cos_t[off.long()], sin_t[off.long()], qw, kw)
            page = torch.arange(1, B + 1, device=dev)[:, None]
            slot = off.long()[:, None] % cs.PAGE_SIZE

            def step(i):
                if writes:
                    return kf.fused_qkv_prep_cuda(*args, eps=eps,
                                                  pages=(kp[i], vp[i], page, slot))
                q, k_row, v_row = kf.fused_qkv_prep_cuda(*args, eps=eps)
                mq._write_pages(kp, i, page, slot, k_row)
                mq._write_pages(vp, i, page, slot, v_row)
                return q

            with_write = cs.graph_ms(lambda: [step(i) for i in range(Ly)]) / Ly
            alone = cs.graph_ms(lambda: [kf.fused_qkv_prep_cuda(*args, eps=eps)
                                         for _ in range(Ly)]) / Ly
            print(json.dumps({"label": label, "row": 8, "heads": f"Hkv {Hkv} n_rep {n_rep}",
                              "B": B, "offsets": offs,
                              "route": "one launch" if writes else "prep, then 2 index_put_",
                              "with_page_write_ms": with_write, "prep_alone_ms": alone}),
                  flush=True)
        del kp, vp
        torch.cuda.empty_cache()


def _row8step(cs, label: str) -> None:
    """One Qwen3-4B decode step at full depth on the three-launch route
    (paged_fused_one=False) over SERVING_BATCH installed requests of the
    serving campaign's first lengths, profiled (chip_smoke._device_profile,
    after three warm steps, twice): device ms and device ops a step."""
    from tiny_llm_tpu_torch.models import QWEN3_CONFIGS, Qwen3Model, synthetic_quantized_params

    cfg = QWEN3_CONFIGS["qwen3-4b"]
    m = Qwen3Model(synthetic_quantized_params(cfg, seed=0), cfg, max_seq_len=cs.MAX_SEQ,
                   paged_fused_one=False).enable_paged_attention(num_pages=cs.POOL_PAGES,
                                                                 page_size=cs.PAGE_SIZE)
    lens, _, _ = cs._serving_campaign()
    batch = m.create_batching_kv_cache(cs.SERVING_BATCH)
    for slot, n in enumerate(lens[:cs.SERVING_BATCH]):
        c = m.create_kv_cache()
        m([[ord("x")] * int(n)], 0, c, logits_to_keep=1)
        batch.add_request(c, slot)
    toks = [[ord("x")]] * cs.SERVING_BATCH
    for _ in range(3):
        m(toks, None, batch, logits_to_keep=1)
    for rep in range(2):
        prof = cs._device_profile(lambda: m(toks, None, batch, logits_to_keep=1), 1, top=6)
        print(json.dumps({"label": label, "row": "8step", "rep": rep,
                          "case": "4B three-launch decode step, full depth, "
                                  f"{cs.SERVING_BATCH} slots at {list(map(int, lens[:4]))}",
                          "device_ms": prof["device_ms_per_step"],
                          "device_ops": prof["device_ops_per_step"],
                          "top": prof["top_kernels_ms_per_step"]}), flush=True)
    batch.release()
    del m
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


# K3's cases: (what, B, L, lens, S); row 4's are those at L <= 16.
K3_CASES = (
    ("dense first chunk", 1, 128, (128,), 1024),
    ("dense chunk at the slab's end", 1, 128, (1024,), 1024),
    ("serving first chunk", 4, 128, (128, 128, 128, 128), 128),
    ("long_prefill first chunk of 1024", 1, 1024, (1024,), 1024),
    ("long_prefill first chunk of 2048", 1, 2048, (2048,), 2048),
    ("row 4: short prompt", 1, 8, (8,), 1024),
    ("row 4: L=8 at lens 200", 1, 8, (200,), 1024),
    ("row 4: L=16 at lens 700", 1, 16, (700,), 1024),
    ("row 4: B=4 L=1 at lens 130/400/777/1000", 4, 1, (130, 400, 777, 1000), 1024),
)
# K2's cases: (what, offsets) over a slab of MAX_SEQ positions.
K2_CASES = (
    ("B=1 offset 128", (128,)), ("B=1 offset 192", (192,)), ("B=1 offset 255", (255,)),
    ("B=1 offset 512", (512,)), ("B=1 offset 1023", (1023,)),
    ("B=4 offsets 128-255", (128, 170, 213, 255)), ("B=4 offsets 512-1023", (512, 700, 900, 1023)),
)
# The tile's sweep adds a prompt chunk's two regimes over longer slabs:
# every row's keys its chunk's own (lens = L), or the slab's end (lens = S).
K3_SWEEP_CASES = K3_CASES + tuple(
    (f"L=128 over a slab of {S} at lens {n}", 1, 128, (n,), S)
    for S in (2048, 4096, 8192) for n in (128, S))
SWEEP_KPS = (128, 256, 512, 1024)
SWEEP_TILE_KPS = (128, 256, 512, 1024, 2048, 4096, 8192)


@contextlib.contextmanager
def _split_at(module, chooser: str, kps: int):
    """The module's split chooser (`flash_split`, or the `decode_split`
    that fused_decode_attention imports) answering `kps` for every shape
    inside the block: the wrappers, counted and otherwise unchanged, then
    launch their kernels in splits of `kps` keys."""
    old = getattr(module, chooser)
    setattr(module, chooser, lambda *shape: kps)
    try:
        yield
    finally:
        setattr(module, chooser, old)


def _heads():
    from tiny_llm_tpu_torch.models import QWEN3_CONFIGS

    return {"qwen3-4b": QWEN3_CONFIGS["qwen3-4b"], "n_rep 8": QWEN3_CONFIGS["qwen3-30b-a3b"]}


def _k3_inputs(cfg, gen, B, L, S, Ly=8):
    dev = torch.device("cuda")
    Hkv, D = cfg.num_key_value_heads, cfg.head_dim
    Hq = cfg.num_attention_heads
    q = torch.randn((B, Hq, L, D), generator=gen, device=dev).to(torch.bfloat16)
    ks = torch.randn((Ly, B, Hkv, S, D), generator=gen, device=dev).to(torch.bfloat16)
    vs = torch.randn((Ly, B, Hkv, S, D), generator=gen, device=dev).to(torch.bfloat16)
    return q, ks, vs


def _k3_sdpa(q, ks, vs, lens_l, L, sc):
    """SDPA computing K3's function over each layer's slab: causal where
    every row's lens is L (the keys below L), else an offset-causal boolean
    mask over the keys below max(lens)."""
    dev = q.device
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if all(n == L for n in lens_l):
        return lambda i: sdpa(q, ks[i][:, :, :L], vs[i][:, :, :L], is_causal=True, scale=sc,
                              enable_gqa=True)
    n = max(lens_l)
    lens = torch.tensor(lens_l, device=dev)
    pos = lens[:, None] - L + torch.arange(L, device=dev)[None, :]  # [B, L]
    mask = (torch.arange(n, device=dev)[None, None, :] <= pos[:, :, None])[:, None]
    return lambda i: sdpa(q, ks[i][:, :, :n], vs[i][:, :, :n], attn_mask=mask, scale=sc,
                          enable_gqa=True)


def _rowK3(cs, label: str) -> None:
    from tiny_llm_tpu_torch.kernels import flash_attention as ka

    gen = torch.Generator(device="cuda").manual_seed(3)
    for heads, cfg in _heads().items():
        sc = cfg.head_dim**-0.5
        for what, B, L, lens_l, S in K3_CASES:
            q, ks, vs = _k3_inputs(cfg, gen, B, L, S)
            lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
            err = cs.max_err(ka.flash_attention_cuda(q, ks[0], vs[0], lens, sc),
                             ka.flash_attention_plain(q, ks[0], vs[0], lens, sc))
            kern = cs.graph_ms(lambda: [ka.flash_attention_cuda(q, ks[i], vs[i], lens, sc)
                                        for i in range(len(ks))]) / len(ks)
            lib_fn = _k3_sdpa(q, ks, vs, lens_l, L, sc)
            lib = cs.graph_ms(lambda: [lib_fn(i) for i in range(len(ks))]) / len(ks)
            print(json.dumps({"label": label, "row": "K3", "heads": heads, "case": what, "B": B,
                              "L": L, "lens": list(lens_l), "S": S, "kernel_ms": kern,
                              "sdpa_ms": lib, "max_err_vs_plain": err}), flush=True)
            del q, ks, vs
        torch.cuda.empty_cache()


def _rowK3split(cs, label: str) -> None:
    from tiny_llm_tpu_torch.kernels import flash_attention as ka

    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for heads, cfg in _heads().items():
        sc, Hkv = cfg.head_dim**-0.5, cfg.num_key_value_heads
        n_rep = cfg.num_attention_heads // Hkv
        for what, B, L, lens_l, S in K3_SWEEP_CASES:
            q, ks, vs = _k3_inputs(cfg, gen, B, L, S)
            lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
            want = ka.flash_attention_plain(q, ks[0], vs[0], lens, sc)
            sizes = SWEEP_KPS if L <= ka.DECODE_MAX_L else SWEEP_TILE_KPS
            times = {}
            chosen = ka.flash_split(B, Hkv, L, n_rep, S, sms)
            for kps in sorted({min(k, S) for k in sizes}):
                with _split_at(ka, "flash_split", kps):
                    err = cs.max_err(ka.flash_attention_cuda(q, ks[0], vs[0], lens, sc), want)
                    times[kps] = [cs.graph_ms(lambda: [ka.flash_attention_cuda(
                        q, ks[i], vs[i], lens, sc) for i in range(len(ks))]) / len(ks), err]
            print(json.dumps({"label": label, "row": "K3split", "heads": heads, "case": what,
                              "B": B, "L": L, "lens": list(lens_l), "S": S,
                              "chosen_kps": chosen, "ms_and_err_by_kps": times}), flush=True)
            del q, ks, vs
        torch.cuda.empty_cache()


def _k2_inputs(cs, cfg, gen, offs, Ly=8):
    dev = torch.device("cuda")
    Hkv, D = cfg.num_key_value_heads, cfg.head_dim
    n_rep, B = cfg.num_attention_heads // Hkv, len(offs)
    from tiny_llm_tpu_torch.ops.rope import rope_tables

    cos_t, sin_t = rope_tables(D, cs.MAX_SEQ, cfg.rope_theta, device=dev)
    keys = torch.randn((Ly, B, Hkv, cs.MAX_SEQ, D), generator=gen, device=dev).to(torch.bfloat16)
    values = torch.randn_like(keys, dtype=torch.float32).to(torch.bfloat16)
    qkv = torch.randn((B, Hkv, n_rep + 2, D), generator=gen, device=dev).to(torch.bfloat16)
    qw = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
    kw = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    return (qkv, keys, values, off, cos_t[off.long()], sin_t[off.long()], qw, kw)


def _rowK2(cs, label: str) -> None:
    from tiny_llm_tpu_torch.kernels import fused_decode_attention as kf

    gen = torch.Generator(device="cuda").manual_seed(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for heads, cfg in _heads().items():
        sc, eps, D = cfg.head_dim**-0.5, cfg.rms_norm_eps, cfg.head_dim
        for what, offs in K2_CASES:
            args = _k2_inputs(cs, cfg, gen, offs)
            keys, values, off, Ly, B = args[1], args[2], args[3], args[1].shape[0], len(offs)
            err = cs.max_err(
                kf.fused_decode_attention_cuda(*args, layer_idx=3, scale=sc, eps=eps)[0],
                kf.fused_decode_attention_plain(*args, layer_idx=3, scale=sc, eps=eps)[0])
            kern = cs.graph_ms(lambda: [kf.fused_decode_attention_cuda(
                *args, layer_idx=i, scale=sc, eps=eps) for i in range(Ly)]) / Ly
            q = torch.randn((B, cfg.num_attention_heads, 1, D), generator=gen,
                            device="cuda").to(torch.bfloat16)
            mask = (torch.arange(cs.MAX_SEQ, device="cuda")[None, :]
                    <= off[:, None])[:, None, None]
            lib = cs.graph_ms(lambda: [sdpa(q, keys[i], values[i], attn_mask=mask, scale=sc,
                                            enable_gqa=True) for i in range(Ly)]) / Ly
            n_ctx = max(offs) + 1
            unmasked = cs.graph_ms(lambda: [sdpa(q, keys[i][:, :, :n_ctx],
                                                 values[i][:, :, :n_ctx], scale=sc,
                                                 enable_gqa=True) for i in range(Ly)]) / Ly
            print(json.dumps({"label": label, "row": "K2", "heads": heads, "case": what,
                              "offsets": list(offs), "kernel_ms": kern, "sdpa_ms": lib,
                              "sdpa_no_row_lengths_ms": unmasked, "max_err_vs_plain": err}),
                  flush=True)
            del args, keys, values
        torch.cuda.empty_cache()


def _rowK2split(cs, label: str) -> None:
    from tiny_llm_tpu_torch.kernels import fused_decode_attention as kf
    from tiny_llm_tpu_torch.kernels import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for heads, cfg in _heads().items():
        sc, eps, Hkv = cfg.head_dim**-0.5, cfg.rms_norm_eps, cfg.num_key_value_heads
        for what, offs in K2_CASES:
            args = _k2_inputs(cs, cfg, gen, offs)
            Ly = args[1].shape[0]
            want = kf.fused_decode_attention_plain(*args, layer_idx=3, scale=sc, eps=eps)[0]
            times = {}
            for kps in SWEEP_KPS:
                with _split_at(kf, "decode_split", kps):
                    err = cs.max_err(kf.fused_decode_attention_cuda(
                        *args, layer_idx=3, scale=sc, eps=eps)[0], want)
                    times[kps] = [cs.graph_ms(lambda: [kf.fused_decode_attention_cuda(
                        *args, layer_idx=i, scale=sc, eps=eps) for i in range(Ly)]) / Ly, err]
            print(json.dumps({"label": label, "row": "K2split", "heads": heads, "case": what,
                              "offsets": list(offs),
                              "chosen_kps": pa.decode_split(len(offs), Hkv, cs.MAX_SEQ, 1, sms),
                              "ms_and_err_by_kps": times}), flush=True)
            del args
        torch.cuda.empty_cache()


def _row9split(cs, label: str) -> None:
    from tiny_llm_tpu_torch.kernels import fused_decode_attention as kf
    from tiny_llm_tpu_torch.kernels import paged_attention as pa
    from tiny_llm_tpu_torch.ops.rope import rope_tables

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    width, Ly = cs.MAX_SEQ // cs.PAGE_SIZE, 8
    perm = (torch.randperm(cs.POOL_PAGES - 1, generator=torch.Generator().manual_seed(2))
            + 1).numpy()
    for heads, cfg in _heads().items():
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
            args = lambda i: (qkv, kp[i], vp[i], bt, off, cr, sr, qw, kw)  # noqa: E731
            times = {}
            for kps in SWEEP_KPS:
                with _split_at(kf, "decode_split", kps):
                    times[kps] = cs.graph_ms(lambda: [kf.fused_paged_decode_attention_cuda(
                        *args(i), scale=sc, eps=eps) for i in range(Ly)]) / Ly
            print(json.dumps({"label": label, "row": "9split", "heads": heads, "case": what,
                              "offsets": list(offs),
                              "chosen_kps": pa.decode_split(B, Hkv, width, cs.PAGE_SIZE, sms),
                              "ms_by_kps": times}), flush=True)
        del kp, vp
        torch.cuda.empty_cache()


def _rowK1staged(cs, label: str) -> None:
    from tiny_llm_tpu_torch.kernels import quant_matmul as qm
    from tiny_llm_tpu_torch.models import QWEN3_CONFIGS
    from tiny_llm_tpu_torch.ops.quantize import dequantize

    cfg = QWEN3_CONFIGS["qwen3-4b"]
    shapes = cs._k1_shapes(cfg)
    gen = torch.Generator(device="cuda").manual_seed(11)
    M = 1024
    for bits, gs, names in ((4, 128, ("qkv", "gate_up", "down")), (8, 64, ("qkv", "down"))):
        fn = qm.quant_matmul_cuda if bits == 4 else qm.quant_matmul_sg_cuda
        for name in names:
            N, K, _, residual = shapes[name]
            ws = cs._random_qt(gen, N, K, bits, gs, copies=4)
            dense = [dequantize(w) for w in ws]
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            r = torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16) \
                if residual else None
            err = cs.max_err(fn(x, ws[0], r), qm.quant_matmul_staged_plain(x, ws[0], r))
            kern = cs.graph_ms(lambda: [fn(x, w, r) for w in ws]) / len(ws)
            lib = cs.graph_ms(lambda: [torch.addmm(r, x, d.T) if residual
                                       else torch.matmul(x, d.T) for d in dense]) / len(ws)
            print(json.dumps({"label": label, "row": "K1" if bits == 4 else 17,
                              "width": f"W{bits} g{gs}", "shape": name + (" +res" if residual
                                                                          else ""),
                              "N": N, "K": K, "M": M, "kernel_ms": kern, "library_ms": lib,
                              "max_err_vs_staged_plain": err}), flush=True)
            del ws, dense
            torch.cuda.empty_cache()


ROWS = {"17": _row17, "6": _row6, "9": _row9, "18": _row18, "K3": _rowK3, "K2": _rowK2,
        "K3split": _rowK3split, "K2split": _rowK2split, "9split": _row9split, "20": _row20,
        "8": _row8, "8step": _row8step, "K1staged": _rowK1staged}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rows", default="17,6,9,18,K3,K2", help="comma-separated rows to time")
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
