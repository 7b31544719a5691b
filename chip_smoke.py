"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--out results.json]

Phases, each printing one JSON line; any failure raises and exits non-zero:

  build     compile the CUDA kernels from tiny_llm_tpu_torch/csrc (nvcc, in
            parallel, into build/), with the card's name and power limit;
            the split prefill's two kernels, the masked prefill walk, K1's
            and row 17's staged tiles and the paged prefill must hold HGMMA
            in their SASS, the masked decode walk, row 14's split walk, the
            paged decode's, row 6's (K3's at L <= 16 too) and row 9's and
            K2's split walks, K1's and row 17's bf16 tiles and rows 18's and
            20's bf16 tile walks HMMA, K3's tile HGMMA, the two W4A8 tiles
            IMMA
  kernels   every kernel against its plain PyTorch version on the card at
            the shapes the main paths give it; kernel, plain and library
            times and the least time the card could take (the bound). K1
            at M = 1, 4, 20, 128 on every projection and, on qkv, gate_up
            and down + res, at its routes' edges M = 2, 3, 32, 33, 36 and
            1024, and on an N-tail weight (N = 1001): each case held to 1 %
            of max of the f32 plain version and per element (2 bf16 ulps +
            1e-3 of max) to the plain version of its route's arithmetic
            (quant_matmul_staged_plain on the staged tile), beside K1's
            time on its former GEMV instances and tile (a prior record). The
            paged kernels read a 57-page pool of 128 with shuffled page ids:
            the fused paged step (row 9) at B = 1 and 4, offsets 0 (the v
            row, exactly), 1, on a split's and a page's boundary +-1 and an
            idle row, one launch a call, held per element to _state_tol
            with offsets - 1 and + 1 as controls that must miss it;
            the paged decode and prefill held per element to _state_tol,
            with lens - 1 (decode) and lens + 1 (prefill) as controls that
            must miss it, at L = 1, 2, 8, 16 (an idle row among B = 4) and
            17, 32, 128 (B = 1: the keys split; B = 4: the unsplit tile).
            K2 and K3 over a slab of 1024 (K3 also L = S = 1024, B = 4,
            L = S = 128 and L = 128 over 8192): K2 at B = 1 and 4, offsets
            0 (the v row, exactly), 127, 128, 129, 192, 255, 1023, one
            launch a call, K3 at L = 8 and 16 (the split walk), 17, 128
            and 1024 (the unsplit tile) and L = 128 over a slab of 8192 at
            lens 128 and 8192 (the split tile and its combine), each case's
            route asserted, each held per element to _state_tol with
            offsets (K2) or lens (K3) - 1 and + 1 as controls that must
            miss it; K2's library at B = 4 with each row's own length
            (SDPA with a per-row mask).
            Qwen3-4B's shapes (n_rep 4), then Qwen3-30B-A3B's: the grouped
            expert matmul (gate and down at T = 8, 32, 1024 and edge cases:
            one expert holding 15, 16, 17, 32, 33 or 128 rows, T = 8 and 9
            on both sides of its gate, T = 16, empty experts at both ends;
            a whole decode step's 3 x MOE_LAYERS calls; and at T = 64, 128, 256, the
            regime of the JAX package's expert-gather schedule, which this
            kernel covers) and the attention kernels at Hkv 4, n_rep 8
  model     the dense path: Qwen3-4B W4A16 (random weights from a seed, full
            width and depth), max_seq 1024, B = 1: a 128-token prefill and
            128 greedy decode steps in 16-step bursts, three times; the
            kernels' launch counts over those runs; the device time by
            kernel of a burst's step and of a prefill; one burst under
            torch.cuda.set_sync_debug_mode("error")
  parity    the 4B widths at 4 layers: teacher-forced logits of the kernels
            against the plain versions, on the card
  checkpoint (right after build) a Qwen3-4B MLX 4-bit export of the
            synthetic params written in two safetensors shards (uint32
            codes, bf16 scales and biases, config.json, tied head), loaded
            with load_params(device="cuda") and held bit-equal to them; the
            loaded params serve every later 4B phase. A Qwen3-0.6B HF BF16
            export (normal x 0.02 from a seed, norms 1) loaded quantized at
            load (W4A16 g128; the card's quantize bit-equal to the CPU's on
            layer 0's seven projections and the embedding) and dense bf16
            (4-layer logits within 5 % of its impl="torch" path); each
            load's seconds and GB/s (a warm read: the files were just
            written). The files live in a temporary directory under build/,
            removed at the end
  generate  three ByteTokenizer prompts through simple_generate_with_kv_cache
  speculative (after generate) the loaded 4B as target, the 0.6B W4A16 as
            draft: speculative_generate (K = 4, 16 tokens, three prompts)
            equal to greedy, again with the target as its own draft (a
            second model on the same params: near-ties alone reject);
            speculative_decode_device (K = 4, 4 rounds a dispatch), with the
            0.6B draft and with the target as its own draft, each equal to
            greedy_continuation, with exact launches over each run; the
            self-draft's acceptance at least SPEC_SELF_ACCEPT in both loops;
            forced_alpha = 0.6 emits its budget; K1's route at M = 5 (the
            bf16 tile) and K3's at L = 5 (the split walk); exact launches
            of one verify forward (145 K1, 36 K3) and one draft step (113
            K1, 28 K2); acceptance, speculative against greedy tok/s in
            turns (A B B A), and the break-even guard's verdict on measured
            steps
  paged_parity  the same over the page pool: three requests with interleaved
            pages, chunks of 128 (offset 0), 128 and 8 (offset > 0), then 8
            batched decode steps beside an idle slot
  serving   the serving path: bench.py --mode serving's default campaign
            (16 requests, batch 4, prompts 128-1024, paged pool of 57 pages)
            through batch_generate, warm-up then SERVING_RUNS (2)
            campaigns, taken in turns with paged3_serving's two and
            a8_serving's two (B C A B C A): output tok/s, TTFT, occupancy,
            the kernels' launch counts, and a profile of one serving decode
            burst
  split_kernels the split paged prefill's two kernels against their plain
            versions at Qwen3-4B's and Qwen3-30B-A3B's head shapes: the
            chunk-state flash prefill (L = 1024, 2048) and the prefix-state
            walk (L = 1024, prefixes 1024, 4096, 7168, beside a prefix-0 row
            that must give the identity state), and the whole split against
            the paged prefill kernel over the same chunk and prefix
  long_parity   4B widths, 4 layers: a 3072-token prompt in 1024-token chunks
            over the pool, the kernel path against the plain path and the
            split route against the unsplit (paged prefill) route
  long_prefill  an 8192-token prompt through Qwen3-4B at full width and depth
            (max_seq 8320, 66-page pool) in chunks of 1024 and 2048: prefill
            tok/s and exact launch counts (the split's kernels 7 x 36 each at
            1024, K3 36, the paged prefill kernel 0)
  long_serving  8 prompts of 2048-8192 tokens through batch_generate on that
            model (batch 4, prefill step 1024, 399-page pool), warm-up then
            two campaigns: output and input tok/s, TTFT, launch counts
  mixed_parity  4B widths, 4 layers: mixed prefill+decode bursts (4 decode
            slots, a 512-token prompt in 32-token sub-chunks), the kernel
            path against the plain path (teacher-forced) and against the
            serialized schedule, and one burst under sync-debug "error"
  mixed_serving the serving phase's campaign with mixed_prefill=True (two
            campaigns), at MIXED_LAYERS of Qwen3-4B's 36 layers on the same
            weights
  moe_model     the model phase on Qwen3-30B-A3B W4A16 (full width, 128
            experts, top-8; 4 of its 48 layers, MOE_LAYERS):
            exact launch counts (K1 13, grouped 12, K2 or K3 4 per step),
            a sync-free burst
  moe_parity    parity and paged_parity at the 30B-A3B widths, 4 layers; the
            plain path takes the kernel path's expert choice where the two
            differ at a near-tie (counted, and held under a 1e-3 margin)
  moe_serving   the serving phase on Qwen3-30B-A3B (two campaigns)
  quant_kernels (run after `kernels`) the quant tiers' four kernels against
            their plain versions: the W4A8 matmul (4B qkv, gate_up, down +
            res at M = 1, 2 on the GEMV, 3, 4, 5, 8, 16, 17, 32 on the int8
            tile; 30B-A3B qkv and o), the any-width matmul on its three
            routes (the GEMV at M <= 3, the bf16 tile and
            the staged wgmma tile as K1's) at their edges: 4B W8 g64 qkv,
            down + res and the tied LM head at M = 1, 2, 3, 4, 20, 32, 33,
            36, 128, 1024, an N-tail (N = 1001), the other seven widths on
            qkv at M = 1, 3, 4, 33, 128, each held to its route's plain
            arithmetic as K1 is, the
            grouped W4A8 matmul (30B-A3B gate and down, T = 8, 16, 32, 128,
            one expert holding 16, 17, 64 or 128 rows, two holding 65 and
            63, empty experts) and the grouped any-width matmul (30B-A3B W4
            g64 and W8 g64 at its routes' edges: T = 8, SG_B16_MIN_T - 1 and
            SG_B16_MIN_T, one expert holding 15, 16, 17, 32 or 33 rows,
            empty experts at both ends, T = 32 and 1024, and from the gate
            an expert holding 15, 16, 17 or 33 rows among the others' and
            one holding all; each case's route asserted, each held per
            element, 2 bf16 ulps + 1e-3 of max); int8 bounds at 1979 TOPS;
            beside each
            W4A8 case the GEMV's time before the int8 tile as PERF.md
            records it (a prior record, not measured in the run); one
            decode step each for the kernel line
  a8_model  (run right after `model`, as sg_model) the model phase on
            Qwen3-4B with act_quant="int8" (the same weights): per decode
            step the W4A8 matmul 144, K1 1, K2 36; per prefill K1 145;
            beside the W4A16 numbers, and both models' B = 1 runs taken in
            turns (A B B A)
  sg_model  Qwen3-4B at W8 g64: one decode run at full depth (the any-width
            matmul 145 a step, K1 0), runs in turns with W4A16's, and
            4-layer parity
  a8_parity 4 layers, W4A8 kernel path against plain path, and the W4A8
            drift from W4A16; then a 12-token prompt tail (the W4A8
            matmul's int8 tile at M = 12) held the same way
  a8_serving    (right after paged3_serving) the serving phase's campaign
            with act_quant="int8": its two campaigns were taken in turns
            with `serving`'s; the medians of both in those turns and both
            sides' launches per campaign (decode steps of 3 or 4 slots and
            prompt tails of 3-32 tokens reach the W4A8 matmul's int8 tile)
  a8_moe    (run right after `moe_model`) Qwen3-30B-A3B with
            act_quant="int8" on moe_model's weights: one decode run (the
            grouped W4A8 matmul 3, the W4A8 matmul 2 and K1 1 a layer and
            step, K1 also the LM head; the grouped W4A16 matmul 3 a layer a
            prefill), runs in turns with
            W4A16's, and 4-layer parity under RouteForcer (its 12-token
            tail: the grouped W4A8 matmul's int8 tile walk at T = 96)
  sg_moe    Qwen3-30B-A3B at W4 g64 (built once the W4 model is freed: one
            30B model on the card at a time): the grouped any-width
            matmul's decode step, one decode run (the any-width matmul 3
            a layer and the LM head, the grouped any-width matmul 3 a layer
            a step), 4-layer parity

Sequence-parallel attention, Qwen3-4B with its KV split over 8
shards, every shard a view on this card (parallel.SPAttention), run after
long_serving:
  sp_kernels    the shard decode-state kernel (row 6: a slab of 8192 in
            shards of 1024, B = 1 at 6000 keys and B = 4 at 1000-5000, L =
            1, 8 and 16, at 4B's heads and at n_rep 8; o held per element to
            _state_tol with the plain version at lens - 1 as a control that
            must miss it, every empty row exactly the identity) and
            the paged decode-state walk (row 14: a 400-page pool striped
            over the shards, B = 4, L = 1 and 16, its split count on the
            case line) against their plain versions on every
            shard, the empty ones included, and the chunk-state kernel at
            the virtual lengths sharded prefill gives it; each whole SP
            attention against unsharded attention
  sp_parity     4 layers: the SP kernel path against the SP plain path and
            SP against unsharded attention, teacher-forced, dense and paged
  sp_model      full depth, max_seq 8192: a 6000-token prompt in chunks of
            2048 and two 16-step bursts, in turns with the unsharded model
            (A B B A), exact launch counts (row 7 or row 6: 8 x 36 a chunk
            or step), B = 4 batched steps, a profile, a sync-free burst
  sp_serving    long_serving's prompts through batch_generate over the
            striped pool, one campaign

The last Pallas rows:
  mask_kernels  (run after quant_kernels) the explicit-mask kernel against
            its plain version at Qwen3-4B's heads and at n_rep 8: decode
            with sliding windows and per-head masks, prefill with a shared
            document mask and a per-head biased causal mask, S = 1000, fully
            masked rows (exactly 0), an additive causal mask against K3;
            then, at both heads and n_rep 1 and 2, the designs' edges (L = 16
            and 17, D = 64, window edges on keys 63 / 64 / 65 and on a decode
            split's boundary, a length below 64, a -1e29 row that averages
            and a -inf / -1e30 row that gives 0, large finite values in
            every hidden V row); each within a per-element tolerance (2 bf16
            ulps plus the probabilities' rounding drift), with a control (the
            mask shifted by one key) that must miss it; SDPA with the same
            float mask as the library; the bound counts the visible keys
            only; the share of map tiles live and the former SIMT kernel's
            time beside each case; then flash_attention(mask=...) as a user
            calls it
  axpby     the tutorial kernel at 8192 x 8192, bf16 and f32, bit-equal to
            its plain version; then axpby() as a user calls it
  paged3_parity (run before serving) Qwen3Model(paged_fused_one=False), 4
            layers: the three-launch route (the prep kernel, which writes
            the page rows, then the paged decode kernel) against its plain
            route and against the fused route, teacher-forced; exact
            launches a step; a profiled step (the device's kernels a step);
            a sync-free burst; the prep kernel against its plain version,
            returning its rows and writing them into the pages (a page's
            boundary +-1, an idle row: written slots against plain, every
            other slot untouched, one launch a call)
  paged3_serving  (run after serving) the serving campaign through that
            route at full depth, after its own warm-up: two campaigns,
            taken in turns with `serving`'s two (B C A B C A), their tokens
            equal; exact launches of a
            full-depth step (36 prep, 36 paged decode); a sync-free burst

Tensor, data and expert parallelism (every shard on this card, the
mesh repeating cuda:0):
  tp_model  (after speculative) Qwen3-4B at tp = 4: the dense model's
            fused weights split (qkv, gate/up on out-features; o, down on
            in-features, partial products summed in f32), run with
            attention on the gathered heads (K2 at decode) and with
            TPAttention (K3 per head shard): prefill and a decode step
            teacher-forced against the unsharded model (5 % of the largest
            logit, top-1 where decided), exact launches (K1 16 a layer + the
            head); the same over a page pool with TPAttention.paged (the
            paged decode kernel per head shard); 32 greedy steps of all
            three in turns (decode tok/s), a sync-free burst on each; K3
            and the paged decode and prefill kernels on a head shard of a
            slab and of a pool, read in place, bit-equal to a contiguous
            copy's and within tolerance of plain; then 4B's down at tp = 8 (1216 columns
            a shard, a quant group cut) against unsharded K1 at M = 1, 4,
            128, within the per-shard rounding bound
  dp_serving (after a8_serving) DPServing at dp = 2 with DPPagedAttention
            over a striped pool, the weights replicated per replica
            (shard_params): the serving campaign's first 8 requests,
            one campaign: every request returns, in a slot of its own
            replica, each stripe free again, tokens equal the `serving`
            campaign's up to a first divergence that must be a near-tie of
            the unsharded model's teacher-forced logits; exact launches of
            a decode step (K1 per replica at M = 2, the paged decode kernel
            once per replica a layer), a sync-free burst; output tok/s
  ep_moe    (before moe_serving) Qwen3-30B-A3B at ep = 4 and ep = 2 x tp =
            2, dropless: prefill and 8 steps teacher-forced against the
            unsharded model (its routing leading; flips only at near-ties),
            exact launches (row 18 three a MoE layer per shard), a sync-free
            burst, 32 greedy steps of all three in turns; EPMoE at ep = 4
            with capacity 1.0 against the plain version of the same drops

Pipeline parallelism and the runtime (every stage on this card, the
devices [cuda:0] * S):
  pp_model  (after tp_model) Qwen3-4B at full width and depth:
            PipelinedQwen3 at S = 2 and 4 on a PROMPT_LEN prompt, and on
            Qwen3-30B-A3B at S = 2, logits bit-equal to the unsharded
            forward_full, exact launches; MicrobatchedPipeline at (S, M) =
            (4, 4) and (2, 4) over 8 prompts, logits within 5 % of
            forward_full's largest, top-1 where decided, exact launches,
            K1 at M = Bm * PROMPT_LEN on its staged tile; DecodePipeline at
            (S, Bm) = (4, 1) and (2, 2) on 4 prompts, prefill and two
            16-step bursts, tokens equal the unsharded B = 4 greedy tokens
            up to each row's first divergence, a near-tie of the unsharded
            model's teacher-forced logits; exact launches of a burst (K1
            145 and K2 36 a microbatch step, K1 at M = Bm), a sync-free
            burst; decode tok/s against the unsharded B = 4 decode in turns
  overlap   (after pp_model) allgather_matmul and matmul_reducescatter at
            tp = 4 on Qwen3-4B's qkv and o shapes, bf16, and the chain,
            each within one bf16 rounding plus the f32 sum's bound of an
            f64 product, ms beside one torch.matmul; then initialize() a
            no-op without a launcher, a one-rank NCCL group through its
            explicit arguments (runtime_topology, barrier, an all_reduce),
            destroyed; a second rank cannot run on one GPU

  dense_moe (before cli) Qwen3-30B-A3B at 4 layers with dense bf16
            weights (random_params(quantized=False)): dense_linear (cuBLAS
            asked for f32 output) and the dense grouped product
            (torch._grouped_mm over device-side group offsets; the decode
            rows leave 120 of 128 experts empty) against an f64 product
            rounded once and the per-expert plain version, each within one
            bf16 ulp plus the f32 sum's error bound; a sync-free burst; and
            the parity rule against impl="torch" under RouteForcer
  cli       (last) python -m tiny_llm_tpu_torch.main --model qwen3-0.6b
            --draft-model qwen3-0.6b --max-tokens 16, python -m
            tiny_llm_tpu_torch.batch_main --model qwen3-0.6b
            --max-output-tokens 16, python -m tiny_llm_tpu_torch.agent_main
            "<task>" --model qwen3-0.6b --no-session --yes --max-steps 1
            --max-tokens 16 --root <tmp>, python -m
            tiny_llm_tpu_torch.evaluate_agent grade evals/localized-constant
            and ... run evals/localized-constant --model qwen3-0.6b
            --max-steps 1 as subprocesses side by side (synthetic weights,
            the byte tokenizer): exit 0 and their printed output

The coding agent (tiny_llm_tpu_torch.agent):
  agent     (after speculative) Qwen3-4B at full width and depth on the
            dense model's weights, max_seq 4096 (agent_main's): a scripted
            conversation (the system prompt of a read-only ToolPolicy, a
            task) of four turns on GenerationSession, at most 32 tokens
            each: cold; the reply and a tool observation appended (prefix
            reuse); the observation's last byte changed (a rewind, a 16-token
            suffix: K3's L <= 16 route, row 4's); the same messages (the
            last token replayed through K2). Each turn's GenerationStats
            held exactly to the session's rule, its K1, K2 and K3 launches
            exactly, its prefill ms and decode tok/s; each warm turn's tokens
            against a cold session's on the same messages, equal up to a
            first divergence from which every token, teacher-forced, lies
            within SPEC_TIE_ULPS bf16 ulps of the step's max; the same turns
            on the plain route (impl="torch", on the card, no launch) and on
            a paged session (K3 for the first chunk, row 13 for later
            chunks, row 12 for the 16-token suffix, row 9 for the replay and
            every decode step), each against the dense kernel route's tokens
            under the same rule, the pages after each turn and each rewind
            (a rewind frees whole pages), none live after reset(); then one
            run_agent call of two steps in a temporary workspace, its
            session log replayed from disk, its journal with no pending
            mutation

Then the nvidia-smi line, one {"kernels": [...]} line and, last,
{"ok": true, "device": {...}}. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, NVIDIA data sheet
INT8_OPS = 1979e12  # dense int8 tensor-core peak, NVIDIA data sheet
FP32_FLOPS = 67e12  # float32 outside the tensor cores, NVIDIA data sheet
PROMPT_LEN, DECODE_STEPS, BURST, MAX_SEQ = 128, 128, 16, 1024
# bench.py serving_bench's default pool: (max_seq // ps) * (batch + 2) + 9 pages.
PAGE_SIZE, SERVING_BATCH, SERVING_REQUESTS = 128, 4, 16
POOL_PAGES = (MAX_SEQ // PAGE_SIZE) * (SERVING_BATCH + 2) + 9
PAGED = ("fused_paged_decode_attention", "paged_decode", "paged_prefill")
SPLIT = ("flash_prefill_state", "paged_prefix_state")  # the split paged prefill's kernels
# Long prompts: bench_chunked_prefill.py's 8192-token prompt in chunks of
# 1024 (offset > 0 chunks of 1024 take the split paged prefill), on a model
# of max_seq 8320 with a 66-page pool (the prompt's 64 pages, the trash page
# and one more).
LONG_PROMPT, LONG_CHUNK, LONG_MAX_SEQ = 8192, 1024, 8320
LONG_PAGES = LONG_MAX_SEQ // PAGE_SIZE + 1
LONG_REQUESTS, LONG_MIN_PROMPT = 8, 2048
MIXED_CHUNK = 32  # bench.py --mixed's sub-chunk
TIE_MARGIN = 1e-3  # routing near-tie: k-th minus (k+1)-th router probability
# W4A8 paths quantize their own activations: a bf16 ulp upstream that
# crosses an int8 step (max|x| / 127 wide) flips a code, so two W4A8 paths drift
# apart by ~1 % of the output per projection (a flip moves it by sx * w),
# where two W4A16 paths differ by the ulp alone. Their parity tolerance
# and near-tie router margin are wider by that much. At that width the
# model-level parity is a drift gate only: it cannot tell W4A8 from W4A16
# (their drift is 5 %). The W4A8 kernels' own checks (`_close` with codes)
# can: kernel and plain version quantize the same x into the same codes.
A8_PARITY_TOL, A8_TIE_MARGIN = 0.10, 1e-2
A8_TAIL = 12  # a8_parity's prompt tail: 12 dense rows, 96 grouped (the int8 tile's routes)
# The masked kernel and the split prefill's state kernels against their
# plain versions, per element.
TOL_ATTENTION = "2 bf16 ulps + min(2^-8 W|v|, 6 * 2^-9 sqrt(W v^2 / l)) (_state_tol)"
# Sequence-parallel attention (the JAX tests' 8-shard mesh, every shard on
# this card): a slab of 8192 positions in shards of 1024; a 6000-token
# prompt leaves shards 6 and 7 empty at decode; B = 4 prompts whose lengths
# cross shard boundaries; long_serving's pool rule at max_seq 8192 (393
# pages), rounded up to a multiple of the shards.
SP_SHARDS, SP_MAX_SEQ, SP_PROMPT, SP_CHUNK = 8, 8192, 6000, 2048
SP_BATCH_PROMPTS = (1000, 2100, 3500, 5000)
SP_PAGES = 400
SP = ("flash_decode_state", "paged_decode_state")  # the sequence-parallel path's own kernels
# Qwen3-30B-A3B runs at full width and 4 of its 48 layers in every MoE
# phase, to keep the script inside its time limit (on slow hosts it took
# 1174 s of its 1200 at 48 layers, 1098 s at 24; 8 layers until the
# pipeline phases came; the 4B model carries the full-depth main path).
MOE_LAYERS = 4
# `serving`'s campaigns, each after one of the three-launch and the W4A8
# models' (B C A B C A): two of each hold each model's tokens across two
# campaigns and keep the script inside its time limit.
SERVING_RUNS = 2
# mixed_serving runs Qwen3-4B at full width and 12 of its 36 layers (the
# dense model's first 12): both campaigns and every check kept, and the
# script kept inside its time limit once the agent phases came.
MIXED_LAYERS = 12


PHASES: list[dict] = []  # every phase line printed, for --out
START = time.perf_counter()


def emit(obj) -> None:
    """Print one phase line, stamped with the seconds since the script began."""
    if "phase" in obj:
        obj["t_s"] = round(time.perf_counter() - START, 1)
    PHASES.append(obj)
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def graph_ms(fn, replays: int = 5) -> float:
    """Device ms of one fn() call: fn's launches captured in a CUDA graph and
    replayed, so host launch cost does not stretch the timing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def event_ms(fn, reps: int = 3) -> float:
    """Device-clock ms of one eager fn() call (host launch gaps included)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    tb, tf = bytes_ / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------


def phase_build():
    from tiny_llm_tpu_torch.kernels import build

    t0 = time.perf_counter()
    log = build.build_all()
    secs = time.perf_counter() - t0
    regs = {name: build.ptxas_registers(info["ptxas"]) for name, info in log.items()}
    # Each library's SASS read once, all in parallel (cuobjdump processes).
    srcs = ("flash_attention", "paged_attention", "flash_attention_masked", "quant_matmul",
            "moe_matmul", "quant_matmul_sg", "fused_decode_attention", "moe_matmul_sg")
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        sass = dict(zip(srcs, pool.map(lambda n: build.sass_report(build._target(n)), srcs)))

    # The split prefill's state kernels and the masked prefill walk run their
    # products as warpgroup MMAs (HGMMA in SASS); the masked decode walk as
    # mma.sync (HMMA); the W4A8 tiles as int8 mma.sync (IMMA).
    def tensor_ops(src, key, kind):
        return {re.sub(r"^_ZN\d+_\w+_cu_[0-9a-f]{8}\d+", "", fn): info[kind]
                for fn, info in sass[src].items() if key in fn}

    tc = {**tensor_ops("flash_attention", "prefill_state", "tensor_core_ops"),
          **tensor_ops("paged_attention", "prefix_state", "tensor_core_ops")}
    check(len(tc) == 16 and all(tc.values()), f"state kernels' tensor-core instructions: {tc}")
    masked = tensor_ops("flash_attention_masked", "flash_masked_prefill", "hgmma")
    check(len(masked) == 24 and all(masked.values()), f"masked prefill HGMMA: {masked}")
    dec = tensor_ops("flash_attention_masked", "flash_masked_decode", "tensor_core_ops")
    check(len(dec) == 24 and all(dec.values()), f"masked decode HMMA: {dec}")
    imma = {**tensor_ops("quant_matmul", "a8_tile", "imma"),
            **tensor_ops("moe_matmul", "a8_tile", "imma")}
    check(len(imma) == 2 and all(imma.values()), f"W4A8 tiles' IMMA: {imma}")
    # Row 14's split walk and K1's bf16 tile run mma.sync (HMMA), K1's
    # staged tile warpgroup MMAs (HGMMA).
    walk = tensor_ops("paged_attention", "paged_state_walk", "tensor_core_ops")
    check(len(walk) == 8 and all(walk.values()), f"paged decode-state walk HMMA: {walk}")
    b16 = tensor_ops("quant_matmul", "qmm_b16_tile", "tensor_core_ops")
    check(len(b16) == 2 and all(b16.values()), f"K1 bf16 tile HMMA: {b16}")
    staged = tensor_ops("quant_matmul", "qmm_staged_tile", "hgmma")
    check(len(staged) == 1 and all(staged.values()), f"K1 staged tile HGMMA: {staged}")
    # Row 17's tiles at its 8 widths (the bf16 tile at 16 and 32 rows a
    # block), row 6's split walk over a slab (8 instances).
    sg_b16 = tensor_ops("quant_matmul_sg", "qmm_sg_b16_tile", "tensor_core_ops")
    check(len(sg_b16) == 16 and all(sg_b16.values()), f"row 17 bf16 tile HMMA: {sg_b16}")
    sg_staged = tensor_ops("quant_matmul_sg", "qmm_sg_staged_tile", "hgmma")
    check(len(sg_staged) == 8 and all(sg_staged.values()), f"row 17 staged tile HGMMA: {sg_staged}")
    fdec = tensor_ops("flash_attention", "flash_decode_walk", "tensor_core_ops")
    check(len(fdec) == 8 and all(fdec.values()), f"row 6 split walk HMMA: {fdec}")
    # The paged decode's split walk runs mma.sync (HMMA), the paged prefill
    # the wgmma tile (HGMMA), unsplit and key-split (8 instances each).
    pdec = tensor_ops("paged_attention", "paged_decode_walk", "tensor_core_ops")
    check(len(pdec) == 8 and all(pdec.values()), f"paged decode walk HMMA: {pdec}")
    pfill = tensor_ops("paged_attention", "paged_flash_prefill", "hgmma")
    check(len(pfill) == 16 and all(pfill.values()), f"paged prefill HGMMA: {pfill}")
    # Row 9's split walk (8 instances) and row 18's bf16 tile walk (16-row
    # tiles) run mma.sync (HMMA).
    fused = tensor_ops("fused_decode_attention", "fused_paged_walk", "tensor_core_ops")
    check(len(fused) == 8 and all(fused.values()), f"row 9 split walk HMMA: {fused}")
    gb16 = tensor_ops("moe_matmul", "moe_b16_tile", "tensor_core_ops")
    check(len(gb16) == 1 and all(gb16.values()), f"row 18 bf16 tile walk HMMA: {gb16}")
    # Row 20's tile walk at its 8 widths (row 18's walk on row 17's bodies).
    sgb16 = tensor_ops("moe_matmul_sg", "moe_sg_b16_tile", "tensor_core_ops")
    check(len(sgb16) == 8 and all(sgb16.values()), f"row 20 bf16 tile walk HMMA: {sgb16}")
    # K3 above L = 16 runs the wgmma tile (HGMMA), unsplit and key-split (8
    # instances each); at L <= 16 row 6's split walk (checked above). K2
    # runs row 9's split walk over the slab (8 instances, HMMA).
    k3tile = tensor_ops("flash_attention", "flash_causal", "hgmma")
    check(len(k3tile) == 16 and all(k3tile.values()), f"K3 tile HGMMA: {k3tile}")
    k2walk = tensor_ops("fused_decode_attention", "fused_dense_walk", "tensor_core_ops")
    check(len(k2walk) == 8 and all(k2walk.values()), f"K2 split walk HMMA: {k2walk}")
    smi = nvidia_smi()
    emit({"phase": "build", "seconds": round(secs, 2), "built": sorted(log),
          "state_kernels_tensor_core_ops": tc, "masked_prefill_hgmma": masked,
          "masked_decode_tensor_core_ops": dec, "a8_tile_imma": imma,
          "paged_state_walk_tensor_core_ops": walk, "k1_b16_tile_tensor_core_ops": b16,
          "k1_staged_tile_hgmma": staged, "paged_decode_walk_tensor_core_ops": pdec,
          "paged_prefill_hgmma": pfill, "sg_b16_tile_tensor_core_ops": sg_b16,
          "sg_staged_tile_hgmma": sg_staged, "flash_decode_walk_tensor_core_ops": fdec,
          "fused_paged_walk_tensor_core_ops": fused, "grouped_b16_tile_tensor_core_ops": gb16,
          "grouped_sg_b16_tile_tensor_core_ops": sgb16,
          "k3_tile_hgmma": k3tile,
          "k2_walk_tensor_core_ops": k2walk,
          "library_done_s": {n: round(i["seconds"], 1) for n, i in log.items()},
          "gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi, regs


def _k1_shapes(cfg):
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qkv = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * cfg.head_dim
    return {"qkv": (qkv, D, "wqkv", False), "o": (D, cfg.num_attention_heads * cfg.head_dim,
            "wo", True), "gate_up": (2 * I, D, "w_gate_up", False),
            "down": (D, I, "w_down", True), "lm_head": (V, D, None, False)}


def _layer_weight(params, layer, attr):
    if attr is None:
        return params.embedding
    holder = layer.attn if attr in ("wqkv", "wo") else layer.mlp
    return getattr(holder, attr)


def _qmm_bytes(qt, M, residual):
    """Packed codes, scales and biases, x, out (and the residual)."""
    N, Kp = qt.out_features, qt.k_padded
    return N * Kp * qt.bits // 8 + 2 * N * (Kp // qt.group_size) * 2 + M * Kp * 2 \
        + M * N * 2 * (2 if residual else 1)


def _path_launches(cfg, act="bf16", sg=False):
    """Each kernel's launches on the dense path at B = 1: per decode step,
    per PROMPT_LEN-token prefill. The projections (qkv and o in every layer,
    gate_up and down in a dense layer), the router in a MoE layer and the
    LM head run K1 at W4A16; at W4A8 (act "int8") the projections run the
    W4A8 kernel at a decode step (1 row) and K1 at the prefill (128 rows),
    the router and head K1; weights of another width (sg) run the
    any-width kernel everywhere. The experts (gate, up, down in a MoE
    layer) likewise run the grouped W4A16, W4A8 (T = 8 at a step; 1024 at
    the prefill: W4A16) or any-width kernel."""
    from tiny_llm_tpu_torch import kernels

    L = cfg.num_hidden_layers
    moe = sum(cfg.is_moe_layer(i) for i in range(L))
    proj, head = 2 * L + 2 * (L - moe), moe + 1
    per_step, per_prefill = dict.fromkeys(kernels.KERNELS, 0), dict.fromkeys(kernels.KERNELS, 0)
    per_step["fused_decode_attention"] = per_prefill["flash_attention"] = L
    if sg:
        for d in (per_step, per_prefill):
            d.update(quant_matmul_sg=proj + head, grouped_quant_matmul_sg=3 * moe)
    else:
        per_prefill.update(quant_matmul=proj + head, grouped_quant_matmul=3 * moe)
        if act == "int8":
            per_step.update(quant_matmul_a8=proj, quant_matmul=head,
                            grouped_quant_matmul_a8=3 * moe)
        else:
            per_step.update(quant_matmul=proj + head, grouped_quant_matmul=3 * moe)
    return per_step, per_prefill


def phase_kernels(model, cfg, moe_model, moe_cfg):
    """Each kernel against its plain version on the card, and timed: K1 and
    the attention kernels at Qwen3-4B's shapes, then the grouped expert
    matmul and the attention kernels at Qwen3-30B-A3B's (n_rep 8)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases, contract = _k1_cases(model, cfg, gen)
    # Distinct, non-unit QK-norm weights (the synthetic model's are all ones),
    # so a kernel that drops or swaps them disagrees with its plain version.
    D_h = cfg.head_dim
    qw = (1 + 0.1 * torch.randn(D_h, generator=gen, device=dev)).to(torch.bfloat16)
    kw = (1 + 0.1 * torch.randn(D_h, generator=gen, device=dev)).to(torch.bfloat16)
    cases += _attention_cases(model, cfg, gen, qw, kw, contract)
    cases += phase_paged_kernels(model, cfg, gen, qw, kw, contract)
    moe_cases = _grouped_cases(moe_model, moe_cfg, gen, contract)
    moe_cases += _attention_cases(moe_model, moe_cfg, gen, qw, kw, None)
    moe_cases += phase_paged_kernels(moe_model, moe_cfg, gen, qw, kw, None)
    for c in moe_cases:
        c["model"] = "qwen3-30b-a3b"
    emit({"phase": "kernels", "cases": cases + moe_cases})
    return contract


def _annotate_launches(cases, cfg):
    """Each dense-path case's launches per decode step and per prefill."""
    per_step, per_prefill = _path_launches(cfg)
    for c in cases:
        c["launches"] = {"per_decode_step": per_step[c["kernel"]],
                         "per_prefill": per_prefill[c["kernel"]]}
    return cases


def _close(got, want, codes=False):
    """(max |got - want|, its ratio to the tolerance; <= 1 passes, NaN
    fails). The tolerance is 1 % of max |want|, or, with `codes`, 2 bf16
    ulps of each element plus 1e-3 of max |want| (a floor for outputs that
    cancel): a W4A8 kernel and its plain version quantize x into the same
    int8 codes, so they differ only by f32 summation order and the one bf16
    rounding. W4A16 arithmetic on the same x misses that check several
    times over (the int8 step's error, ~1 % of max |want|), so it tells
    W4A8 from W4A16, where 1 % of max does not."""
    w = want.float()
    diff = (got.float() - w).abs()
    peak = w.abs().max()
    if codes:
        _, e = torch.frexp(w)  # |w| in [2^(e-1), 2^e): one bf16 ulp is 2^(e-8)
        tol = torch.ldexp(torch.full_like(w, 2.0), e - 8) * (w != 0) + 1e-3 * peak
    else:
        tol = 1e-2 * peak
    return float(diff.max()), float((diff / tol).max())


def _tol_rule(codes):
    return "2 bf16 ulps + 1e-3 max|plain| per element" if codes else "1e-2 max|plain|"


def _dense_cases(kernel, tpu_kernel, ws, Ms, residuals, gen, cuda_fn, plain_fn, peak, label,
                 control=None, route_plain=None):
    """A dense matmul kernel against its plain version on ws[0] at each M
    of `Ms` rows, with and without a residual as `residuals` says, timed
    over every weight of `ws`; library: a bf16 matmul on the dequantized
    weights. With `control` (the W4A16 plain version, for a W4A8 kernel),
    the check is `_close`'s codes check, and `control` on the same x must
    fail it. With `route_plain` (K1: M -> (route, the plain version of that
    route's arithmetic)), each case is also held to its route's plain
    version per element (`_close`'s codes check), beside the 1 %-of-max
    check against `plain_fn`."""
    from tiny_llm_tpu_torch.ops.quantize import dequantize

    dev = torch.device("cuda")
    N, K = ws[0].out_features, ws[0].in_features
    dense = [dequantize(w) for w in ws]
    codes = control is not None
    cases = []
    for M in Ms:
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        for residual in residuals:
            r = torch.randn((M, N), generator=gen, device=dev).to(torch.bfloat16) \
                if residual else None
            got, want = cuda_fn(x, ws[0], r), plain_fn(x, ws[0], r)
            torch.cuda.synchronize()
            err, ratio = _close(got, want, codes)
            what = f"{kernel} {label} M={M} res={residual}"
            check(ratio <= 1, f"{what}: {err} is {ratio} x {_tol_rule(codes)}")
            extra = {}
            if route_plain is not None:
                route, own = route_plain(M)
                own_err, own_ratio = _close(got, own(x, ws[0], r), True)
                check(own_ratio <= 1, f"{what} ({route}): {own_err} is {own_ratio} x "
                      f"{_tol_rule(True)} of its route's plain version")
                extra.update(route=route, route_plain_max_err=own_err,
                             route_plain_err_over_tol=own_ratio,
                             route_plain_tol=_tol_rule(True))
            if codes:
                extra["w4a16_err_over_tol"] = _close(control(x, ws[0], r), want, codes)[1]
                check(extra["w4a16_err_over_tol"] > 1, f"{what}: W4A16 passes the W4A8 check")
            if codes and M == Ms[-1]:  # the worst case's device ms by kernel (quantize, tile)
                extra["device_ms_by_kernel"] = _device_profile(
                    lambda: cuda_fn(x, ws[0], r), 1)["top_kernels_ms_per_step"]
            kern = graph_ms(lambda: [cuda_fn(x, w, r) for w in ws]) / len(ws)
            plain = event_ms(lambda: plain_fn(x, ws[0], r), reps=2)
            lib = graph_ms(lambda: [torch.addmm(r, x, d.T) if residual else torch.matmul(x, d.T)
                                    for d in dense]) / len(ws)
            bms, by = bound(_qmm_bytes(ws[0], M, residual), 2 * M * N * K, peak)
            cases.append({"kernel": kernel, "tpu_kernel": tpu_kernel, "rows": M,
                          "shape": f"{label} N={N} K={K} W{ws[0].bits} g{ws[0].group_size} M={M}"
                                   + (" +res" if residual else ""),
                          "max_err": err, "err_over_tol": ratio, "tol": _tol_rule(codes), **extra,
                          "kernel_ms": kern, "plain_ms": plain, "library_ms": lib,
                          "library": "matmul on bf16-dequantized weights", "bound_ms": bms,
                          "bound_by": by})
    del dense
    torch.cuda.empty_cache()
    return cases


def _dense_step(params, cfg, gen, cuda_fn, plain_fn, name, source, replaces, label, peak,
                head, control=None):
    """One B = 1 decode step of a dense matmul kernel: every layer's qkv,
    o + res, gate_up, down + res in model order (and the LM head when
    `head`), distinct weights: each output against the plain version's
    (`_close`; with `control`, as in `_dense_cases`), kernel, plain and
    library times, and the bound. Returns the kernel line's entry."""
    from tiny_llm_tpu_torch.ops.quantize import dequantize

    dev = torch.device("cuda")
    shapes = _k1_shapes(cfg)
    layers = params.layers
    order = [(n, i) for i in range(len(layers)) for n in ("qkv", "o", "gate_up", "down")]
    if head:
        order.append(("lm_head", 0))
    wq = {n: [_layer_weight(params, L, a) for L in (layers if a else layers[:1])]
          for n, (_, _, a, _) in shapes.items()}
    xs = {n: torch.randn((1, K), generator=gen, device=dev).to(torch.bfloat16)
          for n, (_, K, _, _) in shapes.items()}
    res = torch.randn((1, cfg.hidden_size), generator=gen, device=dev).to(torch.bfloat16)

    def step(fn):
        return lambda: [fn(xs[n], wq[n][i], res if shapes[n][3] else None) for n, i in order]

    step_got, step_want = step(cuda_fn)(), step(plain_fn)()
    step_ctl = step(control)() if control is not None else [None] * len(order)
    torch.cuda.synchronize()
    step_err, ctl_min, codes = 0.0, float("inf"), control is not None
    for (n, i), got, want, ctl in zip(order, step_got, step_want, step_ctl):
        err, ratio = _close(got, want, codes)
        check(ratio <= 1, f"{name} decode step {n}[{i}]: {err} is {ratio} x {_tol_rule(codes)}")
        step_err = max(step_err, err)
        if codes:
            ctl_min = min(ctl_min, _close(ctl, want, codes)[1])
    check(not codes or ctl_min > 1, f"{name} decode step: W4A16 passes the W4A8 check")
    del step_got, step_want, step_ctl
    kern = graph_ms(step(cuda_fn), replays=3)
    plain = event_ms(step(plain_fn), reps=1)
    dense = {(n, i): dequantize(wq[n][i]) for n, i in order}
    lib = graph_ms(lambda: [torch.addmm(res, xs[n], dense[n, i].T) if shapes[n][3]
                            else torch.matmul(xs[n], dense[n, i].T) for n, i in order], replays=3)
    del dense
    torch.cuda.empty_cache()
    bms, by = bound(sum(_qmm_bytes(wq[n][i], 1, shapes[n][3]) for n, i in order),
                    sum(2 * shapes[n][0] * shapes[n][1] for n, _ in order), peak)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "case": f"one {label} decode step: {len(order)} launches at M=1 ({len(layers)} x "
                    "qkv, o+res, gate_up, down+res" + ("; lm_head)" if head else ")"),
            "max_abs_err": step_err, "tol": _tol_rule(codes),
            **({"w4a16_min_err_over_tol": ctl_min} if codes else {}),
            "ms": kern, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "library": "matmul on bf16-dequantized weights"}


# K1's times on its former routes (PERF.md's kernel table: M = 4 and 20 on
# the 4- and 8-row GEMV instances, M = 128 on the 64 x 64 mma.sync tile;
# NVIDIA H100 80GB HBM3, 700.00 W), ms by (shape, M, residual). A prior
# record, printed beside this run's times under its own key.
K1_PRIOR_MS = {
    ("qkv", 4, False): 0.0235, ("qkv", 20, False): 0.1029, ("qkv", 128, False): 0.0531,
    ("gate_up", 4, False): 0.0645, ("gate_up", 20, False): 0.3086,
    ("gate_up", 128, False): 0.1126, ("down", 4, True): 0.0378, ("down", 20, True): 0.1449,
    ("down", 128, True): 0.1526, ("lm_head", 4, False): 0.4700,
    ("lm_head", 20, False): 2.3919, ("lm_head", 128, False): 0.7141,
}


def _k1_route_plain(M):
    """K1's route at M rows and the plain version of its arithmetic."""
    from tiny_llm_tpu_torch.kernels import quant_matmul as k1

    route = k1.k1_route(M)
    return route, k1.quant_matmul_staged_plain if route == "staged" else k1.quant_matmul_plain


def _k1_cases(model, cfg, gen):
    """K1 for each projection shape, with and without residual, at M = 1
    (decode) and 128 (prefill), the main path's, and at M = 4 and 20
    (batched decode); also at the routes' edges M = 2, 3, 32,
    33, 36 (mixed serving) and 1024 (long prefill) on qkv, gate_up and down
    + res, and on an N-tail weight (N = 1001, K = 2560); each case beside
    its route and K1_PRIOR_MS; then one decode step, 145 launches in model
    order, for the kernel line."""
    from tiny_llm_tpu_torch.kernels import quant_matmul as k1

    params, layers = model.params, model.params.layers
    cases = []
    run = functools.partial(_dense_cases, "quant_matmul", k1.TPU_KERNEL, gen=gen,
                            cuda_fn=k1.quant_matmul_cuda, plain_fn=k1.quant_matmul_plain,
                            peak=BF16_FLOPS, route_plain=_k1_route_plain)
    for name, (_, _, attr, residual) in _k1_shapes(cfg).items():
        ws = [_layer_weight(params, L, attr) for L in (layers if attr else layers[:1])]
        cases += run(ws=ws, Ms=(1, 4, 20, 128), residuals=(False, True), label=name)
        if name in ("qkv", "gate_up", "down"):
            cases += run(ws=ws, Ms=(2, 3, 32, 33, 36, 1024), residuals=(residual,), label=name)
    ws = _random_qt(gen, 1001, 2560, 4, 128, copies=4)
    cases += run(ws=ws, Ms=(1, 4, 36, 1024), residuals=(True,), label="N-tail")
    del ws
    for c in cases:
        c["prior_record_ms"] = K1_PRIOR_MS.get(
            (c["shape"].split()[0], c["rows"], c["shape"].endswith("+res")))
    contract = {"quant_matmul": _dense_step(
        params, cfg, gen, k1.quant_matmul_cuda, k1.quant_matmul_plain, "quant_matmul", k1.SOURCE,
        "tiny_llm_tpu/kernels/quant_matmul.py:154", "4B", BF16_FLOPS, head=True)}
    return _annotate_launches(cases, cfg), contract


# K2's cases: offsets over a slab of MAX_SEQ positions. B = 1 at 192 is
# the contract's case; offset 0 is the v row exactly; 127 / 128 / 129 sit
# on a split's boundary, 1023 fills the slab.
K2_CASES = ([128], [255], [128, 170, 213, 255], [192], [0], [127, 128, 129, 1023])
# K3's cases: (B, L, lens, S, the route flash_split must choose). L = 128
# over the slab of MAX_SEQ (the dense prompt chunk, at the slab's start and
# its end: the unsplit tile, as every slab under K3_SPLIT_MIN_S keys), L =
# 8 and 16 (row 4's regime, the split walk) and 17 (the tile) at the route
# gate, L = S = lens = 1024 (long_prefill's first chunk), B = 4, L = S =
# 128 (serving's first chunk, its own k/v), and L = 128 over a slab of 8192
# at lens 128 and 8192 (a dense model at a long max_seq: the split tile).
K3_WALK, K3_TILE, K3_SPLIT = "split walk + combine", "tile", "split tile + combine"
K3_CASES = ((1, 128, (128,), MAX_SEQ, K3_TILE), (1, 8, (8,), MAX_SEQ, K3_WALK),
            (1, 8, (200,), MAX_SEQ, K3_WALK), (1, 16, (16,), MAX_SEQ, K3_WALK),
            (1, 17, (700,), MAX_SEQ, K3_TILE), (1, 128, (1024,), MAX_SEQ, K3_TILE),
            (1, 1024, (1024,), 1024, K3_TILE), (4, 128, (128, 128, 128, 128), 128, K3_TILE),
            (1, 128, (128,), 8192, K3_SPLIT), (1, 128, (8192,), 8192, K3_SPLIT))


def _step_tol(qkv, k, v, off, cr, sr, qw, kw, scale, eps, want):
    """_state_tol for the fused decode step (K2 over a slab, row 9 over the
    gathered pages, k / v [B, Hkv, S, D]): the plain step's attention is
    attention_state_plain of its normed and roped q over the cached keys
    [0, off) and the current token's own k and v row at position off.
    Returns it shaped as the kernel's out [B, Hkv, n_rep, D]."""
    from tiny_llm_tpu_torch.kernels import fused_decode_attention as kf

    B, Hkv, n_rep, D = want.shape
    q, k_row, v_row = kf.fused_qkv_prep_plain(qkv, off, cr, sr, qw, kw, eps=eps)
    k, v = k.clone(), v.clone()
    rows = torch.arange(B, device=qkv.device)
    k[rows, :, off.long()] = k_row[:, :, 0]
    v[rows, :, off.long()] = v_row[:, :, 0]
    ok = (torch.arange(k.shape[2], device=qkv.device)[None, :] <= off[:, None].long())[:, None]
    tol = _state_tol(q.reshape(B, Hkv * n_rep, 1, D), k, v, ok, scale,
                     want.reshape(B, Hkv * n_rep, 1, D))
    return tol.reshape(B, Hkv, n_rep, D)


def _attention_cases(model, cfg, gen, qw, kw, contract):
    """K2 and K3 against their plain versions at the model's head shape,
    each held per element to _state_tol with controls one key off that must
    miss it in every batch row they change (K2: offsets - 1 and + 1; K3:
    lens - 1 and + 1), one count a call; `contract` (None: not recorded)
    takes the main cases' numbers."""
    from tiny_llm_tpu_torch.kernels import flash_attention as k3
    from tiny_llm_tpu_torch.kernels import fused_decode_attention as k2
    from tiny_llm_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    Hkv, D_h = cfg.num_key_value_heads, cfg.head_dim
    n_rep = cfg.num_attention_heads // Hkv
    Hq, Ly = Hkv * n_rep, cfg.num_hidden_layers
    eps, scale = cfg.rms_norm_eps, D_h**-0.5
    cos_t, sin_t = model._rope_tables
    sms = _sms()
    name = "fused_decode_attention"
    k2_errs = []
    for offs in K2_CASES:
        B = len(offs)
        keys = torch.randn((Ly, B, Hkv, MAX_SEQ, D_h), generator=gen, device=dev).to(torch.bfloat16)
        values = torch.randn_like(keys, dtype=torch.float32).to(torch.bfloat16)
        qkv = torch.randn((B, Hkv, n_rep + 2, D_h), generator=gen, device=dev).to(torch.bfloat16)
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        cr, sr = cos_t[off.long()], sin_t[off.long()]

        def args(o=off):
            return (qkv, keys, values, o, cr, sr, qw, kw)

        got = []
        counts = _kernel_path(lambda: got.append(k2.fused_decode_attention_cuda(
            *args(), layer_idx=3, scale=scale, eps=eps)), name)
        check(counts[name] == 1, f"{name} offs={offs}: {counts[name]} launches for one call")
        got = got[0]
        want = k2.fused_decode_attention_plain(*args(), layer_idx=3, scale=scale, eps=eps)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got[0]).all()), f"{name} offs={offs}: not finite")
        tol = _step_tol(qkv, keys[3], values[3], off, cr, sr, qw, kw, scale, eps, want[0])
        err, rows = max_err(got[0], want[0]), _over_tol(got[0], want[0], tol)
        check(max(rows) <= 1, f"{name} offs={offs}: {err}, {max(rows)} times its tolerance")
        ctl = {}
        for delta in (-1, 1):
            shifted = (off + delta).clamp(min=0)
            changed = [bool(shifted[b] != off[b]) for b in range(B)]
            control = k2.fused_decode_attention_plain(*args(shifted), layer_idx=3, scale=scale,
                                                      eps=eps)
            ctl[f"offsets {delta:+d}"] = _state_control(
                f"{name} offs={offs} offsets {delta:+d}", (got[0],), tol, (control[0],),
                changed) if any(changed) else []
        v_rows = qkv[:, :, n_rep + 1 :].expand(B, Hkv, n_rep, D_h)
        for b in range(B):
            if offs[b] == 0:
                check(torch.equal(got[0][b], v_rows[b]), f"{name} offs={offs}: row {b} is not "
                                                         "its v row")
        kerr = max_err(got[1], want[1])
        check(kerr <= 2**-7 * float(want[1].float().abs().max()), f"k_row {kerr}")
        check(torch.equal(got[2], want[2]), "v_row not bit-equal")
        k2_errs.append(err)
        kern = graph_ms(lambda: [k2.fused_decode_attention_cuda(
            *args(), layer_idx=i, scale=scale, eps=eps) for i in range(Ly)]) / Ly
        plain = event_ms(lambda: k2.fused_decode_attention_plain(
            *args(), layer_idx=3, scale=scale, eps=eps))
        # Library yardstick: SDPA over the slab's keys with each row's own
        # length (keys at or below its offset: the attention part of K2's
        # work, the current token's key taken from the slab). At B = 1 the
        # keys below offset + 1, no mask; at B = 4 a per-row boolean mask,
        # beside SDPA over max(offsets) + 1 keys with no per-row length (it
        # does not compute K2's function where the offsets differ).
        q = got[0].new_empty((B, Hq, 1, D_h)).normal_(generator=gen)
        n_ctx = max(offs) + 1
        unmasked = graph_ms(lambda: [sdpa(q, keys[i][:, :, :n_ctx], values[i][:, :, :n_ctx],
                                          scale=scale, enable_gqa=True) for i in range(Ly)]) / Ly
        lib, lib_what = unmasked, "SDPA over the keys below offset + 1"
        if B > 1:
            mask = (torch.arange(MAX_SEQ, device=dev)[None, :] <= off[:, None])[:, None, None]
            lib = graph_ms(lambda: [sdpa(q, keys[i], values[i], attn_mask=mask, scale=scale,
                                         enable_gqa=True) for i in range(Ly)]) / Ly
            lib_what = "SDPA over the slab, a per-row boolean mask (keys <= offset)"
        kv_bytes = sum(2 * Hkv * o * D_h * 2 for o in offs)
        io_bytes = B * Hkv * (n_rep + 2) * D_h * 2 * 2
        bms, by = bound(kv_bytes + io_bytes, sum(4 * Hkv * n_rep * (o + 1) * D_h for o in offs))
        kps = pa.decode_split(B, Hkv, MAX_SEQ, 1, sms)
        case = {"kernel": name, "tpu_kernel": k2.TPU_KERNEL,
                "shape": f"B={B} offsets={offs} S={MAX_SEQ} Hkv={Hkv} n_rep={n_rep} D={D_h}, "
                         f"{-(-MAX_SEQ // kps)} splits of {kps} keys",
                "launches_per_call": counts[name], "max_err": err,
                "err_over_tol_per_batch_row": rows, "tol": TOL_ATTENTION,
                "control_err_over_tol_per_batch_row": ctl, "kernel_ms": kern,
                "plain_ms": plain, "library_ms": lib, "library": lib_what,
                "library_no_row_lengths_ms": unmasked if B > 1 else None,
                "bound_ms": bms, "bound_by": by}
        cases.append(case)
        if offs == [192] and contract is not None:
            contract[name] = {
                "name": name, "route": "cuda", "source": k2.SOURCE,
                "replaces": "tiny_llm_tpu/kernels/fused_decode_attention.py:79",
                "case": case["shape"], "max_abs_err": None, "ms": kern,
                "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": lib,
            }
        del keys, values
    if contract is not None:
        contract[name]["max_abs_err"] = max(k2_errs)

    # K3 at K3_CASES over Ly layers' slabs.
    name = "flash_attention"
    k3_errs = []
    for B, L, lens_l, S, want_route in K3_CASES:
        q = torch.randn((B, Hq, L, D_h), generator=gen, device=dev).to(torch.bfloat16)
        ks = torch.randn((Ly, B, Hkv, S, D_h), generator=gen, device=dev).to(torch.bfloat16)
        vs = torch.randn_like(ks, dtype=torch.float32).to(torch.bfloat16)
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        got = []
        counts = _kernel_path(lambda: got.append(k3.flash_attention_cuda(q, ks[0], vs[0], lens,
                                                                         scale)), name)
        check(counts[name] == 1, f"{name} L={L}: {counts[name]} launches for one call")
        got = got[0]
        want = k3.flash_attention_plain(q, ks[0], vs[0], lens, scale)
        torch.cuda.synchronize()
        what = f"{name} B={B} L={L} lens={list(lens_l)} S={S}"
        check(bool(torch.isfinite(got).all()), f"{what}: not finite")
        ok = k3._causal_mask(lens, L, S, dev)
        tol = _state_tol(q, ks[0], vs[0], ok, scale, want)
        err, rows = max_err(got, want), _over_tol(got, want, tol)
        check(max(rows) <= 1, f"{what}: {err}, {max(rows)} times its tolerance")
        ctl = {}
        for delta in (-1, 1):
            shifted = lens + delta
            control = k3.flash_attention_plain(q, ks[0], vs[0], shifted, scale)
            ctl[f"lens {delta:+d}"] = _state_control(f"{what} lens {delta:+d}", (got,), tol,
                                                      (control,), [True] * B)
        k3_errs.append(err)
        kern = graph_ms(lambda: [k3.flash_attention_cuda(q, ks[i], vs[i], lens, scale)
                                 for i in range(Ly)]) / Ly
        plain = event_ms(lambda: k3.flash_attention_plain(q, ks[0], vs[0], lens, scale))
        # Library yardstick: SDPA over the keys below max(lens), query i of
        # row b attending to keys j <= lens[b] - L + i: plain causal where
        # every lens is L, else a boolean mask built outside the timing. It
        # computes K3's function.
        n_keys = max(lens_l)
        mask = None
        if any(n != L for n in lens_l):
            pos = lens[:, None].long() - L + torch.arange(L, device=dev)[None, :]
            mask = (torch.arange(n_keys, device=dev)[None, None, :] <= pos[:, :, None])[:, None]

        def lib_call(i):
            return sdpa(q, ks[i][:, :, :n_keys], vs[i][:, :, :n_keys], attn_mask=mask,
                        is_causal=mask is None, scale=scale, enable_gqa=True)

        check(max_err(lib_call(0), want) <= 2e-2, f"SDPA yardstick {what} differs")
        lib = graph_ms(lambda: [lib_call(i) for i in range(Ly)]) / Ly
        pairs = sum(max(0, min(n - L + i + 1, n)) for n in lens_l for i in range(L))
        bms, by = bound(2 * B * Hq * L * D_h * 2 + 2 * Hkv * sum(lens_l) * D_h * 2,
                        4 * Hq * pairs * D_h)
        kps = k3.flash_split(B, Hkv, L, n_rep, S, sms)
        route = K3_WALK if L <= k3.DECODE_MAX_L else K3_TILE if kps >= S else K3_SPLIT
        check(route == want_route, f"{what}: flash_split chose the {route}, not the {want_route}")
        case = {"kernel": name,
                "tpu_kernel": k3.TPU_KERNEL if L > k3.DECODE_MAX_L else k3.TPU_KERNEL_SHORT,
                "shape": f"B={B} L={L} lens={list(lens_l)} S={S} Hq={Hq} Hkv={Hkv} D={D_h}, "
                         f"{route}, {-(-S // kps)} splits of {kps} keys",
                "launches_per_call": counts[name], "max_err": err,
                "err_over_tol_per_batch_row": rows, "tol": TOL_ATTENTION,
                "control_err_over_tol_per_batch_row": ctl, "kernel_ms": kern,
                "plain_ms": plain, "library_ms": lib, "bound_ms": bms, "bound_by": by}
        if L * n_keys >= 1024 * 128:
            case["tflops"] = 4 * Hq * pairs * D_h / kern / 1e9
        cases.append(case)
        if (B, L, lens_l, S) == (1, 128, (128,), MAX_SEQ) and contract is not None:
            contract[name] = {
                "name": name, "route": "cuda", "source": k3.SOURCE,
                "replaces": "tiny_llm_tpu/kernels/flash_attention_pallas.py:450",
                "case": case["shape"], "max_abs_err": None, "ms": kern, "plain_ms": plain,
                "bound_ms": bms, "bound_by": by, "library_ms": lib,
            }
        del ks, vs
    if contract is not None:
        contract[name]["max_abs_err"] = max(k3_errs)
    torch.cuda.empty_cache()
    return _annotate_launches(cases, cfg)


def _routing(rng, tokens: int, E: int, k: int) -> np.ndarray:
    """Group sizes [E] of `tokens` tokens routed to their top-k experts
    under seeded random router logits."""
    ids = np.argsort(-rng.standard_normal((tokens, E)), axis=1, kind="stable")[:, :k]
    return np.bincount(ids.reshape(-1), minlength=E)


def _active(qt, sizes: np.ndarray):
    """The stacked weight cut to the experts that have rows."""
    idx = torch.as_tensor(np.nonzero(sizes)[0], device=qt.packed.device)
    return dataclasses.replace(qt, packed=qt.packed[idx], scales=qt.scales[idx],
                               biases=qt.biases[idx])


def _grouped_library(x, qts, sizes):
    """torch._grouped_mm on the active experts' bf16-dequantized weights:
    (fn(i) computing x's grouped product with weight i, its output for
    weight 0, a label). The yardstick only; the port never calls it."""
    from tiny_llm_tpu_torch.ops.quantize import dequantize

    dense = [dequantize(_active(q, sizes)) for q in qts]  # [A, N, K] bf16
    offs = torch.as_tensor(np.cumsum(sizes[sizes > 0]), dtype=torch.int32, device=x.device)

    def fn(i):
        return torch._grouped_mm(x, dense[i].transpose(-2, -1), offs=offs)

    return fn, fn(0), "torch._grouped_mm, active experts' bf16-dequantized weights"


def _grouped_bytes(qt, sizes, T):
    """Active experts' packed codes, scales and biases, plus x and out."""
    N, Kp = qt.out_features, qt.k_padded
    return int((sizes > 0).sum()) * (N * Kp * qt.bits // 8 + 2 * N * (Kp // qt.group_size) * 2) \
        + T * Kp * 2 + T * N * 2


def _grouped_cases(model, cfg, gen, contract):
    """The grouped expert matmul against its plain version at Qwen3-30B-A3B's
    expert shapes, timed over the MOE_LAYERS layers' weights, and one decode
    step's 3 x MOE_LAYERS calls (each layer its own routing) for the kernel
    line."""
    from tiny_llm_tpu_torch.kernels import moe_matmul as km

    E, k = cfg.num_experts, cfg.num_experts_per_tok
    mlps = [layer.mlp for layer in model.params.layers]
    rng = np.random.default_rng(3)
    one = lambda T: np.bincount([17] * T, minlength=E)  # noqa: E731
    ends = lambda T: np.concatenate([np.zeros(5, int), rng.multinomial(  # noqa: E731
        T, np.full(E - 12, 1 / (E - 12))), np.zeros(7, int)])
    specs = [("T=8: one token's top-8", _routing(rng, 1, E, k)),
             ("T=32: four tokens' top-8", _routing(rng, 4, E, k)),
             ("T=1024: 128 tokens' top-8", _routing(rng, 128, E, k)),
             ("T=32, one expert holds every row", one(32)),
             ("T=128, one expert holds every row", one(128)),
             ("T=24, experts 0-4 and 121-127 empty", ends(24)),
             ("T=200, experts 0-4 and 121-127 empty", ends(200))]
    # The bf16 tile walk's edges (16-row tiles of one expert) and the first
    # rows above its gate (B16_MIN_T = 9: T = 8 takes the GEMV walk).
    nine = _routing(rng, 1, E, k)
    nine[int(np.flatnonzero(nine == 0)[0])] += 1
    specs += [(f"T={T}, one expert holds every row", one(T)) for T in (15, 16, 17, 33)]
    specs += [("T=9: one token's top-8 and a row of a ninth expert", nine),
              ("T=16: two tokens' top-8", _routing(rng, 2, E, k))]
    cases = _grouped_kernel_cases(mlps, cfg, gen, specs, "grouped_quant_matmul",
                                  km.grouped_quant_matmul_cuda, km.grouped_quant_matmul_plain,
                                  km.TPU_KERNEL)
    contract["grouped_quant_matmul"] = _grouped_step(
        mlps, cfg, gen, rng, km.grouped_quant_matmul_cuda,
        km.grouped_quant_matmul_plain, "grouped_quant_matmul", km.SOURCE,
        "tiny_llm_tpu/kernels/moe_matmul.py:120", "30B-A3B")
    # Row 21, the JAX package's expert-gather schedule (TLT_MOE_DECODE=gather,
    # T <= 256), computes this kernel's function: the kernel at its decode
    # regime, 8, 16 and 32 tokens' random top-8 (own generators, so the
    # cases above draw what they drew before).
    rng21, gen21 = np.random.default_rng(21), torch.Generator(device=gen.device).manual_seed(21)
    specs = [(f"T={8 * n}: {n} tokens' top-{k} (the gather schedule's regime)",
              _routing(rng21, n, E, k)) for n in (8, 16, 32)]
    cases += _grouped_kernel_cases(mlps, cfg, gen21, specs, "grouped_quant_matmul",
                                   km.grouped_quant_matmul_cuda, km.grouped_quant_matmul_plain,
                                   f"{km.TPU_KERNEL_GATHER}, {km.COVERED_GATHER}")
    torch.cuda.empty_cache()
    return _annotate_launches(cases, cfg)


def _grouped_kernel_cases(mlps, cfg, gen, specs, kernel, cuda_fn, plain_fn, tpu_kernel,
                          peak=BF16_FLOPS, control=None, per_element=False):
    """A grouped kernel against its plain version at the gate and down
    projections of `mlps` for each (label, group sizes[, route]) of
    `specs`, timed over every layer's weights (`control`: as in
    `_dense_cases`; `per_element`: held to 2 bf16 ulps + 1e-3 of max per
    element, `_close` with codes, without a control); where a spec names
    the route the kernel's entry must take, asserted; the library yardstick
    (torch._grouped_mm on up to 8 layers' bf16-dequantized weights) is checked
    against the W4A16-exact plain version."""
    from tiny_llm_tpu_torch.kernels import moe_matmul as km

    dev = torch.device("cuda")
    E = cfg.num_experts
    codes = control is not None or per_element
    route_of = {"grouped_quant_matmul": km.w4a16_route, "grouped_quant_matmul_sg": km.sg_route}
    cases = []
    for what, sizes, *route in specs:
        T = int(sizes.sum())
        sizes_t = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
        for proj in ("w_gate", "w_down"):
            ws = [getattr(m, proj) for m in mlps]
            N, K = ws[0].out_features, ws[0].in_features
            x = torch.randn((T, K), generator=gen, device=dev).to(torch.bfloat16)
            got = cuda_fn(x, ws[0], sizes_t)
            want = plain_fn(x, ws[0], sizes_t)
            torch.cuda.synchronize()
            err, ratio = _close(got, want, codes)
            check(ratio <= 1, f"{kernel} {proj} {what}: {err} is {ratio} x {_tol_rule(codes)}")
            extra = {}
            if control is not None:
                extra["w4a16_err_over_tol"] = _close(control(x, ws[0], sizes_t), want, codes)[1]
                check(extra["w4a16_err_over_tol"] > 1,
                      f"{kernel} {proj} {what}: W4A16 passes the W4A8 check")
            if control is not None and "one expert" in what and T == 128:  # the worst case
                extra["device_ms_by_kernel"] = _device_profile(
                    lambda: cuda_fn(x, ws[0], sizes_t), 1)["top_kernels_ms_per_step"]
            kern = graph_ms(lambda: [cuda_fn(x, w, sizes_t) for w in ws]) / len(ws)
            plain = event_ms(lambda: plain_fn(x, ws[0], sizes_t), reps=1)
            lib_fn, lib_out, lib_name = _grouped_library(x, ws[:8], sizes)
            exact = want if plain_fn is km.grouped_quant_matmul_plain \
                else km.grouped_quant_matmul_plain(x, ws[0], sizes_t)
            check(max_err(lib_out, exact) <= 1e-2 * float(exact.float().abs().max()),
                  f"library yardstick {proj} {what} differs")
            n_lib = min(8, len(ws))
            lib = graph_ms(lambda: [lib_fn(i) for i in range(n_lib)]) / n_lib
            del lib_fn, lib_out, exact
            bms, by = bound(_grouped_bytes(ws[0], sizes, T), 2 * T * N * K, peak)
            if kernel in route_of:
                extra["route"] = route_of[kernel](T)
                check(not route or extra["route"] == route[0],
                      f"{kernel} {what}: the {extra['route']} route, not {route}")
            cases.append({"kernel": kernel, "tpu_kernel": tpu_kernel, "proj": proj[2:],
                          "spec": what,
                          "shape": f"{proj[2:]} N={N} K={K} E={E} W{ws[0].bits} "
                                   f"g{ws[0].group_size} {what}, "
                                   f"{int((sizes > 0).sum())} experts active",
                          "max_err": err, "err_over_tol": ratio, "tol": _tol_rule(codes),
                          **extra, "kernel_ms": kern, "plain_ms": plain, "library_ms": lib,
                          "library": lib_name, "bound_ms": bms, "bound_by": by})
            torch.cuda.empty_cache()
    return cases


def _grouped_step(mlps, cfg, gen, rng, cuda_fn, plain_fn, name, source, replaces, label,
                  peak=BF16_FLOPS, control=None):
    """One decode step of a grouped kernel: the layers' (gate, up, down) at
    T = 8 in model order, each layer its own top-8 routing: each output
    against the plain version's (`_close`; with `control`, as in
    `_dense_cases`), the step's kernel, plain and library
    (torch._grouped_mm) times and its bound. Returns the kernel line's
    entry."""
    dev = torch.device("cuda")
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    step_sizes = [_routing(rng, 1, E, k) for _ in mlps]
    sizes_t = [torch.as_tensor(sz, dtype=torch.int32, device=dev) for sz in step_sizes]
    xs = {K: torch.randn((8, K), generator=gen, device=dev).to(torch.bfloat16)
          for K in (cfg.hidden_size, cfg.moe_intermediate_size)}
    order = [(i, proj) for i in range(len(mlps)) for proj in ("w_gate", "w_up", "w_down")]

    def step(fn):
        return lambda: [fn(xs[getattr(mlps[i], p).in_features], getattr(mlps[i], p),
                           sizes_t[i]) for i, p in order]

    step_got, step_want = step(cuda_fn)(), step(plain_fn)()
    step_ctl = step(control)() if control is not None else [None] * len(order)
    torch.cuda.synchronize()
    step_err, ctl_min, codes = 0.0, float("inf"), control is not None
    for (i, p), got, want, ctl in zip(order, step_got, step_want, step_ctl):
        err, ratio = _close(got, want, codes)
        check(ratio <= 1, f"{name} decode step {p}[{i}]: {err} is {ratio} x {_tol_rule(codes)}")
        step_err = max(step_err, err)
        if codes:
            ctl_min = min(ctl_min, _close(ctl, want, codes)[1])
    check(not codes or ctl_min > 1, f"{name} decode step: W4A16 passes the W4A8 check")
    del step_got, step_want, step_ctl
    step_kern = graph_ms(step(cuda_fn), replays=3)
    step_plain = event_ms(step(plain_fn), reps=1)
    libs = [_grouped_library(xs[getattr(mlps[i], p).in_features], [getattr(mlps[i], p)],
                             step_sizes[i]) for i, p in order]
    step_lib = graph_ms(lambda: [fn(0) for fn, _, _ in libs], replays=3)
    lib_name = libs[0][2]
    del libs
    bms, by = bound(sum(_grouped_bytes(getattr(mlps[i], p), step_sizes[i], 8) for i, p in order),
                    sum(2 * 8 * getattr(mlps[i], p).out_features
                        * getattr(mlps[i], p).in_features for i, p in order), peak)
    torch.cuda.empty_cache()
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "case": f"one {label} decode step: {len(order)} launches at T=8 ({len(mlps)} x gate, "
                f"up, down), each layer its own top-{k} of {E} experts",
        "max_abs_err": step_err, "tol": _tol_rule(codes),
        **({"w4a16_min_err_over_tol": ctl_min} if codes else {}),
        "ms": step_kern, "plain_ms": step_plain, "bound_ms": bms, "bound_by": by,
        "library_ms": step_lib, "library": lib_name,
    }


def _tables(perm, ctxs, width):
    """Block tables [B, width] (-1 padded) taking each row's pages in turn
    from the shuffled page ids `perm`; a row of context 0 is idle (all -1)."""
    bt = np.full((len(ctxs), width), -1, np.int32)
    k = 0
    for b, n in enumerate(ctxs):
        m = -(-n // PAGE_SIZE)
        bt[b, :m] = perm[k : k + m]
        k += m
    return torch.from_numpy(bt).cuda()


# The paged decode's and prefill's cases: (label, B, L, contexts, D, the
# Pallas kernel where it is not the entry's own), each row's queries the
# last L positions of its context, a context of 0 an idle row (table all
# -1). Rows 12 and 13 at B = 1 (a later prompt chunk, its K/V already in
# the pages; row 13's few q tiles split the keys), both sides of the gate
# (L = 16 / 17), the mixed burst's sub-chunk late in a prompt, row 11's
# whole pages (which the TPU runs inside its decode bursts), a serving
# burst's idle slot, row 13 at B = 4, whose q tiles fill the SMs (the
# unsplit tile), and row 10's head dim (D = 64).
PAGED_CASES = (
    ("L=8 ctx=508", 1, 8, (508,), 128, None), ("L=2 ctx=131", 1, 2, (131,), 128, None),
    ("L=128 ctx=512", 1, 128, (512,), 128, None), ("L=128 ctx=1024", 1, 128, (1024,), 128, None),
    ("L=16 ctx=700", 1, 16, (700,), 128, None), ("L=17 ctx=700", 1, 17, (700,), 128, None),
    (f"L={MIXED_CHUNK} ctx=1000", 1, MIXED_CHUNK, (1000,), 128, None),
    ("whole pages", 4, 1, (256, 512, 768, 1024), 128,
     "tiny_llm_tpu/kernels/paged_attention_pallas.py:154 _paged_decode_page_kernel (whole pages)"),
    ("row 1 idle", 4, 1, (300, 0, 650, 900), 128, None),
    ("B=4 L=128 unsplit", 4, 128, (128, 600, 1000, 333), 128, None),
    ("D=64", 2, 8, (508, 131), 64,
     "tiny_llm_tpu/kernels/paged_attention_pallas.py:52 _paged_decode_kernel (D % 128 != 0)"),
)


def paged_times(fn, q, kps, vps, bt, lens, n, sc):
    """A paged case's device ms a layer, by CUDA-graph replay over the
    layers' page buffers `kps` / `vps`: the kernel `fn`'s, and SDPA's over
    the same keys gathered contiguous (the first `n`) under the
    offset-causal boolean mask (attention part only); and SDPA's output on
    layer 3 (NaN on an idle row, which sees no key)."""
    from tiny_llm_tpu_torch.kernels import paged_attention as pa

    Ly, L = kps.shape[0], q.shape[2]
    kern = graph_ms(lambda: [fn(q, kps[i], vps[i], bt, lens, sc) for i in range(Ly)]) / Ly
    gathered = []
    for i in range(Ly):
        k_i, v_i = pa.gather_pages_dense(kps[i], vps[i], bt)
        gathered.append((k_i[:, :, :n].contiguous(), v_i[:, :, :n].contiguous()))
    qpos = lens[:, None] - L + torch.arange(L, device=q.device)[None, :]  # [B, L]
    mask = (torch.arange(n, device=q.device)[None, None, :] <= qpos[:, :, None])[:, None]
    sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, attn_mask=mask,
                             scale=sc, enable_gqa=True)
    lib = graph_ms(lambda: [sdpa(q, k, v) for k, v in gathered]) / Ly
    return kern, lib, sdpa(q, *gathered[3])


def _paged_check(what, fn, q, kp, vp, bt, lens, sc):
    """A paged decode or prefill kernel against paged_attention_plain on the
    card: every value finite, an idle row (lens 0) exactly 0, o per element
    within _state_tol; the control, the plain version at lens - 1 (decode)
    or with each query one position later, lens + 1 (prefill), must miss
    that tolerance in every batch row whose visible keys it changes.
    Returns the case's fields and the plain output."""
    from tiny_llm_tpu_torch.kernels import flash_attention as ka
    from tiny_llm_tpu_torch.kernels import paged_attention as pa

    got = fn(q, kp, vp, bt, lens, sc)
    want = pa.paged_attention_plain(q, kp, vp, bt, lens, sc)
    torch.cuda.synchronize()
    k, v = pa.gather_pages_dense(kp, vp, bt)
    L, S = q.shape[2], k.shape[2]
    ok = ka._causal_mask(lens, L, S, q.device)
    tol = _state_tol(q, k, v, ok, sc, want)
    del k, v
    check(bool(torch.isfinite(got).all()), f"{what}: not finite")
    check(not bool(got[lens == 0].any()), f"{what}: an idle row is not 0")
    rows = _over_tol(got, want, tol)
    check(max(rows) <= 1, f"{what}: {max_err(got, want)}, {max(rows)} times its tolerance")
    decode = L <= pa.DECODE_MAX_L
    shifted = ((lens - 1) if decode else (lens + 1)) * (lens > 0)
    changed = (ok != ka._causal_mask(shifted, L, S, q.device)).flatten(1).any(1).tolist()
    ctl = _state_control(what, (got,), tol,
                         (pa.paged_attention_plain(q, kp, vp, bt, shifted, sc),), changed)
    return {"max_err": max_err(got, want), "err_over_tol_per_batch_row": rows,
            "tol": TOL_ATTENTION, "control": "lens - 1" if decode else "lens + 1 (q one "
            "position later)", "control_err_over_tol_per_batch_row": ctl}, want


# Row 9's cases: (label, offsets, the idle row or None). Each row's table
# holds its offset + 1 positions (the current token's slot too), an idle
# row none (all -1, offset 0: its output is discarded and not compared). At
# the pool's width (8 pages of 128) decode_split gives splits of 128 keys,
# so 127 / 128 / 129 and 255 / 256 / 257 sit on a split's and a page's
# boundary; 1023 fills the table; an offset of 0 gives the v row exactly.
FUSED_PAGED_CASES = (
    ("B=4 offsets 130/400/777/1000", (130, 400, 777, 1000), None),
    ("row 1 idle", (300, 0, 650, 900), 1),
    ("B=1 offset 508", (508,), None),
    ("B=1 offset 0: the v row", (0,), None),
    ("split and page edges 127/128/129/1023", (127, 128, 129, 1023), None),
    ("offsets 1/255/256/257", (1, 255, 256, 257), None),
)


def _fused_tol(qkv, kp, vp, bt, off, cr, sr, qw, kw, scale, eps, want):
    """_step_tol for row 9, over the pages gathered contiguous."""
    from tiny_llm_tpu_torch.kernels import paged_attention as pa

    k, v = pa.gather_pages_dense(kp, vp, bt)
    return _step_tol(qkv, k, v, off, cr, sr, qw, kw, scale, eps, want)


def _fused_paged_cases(cfg, rope, gen, qw, kw, kp, vp, perm, errs, contract):
    """Row 9, the fused paged decode step, against its plain version at
    FUSED_PAGED_CASES over the layers' pools `kp` / `vp` [Ly, P, Hkv, ps, D]:
    exactly one launch a call; out per element within _state_tol on every
    live row, with the plain version at offsets - 1 and + 1 as controls
    that must miss it in every row they change; a row at offset 0 exactly
    its v row; k_row within 2^-7 of max, v_row bit-equal. Timed by CUDA-graph
    replay over the layers beside SDPA and the bound. `contract` (None: not
    recorded) takes the first case."""
    from tiny_llm_tpu_torch.kernels import fused_decode_attention as kf
    from tiny_llm_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    Hkv, D_h = cfg.num_key_value_heads, cfg.head_dim
    n_rep = cfg.num_attention_heads // Hkv
    Hq, Ly = Hkv * n_rep, kp.shape[0]
    eps, scale = cfg.rms_norm_eps, D_h**-0.5
    cos_t, sin_t = rope
    width = MAX_SEQ // PAGE_SIZE  # the model's block-table width at max_seq 1024
    sdpa = torch.nn.functional.scaled_dot_product_attention
    name = "fused_paged_decode_attention"
    cases = []
    for what, offs, idle in FUSED_PAGED_CASES:
        B = len(offs)
        live = [b for b in range(B) if b != idle]
        bt = _tables(perm, [0 if b == idle else o + 1 for b, o in enumerate(offs)], width)
        qkv = torch.randn((B, Hkv, n_rep + 2, D_h), generator=gen, device=dev).to(torch.bfloat16)
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        cr, sr = cos_t[off.long()], sin_t[off.long()]

        def args(i, o=off):
            return (qkv, kp[i], vp[i], bt, o, cr, sr, qw, kw)

        got = []
        counts = _kernel_path(
            lambda: got.append(kf.fused_paged_decode_attention_cuda(*args(3), scale=scale,
                                                                    eps=eps)), name)
        check(counts[name] == 1, f"{name} {what}: {counts[name]} launches for one call")
        got = got[0]
        want = kf.fused_paged_decode_attention_plain(*args(3), scale=scale, eps=eps)
        torch.cuda.synchronize()
        tol = _fused_tol(qkv, kp[3], vp[3], bt, off, cr, sr, qw, kw, scale, eps, want[0])
        check(bool(torch.isfinite(got[0]).all()), f"{name} {what}: not finite")
        err = max_err(got[0][live], want[0][live])
        rows = _over_tol(got[0][live], want[0][live], tol[live])
        check(max(rows) <= 1, f"{name} {what}: {err}, {max(rows)} times its tolerance")
        ctl = {}
        for delta in (-1, 1):
            shifted = (off + delta).clamp(min=0)
            changed = [bool(shifted[b] != off[b]) for b in live]
            control = kf.fused_paged_decode_attention_plain(*args(3, shifted), scale=scale,
                                                            eps=eps)
            ctl[f"offsets {delta:+d}"] = _state_control(
                f"{name} {what} offsets {delta:+d}", (got[0][live],), tol[live],
                (control[0][live],), changed) if any(changed) else []
        v_rows = qkv[:, :, n_rep + 1 :].expand(B, Hkv, n_rep, D_h)
        for b in range(B):
            if offs[b] == 0:
                check(torch.equal(got[0][b], v_rows[b]), f"{name} {what}: row {b} is not its v row")
        kerr = max_err(got[1][live], want[1][live])
        check(kerr <= 2**-7 * float(want[1].float().abs().max()), f"paged k_row {kerr}")
        check(torch.equal(got[2][live], want[2][live]), "paged v_row not bit-equal")
        errs[name].append(err)
        kern = graph_ms(lambda: [kf.fused_paged_decode_attention_cuda(
            *args(i), scale=scale, eps=eps) for i in range(Ly)]) / Ly
        plain = event_ms(lambda: kf.fused_paged_decode_attention_plain(
            *args(3), scale=scale, eps=eps))
        q = torch.randn((B, Hq, 1, D_h), generator=gen, device=dev).to(torch.bfloat16)
        gathered = [pa.gather_pages_dense(kp[i], vp[i], bt) for i in range(Ly)]
        mask = (torch.arange(width * PAGE_SIZE, device=dev)[None, :] <= off[:, None])[:, None, None]
        lib = graph_ms(lambda: [sdpa(q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)
                                for k, v in gathered]) / Ly
        del gathered
        ctx = [o for b, o in enumerate(offs) if b != idle]
        bms, by = bound(sum(2 * Hkv * o * D_h * 2 for o in ctx)
                        + len(ctx) * Hkv * (n_rep + 2) * D_h * 2 * 2,
                        sum(4 * Hq * (o + 1) * D_h for o in ctx))
        kps = pa.decode_split(B, Hkv, width, PAGE_SIZE, _sms())
        case = {"kernel": name, "tpu_kernel": kf.TPU_KERNEL_PAGED,
                "shape": f"{what}: B={B} offsets={list(offs)}"
                + (f" row {idle} idle" if idle is not None else "")
                + f" pool={kp.shape[1]}x{PAGE_SIZE} width={width} Hkv={Hkv} n_rep={n_rep} "
                  f"D={D_h}, {-(-width * PAGE_SIZE // kps)} splits of {kps} keys",
                "launches_per_call": counts[name], "max_err": err,
                "err_over_tol_per_batch_row": rows, "tol": TOL_ATTENTION,
                "control_err_over_tol_per_batch_row": ctl, "kernel_ms": kern,
                "plain_ms": plain, "library_ms": lib,
                "library": "SDPA over the same keys gathered contiguous, offset-causal boolean "
                           "mask (attention part only)", "bound_ms": bms, "bound_by": by}
        cases.append(case)
        if what == FUSED_PAGED_CASES[0][0] and contract is not None:
            contract[name] = {
                "name": name, "route": "cuda", "source": kf.SOURCE,
                "replaces": "tiny_llm_tpu/kernels/fused_decode_attention.py:275",
                "case": case["shape"], "ms": kern, "plain_ms": plain, "bound_ms": bms,
                "bound_by": by, "library_ms": lib,
            }
    return cases


def phase_paged_kernels(model, cfg, gen, qw, kw, contract):
    """The three paged kernels against their plain versions over a pool of
    POOL_PAGES pages per layer with shuffled page ids, timed by CUDA-graph
    replay over the model's layers' page buffers. `contract` (None: not
    recorded) takes the main cases' numbers."""
    from tiny_llm_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    Hkv, D_h = cfg.num_key_value_heads, cfg.head_dim
    Hq, Ly = cfg.num_attention_heads, cfg.num_hidden_layers
    width = MAX_SEQ // PAGE_SIZE  # the model's block-table width at max_seq 1024
    shape = (Ly, POOL_PAGES, Hkv, PAGE_SIZE, D_h)
    kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    perm = (torch.randperm(POOL_PAGES - 1, generator=torch.Generator().manual_seed(2)) + 1).numpy()
    errs = {name: [] for name in PAGED}
    lib_label = "SDPA over the same keys gathered contiguous, offset-causal boolean mask " \
                "(attention part only)"
    cases = _fused_paged_cases(cfg, model._rope_tables, gen, qw, kw, kp, vp, perm, errs, contract)

    pools = {D_h: (kp, vp)}
    del kp, vp
    for what, B, L, ctxs, d, tpu_kernel in PAGED_CASES:
        name = "paged_decode" if L <= pa.DECODE_MAX_L else "paged_prefill"
        fn = pa.paged_decode_cuda if name == "paged_decode" else pa.paged_prefill_cuda
        tpu_kernel = tpu_kernel or (pa.TPU_KERNEL_DECODE if name == "paged_decode"
                                    else pa.TPU_KERNEL_PREFILL)
        if d not in pools:  # one pool at a time: D_h's, then D = 64's (the last cases)
            pools = {d: tuple(torch.randn((Ly, POOL_PAGES, Hkv, PAGE_SIZE, d), generator=gen,
                                          device=dev).to(torch.bfloat16) for _ in range(2))}
        kps, vps = pools[d]
        q = torch.randn((B, Hq, L, d), generator=gen, device=dev).to(torch.bfloat16)
        sc = d**-0.5
        bt = _tables(perm, ctxs, width)
        lens = torch.tensor(ctxs, dtype=torch.int32, device=dev)
        fields, want = _paged_check(f"{name} {what}", fn, q, kps[3], vps[3], bt, lens, sc)
        errs[name].append(fields["max_err"])
        kern, lib, lib_out = paged_times(fn, q, kps, vps, bt, lens, max(ctxs), sc)
        plain = event_ms(lambda: pa.paged_attention_plain(q, kps[3], vps[3], bt, lens, sc))
        # SDPA gives NaN on an idle row (no key visible): its live rows only.
        live = [b for b, c in enumerate(ctxs) if c > 0]
        check(max_err(lib_out[live], want[live]) <= 2e-2, f"SDPA yardstick {name} {what} differs")
        pairs = sum(c - L + i + 1 for c in ctxs if c for i in range(L))
        bms, by = bound(sum(2 * Hkv * c * d * 2 for c in ctxs) + 2 * B * Hq * L * d * 2,
                        4 * Hq * pairs * d)
        case = {"kernel": name, "tpu_kernel": tpu_kernel,
                "shape": f"B={B} L={L} ctx={list(ctxs)} pool={POOL_PAGES}x{PAGE_SIZE} "
                         f"width={width} Hq={Hq} Hkv={Hkv} D={d}", **fields,
                "kernel_ms": kern, "plain_ms": plain, "library_ms": lib, "library": lib_label,
                "bound_ms": bms, "bound_by": by}
        cases.append(case)
        if what in ("L=8 ctx=508", "L=128 ctx=512") and contract is not None:
            contract[name] = {
                "name": name, "route": "cuda", "source": pa.SOURCE,
                "replaces": "tiny_llm_tpu/kernels/paged_attention_pallas.py:"
                + ("297" if name == "paged_decode" else "475"),
                "case": case["shape"], "ms": kern, "plain_ms": plain, "bound_ms": bms,
                "bound_by": by, "library_ms": lib,
            }
    del pools
    if contract is not None:
        for name in PAGED:
            contract[name]["max_abs_err"] = max(errs[name])
    torch.cuda.empty_cache()
    return cases


def _decode_run(model, prompt, steps=DECODE_STEPS):
    """Prefill + `steps` greedy steps in BURST-step bursts."""
    cache = model.create_kv_cache(batch_size=prompt.shape[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = model(prompt, 0, cache, logits_to_keep=1)
    tok = logits[:, -1].float().argmax(-1).cpu().numpy()
    prefill_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits.float()).all()), "non-finite prefill logits")
    check(tuple(logits.shape) == (prompt.shape[0], 1, model.vocab_size), "logits shape")
    toks = [tok]
    t0 = time.perf_counter()
    done = 0
    while done < steps:
        out = model.decode_burst_dense(cache, tok, BURST)
        toks.extend(out)
        tok = out[-1]
        done += BURST
    decode_s = time.perf_counter() - t0
    cache.release()
    return prefill_s, decode_s, np.stack(toks)


def _alternating(models: dict, prompt, steps=DECODE_STEPS) -> dict:
    """Decode and prefill tok/s of the same B = 1 run on each model, taken
    in turns (A B B A), medians per model: a difference between models of
    one call that the host's drift over the call does not bias."""
    names = list(models)
    order = names + names[::-1]
    got = {n: [] for n in names}
    for n in order:
        pre_s, dec_s, _ = _decode_run(models[n], prompt, steps)
        got[n].append((PROMPT_LEN / pre_s, steps / dec_s))
    return {n: {"prefill_tok_s": float(np.median([p for p, _ in v])),
                "decode_tok_s": float(np.median([d for _, d in v])), "order": "ABBA"}
            for n, v in got.items()}


def _sync_free_burst(model, prompt) -> dict:
    """One BURST-step dense decode burst under sync-debug "error": any op
    in it that waits for the device raises. Only the copy of the emitted
    tokens to the host, after the burst, may sync."""
    from tiny_llm_tpu_torch.models.qwen3 import forward_decode_burst_dense

    cache = model.create_kv_cache()
    tok = model(prompt, 0, cache, logits_to_keep=1)[:, -1].float().argmax(-1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = forward_decode_burst_dense(model.params, model.cfg, model._rope_tables, tok,
                                          cache.offset, cache.keys, cache.values, steps=BURST,
                                          attn_impl=model.attn_impl)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out = toks.cpu()
    cache.release()
    check(tuple(out.shape) == (BURST, 1), "sync-free burst shape")
    return {"steps": BURST, "mode": "error", "host_syncs_in_burst": 0}


def phase_model(model, cfg, phase, name, runs=3, beside=None):
    """B = 1 dense decode at full width and depth: a PROMPT_LEN-token
    prefill and DECODE_STEPS greedy steps in BURST-step bursts, `runs`
    times after a warm-up, with exact launch counts (the model's act_quant
    and its weights' width set which kernels), a device profile of one
    burst and one sync-free burst.
    `beside`: another phase's numbers to print beside these."""
    from tiny_llm_tpu_torch import kernels

    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, PROMPT_LEN))
    torch.cuda.reset_peak_memory_stats()
    _decode_run(model, prompt)  # warm-up (allocator, kernel first calls)
    kernels.reset_launches()
    samples = [_decode_run(model, prompt) for _ in range(runs)]
    counts = kernels.launches()
    L = cfg.num_hidden_layers
    sg = not model.params.layers[0].attn.wqkv.is_w4g128
    per_step, per_prefill = _path_launches(cfg, model.act_quant, sg)
    expected = {k: runs * (per_prefill[k] + DECODE_STEPS * per_step[k]) for k in counts}
    check(counts == expected, f"launch counts {counts} != expected {expected}")
    check(all(counts[k] > 0 for k, v in per_step.items() if v > 0),
          "a kernel of the path never launched")
    toks = [s[2] for s in samples]
    check(all(np.array_equal(t, toks[0]) for t in toks), "greedy runs disagree")
    check(bool(((toks[0] >= 0) & (toks[0] < cfg.vocab_size)).all()), "token out of range")
    dec = sorted(DECODE_STEPS / s[1] for s in samples)
    pre = sorted(PROMPT_LEN / s[0] for s in samples)
    busy = _profile_burst(model, prompt)
    dev_ms = busy["device_ms_per_step"]  # None when the profiler saw no device time
    busy["busy_share_unprofiled"] = None if dev_ms is None else dev_ms * dec[len(dec) // 2] / 1e3
    prefill_prof = _profile_prefill(model, prompt)
    sync_free = _sync_free_burst(model, prompt)
    emit({"phase": phase, "model": name, "layers": L, "batch": 1, "act_quant": model.act_quant,
          "prompt_len": PROMPT_LEN, "decode_steps": DECODE_STEPS, "burst": BURST, "runs": runs,
          "max_seq": MAX_SEQ, "prefill_tok_s": pre[len(pre) // 2],
          "decode_tok_s": dec[len(dec) // 2], "decode_tok_s_all": dec,
          "launches": counts, "launches_per_decode_step": per_step,
          "launches_per_prefill": per_prefill,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "first_tokens": toks[0][:8, 0].tolist(), "decode_profile": busy,
          "prefill_profile": prefill_prof,
          "sync_free_burst": sync_free, **(beside or {})})
    return counts


def _device_profile(run, steps: int, top: int = 8):
    """Device time by kernel name over run() (torch.profiler), per step,
    outside the launch-counted runs: the total and the `top` kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name, host = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = (e.self_device_time_total / 1e3 / steps, e.count // steps)
        elif e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0:
            host[e.key] = (e.self_cpu_time_total / 1e3 / steps, e.count // steps)
    total = sum(ms for ms, _ in by_name.values())
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:8]
    # Host times are the profiler's own (it adds cost to every op it records).
    return {"device_ms_per_step": total or None,
            "device_ops_per_step": sum(n for _, n in by_name.values()),
            "top_kernels_ms_per_step": {k[:60]: [ms, n] for k, (ms, n) in kernels},
            "top_host_ops_ms_per_step_profiled": {k[:60]: [ms, n] for k, (ms, n) in top_host}}


def _profile_burst(model, prompt):
    """Device time of one BURST-step dense decode burst by kernel name."""
    cache = model.create_kv_cache()
    tok = model(prompt, 0, cache, logits_to_keep=1)[:, -1].float().argmax(-1).cpu().numpy()
    out = _device_profile(lambda: model.decode_burst_dense(cache, tok, BURST), BURST)
    cache.release()
    return out


def _profile_prefill(model, prompt):
    """Device time of one PROMPT_LEN-token dense prefill by kernel name."""
    cache = model.create_kv_cache()
    out = _device_profile(lambda: model(prompt, 0, cache, logits_to_keep=1), 1, top=10)
    cache.release()
    return out


class RouteForcer:
    """Inside `with`, the plain path (impl="torch") takes the kernel path's
    expert choice wherever the two pick different experts for a row, and
    records the plain router's k-th minus (k+1)-th probability there. The
    kernel path routes first: each of its route_topk calls queues its ids
    for the plain path's call of the same layer. `summary` fails unless
    every such row was a near-tie (margin < `margin`): a bf16 ulp of
    router logit that flips one expert is not a kernel fault, and a flip
    at a wide margin would be."""

    def __init__(self, margin: float = TIE_MARGIN, lead=lambda impl: impl is None):
        self.margin = margin
        self.lead = lead  # lead(impl): whether a route_topk call leads (queues its ids)
        self.queue: collections.deque = collections.deque()
        self.forced: list[tuple[int, float]] = []  # (batch row, margin)

    def __enter__(self):
        import tiny_llm_tpu_torch.ops.moe as moe

        self._moe, self._orig = moe, moe.route_topk
        moe.route_topk = self.route
        return self

    def __exit__(self, *exc):
        self._moe.route_topk = self._orig

    def route(self, x, w_router, top_k, norm_topk_prob=False, impl=None):
        probs, ids, scores = self._orig(x, w_router, top_k, norm_topk_prob, impl=impl)
        if self.lead(impl):
            self.queue.append(ids)
            return probs, ids, scores
        fast = self.queue.popleft()
        differ = (ids.sort(-1).values != fast.sort(-1).values).any(-1)  # [B, L]
        if bool(differ.any()):
            top = probs.sort(-1, descending=True).values
            margin = (top[..., top_k - 1] - top[..., top_k])[differ]
            self.forced += list(zip(differ.nonzero()[:, 0].tolist(), margin.tolist()))
            ids = torch.where(differ[..., None], fast, ids)
            scores = probs.gather(-1, ids)
            if norm_topk_prob:
                scores = scores / scores.sum(dim=-1, keepdim=True)
        return probs, ids, scores

    def summary(self, live) -> dict:
        """Forced rows among the compared batch rows (live(b) true)."""
        check(not self.queue, "kernel and plain paths routed a different number of times")
        margins = [m for b, m in self.forced if live(b)]
        check(all(m < self.margin for m in margins),
              f"experts differ at a router margin >= {self.margin}: {max(margins, default=0)}")
        self.forced.clear()
        return {"routing_forced": len(margins), "max_forced_margin": max(margins, default=None)}


def phase_parity(cfg, phase="parity", forcer=None, act_quant=None, bits=4, group_size=128,
                 params=None):
    """4 layers at full width, teacher-forced (the plain path's tokens): a
    PROMPT_LEN-token prefill and 8 decode steps, the kernel path's logits
    against the plain path's. With act_quant "int8", also the W4A8 kernel
    path's drift from the W4A16 kernel path on the same inputs (dense
    models), and an A8_TAIL-token prompt tail after the steps (the W4A8
    kernels' int8 tile routes), held to the same tolerance. `params`: the
    first 4 layers of these (bits and group_size then None: dense weights),
    in place of synthetic ones at `bits` and `group_size`."""
    from tiny_llm_tpu_torch.models import Qwen3Model, synthetic_quantized_params

    cfg4 = dataclasses.replace(cfg, num_hidden_layers=4)
    if params is None:
        params = synthetic_quantized_params(cfg4, seed=1, group_size=group_size, bits=bits)
    else:
        params = dataclasses.replace(params, layers=params.layers[:4])
    fast = Qwen3Model(params, cfg4, max_seq_len=256, act_quant=act_quant)
    plain = Qwen3Model(params, cfg4, max_seq_len=256, impl="torch", act_quant=act_quant)
    # The W4A16 kernel path beside W4A8 (dense only: under a RouteForcer
    # its routing would join the kernel path's queue).
    a16 = Qwen3Model(params, cfg4, max_seq_len=256) if act_quant == "int8" and forcer is None \
        else None
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(1, PROMPT_LEN))
    cf, cp = fast.create_kv_cache(), plain.create_kv_cache()
    lf, lp = fast(prompt, 0, cf), plain(prompt, 0, cp)
    if a16 is not None:
        ca = a16.create_kv_cache()
        la = a16(prompt, 0, ca)
    worst, decided, agree = 0.0, 0, 0
    tol_share = A8_PARITY_TOL if act_quant == "int8" else 5e-2
    drift = []  # per decode step: max |W4A8 - W4A16| / max |W4A16|, and top-1 equal
    # Tolerance: 5 % of the largest plain logit. Kernel and plain version
    # sum in f32 in other orders and round each projection to bf16 (an ulp is
    # 0.4 %); four layers compound that.
    for step in range(9):
        a, b = lf[0].float(), lp[0].float()
        tol = tol_share * float(b.abs().max())
        err = float((a - b).abs().max())
        worst = max(worst, err / max(tol, 1e-30))
        check(bool(torch.isfinite(a).all()) and err <= tol, f"parity step {step}: {err} > {tol}")
        top2 = b.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol
        decided += int(sure.sum())
        agree += int((a.argmax(-1) == b.argmax(-1))[sure].sum())
        if a16 is not None and step > 0:
            ref = la[0, -1].float()
            drift.append((float((a[-1] - ref).abs().max() / ref.abs().max()),
                          bool(a[-1].argmax() == ref.argmax())))
        tok = [[int(b[-1].argmax())]]  # teacher-forced: the plain path's token
        if step < 8:
            lf, lp = fast(tok, PROMPT_LEN + step, cf), plain(tok, PROMPT_LEN + step, cp)
            if a16 is not None:
                la = a16(tok, PROMPT_LEN + step, ca)
    check(agree == decided, f"top-1 disagrees on {decided - agree} decided positions")
    tail = {}
    if act_quant == "int8":
        # A prompt tail of A8_TAIL tokens: the int8 tile's rows (the dense
        # matmul at M = A8_TAIL, the grouped at 8 x A8_TAIL), held as above.
        toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(1, A8_TAIL))
        a = fast(toks, PROMPT_LEN + 8, cf)[0].float()
        b = plain(toks, PROMPT_LEN + 8, cp)[0].float()
        tol = tol_share * float(b.abs().max())
        err = float((a - b).abs().max())
        check(bool(torch.isfinite(a).all()) and err <= tol, f"parity tail: {err} > {tol}")
        tail = {"tail_tokens": A8_TAIL, "tail_err_over_tol": err / tol}
    forced = forcer.summary(lambda b: True) if forcer is not None else {}
    line = {"phase": phase, "path": "dense", "layers": 4, "positions": PROMPT_LEN + 8,
            "act_quant": fast.act_quant, "bits": bits, "group_size": group_size,
            "worst_err_over_tol": worst, "tol": f"{tol_share:.0%} of max |plain logit|",
            "top1_decided": decided, "top1_agree": agree, **tail, **forced}
    if drift:
        line["w4a8_vs_w4a16_decode_logits"] = {
            "max_rel_err": max(d for d, _ in drift), "mean_rel_err": sum(d for d, _ in drift)
            / len(drift), "top1_equal": sum(t for _, t in drift), "steps": len(drift)}
    emit(line)


def phase_generate(model):
    from tiny_llm_tpu_torch.generate import simple_generate_with_kv_cache
    from tiny_llm_tpu_torch.tokenizer import ByteTokenizer

    class Recording(ByteTokenizer):
        """Records the longest id list decoded: the full output."""

        def __init__(self):
            self.ids: list[int] = []

        def decode(self, ids):
            ids = list(ids)
            if len(ids) >= len(self.ids):
                self.ids = ids
            return super().decode(ids)

    from tiny_llm_tpu_torch import kernels

    out = []
    for prompt in ("hello", "The quick brown fox jumps over the lazy dog.",
                   "def fibonacci(n):\n    return n if n < 2 else"):
        tok = Recording()
        kernels.reset_launches()
        t0 = time.perf_counter()
        text = simple_generate_with_kv_cache(model, tok, prompt, max_tokens=16)
        secs = time.perf_counter() - t0
        # K3's launches: the prompt's prefill (L = its tokens; a prompt of
        # <= 16 tokens is the TPU's _decode_kernel case, row 4).
        out.append({"prompt": prompt, "prompt_tokens": len(tok.encode(prompt)),
                    "tokens": len(tok.ids), "text": text, "ids": tok.ids, "seconds": secs,
                    "k3_launches": kernels.launches()["flash_attention"]})
    # The per-step path and the burst path give the same greedy tokens.
    first = out[0]
    if len(first["ids"]) == 16:
        cache = model.create_kv_cache()
        logits = model([list(b"hello")], 0, cache, logits_to_keep=1)
        t0 = int(logits[0, -1].float().argmax())
        burst = model.decode_burst_dense(cache, [t0], 15)[:, 0].tolist()
        check([t0] + burst == first["ids"], "generate and burst paths disagree")
        cache.release()
    check(all(r["tokens"] > 0 for r in out), "a request produced no token")
    emit({"phase": "generate", "requests": out})


def _parity_check(fast, plain, what, tally):
    """Kernel-path logits against the plain path's: within 5 % of the
    largest plain logit (the sums run in other orders and every projection
    rounds to bf16, an ulp is 0.4 %; four layers compound that), top-1
    equal wherever the plain top-2 gap exceeds the tolerance."""
    a, b = fast.float(), plain.float()
    tol = 5e-2 * float(b.abs().max())
    err = float((a - b).abs().max())
    tally["worst"] = max(tally["worst"], err / max(tol, 1e-30))
    check(bool(torch.isfinite(a).all()) and err <= tol, f"{what}: {err} > {tol}")
    top2 = b.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tol
    tally["decided"] += int(sure.sum())
    tally["agree"] += int((a.argmax(-1) == b.argmax(-1))[sure].sum())


def phase_paged_parity(cfg, phase="paged_parity", forcer=None):
    """The paged path's kernels against its plain versions, teacher-forced:
    three requests prefilled round-robin (so their pages interleave in the
    pool) in chunks of 128 at offset 0 (K3 on the chunk), 128 at offset 128
    (paged prefill) and 8 at offset 256 (paged decode), then 8 decode steps
    of the three in a 4-slot batching cache beside an idle slot (fused paged
    decode); only installed rows are compared."""
    from tiny_llm_tpu_torch.models import Qwen3Model, synthetic_quantized_params

    cfg4 = dataclasses.replace(cfg, num_hidden_layers=4)
    params = synthetic_quantized_params(cfg4, seed=2)
    fast, plain = (Qwen3Model(params, cfg4, max_seq_len=MAX_SEQ, impl=impl)
                   .enable_paged_attention(num_pages=16, page_size=PAGE_SIZE)
                   for impl in (None, "torch"))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(3, 264))
    cf = [fast.create_kv_cache() for _ in range(3)]
    cp = [plain.create_kv_cache() for _ in range(3)]
    tally = {"worst": 0.0, "decided": 0, "agree": 0}
    off, last = 0, [None] * 3
    for L in (128, 128, 8):
        for r in range(3):
            chunk = prompts[r : r + 1, off : off + L]
            lf = fast(chunk, off, cf[r])
            lp = plain(chunk, off, cp[r])
            _parity_check(lf, lp, f"request {r} chunk L={L} at {off}", tally)
            last[r] = int(lp[0, -1].float().argmax())
        off += L
    check(cf[0].page_ids != list(range(1, len(cf[0].page_ids) + 1)), "pages did not interleave")
    bf, bp = fast.create_batching_kv_cache(4), plain.create_batching_kv_cache(4)
    for r in range(3):
        bf.add_request(cf[r], r)
        bp.add_request(cp[r], r)
    for step in range(8):
        toks = [[t] for t in last] + [[0]]  # slot 3 idle
        lf, lp = fast(toks, None, bf, logits_to_keep=1), plain(toks, None, bp, logits_to_keep=1)
        _parity_check(lf[:3], lp[:3], f"decode step {step}", tally)
        last = lp[:3, -1].float().argmax(-1).tolist()  # teacher-forced: the plain path's
    bf.release()
    bp.release()
    check(fast.page_pool.live_pages == 0 and plain.page_pool.live_pages == 0, "pages leaked")
    check(tally["agree"] == tally["decided"],
          f"top-1 disagrees on {tally['decided'] - tally['agree']} decided positions")
    forced = forcer.summary(lambda b: b < 3) if forcer is not None else {}
    emit({"phase": phase, "path": "paged", "layers": 4, "requests": 3, "chunks": [128, 128, 8],
          "decode_steps": 8, "worst_err_over_tol": tally["worst"],
          "tol": "5% of max |plain logit|", "top1_decided": tally["decided"],
          "top1_agree": tally["agree"], **forced})


def _recorder():
    """A ByteTokenizer with no EOS (synthetic weights) that records each
    finished request's ids, in the order batch_generate returns them."""
    from tiny_llm_tpu_torch.tokenizer import ByteTokenizer

    class Recorder(ByteTokenizer):
        eos_token_id = -1

        def __init__(self):
            self.decoded: list[list[int]] = []

        def decode(self, ids):
            self.decoded.append(list(ids))
            return super().decode(ids)

    return Recorder()


def _campaigns(model, cfg, lens, max_out, kw, warm, n_runs, turns=None):
    """A warm-up on the prompts `warm`, then n_runs campaigns of "x" * n
    prompts (one byte token per character, all arriving at t = 0) through
    batch_generate. Checks: every request returns, runs to the output cap
    or to max_seq, with tokens in range; the pool is full again after each
    campaign; the campaigns give identical tokens. Returns (each campaign's
    metrics, with its wall time, and the launches over the campaigns).
    `turns` (a list of {"model": m, "warm": prompts}): other models, each
    warmed up the same way, run a campaign each, in list order, before
    each of these (B C A B C A for two other models and two campaigns), so
    that each runs n_runs campaigns too, under the same checks (with turns
    n_runs must be at least 2: each model's campaigns' tokens are held to
    each other); each
    one's rows, the tokens of each campaign and its launches over its
    campaigns go back into its dict as "rows", "ids" and "launches", and
    this model's as "a_rows", "a_ids" and "a_launches"."""
    from tiny_llm_tpu_torch import kernels
    from tiny_llm_tpu_torch.serving import ServingMetrics, batch_generate

    max_seq = kw["max_seq_len"]
    prompts = ["x" * int(n) for n in lens]

    def campaign(m):
        """One campaign on m: (its metrics row, its tokens per request, its launches)."""
        pool = m.page_pool
        tok = _recorder()
        met = ServingMetrics(pool_capacity_pages=pool.num_pages, page_size=pool.page_size)
        met._bytes_per_slot = 2 * cfg.num_hidden_layers * cfg.num_key_value_heads \
            * cfg.head_dim * 2
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = batch_generate(m, tok, prompts, max_output_tokens=max_out, metrics=met, **kw)
        met.wall_s = time.perf_counter() - t0
        counts = kernels.launches()
        check(sorted(i for i, _ in res) == list(range(len(prompts))), "a request did not return")
        check(pool.free_pages == pool.num_pages - 1, "a campaign leaked pages")
        ids = {i: got for (i, _), got in zip(res, tok.decoded)}
        for i, got in ids.items():
            # Each request runs to the output cap, or to max_seq (its offset
            # is prompt + outputs - 1: the first token comes from prefill).
            check(len(got) == max_out or int(lens[i]) + len(got) - 1 == max_seq,
                  f"request {i}: {len(got)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in got), f"request {i}: token out of range")
        return dict(met.as_dict(), wall_s=met.wall_s), ids, counts

    def add(total, counts):
        return {k: total.get(k, 0) + v for k, v in counts.items()}

    turns = turns or []
    check(not turns or n_runs >= 2, f"{n_runs} campaign: a model in turns must run two, its "
          "tokens held to each other's")
    for m, w in [(t["model"], t["warm"]) for t in turns] + [(model, warm)]:
        batch_generate(m, _recorder(), w, max_output_tokens=max(8, BURST), **kw)
        check(m.page_pool.free_pages == m.page_pool.num_pages - 1, "the warm-up leaked pages")
    rows, ids, counts = [], [], {}
    for t in turns:
        t.update(rows=[], ids=[], launches={})
    for _ in range(n_runs):
        for t in turns:
            row, got, c = campaign(t["model"])
            t["rows"].append(row)
            t["ids"].append(got)
            t["launches"] = add(t["launches"], c)
        row, got, c = campaign(model)
        rows.append(row)
        ids.append(got)
        counts = add(counts, c)
    check(all(got == ids[0] for got in ids), "the campaigns' tokens differ")
    for t in turns:
        check(len(t["ids"]) == n_runs, f"a model in turns ran {len(t['ids'])} campaigns")
        check(all(got == t["ids"][0] for got in t["ids"]),
              "a model in turns gave different tokens in two campaigns")
        t.update(a_rows=rows, a_ids=ids, a_launches=counts)
    return rows, counts


def _serving_campaign():
    """bench.py serving_bench's default campaign: (prompt lengths, output
    cap, batch_generate keywords)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(128, MAX_SEQ + 1, size=SERVING_REQUESTS)
    max_out = int(rng.integers(32, 129, size=SERVING_REQUESTS).mean())
    kw = dict(max_seq_len=MAX_SEQ, batch_size=SERVING_BATCH, prefill_step=128,
              decode_burst=BURST)
    return lens, max_out, kw


# The serving warm-up, as bench.py's: every power-of-two chunk, the 256
# chunk's shape and the longest prompt.
SERVING_WARM = ["x" * 255, "x" * 257, "x" * MAX_SEQ]


def phase_serving(model, cfg, phase, name, mixed=False, n_runs=3, beside=None, turns=None):
    """bench.py serving_bench's default campaign through the port, a
    warm-up and `n_runs` campaigns; with `mixed`, bench.py --mode serving
    --mixed's (mixed prefill+decode bursts of MIXED_CHUNK-token
    sub-chunks). The model's act_quant sets which matmul kernels must run.
    `beside`: another phase's numbers to print beside these. `turns` (a
    list of dicts with "model" and "warm", each model's page pool enabled):
    other models whose campaigns are taken in turns with these
    (_campaigns)."""
    torch.cuda.reset_peak_memory_stats()
    model.enable_paged_attention(num_pages=POOL_PAGES, page_size=PAGE_SIZE)
    lens, max_out, kw = _serving_campaign()
    mixed_bursts = []
    if mixed:
        kw.update(mixed_prefill=True, mixed_chunk=MIXED_CHUNK)
        orig = model.mixed_burst
        model.mixed_burst = lambda *a, **k: mixed_bursts.append(1) or orig(*a, **k)
    try:
        rows, counts = _campaigns(model, cfg, lens, max_out, kw, SERVING_WARM, n_runs, turns)
    finally:
        if mixed:
            del model.mixed_burst
    return _serving_line(model, cfg, phase, name, rows, counts, mixed_bursts if mixed else None,
                         beside)


def _serving_line(model, cfg, phase, name, rows, counts, mixed_bursts=None, beside=None):
    """Check and print a serving phase's campaigns (`rows`, `counts`: their
    metrics and launches; `mixed_bursts`: a mixed campaign's bursts): every
    kernel of the model's path launched, the dense decode kernel never, the
    median campaign's numbers and a profile of one serving burst. Returns
    `counts`."""
    mixed = mixed_bursts is not None
    lens, max_out, _ = _serving_campaign()
    n_runs = len(rows)
    per_step, per_prefill = _path_launches(cfg, model.act_quant)
    # A mixed campaign's sub-chunks (32 tokens) run paged prefill; only its
    # classic chunks (a prefill with no active slot) may reach paged decode.
    need = [k for k in per_step if per_step[k] or per_prefill[k]] + list(PAGED)
    for kern in need:
        if kern != "fused_decode_attention" and not (mixed and kern == "paged_decode"):
            check(counts[kern] > 0, f"{kern} never launched on the serving path")
    check(counts["fused_decode_attention"] == 0, "the dense decode kernel ran on the paged path")
    check(not mixed or len(mixed_bursts) > 0, "no mixed burst ran")
    tok_s = [r["output_tok_s"] for r in rows]
    mid = rows[sorted(range(n_runs), key=lambda k: tok_s[k])[(n_runs - 1) // 2]]
    line = {"phase": phase, "model": name, "layers": cfg.num_hidden_layers,
            "act_quant": model.act_quant,
            "requests": SERVING_REQUESTS, "batch": SERVING_BATCH, "max_seq": MAX_SEQ,
            "page_size": PAGE_SIZE, "pool_pages": POOL_PAGES, "prefill_step": 128,
            "decode_burst": BURST, "max_output_tokens": max_out,
            "prompt_tokens": int(lens.sum()), "output_tok_s": mid["output_tok_s"],
            "output_tok_s_all": tok_s, "req_s": mid["req_s"],
            "ttft_p50_ms": mid["ttft_p50_ms"], "ttft_p95_ms": mid["ttft_p95_ms"],
            "request_latency_p50_ms": mid["request_latency_p50_ms"],
            "mean_batch_occupancy": mid["mean_batch_occupancy"],
            "peak_live_pages": mid["peak_live_pages"],
            "output_tokens": mid["output_tokens"], "decode_bursts": mid["decode_steps"],
            "wall_s_all": [r["wall_s"] for r in rows], f"launches_{n_runs}_campaigns": counts,
            "pool_full_after_each_campaign": True,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if mixed:
        line.update(mixed_chunk=MIXED_CHUNK, mixed_bursts=len(mixed_bursts),
                    mixed_burst_profile=_profile_serving_burst(model, lens, mixed=True))
    else:
        line["decode_burst_profile"] = _profile_serving_burst(model, lens)
    emit(dict(line, **(beside or {})))
    return counts


def phase_a8_serving(a8, cfg, turns):
    """The serving campaign through Qwen3-4B with act_quant="int8" on the
    W4A16 model's weights: its campaign was taken in turns with
    `serving`'s two and paged3_serving's two (three-launch, W4A8, W4A16,
    twice; `turns` holds both sides), each model after its own warm-up. The
    serving line's checks and numbers, beside the W4A16 campaigns'
    medians in the same turns and both sides' launches per campaign.
    Prompt tails of 5-32 tokens reach the W4A8 matmul's int8 tile."""
    w4a16, w4a8 = turns["a_rows"], turns["rows"]

    def med(rows, key):
        return float(np.median([r[key] for r in rows]))

    def per_campaign(counts, n):
        return {k: v / n for k, v in counts.items() if v}

    keys = ("output_tok_s", "ttft_p50_ms", "ttft_p95_ms")
    return _serving_line(a8, cfg, "a8_serving", "qwen3-4b W4A8", w4a8, turns["launches"],
                         beside={"order": "three-launch, W4A8, W4A16, twice (serving's "
                                          "campaigns)",
                                 "in_turns_medians": {
                                     **{f"w4a16_{k}": med(w4a16, k) for k in keys},
                                     **{f"w4a8_{k}": med(w4a8, k) for k in keys}},
                                 "launches_per_campaign": {
                                     "w4a16": per_campaign(turns["a_launches"], len(w4a16)),
                                     "w4a8": per_campaign(turns["launches"], len(w4a8))}})


def _profile_serving_burst(model, lens, mixed=False):
    """One BURST-step serving decode burst over four installed requests (the
    campaign's first four prompt lengths): device time by kernel name, and
    the device busy share against the same burst's wall time unprofiled.
    With `mixed`, a mixed burst whose steps also prefill BURST sub-chunks of
    MIXED_CHUNK tokens of a fresh prompt."""
    from tiny_llm_tpu_torch.models.qwen3 import MixedStep

    batch = model.create_batching_kv_cache(SERVING_BATCH)
    for slot, n in enumerate(lens[:SERVING_BATCH]):
        c = model.create_kv_cache()
        model([[ord("x")] * int(n)], 0, c, logits_to_keep=1)
        batch.add_request(c, slot)
    first = np.full((SERVING_BATCH,), ord("x"), np.int32)

    def burst():
        if not mixed:
            return model.decode_burst(batch, first, BURST)
        c = model.create_kv_cache()
        model.mixed_burst(batch, first, BURST, [
            MixedStep(cache=c, tokens=[ord("x")] * MIXED_CHUNK, offset=t * MIXED_CHUNK)
            for t in range(BURST)], MIXED_CHUNK)
        c.release()

    out = _device_profile(burst, BURST)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    burst()
    wall_ms = (time.perf_counter() - t0) * 1e3 / BURST
    batch.release()
    out["wall_ms_per_step"] = wall_ms
    dev_ms = out["device_ms_per_step"]
    out["busy_share_unprofiled"] = None if dev_ms is None else dev_ms / wall_ms
    return out



def _state_err(what, got, want, tol):
    """Kernel (o, m, l) against the plain version's: o within tol (a number,
    or per element: _state_tol), m and l within 1e-3 of max(1, |plain|)
    (f32 sums in other orders). Returns o's max error and, per batch row,
    its largest ratio to tol."""
    err, rows = max_err(got[0], want[0]), _over_tol(got[0], want[0], tol)
    check(max(rows) <= 1, f"{what}: o {err}, {max(rows)} times its tolerance")
    for i, part in ((1, "m"), (2, "l")):
        gap = float(((got[i] - want[i]).abs() / want[i].abs().clamp(min=1.0)).max())
        check(gap <= 1e-3, f"{what}: {part} differs by {gap} (relative)")
    return err, rows


def _state_control(what, got, tol, control, changed):
    """`control` (the plain version with each row's visible keys shifted by
    one) must miss o's tolerance in every batch row whose visible keys the
    shift changed (`changed`, one bool a row). Returns the per-row ratios."""
    ctl = _over_tol(got[0], control[0], tol)
    check(any(changed) and all(c > 1 for c, ch in zip(ctl, changed) if ch),
          f"{what}: the control is within tolerance in a row it changed: {ctl}")
    return ctl


def _chunk_state_check(what, q, k, v, lens, sc):
    """Row 7 against its plain version on the card: (o, m, l) as
    _sp_state_check holds them, o per element within _state_tol, and the
    plain version at lens + 1 as the control. Returns the case's fields."""
    from tiny_llm_tpu_torch.kernels import flash_attention as ka

    got = ka.flash_prefill_state_cuda(q, k, v, lens, sc)
    want = ka.flash_prefill_state_plain(q, k, v, lens, sc)
    torch.cuda.synchronize()
    L, S = q.shape[2], k.shape[2]
    ok = ka._causal_mask(lens, L, S, q.device)
    tol = _state_tol(q, k, v, ok, sc, want[0])
    err, rows, empty = _sp_state_check(what, got, want, tol)
    changed = (ok != ka._causal_mask(lens + 1, L, S, q.device)).flatten(1).any(1).tolist()
    ctl = _state_control(what, got, tol, ka.flash_prefill_state_plain(q, k, v, lens + 1, sc),
                         changed)
    return {"max_err": err, "err_over_tol_per_batch_row": rows, "tol": TOL_ATTENTION,
            "control": "lens + 1", "control_err_over_tol_per_batch_row": ctl,
            "identity_rows": empty}, want


def _prefix_state_check(what, q, kp, vp, bt, pre, sc, clean=None):
    """Row 15 against its plain version on the card, as _chunk_state_check,
    with prefix_lens - 1 as the control. `clean`: the pages the plain
    version reads, where the kernel's hold NaN and Inf in rows no query may
    see (the function does not depend on them; the kernel must not read
    them)."""
    from tiny_llm_tpu_torch.kernels import paged_attention as pa

    got = pa.paged_prefix_state_cuda(q, kp, vp, bt, pre, sc)
    kc, vc = clean or (kp, vp)
    want = pa.paged_prefix_state_plain(q, kc, vc, bt, pre, sc)
    torch.cuda.synchronize()
    k, v = pa.gather_pages_dense(kc, vc, bt)
    B, _, L, _ = q.shape
    S = k.shape[2]
    ok = torch.arange(S, device=q.device)[None, None, :] < pre[:, None, None].long()
    tol = _state_tol(q, k, v, ok.expand(B, L, S), sc, want[0])
    del k, v
    err, rows, empty = _sp_state_check(what, got, want, tol)
    ctl = _state_control(what, got, tol,
                         pa.paged_prefix_state_plain(q, kc, vc, bt, (pre - 1).clamp(min=0), sc),
                         (pre > 0).tolist())
    return {"max_err": err, "err_over_tol_per_batch_row": rows, "tol": TOL_ATTENTION,
            "control": "prefix_lens - 1", "control_err_over_tol_per_batch_row": ctl,
            "identity_rows": empty}, want


def _split_edges(randn, errs):
    """Rows 7 and 15 where the tile's edges fall: D 64 and 128, n_rep 1, 4
    and 8 over 2 KV heads, a 1000-token chunk (a ragged 128-row q tile and,
    for row 7, a ragged 64-key tile over a 1000-key slab); row 15 over
    prefixes of 1, 63, 64, 65, 1000 and 0 in pools of 16- and 128-token
    pages whose trash page and whose rows at or past each prefix hold NaN in
    K and Inf in V. Returns one summary line a case."""
    dev = torch.device("cuda")
    L, Hkv, pres = 1000, 2, [1, 63, 64, 65, 1000, 0]
    out = []
    for D in (64, 128):
        for n_rep in (1, 4, 8):
            Hq, sc = Hkv * n_rep, D**-0.5
            q, k, v = randn(2, Hq, L, D), randn(2, Hkv, L, D), randn(2, Hkv, L, D)
            lens = torch.full((2,), L, dtype=torch.int32, device=dev)
            f, _ = _chunk_state_check(f"flash_prefill_state D={D} n_rep={n_rep} L={L}", q, k, v,
                                      lens, sc)
            errs["flash_prefill_state"].append(f["max_err"])
            out.append({"kernel": "flash_prefill_state", "D": D, "n_rep": n_rep, "L": L,
                        "lens": L, "err_over_tol": max(f["err_over_tol_per_batch_row"]),
                        "control_min": min(f["control_err_over_tol_per_batch_row"])})
            for ps in (16, 128):
                used = [-(-(p + L) // ps) for p in pres]
                P = sum(used) + 2
                perm = np.random.default_rng(ps + D + n_rep).permutation(np.arange(1, P))
                bt = np.full((len(pres), max(used) + 1), -1, np.int32)
                unseen = np.zeros((P, ps), bool)
                unseen[0] = True  # the trash page
                j = 0
                for b, (p, n) in enumerate(zip(pres, used)):
                    bt[b, :n] = perm[j : j + n]
                    j += n
                    pos = np.arange(p, n * ps)
                    unseen[bt[b, pos // ps], pos % ps] = True
                bad = torch.from_numpy(unseen).to(dev)[:, None, :, None]
                kc, vc = randn(P, Hkv, ps, D), randn(P, Hkv, ps, D)
                kp, vp = kc.masked_fill(bad, float("nan")), vc.masked_fill(bad, float("inf"))
                kc, vc = kc.masked_fill(bad, 0.0), vc.masked_fill(bad, 0.0)
                q = randn(len(pres), Hq, L, D)
                f, _ = _prefix_state_check(
                    f"paged_prefix_state D={D} n_rep={n_rep} ps={ps} prefixes={pres}", q, kp,
                    vp, torch.from_numpy(bt).to(dev), torch.tensor(pres, dtype=torch.int32,
                                                                   device=dev), sc, (kc, vc))
                errs["paged_prefix_state"].append(f["max_err"])
                ctl = [c for c, p in zip(f["control_err_over_tol_per_batch_row"], pres) if p]
                out.append({"kernel": "paged_prefix_state", "D": D, "n_rep": n_rep, "L": L,
                            "page_size": ps, "prefixes": pres,
                            "err_over_tol": max(f["err_over_tol_per_batch_row"]),
                            "control_min": min(ctl)})
    return out


def phase_split_kernels(shapes, contract):
    """The split paged prefill's two kernels against their plain versions on
    the card, o per element within _state_tol (m and l within 1e-3, a row
    that sees no key exactly the identity) and a control one key off that
    must miss it: first at the tile's edges (_split_edges), then at
    Qwen3-4B's and Qwen3-30B-A3B's head shapes, the chunk-state flash
    prefill at L = 1024 and 2048 (its own k/v, lens = L), and the
    prefix-state walk at L = 1024 over prefixes of 1024, 4096 and 7168 in a
    shuffled pool, beside a row of prefix 0. Beside the walk: the whole
    split (both kernels and the combine) against the paged prefill kernel
    over the same chunk and prefix, and the combine alone. Timed by
    CUDA-graph replay (the walk over 4 layers' pages)."""
    from tiny_llm_tpu_torch.kernels import flash_attention as ka
    from tiny_llm_tpu_torch.kernels import paged_attention as pa
    from tiny_llm_tpu_torch.kernels.split_prefill import combine_state_pair, split_paged_prefill

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tol = 2e-2  # the split against row 13, the SDPA yardsticks: other rounding points
    errs = {n: [] for n in SPLIT}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    edges = _split_edges(randn, errs)
    cases = []
    for model_name, cfg in shapes:
        Hkv, D = cfg.num_key_value_heads, cfg.head_dim
        Hq = cfg.num_attention_heads
        sc = D**-0.5
        main = model_name == "qwen3-4b"
        for L in (LONG_CHUNK, 2 * LONG_CHUNK):
            q, k, v = randn(1, Hq, L, D), randn(1, Hkv, L, D), randn(1, Hkv, L, D)
            lens = torch.full((1,), L, dtype=torch.int32, device=dev)
            fields, want = _chunk_state_check(f"flash_prefill_state L={L}", q, k, v, lens, sc)
            errs["flash_prefill_state"].append(fields["max_err"])
            kern = graph_ms(lambda: ka.flash_prefill_state_cuda(q, k, v, lens, sc))
            plain = event_ms(lambda: ka.flash_prefill_state_plain(q, k, v, lens, sc), reps=1)

            def lib_fn():
                return sdpa(q, k, v, is_causal=True, scale=sc, enable_gqa=True)

            check(max_err(lib_fn(), want[0]) <= tol, f"SDPA yardstick L={L} differs")
            lib = graph_ms(lib_fn)
            del want
            flops = 4 * Hq * (L * (L + 1) // 2) * D
            bms, by = bound(2 * Hq * L * D * 2 + 2 * Hkv * L * D * 2 + 2 * Hq * L * 4, flops)
            case = {"kernel": "flash_prefill_state", "tpu_kernel": ka.TPU_KERNEL_STATE,
                    "model": model_name,
                    "shape": f"B=1 L={L} lens={L} Hq={Hq} Hkv={Hkv} D={D}", **fields,
                    "kernel_ms": kern, "tflop_s": flops / kern / 1e9, "plain_ms": plain,
                    "library_ms": lib, "library": "SDPA causal over the chunk",
                    "bound_ms": bms, "bound_by": by}
            cases.append(case)
            if main and L == LONG_CHUNK:
                contract["flash_prefill_state"] = {
                    "name": "flash_prefill_state", "route": "cuda", "source": ka.SOURCE,
                    "replaces": "tiny_llm_tpu/kernels/flash_attention_pallas.py:597",
                    "case": case["shape"], "ms": kern, "plain_ms": plain, "bound_ms": bms,
                    "bound_by": by, "library_ms": lib,
                }
            del q, k, v

        # The prefix walk: row 0 a chunk of L at offset `prefix`, row 1 a
        # chunk at offset 0; both chunks' k/v already in the pages.
        L, layers = LONG_CHUNK, 4
        width = LONG_PROMPT // PAGE_SIZE
        n_pages = width + L // PAGE_SIZE + 8
        kp = randn(layers, n_pages, Hkv, PAGE_SIZE, D)
        vp = randn(layers, n_pages, Hkv, PAGE_SIZE, D)
        perm = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(6)) + 1).numpy()
        for prefix in (1024, 4096, LONG_PROMPT - L):
            bt = _tables(perm, [prefix + L, L], width)
            pre = torch.tensor([prefix, 0], dtype=torch.int32, device=dev)
            q = randn(2, Hq, L, D)
            what = f"paged_prefix_state prefix={prefix}"
            fields, want = _prefix_state_check(what, q, kp[0], vp[0], bt, pre, sc)
            errs["paged_prefix_state"].append(fields["max_err"])
            kern = graph_ms(lambda: [pa.paged_prefix_state_cuda(q, kp[i], vp[i], bt, pre, sc)
                                     for i in range(layers)]) / layers
            plain = event_ms(lambda: pa.paged_prefix_state_plain(q, kp[0], vp[0], bt, pre, sc),
                             reps=1)
            # Library yardstick: SDPA of row 0 over its prefix gathered
            # contiguous (row 1 has no prefix).
            pref = []
            for i in range(layers):
                k_i, v_i = pa.gather_pages_dense(kp[i], vp[i], bt[:1])
                pref.append((k_i[:, :, :prefix].contiguous(), v_i[:, :, :prefix].contiguous()))
            check(max_err(sdpa(q[:1], *pref[0], scale=sc, enable_gqa=True), want[0][:1]) <= tol,
                  f"SDPA yardstick {what} differs")
            lib = graph_ms(lambda: [sdpa(q[:1], k_i, v_i, scale=sc, enable_gqa=True)
                                    for k_i, v_i in pref]) / layers
            del pref, want
            # The whole split against the paged prefill kernel (row 13) over
            # the same chunk and prefix: both rows' chunk k/v, per layer.
            chunks = []
            for i in range(layers):
                k_i, v_i = pa.gather_pages_dense(kp[i], vp[i], bt)
                chunks.append(tuple(torch.stack([x[0, :, prefix : prefix + L], x[1, :, :L]])
                                    .contiguous() for x in (k_i, v_i)))
            split = split_paged_prefill(q, *chunks[0], kp[0], vp[0], bt, pre, sc)
            unsplit = pa.paged_prefill_cuda(q, kp[0], vp[0], bt, pre + L, sc)
            torch.cuda.synchronize()
            split_err = max_err(split, unsplit)
            check(split_err <= tol, f"split against paged prefill, prefix={prefix}: {split_err}")
            split_ms = graph_ms(lambda: [split_paged_prefill(q, *chunks[i], kp[i], vp[i], bt, pre,
                                                             sc) for i in range(layers)]) / layers
            row13_ms = graph_ms(lambda: [pa.paged_prefill_cuda(q, kp[i], vp[i], bt, pre + L, sc)
                                         for i in range(layers)]) / layers
            # The split's plain combine alone, on the two kernels' states.
            full = torch.full((2,), L, dtype=torch.int32, device=dev)
            states = (ka.flash_prefill_state_cuda(q, *chunks[0], full, sc)
                      + pa.paged_prefix_state_cuda(q, kp[0], vp[0], bt, pre, sc))
            combine_ms = graph_ms(lambda: combine_state_pair(*states))
            del chunks, split, unsplit, states
            # Row 0's prefix k/v, both rows' q and o (bf16), m and l (f32).
            flops = 4 * Hq * L * prefix * D
            bms, by = bound(2 * Hkv * prefix * D * 2 + 2 * (2 * Hq * L * D * 2)
                            + 2 * (2 * Hq * L * 4), flops)
            case = {"kernel": "paged_prefix_state", "tpu_kernel": pa.TPU_KERNEL_PREFIX,
                    "model": model_name,
                    "shape": f"B=2 L={L} prefix=[{prefix}, 0] pool={n_pages}x{PAGE_SIZE} "
                             f"width={width} Hq={Hq} Hkv={Hkv} D={D}", **fields,
                    "kernel_ms": kern, "tflop_s": flops / kern / 1e9, "plain_ms": plain,
                    "library_ms": lib, "library": "SDPA of row 0 over its prefix gathered "
                    "contiguous", "bound_ms": bms, "bound_by": by,
                    "split_ms": split_ms, "split_vs_paged_prefill_max_err": split_err,
                    "paged_prefill_ms": row13_ms, "split_speedup_over_paged_prefill":
                    row13_ms / split_ms, "combine_ms": combine_ms,
                    "combine_share_of_split": combine_ms / split_ms}
            cases.append(case)
            if main and prefix == LONG_PROMPT - L:
                contract["paged_prefix_state"] = {
                    "name": "paged_prefix_state", "route": "cuda", "source": pa.SOURCE,
                    "replaces": "tiny_llm_tpu/kernels/paged_attention_pallas.py:716",
                    "case": case["shape"], "ms": kern, "plain_ms": plain, "bound_ms": bms,
                    "bound_by": by, "library_ms": lib,
                }
            del q
        del kp, vp
        torch.cuda.empty_cache()
    for name in SPLIT:
        contract[name]["max_abs_err"] = max(errs[name])
    emit({"phase": "split_kernels", "edges": edges, "cases": cases})


def phase_long_parity(cfg):
    """The split route on the card at 4B widths, 4 layers: a 3072-token
    prompt in chunks of LONG_CHUNK over the pool (K3 on the first, the
    split on the two at offset > 0). Last-row logits of the kernel path
    against the plain path's, and of the split route against the unsplit
    route (the paged prefill kernel, forward_step_paged(split_attention=
    False), run first on the same pages: it writes the same k/v)."""
    from tiny_llm_tpu_torch import kernels
    from tiny_llm_tpu_torch.models import Qwen3Model, synthetic_quantized_params
    from tiny_llm_tpu_torch.models.qwen3 import forward_step_paged

    cfg4 = dataclasses.replace(cfg, num_hidden_layers=4)
    params = synthetic_quantized_params(cfg4, seed=3)
    n = 3 * LONG_CHUNK
    fast, plain = (Qwen3Model(params, cfg4, max_seq_len=n + PAGE_SIZE, impl=impl)
                   .enable_paged_attention(num_pages=n // PAGE_SIZE + 4, page_size=PAGE_SIZE)
                   for impl in (None, "torch"))
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(1, n))
    cf, cp = fast.create_kv_cache(), plain.create_kv_cache()
    tally = {"worst": 0.0, "decided": 0, "agree": 0}
    split_tally = {"worst": 0.0, "decided": 0, "agree": 0}
    pool = fast.page_pool
    kernels.reset_launches()
    for off in range(0, n, LONG_CHUNK):
        chunk = prompt[:, off : off + LONG_CHUNK]
        if off:
            cf.ensure_capacity(off + LONG_CHUNK)
            table = torch.tensor([cf.block_table_row(fast._paged_width)], dtype=torch.int32,
                                 device=fast.device)
            unsplit = forward_step_paged(
                fast.params, cfg4, fast._rope_tables, fast._tokens(chunk),
                torch.tensor([off], dtype=torch.int32, device=fast.device), pool.key_pages,
                pool.value_pages, table, logits_to_keep=1, split_attention=False)
        lf = fast(chunk, off, cf, logits_to_keep=1)
        lp = plain(chunk, off, cp, logits_to_keep=1)
        _parity_check(lf, lp, f"long prompt chunk at {off}", tally)
        if off:
            _parity_check(lf, unsplit, f"split against unsplit at {off}", split_tally)
    counts = kernels.launches()
    want = {"flash_attention": 4, "flash_prefill_state": 8, "paged_prefix_state": 8,
            "paged_prefill": 8}
    check({k: counts[k] for k in want} == want, f"long_parity launches {counts}")
    cf.release()
    cp.release()
    check(tally["agree"] == tally["decided"] and split_tally["agree"] == split_tally["decided"],
          "top-1 disagrees on a decided position")
    emit({"phase": "long_parity", "layers": 4, "prompt_tokens": n, "chunk": LONG_CHUNK,
          "kernel_vs_plain_worst_err_over_tol": tally["worst"],
          "split_vs_unsplit_worst_err_over_tol": split_tally["worst"],
          "tol": "5% of max |reference logit|", "top1_decided": tally["decided"] +
          split_tally["decided"], "top1_agree": tally["agree"] + split_tally["agree"],
          "launches": {k: counts[k] for k in want}})


def phase_long_prefill(long, cfg):
    """One LONG_PROMPT-token prompt at full width and depth, prefilled in
    chunks of LONG_CHUNK and of 2 * LONG_CHUNK (three runs each, after a
    warm-up), with exact launch counts: the offset > 0 chunks take the
    split, the first chunk K3, and no chunk the paged prefill kernel."""
    from tiny_llm_tpu_torch import kernels

    torch.cuda.reset_peak_memory_stats()
    long.enable_paged_attention(num_pages=LONG_PAGES, page_size=PAGE_SIZE)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, size=LONG_PROMPT)
    Ly = cfg.num_hidden_layers
    k1 = _path_launches(cfg)[1]["quant_matmul"]

    def run(chunk):
        c = long.create_kv_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for off in range(0, LONG_PROMPT, chunk):
            logits = long([prompt[off : off + chunk]], off, c, logits_to_keep=1)
        tok = int(logits[0, -1].float().argmax())
        secs = time.perf_counter() - t0
        check(bool(torch.isfinite(logits.float()).all()), "non-finite long-prompt logits")
        check(tuple(logits.shape) == (1, 1, long.vocab_size), "long-prompt logits shape")
        c.release()
        return secs, tok

    run(LONG_CHUNK)  # warm-up
    line, total = {}, collections.Counter()
    for chunk in (LONG_CHUNK, 2 * LONG_CHUNK):
        kernels.reset_launches()
        runs = [run(chunk) for _ in range(3)]
        counts = kernels.launches()
        total.update(counts)
        n_chunks = LONG_PROMPT // chunk
        per_prefill = {name: 0 for name in counts}
        per_prefill.update(quant_matmul=k1 * n_chunks, flash_attention=Ly,
                           flash_prefill_state=Ly * (n_chunks - 1),
                           paged_prefix_state=Ly * (n_chunks - 1))
        check(counts == {k: 3 * v for k, v in per_prefill.items()},
              f"chunk {chunk}: launches {counts} != 3 x {per_prefill}")
        check(len({tok for _, tok in runs}) == 1, f"chunk {chunk}: the runs' tokens differ")
        tok_s = sorted(LONG_PROMPT / secs for secs, _ in runs)
        line[f"chunk_{chunk}"] = {"prefill_tok_s": tok_s[1], "prefill_tok_s_all": tok_s,
                                  "launches_per_prefill": per_prefill}
    # Device time of one prefill at chunks of LONG_CHUNK, by kernel name,
    # and each kernel's share of it.
    prof = _device_profile(lambda: run(LONG_CHUNK), 1)
    dev_ms = prof["device_ms_per_step"]
    prof["top_kernels_share"] = {name: ms / dev_ms for name, (ms, _) in
                                 prof["top_kernels_ms_per_step"].items()} if dev_ms else None
    line["prefill_profile"] = prof
    emit({"phase": "long_prefill", "model": "qwen3-4b", "layers": Ly,
          "prompt_tokens": LONG_PROMPT, "max_seq": LONG_MAX_SEQ, "pool_pages": LONG_PAGES,
          "page_size": PAGE_SIZE, **line,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return dict(total)


def phase_long_serving(long, cfg):
    """Long prompts through batch_generate on the LONG_MAX_SEQ model:
    LONG_REQUESTS prompts of LONG_MIN_PROMPT..LONG_PROMPT tokens, output
    cap the mean of draws from 32..128, batch 4, prefill step LONG_CHUNK,
    bench.py's pool rule (max_seq // ps) * (batch + 2) + 9, a warm-up and
    two campaigns."""
    torch.cuda.reset_peak_memory_stats()
    pages = (LONG_MAX_SEQ // PAGE_SIZE) * (SERVING_BATCH + 2) + 9
    long.enable_paged_attention(num_pages=pages, page_size=PAGE_SIZE)
    rng = np.random.default_rng(0)
    lens = rng.integers(LONG_MIN_PROMPT, LONG_PROMPT + 1, size=LONG_REQUESTS)
    max_out = int(rng.integers(32, 129, size=LONG_REQUESTS).mean())
    kw = dict(max_seq_len=LONG_MAX_SEQ, batch_size=SERVING_BATCH, prefill_step=LONG_CHUNK,
              decode_burst=BURST)
    rows, counts = _campaigns(long, cfg, lens, max_out, kw, ["x" * (LONG_MIN_PROMPT + 1)], 2)
    for kern in ("quant_matmul", "flash_attention", "fused_paged_decode_attention",
                 "paged_prefill", *SPLIT):
        check(counts[kern] > 0, f"{kern} never launched on the long serving path")
    emit({"phase": "long_serving", "model": "qwen3-4b", "layers": cfg.num_hidden_layers,
          "requests": LONG_REQUESTS, "batch": SERVING_BATCH, "max_seq": LONG_MAX_SEQ,
          "page_size": PAGE_SIZE, "pool_pages": pages, "prefill_step": LONG_CHUNK,
          "decode_burst": BURST, "max_output_tokens": max_out, "prompt_lens": lens.tolist(),
          "prompt_tokens": int(lens.sum()),
          "output_tok_s_all": [r["output_tok_s"] for r in rows],
          "input_tok_s_all": [int(lens.sum()) / r["wall_s"] for r in rows],
          "ttft_p50_ms_all": [r["ttft_p50_ms"] for r in rows],
          "ttft_p95_ms_all": [r["ttft_p95_ms"] for r in rows],
          "request_latency_p50_ms_all": [r["request_latency_p50_ms"] for r in rows],
          "mean_batch_occupancy_all": [r["mean_batch_occupancy"] for r in rows],
          "wall_s_all": [r["wall_s"] for r in rows], "launches_2_campaigns": counts,
          "pool_full_after_each_campaign": True,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return counts


class LogitRecorder:
    """Inside `with`, records every LM-head output of the port's model
    steps (models/qwen3.py _lm_head), in call order."""

    def __enter__(self):
        import tiny_llm_tpu_torch.models.qwen3 as qwen3

        self._mod, self._orig, self.out = qwen3, qwen3._lm_head, []

        def lm_head(*a, **k):
            y = self._orig(*a, **k)
            self.out.append(y)
            return y

        qwen3._lm_head = lm_head
        return self

    def __exit__(self, *exc):
        self._mod._lm_head = self._orig


def phase_mixed_parity(cfg):
    """The mixed prefill+decode burst at 4B widths, 4 layers: 4 installed
    decode slots and a 512-token prompt scheduled as 16 sub-chunks of
    MIXED_CHUNK. (a) Kernel path against plain path, teacher-forced: 16
    one-step mixed bursts fed the plain path's decode tokens, each step's
    decode and completion logits within parity's tolerance. (b) One 16-step
    mixed burst against the serialized schedule (a 16-step decode burst,
    then the prompt's chunked prefill) on the kernel path: tokens equal
    wherever the serialized logits decide them, up to a slot's first
    undecided step that differs. (c) One mixed burst under
    set_sync_debug_mode("error")."""
    from tiny_llm_tpu_torch import kernels
    from tiny_llm_tpu_torch.models import Qwen3Model, synthetic_quantized_params
    from tiny_llm_tpu_torch.models.qwen3 import MixedStep, forward_mixed_burst_paged

    cfg4 = dataclasses.replace(cfg, num_hidden_layers=4)
    params = synthetic_quantized_params(cfg4, seed=4)
    fast, plain = (Qwen3Model(params, cfg4, max_seq_len=MAX_SEQ, impl=impl)
                   .enable_paged_attention(num_pages=48, page_size=PAGE_SIZE)
                   for impl in (None, "torch"))
    rng = np.random.default_rng(5)
    slot_prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (130, 257, 300, 411)]
    prompt = rng.integers(0, cfg.vocab_size, size=16 * MIXED_CHUNK).tolist()
    steps, B = 16, len(slot_prompts)

    def install(m):
        batch = m.create_batching_kv_cache(B)
        first = []
        for slot, p in enumerate(slot_prompts):
            c = m.create_kv_cache()
            first.append(int(m([p], 0, c, logits_to_keep=1)[0, -1].float().argmax()))
            batch.add_request(c, slot)
        return batch, np.asarray(first, np.int32)

    def schedule(cache):
        return [MixedStep(cache=cache, tokens=prompt[t * MIXED_CHUNK : (t + 1) * MIXED_CHUNK],
                          offset=t * MIXED_CHUNK) for t in range(steps)]

    # (a) teacher-forced, one step per burst.
    (bf, first), (bp, _) = install(fast), install(plain)
    cf, cp = fast.create_kv_cache(), plain.create_kv_cache()
    sf, sp = schedule(cf), schedule(cp)
    tally = {"worst": 0.0, "decided": 0, "agree": 0}
    toks = first
    kernels.reset_launches()
    for t in range(steps):
        with LogitRecorder() as rf:
            fast.mixed_burst(bf, toks, 1, [sf[t]], MIXED_CHUNK)
        with LogitRecorder() as rp:
            plain.mixed_burst(bp, toks, 1, [sp[t]], MIXED_CHUNK)
        _parity_check(rf.out[0], rp.out[0], f"mixed step {t}", tally)
        toks = rp.out[0][0, :B].float().argmax(-1).to(torch.int32).cpu().numpy()
    counts = kernels.launches()
    Ly = cfg4.num_hidden_layers
    want = {"fused_paged_decode_attention": steps * Ly, "paged_prefill": steps * Ly}
    check({k: counts[k] for k in want} == want, f"mixed step launches {counts}")
    check(tally["agree"] == tally["decided"], "mixed: top-1 disagrees on a decided position")
    for b, c in ((bf, cf), (bp, cp)):
        b.release()
        c.release()

    # (b) one 16-step mixed burst against the serialized schedule.
    def serialized():
        batch, first = install(fast)
        c = fast.create_kv_cache()
        with LogitRecorder() as rec:
            dec = fast.decode_burst(batch, first, steps)
            for off in range(0, len(prompt), 128):
                fast([prompt[off : off + 128]], off, c, logits_to_keep=1)
        batch.release()
        c.release()
        dec_logits = torch.stack([y[:, -1] for y in rec.out[:steps]])  # [steps, B, V]
        return dec, dec_logits, rec.out[-1][0, -1]

    def mixed():
        batch, first = install(fast)
        c = fast.create_kv_cache()
        dec, comp = fast.mixed_burst(batch, first, steps, schedule(c), MIXED_CHUNK)
        batch.release()
        c.release()
        return dec, int(comp[-1])

    (dec_s, logits_s, comp_logits), (dec_m, comp_m) = serialized(), mixed()
    compared, skipped = 0, 0
    for b in range(B):
        for t in range(steps):
            top2 = logits_s[t, b].float().topk(2).values
            tol = 5e-2 * float(logits_s[t, b].float().abs().max())
            if float(top2[0] - top2[1]) > tol:
                check(dec_m[t, b] == dec_s[t, b], f"mixed against serialized: slot {b} step {t}")
                compared += 1
            elif dec_m[t, b] != dec_s[t, b]:
                skipped += steps - t  # an undecided step went the other way
                break
    top2 = comp_logits.float().topk(2).values
    if float(top2[0] - top2[1]) > 5e-2 * float(comp_logits.float().abs().max()):
        check(comp_m == int(comp_logits.float().argmax()), "mixed completion token differs")
        compared += 1

    # (c) one mixed burst with no host sync inside.
    batch, first = install(fast)
    c = fast.create_kv_cache()
    sched = schedule(c)
    for s in sched:
        c.ensure_capacity(s.offset + len(s.tokens))
    for slot in batch.slots:
        slot.ensure_capacity(slot.offset + steps)
    width, dev = fast._paged_width, fast.device
    args = dict(
        tokens0=torch.as_tensor(first, device=dev),
        offsets0=torch.as_tensor(batch.offsets, device=dev),
        key_pages=fast.page_pool.key_pages, value_pages=fast.page_pool.value_pages,
        block_table=torch.as_tensor(batch.block_table(width), device=dev),
        p_chunks=torch.as_tensor([s.tokens for s in sched], device=dev),
        p_offsets=torch.as_tensor([s.offset for s in sched], dtype=torch.int32, device=dev),
        p_tables=torch.as_tensor([c.block_table_row(width)] * steps, dtype=torch.int32,
                                 device=dev),
        p_last=torch.full((steps,), MIXED_CHUNK - 1, device=dev),
    )
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, comp = forward_mixed_burst_paged(fast.params, cfg4, fast._rope_tables, steps=steps,
                                              **args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(tuple(out.cpu().shape) == (steps, B) and tuple(comp.cpu().shape) == (steps,),
          "sync-free mixed burst shape")
    batch.release()
    c.release()
    check(fast.page_pool.live_pages == 0 and plain.page_pool.live_pages == 0, "pages leaked")
    emit({"phase": "mixed_parity", "layers": 4, "decode_slots": B,
          "slot_prompt_tokens": [len(p) for p in slot_prompts], "prompt_tokens": len(prompt),
          "mixed_chunk": MIXED_CHUNK, "steps": steps,
          "kernel_vs_plain_worst_err_over_tol": tally["worst"],
          "tol": "5% of max |plain logit|", "top1_decided": tally["decided"],
          "top1_agree": tally["agree"], "launches_teacher_forced": {k: counts[k] for k in want},
          "mixed_vs_serialized_decided_compared": compared,
          "mixed_vs_serialized_steps_after_an_undecided_flip": skipped,
          "sync_free_burst": {"steps": steps, "mode": "error", "host_syncs_in_burst": 0}})


def _random_qt(gen, N, K, bits, group_size, copies=1):
    """`copies` random weights [N, K] at the width, drawn as the port's
    synthetic params (centred codes)."""
    from tiny_llm_tpu_torch.ops.quantize import QuantizedTensor, padded_k

    dev = torch.device("cuda")
    kp, levels = padded_k(K), (1 << bits) - 1
    out = []
    for _ in range(copies):
        packed = torch.randint(-(2**31), 2**31, (N, kp * bits // 32), dtype=torch.int32,
                               generator=gen, device=dev)
        sc = ((torch.rand((N, kp // group_size), generator=gen, device=dev) * 0.004 + 0.001)
              * (15 / levels)).to(torch.bfloat16)
        bi = (-(levels / 2) * sc.float()).to(torch.bfloat16)
        out.append(QuantizedTensor(packed, sc, bi, N, K, kp, group_size, bits))
    return out


# Rows 16 and 19 before the int8 tile (the W4A8 GEMVs alone, as PERF.md's
# kernel table records them on NVIDIA H100 80GB HBM3, 700.00 W), ms: dense
# by (model, projection, M), grouped by (projection, case). A prior record,
# printed beside this run's times under its own key and never taken for
# one of them.
A8_GEMV_MS = {
    ("qwen3-4b", "qkv", 1): 0.0081, ("qwen3-4b", "qkv", 4): 0.0204,
    ("qwen3-4b", "qkv", 32): 0.1190, ("qwen3-4b", "gate_up", 1): 0.0179,
    ("qwen3-4b", "gate_up", 4): 0.0480, ("qwen3-4b", "gate_up", 32): 0.3432,
    ("qwen3-4b", "down", 1): 0.0147, ("qwen3-4b", "down", 4): 0.0375,
    ("qwen3-4b", "down", 32): 0.2465, ("qwen3-30b-a3b", "qkv", 1): 0.0060,
    ("qwen3-30b-a3b", "qkv", 4): 0.0144, ("qwen3-30b-a3b", "qkv", 32): 0.0785,
    ("qwen3-30b-a3b", "o", 1): 0.0063, ("qwen3-30b-a3b", "o", 4): 0.0141,
    ("qwen3-30b-a3b", "o", 32): 0.0635,
    ("gate", "T=8: one token's top-8"): 0.0092, ("down", "T=8: one token's top-8"): 0.0133,
    ("gate", "T=32: four tokens' top-8"): 0.0224, ("down", "T=32: four tokens' top-8"): 0.0398,
    ("gate", "T=128: sixteen tokens' top-8"): 0.0740,
    ("down", "T=128: sixteen tokens' top-8"): 0.1466,
    ("gate", "T=128, one expert holds every row"): 0.2047,
    ("down", "T=128, one expert holds every row"): 0.1757,
    ("gate", "T=24, experts 0-4 and 121-127 empty"): 0.0172,
    ("down", "T=24, experts 0-4 and 121-127 empty"): 0.0296,
}


SG_WIDTHS = ((2, 32), (2, 64), (2, 128), (4, 32), (4, 64), (8, 32), (8, 128))  # beside W8 g64


def _sg_route_plain(M):
    """Row 17's route at M rows and the plain version of its arithmetic."""
    from tiny_llm_tpu_torch.kernels import quant_matmul as qm

    route = qm.sg_route(M)
    return route, qm.quant_matmul_staged_plain if route == "staged" else qm.quant_matmul_plain


def _sg_cases(cfg, sg_model, gen):
    """Row 17 on each of its routes at their edges: 4B W8 g64 (the sg
    model's weights) qkv, down + res and the tied LM head at M = 1, 2, 3, 4,
    20, 32, 33, 36, 128 and 1024, an N-tail weight (N = 1001) at M = 1, 4,
    36 and 1024; the other widths on the qkv shape at M = 1, 3, 4, 33 and
    128 (each route at each width). Each held to 1 % of max of the f32 plain
    version and per element (2 bf16 ulps + 1e-3 of max) to its route's plain
    arithmetic."""
    from tiny_llm_tpu_torch.kernels import quant_matmul as qm

    run = functools.partial(_dense_cases, "quant_matmul_sg", qm.TPU_KERNEL_SG, gen=gen,
                            cuda_fn=qm.quant_matmul_sg_cuda, plain_fn=qm.quant_matmul_plain,
                            peak=BF16_FLOPS, route_plain=_sg_route_plain)
    shapes, cases = _k1_shapes(cfg), []
    for name in ("qkv", "down", "lm_head"):
        _, _, attr, residual = shapes[name]
        ws = [_layer_weight(sg_model.params, L, attr)
              for L in (sg_model.params.layers[:8] if attr else sg_model.params.layers[:1])]
        cases += run(ws=ws, Ms=(1, 2, 3, 4, 20, 32, 33, 36, 128, 1024), residuals=(residual,),
                     label=name)
    ws = _random_qt(gen, 1001, 2560, 8, 64, copies=4)
    cases += run(ws=ws, Ms=(1, 4, 36, 1024), residuals=(True,), label="N-tail")
    N, K = shapes["qkv"][:2]
    for bits, group_size in SG_WIDTHS:
        ws = _random_qt(gen, N, K, bits, group_size, copies=8)
        cases += run(ws=ws, Ms=(1, 3, 4, 33, 128), residuals=(False,), label="qkv")
    del ws
    return cases


def _sg_gate() -> int:
    """SG_B16_MIN_T as csrc/moe_matmul_sg.cu writes it (the route each of
    row 20's cases names comes from the source, the one taken from the
    library)."""
    src = Path(__file__).resolve().parent / "tiny_llm_tpu_torch" / "csrc" / "moe_matmul_sg.cu"
    return int(re.search(r"^constexpr int SG_B16_MIN_T = (\d+);$", src.read_text(),
                         flags=re.M).group(1))


def _sg_grouped_cases(moe_cfg, gen, rng):
    """Row 20 at Qwen3-30B-A3B's gate and down, W4 g64 and W8 g64 (8 random
    weight sets of 128 experts each, drawn as `_random_qt`), at its routes'
    edges: T = 8 (one token's top-8: eight experts of a row), SG_B16_MIN_T
    - 1 and SG_B16_MIN_T (tokens' top-8 and a row each of more experts),
    one expert holding every row of 15, 16, 17, 32 or 33 (the GEMV's 4-row
    passes), experts 0-4 and 121-127 empty (T = 24), T = 32 and 1024 (4
    and 128 tokens' top-8); on the tile from the gate, SG_B16_MIN_T / 8
    tokens' top-8 with expert 17 holding 15, 16, 17 or 33 rows (the tile's
    16-row edges) and one expert holding all SG_B16_MIN_T rows (the fewest
    tiles there). Each case names the route the entry must take (by the
    gate in the source) and is held per element to the plain version."""
    from types import SimpleNamespace

    from tiny_llm_tpu_torch.kernels import moe_matmul as km

    E, k, gate = moe_cfg.num_experts, moe_cfg.num_experts_per_tok, _sg_gate()
    one = lambda T: np.bincount([17] * T, minlength=E)  # noqa: E731

    def spread(T):  # T // k tokens' top-8, then a row each of experts they left empty
        sz = _routing(rng, T // k, E, k)
        for extra in range(T % k):
            sz[int(np.flatnonzero(sz == 0)[0])] += 1
        return sz

    def hot(rows):  # the gate's tokens' top-8, expert 17 holding `rows` of them
        sz = _routing(rng, gate // k, E, k)
        sz[17] = rows
        return sz

    specs = [("T=8: one token's top-8", _routing(rng, 1, E, k)),
             (f"T={gate - 1}: below the gate", spread(gate - 1)),
             (f"T={gate}: at the gate", spread(gate))]
    specs += [(f"T={T}, one expert holds every row", one(T)) for T in (15, 16, 17, 33)]
    specs += [("T=32, one expert holds every row", one(32)),
              ("T=24, experts 0-4 and 121-127 empty", np.concatenate([
                  np.zeros(5, int), rng.multinomial(24, np.full(E - 12, 1 / (E - 12))),
                  np.zeros(7, int)])),
              ("T=32: four tokens' top-8", _routing(rng, 4, E, k)),
              ("T=1024: 128 tokens' top-8", _routing(rng, 128, E, k))]
    specs += [(f"T={int(sz.sum())}: {gate // k} tokens' top-8, expert 17 holding {rows} rows",
               sz) for rows, sz in ((r, hot(r)) for r in (15, 16, 17, 33))]
    specs += [(f"T={gate}, one expert holds every row: the fewest tiles at the gate", one(gate))]
    specs = [(w, sz, "b16" if sz.sum() >= gate else "gemv") for w, sz in specs]
    shapes = {"w_gate": (moe_cfg.moe_intermediate_size, moe_cfg.hidden_size),
              "w_down": (moe_cfg.hidden_size, moe_cfg.moe_intermediate_size)}
    cases = []
    for bits, gs in ((4, 64), (8, 64)):
        drawn = {p: [type(q)(q.packed.view(E, N, -1), q.scales.view(E, N, -1),
                             q.biases.view(E, N, -1), N, K, q.k_padded, gs, bits)
                     for q in _random_qt(gen, E * N, K, bits, gs, copies=8)]
                 for p, (N, K) in shapes.items()}
        mlps = [SimpleNamespace(**{p: drawn[p][i] for p in shapes}) for i in range(8)]
        del drawn
        cases += [dict(c, model="qwen3-30b-a3b") for c in _grouped_kernel_cases(
            mlps, moe_cfg, gen, specs, "grouped_quant_matmul_sg",
            km.grouped_quant_matmul_sg_cuda, km.grouped_quant_matmul_plain, km.TPU_KERNEL_SG,
            per_element=True)]
        del mlps
        torch.cuda.empty_cache()
    return cases


def phase_quant_kernels(model, cfg, sg_model, moe, moe_cfg, contract):
    """The quant tiers' kernels against their plain versions on the card,
    timed by CUDA-graph replay over distinct weights (up to 8 layers'):
    the W4A8 matmul at the 4B shapes (qkv, gate_up, down + res; M = 1 and
    2 on the GEMV, 3 on the int8 tile and its edges 4, 5, 8, 16, 17, 32)
    and 30B-A3B's qkv and o;
    the any-width matmul on its three routes (_sg_cases); the grouped
    W4A8 matmul at 30B-A3B's gate and down (T = 8, 32, 128, one expert
    holding 16, 17, 64 or 128 rows, two holding 65 and 63, empty experts,
    and T = 16); the grouped any-width matmul at 30B-A3B W4 g64 (8 layers'
    experts; T = 8, 32, 1024). Each W4A8 case carries the GEMV's time
    before the tile as PERF.md records it (A8_GEMV_MS). Then one decode
    step each of the W4A8 (4B), any-width (4B W8 g64) and grouped W4A8
    (30B-A3B) matmuls for the kernel line."""
    from tiny_llm_tpu_torch.kernels import moe_matmul as km
    from tiny_llm_tpu_torch.kernels import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = []
    for mdl, c, names, label in ((model, cfg, ("qkv", "gate_up", "down"), "qwen3-4b"),
                                 (moe, moe_cfg, ("qkv", "o"), "qwen3-30b-a3b")):
        shapes = _k1_shapes(c)
        for name in names:
            _, _, attr, residual = shapes[name]
            ws = [_layer_weight(mdl.params, L, attr) for L in mdl.params.layers[:8]]
            cases += [dict(c, model=label, prior_record_gemv_ms=A8_GEMV_MS.get(
                (label, name, c["rows"]))) for c in _dense_cases(
                "quant_matmul_a8", qm.TPU_KERNEL_A8, ws, (1, 2, 3, 4, 5, 8, 16, 17, 32),
                (residual,), gen, qm.quant_matmul_a8_cuda, qm.quant_matmul_a8_plain, INT8_OPS,
                name, control=qm.quant_matmul_plain)]
    cases += _sg_cases(cfg, sg_model, gen)
    rng = np.random.default_rng(8)
    E, k = moe_cfg.num_experts, moe_cfg.num_experts_per_tok
    mlps = [layer.mlp for layer in moe.params.layers]
    specs = [("T=8: one token's top-8", _routing(rng, 1, E, k)),
             ("T=32: four tokens' top-8", _routing(rng, 4, E, k)),
             ("T=128: sixteen tokens' top-8", _routing(rng, 16, E, k)),
             ("T=128, one expert holds every row", np.bincount([17] * 128, minlength=E)),
             ("T=24, experts 0-4 and 121-127 empty", np.concatenate([
                 np.zeros(5, int), rng.multinomial(24, np.full(E - 12, 1 / (E - 12))),
                 np.zeros(7, int)]))]
    # The int8 tile walk's edges (no random draws: the cases above and below
    # draw what they drew before), and T = 16 from a generator of its own.
    one = lambda T, e=17: np.bincount([e] * T, minlength=E)  # noqa: E731
    specs += [(f"T={T}, one expert holds every row", one(T)) for T in (16, 17, 64)]
    specs += [("T=128, two experts hold 65 and 63 rows", one(65) + one(63, 18)),
              ("T=16: two tokens' top-8", _routing(np.random.default_rng(16), 2, E, k))]
    cases += [dict(c, model="qwen3-30b-a3b", prior_record_gemv_ms=A8_GEMV_MS.get(
        (c["proj"], c["spec"]))) for c in _grouped_kernel_cases(
        mlps, moe_cfg, gen, specs, "grouped_quant_matmul_a8", km.grouped_quant_matmul_a8_cuda,
        km.grouped_quant_matmul_a8_plain, km.TPU_KERNEL_A8, INT8_OPS,
        control=km.grouped_quant_matmul_plain)]
    cases += _sg_grouped_cases(moe_cfg, gen, rng)
    contract["quant_matmul_a8"] = _dense_step(
        model.params, cfg, gen, qm.quant_matmul_a8_cuda, qm.quant_matmul_a8_plain,
        "quant_matmul_a8", qm.SOURCE, "tiny_llm_tpu/kernels/quant_matmul.py:278", "4B W4A8",
        INT8_OPS, head=False, control=qm.quant_matmul_plain)
    contract["quant_matmul_sg"] = _dense_step(
        sg_model.params, cfg, gen, qm.quant_matmul_sg_cuda, qm.quant_matmul_plain,
        "quant_matmul_sg", qm.SOURCE_SG, "tiny_llm_tpu/kernels/quant_matmul.py:79",
        "4B W8 g64", BF16_FLOPS, head=True)
    contract["grouped_quant_matmul_a8"] = _grouped_step(
        mlps, moe_cfg, gen, rng, km.grouped_quant_matmul_a8_cuda, km.grouped_quant_matmul_a8_plain,
        "grouped_quant_matmul_a8", km.SOURCE, "tiny_llm_tpu/kernels/moe_matmul.py:173",
        "30B-A3B W4A8", INT8_OPS, control=km.grouped_quant_matmul_plain)
    emit({"phase": "quant_kernels", "cases": cases})


def phase_sg_moe(moe_cfg, contract, beside):
    """Qwen3-30B-A3B at W4 g64 (mlx_lm.convert's default group size) from
    synthetic params, full width, MOE_LAYERS layers: one decode step of the
    grouped any-width matmul for the kernel line (3 x MOE_LAYERS launches,
    every layer's experts), B = 1 decode with exact launch counts (`beside`: the W4A16
    numbers), and 4-layer parity under RouteForcer. Returns the decode
    run's launches."""
    from tiny_llm_tpu_torch.kernels import moe_matmul as km
    from tiny_llm_tpu_torch.models import Qwen3Model, synthetic_quantized_params

    sg_moe = Qwen3Model(synthetic_quantized_params(moe_cfg, seed=0, group_size=64), moe_cfg,
                        max_seq_len=MAX_SEQ)
    contract["grouped_quant_matmul_sg"] = _grouped_step(
        [layer.mlp for layer in sg_moe.params.layers], moe_cfg,
        torch.Generator(device="cuda").manual_seed(9), np.random.default_rng(9),
        km.grouped_quant_matmul_sg_cuda, km.grouped_quant_matmul_plain,
        "grouped_quant_matmul_sg", km.SOURCE_SG, "tiny_llm_tpu/kernels/moe_matmul.py:74",
        "30B-A3B W4 g64")
    counts = phase_model(sg_moe, moe_cfg, "sg_moe", "qwen3-30b-a3b W4 g64", runs=1,
                         beside=beside)
    del sg_moe
    torch.cuda.empty_cache()
    with RouteForcer() as forcer:
        phase_parity(moe_cfg, "sg_moe", forcer, bits=4, group_size=64)
    return counts



# ---------------------------------------------------------------------------
# Sequence-parallel (sharded-KV) attention on Qwen3-4B: the KV slab or page
# pool split over SP_SHARDS shards, all views on the one card.


def _sp(impl=None):
    """parallel.SPAttention over SP_SHARDS shards, every one on this card."""
    from tiny_llm_tpu_torch.parallel import ShardingConfig, SPAttention, make_mesh

    mesh = make_mesh(tp=SP_SHARDS, devices=[torch.device("cuda", 0)] * SP_SHARDS)
    return SPAttention(ShardingConfig(mesh), impl=impl)


def _sp_state_check(what, got, want, tol):
    """_state_err, every output finite, and the identity (0, NEG_INF, 0)
    exactly wherever the plain version's l is 0 (an empty shard or row).
    Returns o's max error, its ratio to tol per batch row and the count of
    identity rows."""
    from tiny_llm_tpu_torch.kernels.flash_attention import NEG_INF

    err, rows = _state_err(what, got, want, tol)
    check(all(bool(torch.isfinite(x).all()) for x in got), f"{what}: not finite")
    empty = want[2] == 0
    check(not bool(got[0][empty].any()) and bool((got[1][empty] == NEG_INF).all())
          and not bool(got[2][empty].any()), f"{what}: an empty row is not the identity")
    return err, rows, int(empty.sum())


def _sp_kernel_entry(name, source, replaces, case, err, kern, plain, lib, bms, by):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "case": case,
            "max_abs_err": err, "ms": kern, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib}


def _decode_state_check(what, q, k, v, lens, sc):
    """Row 6 on one shard against its plain version on the card: (o, m, l)
    as _sp_state_check holds them, o per element within _state_tol, and the
    plain version at lens - 1 as the control, which must miss it in every
    batch row whose visible keys it changes (an empty shard has none).
    Returns o's max error, its largest ratio to the tolerance, the identity
    rows and the control's ratios in the rows it changed (None: none)."""
    from tiny_llm_tpu_torch.kernels import flash_attention as ka

    got = ka.flash_decode_state_cuda(q, k, v, lens, sc)
    want = ka.flash_decode_state_plain(q, k, v, lens, sc)
    torch.cuda.synchronize()
    L, S = q.shape[2], k.shape[2]
    ok = ka._causal_mask(lens, L, S, q.device)
    tol = _state_tol(q, k, v, ok, sc, want[0])
    err, rows, empty = _sp_state_check(what, got, want, tol)
    shifted = (lens - 1).clamp(min=0)
    changed = (ok != ka._causal_mask(shifted, L, S, q.device)).flatten(1).any(1).tolist()
    ctl = None
    if any(changed):
        ctl = _state_control(what, got, tol, ka.flash_decode_state_plain(q, k, v, shifted, sc),
                             changed)
        ctl = [c for c, ch in zip(ctl, changed) if ch]
    return err, max(rows), empty, ctl


def phase_sp_kernels(cfg, contract):
    """The sequence-parallel path's kernels against their plain versions on
    the card at Qwen3-4B's head shapes, on every shard (the empty ones too):
    the shard decode-state kernel (row 6) over one layer's slab of SP_MAX_SEQ
    positions in SP_SHARDS shards of 1024 (B = 1 at SP_PROMPT keys, B = 4 at
    SP_BATCH_PROMPTS at L = 1, 8 and 16; at 4B's heads and at n_rep 8; each
    shard held per element by _decode_state_check),
    the paged decode-state walk (row 14) over one
    layer's striped pool (B = 4, contexts 6000, 2500, 130, 8000), and the
    chunk-state kernel (row 7) at the virtual lengths sharded prefill gives
    it (below 0, inside, past the shard). Beside each: the whole SP
    attention (the shards and the combine) against unsharded attention
    (K3, the paged decode kernel). Timed by CUDA-graph replay."""
    from tiny_llm_tpu_torch.kernels import flash_attention as ka
    from tiny_llm_tpu_torch.kernels import paged_attention as pa
    from tiny_llm_tpu_torch.kv import PagedKVCache, PagePool

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    sc, tol, n = D**-0.5, 2e-2, SP_SHARDS
    S_loc = SP_MAX_SEQ // n
    sp = _sp()
    cases, errs = [], {"flash_decode_state": [], "paged_decode_state": []}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    # Row 6: one layer's slab; shard s is the strided view [:, :, s*S_loc:(s+1)*S_loc].
    starts = torch.arange(0, SP_MAX_SEQ, S_loc, dtype=torch.int32, device=dev)[:, None]
    for heads, (hkv, n_rep) in (("qwen3-4b", (Hkv, Hq // Hkv)), ("n_rep 8", (4, 8))):
        k, v = randn(4, hkv, SP_MAX_SEQ, D), randn(4, hkv, SP_MAX_SEQ, D)
        for lens, L in (([SP_PROMPT], 1), (list(SP_BATCH_PROMPTS), 1),
                        (list(SP_BATCH_PROMPTS), 8), (list(SP_BATCH_PROMPTS), 16)):
            B = len(lens)
            q, kb, vb = randn(B, hkv * n_rep, L, D), k[:B], v[:B]
            lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            shard_lens = (lens_t[None] - starts).clamp(0, S_loc)
            shards = [(kb[:, :, s * S_loc : (s + 1) * S_loc], vb[:, :, s * S_loc : (s + 1) * S_loc])
                      for s in range(n)]
            empty, worst, controls = 0, 0.0, []
            for s, (ks, vs) in enumerate(shards):
                err, ratio, e, ctl = _decode_state_check(
                    f"flash_decode_state {heads} B={B} L={L} shard {s}", q, ks, vs, shard_lens[s],
                    sc)
                errs["flash_decode_state"].append(err)
                worst, empty = max(worst, ratio), empty + e
                if ctl is not None:
                    controls.append(min(ctl))
            # One launch over a full shard (shard 0; row 0 of B = 4 holds 1000 keys there).
            ks, vs = shards[0]
            full = shard_lens[0]
            kern = graph_ms(lambda: ka.flash_decode_state_cuda(q, ks, vs, full, sc))
            plain = event_ms(lambda: ka.flash_decode_state_plain(q, ks, vs, full, sc), reps=2)
            keys = [int(x) for x in full.tolist()]
            kmax = max(keys)
            qpos = full[:, None] - L + torch.arange(L, device=dev)[None, :]  # [B, L]
            mask = (torch.arange(kmax, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]

            def lib_fn():
                return sdpa(q, ks[:, :, :kmax], vs[:, :, :kmax], attn_mask=mask, scale=sc,
                            enable_gqa=True)

            want = ka.flash_decode_state_plain(q, ks, vs, full, sc)[0]
            check(max_err(lib_fn(), want) <= tol, f"SDPA yardstick {heads} B={B} L={L} differs")
            lib = graph_ms(lib_fn)
            rows = B * hkv * n_rep * L
            bms, by = bound(sum(2 * hkv * t * D * 2 for t in keys) + rows * (D * 4 + 8),
                            sum(4 * hkv * n_rep * L * t * D for t in keys))
            split = pa.decode_split(B, hkv, S_loc, 1, _sms())
            case = {"kernel": "flash_decode_state", "tpu_kernel": ka.TPU_KERNEL_DECODE_STATE,
                    "heads": heads,
                    "shape": f"B={B} L={L} shard 0 of {n} (S={SP_MAX_SEQ}, S_loc={S_loc}) "
                             f"keys={keys} Hq={hkv * n_rep} Hkv={hkv} D={D}, "
                             f"{-(-S_loc // split)} splits of {split} keys",
                    "max_err": max(errs["flash_decode_state"]), "err_over_tol": worst,
                    "tol": TOL_ATTENTION, "control": "lens - 1",
                    "control_min_err_over_tol": min(controls), "kernel_ms": kern,
                    "plain_ms": plain, "library_ms": lib, "library": "SDPA over the shard's keys",
                    "bound_ms": bms, "bound_by": by, "lens": lens, "empty_shard_rows": empty}
            if L == 1:  # the whole SP attention (sp.flash takes L = 1 to row 6)
                whole = ka.flash_attention_cuda(q, kb, vb, lens_t, sc)
                sp_err = max_err(sp.flash(q, kb, vb, lens_t, sc), whole)
                check(sp_err <= tol, f"SP flash {heads} B={B} against K3: {sp_err}")
                case.update(sp_attention_ms=graph_ms(lambda: sp.flash(q, kb, vb, lens_t, sc)),
                            sp_vs_k3_max_err=sp_err, k3_unsharded_ms=graph_ms(
                                lambda: ka.flash_attention_cuda(q, kb, vb, lens_t, sc)))
            cases.append(case)
            if heads == "qwen3-4b" and B == 1:
                contract["flash_decode_state"] = _sp_kernel_entry(
                    "flash_decode_state", ka.SOURCE,
                    "tiny_llm_tpu/kernels/flash_attention_pallas.py:282", case["shape"], 0.0,
                    kern, plain, lib, bms, by)
        del k, v

    # Row 14: one layer's pool striped over the shards; requests admitted in turn.
    ps, ctxs = PAGE_SIZE, [6000, 2500, 130, 8000]
    pool = PagePool(1, SP_PAGES, Hkv, ps, D, device=dev, stripe_shards=n)
    pool.key_pages.normal_(generator=gen)
    pool.value_pages.normal_(generator=gen)
    reqs = [PagedKVCache(pool) for _ in ctxs]
    for r, c in zip(reqs, ctxs):
        r.ensure_capacity(c)
    width = SP_MAX_SEQ // ps
    bt = torch.tensor([r.block_table_row(width) for r in reqs], dtype=torch.int32, device=dev)
    lens_t = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    kp, vp, P_loc = pool.key_pages[0], pool.value_pages[0], SP_PAGES // n
    q = randn(len(ctxs), Hq, 1, D)
    locs = [(kp[s * P_loc : (s + 1) * P_loc], vp[s * P_loc : (s + 1) * P_loc], s * P_loc)
            for s in range(n)]
    owned_keys, libs, empty = [], [], 0
    kg, vg = pa.gather_pages_dense(kp, vp, bt)
    for s, (kl, vl, base) in enumerate(locs):
        got = pa.paged_decode_state_cuda(q, kl, vl, bt, lens_t, base, sc)
        want = pa.paged_decode_state_plain(q, kl, vl, bt, lens_t, base, sc)
        torch.cuda.synchronize()
        err, _, e = _sp_state_check(f"paged_decode_state shard {s}", got, want, tol)
        errs["paged_decode_state"].append(err)
        empty += e
        # The shard's live keys per row, gathered contiguous for the SDPA yardstick.
        rows = []
        for b, r in enumerate(reqs):
            pos = [i * ps + j for i, page in enumerate(r.page_ids) if base <= page < base + P_loc
                   for j in range(min(ps, ctxs[b] - i * ps))]
            rows.append(pos)
        owned_keys.append(sum(len(p) for p in rows))
        kmax = max(len(p) for p in rows)
        kd = torch.zeros((len(ctxs), Hkv, kmax, D), dtype=torch.bfloat16, device=dev)
        vd = torch.zeros_like(kd)
        kpos = torch.full((len(ctxs), kmax), SP_MAX_SEQ, dtype=torch.long, device=dev)
        for b, pos in enumerate(rows):
            idx = torch.tensor(pos, dtype=torch.long, device=dev)
            kd[b, :, : len(pos)], vd[b, :, : len(pos)] = kg[b, :, idx], vg[b, :, idx]
            kpos[b, : len(pos)] = idx
        m = (torch.arange(kmax, device=dev)[None, :]
             < torch.tensor([len(p) for p in rows], device=dev)[:, None])[:, None, None]
        live = want[2][:, 0, 0] > 0
        lib_out = sdpa(q, kd, vd, attn_mask=m, scale=sc, enable_gqa=True)
        check(max_err(lib_out[live], want[0][live]) <= tol, f"SDPA yardstick shard {s} differs")
        libs.append((kd, vd, m, kpos))
    del kg, vg
    kern = graph_ms(lambda: [pa.paged_decode_state_cuda(q, kl, vl, bt, lens_t, base, sc)
                             for kl, vl, base in locs]) / n
    plain = event_ms(lambda: pa.paged_decode_state_plain(q, locs[0][0], locs[0][1], bt, lens_t,
                                                         0, sc), reps=2)
    lib = graph_ms(lambda: [sdpa(q, kd, vd, attn_mask=m, scale=sc, enable_gqa=True)
                            for kd, vd, m, _ in libs]) / n
    whole = pa.paged_decode_cuda(q, kp, vp, bt, lens_t, sc)
    sp_err = max_err(sp.paged(q, kp, vp, bt, lens_t, sc), whole)
    check(sp_err <= tol, f"SP paged against the paged decode kernel: {sp_err}")
    sp_ms = graph_ms(lambda: sp.paged(q, kp, vp, bt, lens_t, sc))
    row12_ms = graph_ms(lambda: pa.paged_decode_cuda(q, kp, vp, bt, lens_t, sc))
    B = len(ctxs)
    per = pa.decode_state_split(B, Hkv, width, ps, _sms())
    splits = f"{-(-width // per)} splits of {per} table entries"
    bms, by = bound(sum(owned_keys) / n * Hkv * D * 2 * 2 + B * Hq * D * 2 * 2 + B * Hq * 4 * 2,
                    sum(owned_keys) / n * 4 * Hq * D)
    case = {"kernel": "paged_decode_state", "tpu_kernel": pa.TPU_KERNEL_DECODE_STATE,
            "shape": f"B={B} L=1 contexts={ctxs} pool={SP_PAGES}x{ps} striped over {n} shards "
                     f"(P_loc={P_loc}) width={width} Hq={Hq} Hkv={Hkv} D={D}, {splits}; mean of "
                     f"the {n} shards' launches",
            "max_err": max(errs["paged_decode_state"]), "tol": tol, "kernel_ms": kern,
            "plain_ms": plain, "library_ms": lib,
            "library": "SDPA over the shard's live keys gathered contiguous (mean of shards)",
            "bound_ms": bms, "bound_by": by, "owned_keys_per_shard": owned_keys,
            "empty_shard_rows": empty, "sp_attention_ms": sp_ms, "sp_vs_paged_decode_max_err":
            sp_err, "paged_decode_unsharded_ms": row12_ms}
    cases.append(case)
    contract["paged_decode_state"] = _sp_kernel_entry(
        "paged_decode_state", pa.SOURCE, "tiny_llm_tpu/kernels/paged_attention_pallas.py:583",
        case["shape"], 0.0, kern, plain, lib, bms, by)
    # L = 16 (speculative verification's and a mixed burst's rows; 64 rows
    # a KV head, four m16 tiles) over the same pool.
    # Its SDPA yardstick: each shard's live keys gathered contiguous, each
    # query row masked by the keys' global positions (rows that see no key
    # of a shard are NaN in SDPA: the live rows are compared).
    L16, err16 = 16, 0.0
    q16 = randn(B, Hq, L16, D)
    qpos16 = lens_t[:, None].long() - L16 + torch.arange(L16, device=dev)[None, :]
    masks16 = [(kpos[:, None, :] <= qpos16[:, :, None])[:, None] for _, _, _, kpos in libs]
    for s, (kl, vl, base) in enumerate(locs):
        got = pa.paged_decode_state_cuda(q16, kl, vl, bt, lens_t, base, sc)
        want = pa.paged_decode_state_plain(q16, kl, vl, bt, lens_t, base, sc)
        torch.cuda.synchronize()
        err16 = max(err16, _sp_state_check(f"paged_decode_state L={L16} shard {s}", got, want,
                                           tol)[0])
        kd, vd = libs[s][:2]
        live = want[2] > 0
        lib_out = sdpa(q16, kd, vd, attn_mask=masks16[s], scale=sc, enable_gqa=True)
        check(max_err(lib_out[live], want[0][live]) <= tol,
              f"SDPA yardstick L={L16} shard {s} differs")
    errs["paged_decode_state"].append(err16)
    kern16 = graph_ms(lambda: [pa.paged_decode_state_cuda(q16, kl, vl, bt, lens_t, base, sc)
                               for kl, vl, base in locs]) / n
    plain16 = event_ms(lambda: pa.paged_decode_state_plain(q16, locs[0][0], locs[0][1], bt,
                                                           lens_t, 0, sc), reps=1)
    lib16 = graph_ms(lambda: [sdpa(q16, kd, vd, attn_mask=m16, scale=sc, enable_gqa=True)
                              for (kd, vd, _, _), m16 in zip(libs, masks16)]) / n
    del libs, masks16
    bms16, by16 = bound(sum(owned_keys) / n * Hkv * D * 2 * 2 + B * Hq * L16 * (D * 2 * 2 + 8),
                        sum(owned_keys) / n * 4 * Hq * L16 * D)
    cases.append({"kernel": "paged_decode_state", "tpu_kernel": pa.TPU_KERNEL_DECODE_STATE,
                  "shape": case["shape"].replace("L=1 ", f"L={L16} "),
                  "max_err": err16, "tol": tol, "kernel_ms": kern16,
                  "plain_ms": plain16, "library_ms": lib16,
                  "library": "SDPA over the shard's live keys gathered contiguous, masked by "
                             "their global positions (mean of shards)",
                  "bound_ms": bms16, "bound_by": by16})
    del q16
    for r in reqs:
        r.release()
    del pool, kp, vp, locs

    # Row 7 at virtual lengths: a 1024-token chunk over one 1024-key shard.
    L = LONG_CHUNK
    vlens = [-512, 700, 1024 + 1500]
    q, ks, vs = randn(3, Hq, L, D), randn(3, Hkv, S_loc, D), randn(3, Hkv, S_loc, D)
    lv = torch.tensor(vlens, dtype=torch.int32, device=dev)
    # o per element within _state_tol; the control at lens + 1 changes only
    # the row inside the shard (row 0 sees no key either way, row 2 all).
    fields, want = _chunk_state_check(f"flash_prefill_state at virtual lengths {vlens}", q, ks, vs,
                                      lv, sc)
    check(bool((want[2][2] > 0).all()), "past the shard, a row saw no key")
    kern = graph_ms(lambda: ka.flash_prefill_state_cuda(q, ks, vs, lv, sc))
    plain = event_ms(lambda: ka.flash_prefill_state_plain(q, ks, vs, lv, sc), reps=1)
    # Library: SDPA over the shard's keys, query i of row b seeing the keys
    # at or before its virtual position vlens[b] - L + i (the mask built
    # outside the timing); compared where the row sees a key.
    qpos = lv[:, None] - L + torch.arange(L, device=dev)[None, :]  # [3, L]
    vmask = (torch.arange(S_loc, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
    live = want[2] > 0

    def lib_fn():
        return sdpa(q, ks, vs, attn_mask=vmask, scale=sc, enable_gqa=True)

    check(max_err(lib_fn()[live], want[0][live]) <= tol, "SDPA yardstick at virtual lens differs")
    lib = graph_ms(lib_fn)
    pairs = sum(min(max(t - L + i + 1, 0), S_loc) for t in vlens for i in range(L))
    bms, by = bound(3 * (2 * Hq * L * D * 2 + 2 * Hkv * S_loc * D * 2 + 2 * Hq * L * 4),
                    4 * Hq * pairs * D)
    cases.append({"kernel": "flash_prefill_state", "tpu_kernel": ka.TPU_KERNEL_STATE,
                  "shape": f"B=3 L={L} S_loc={S_loc} virtual lens={vlens} Hq={Hq} Hkv={Hkv} D={D}",
                  **fields, "kernel_ms": kern, "plain_ms": plain,
                  "library_ms": lib, "library": "SDPA over the shard's keys, virtual-length "
                  "boolean mask", "bound_ms": bms, "bound_by": by})
    del q, ks, vs
    torch.cuda.empty_cache()
    for name, e in errs.items():
        contract[name]["max_abs_err"] = max(e)
    emit({"phase": "sp_kernels", "shards": n, "cases": cases})


def phase_sp_parity(cfg):
    """4 layers at the 4B widths, teacher-forced (the SP plain path's tokens):
    the SP kernel path against the SP plain path, and SP against unsharded
    attention (the model with no attention strategy), dense and paged.
    Dense, max_seq 2048 (S_loc 256): a 1500-token prompt in chunks of 1024
    and 476 (row 7 per shard), 8 decode steps (row 6 per shard). Paged, a
    32-page pool striped over the shards: request 0 in chunks of 1024
    (offset 0: row 7 per shard on the chunk's own k/v), 468 (the paged
    prefill kernel over the pool) and 8 (row 14 per shard, L = 8), request
    1 in 256 and 12, then 8 decode steps of both in a 3-slot batching cache
    beside an idle slot (row 14); only installed rows are compared."""
    from tiny_llm_tpu_torch import kernels
    from tiny_llm_tpu_torch.kv import PagePool
    from tiny_llm_tpu_torch.models import Qwen3Model, synthetic_quantized_params

    cfg4 = dataclasses.replace(cfg, num_hidden_layers=4)
    params = synthetic_quantized_params(cfg4, seed=6)
    max_seq, keep = 2048, 8
    fast, plain, whole = (Qwen3Model(params, cfg4, max_seq_len=max_seq, impl=impl, attn_impl=a)
                          for impl, a in ((None, _sp()), ("torch", _sp("torch")), (None, None)))
    rng = np.random.default_rng(6)
    tallies = {"kernel_vs_plain": {"worst": 0.0, "decided": 0, "agree": 0},
               "sp_vs_unsharded": {"worst": 0.0, "decided": 0, "agree": 0}}

    def compare(lf, lp, lw, what):
        _parity_check(lf, lp, f"{what}: SP kernel against SP plain", tallies["kernel_vs_plain"])
        _parity_check(lf, lw, f"{what}: SP against unsharded", tallies["sp_vs_unsharded"])

    kernels.reset_launches()
    prompt = rng.integers(0, cfg.vocab_size, size=(1, 1500))
    caches = [m.create_kv_cache() for m in (fast, plain, whole)]
    off = 0
    for L in (1024, 476):
        out = [m(prompt[:, off : off + L], off, c, logits_to_keep=keep)
               for m, c in zip((fast, plain, whole), caches)]
        compare(*out, f"dense chunk L={L} at {off}")
        off += L
    for step in range(8):
        tok = [[int(out[1][0, -1].float().argmax())]]
        out = [m(tok, off, c) for m, c in zip((fast, plain, whole), caches)]
        compare(*out, f"dense decode step {step}")
        off += 1
    for c in caches:
        c.release()
    dense_counts = kernels.launches()

    kernels.reset_launches()
    dims = (4, 32, cfg.num_key_value_heads, PAGE_SIZE, cfg.head_dim)
    for m in (fast, plain, whole):
        m.enable_paged_attention(num_pages=32, page_size=PAGE_SIZE)
    for m in (fast, plain):
        m.page_pool = PagePool(*dims, device=m.device, stripe_shards=SP_SHARDS)
    prompts = [rng.integers(0, cfg.vocab_size, size=(1, 1500)),
               rng.integers(0, cfg.vocab_size, size=(1, 268))]
    reqs = [[m.create_kv_cache() for m in (fast, plain, whole)] for _ in prompts]
    last = []
    for r, chunks in enumerate(((1024, 468, 8), (256, 12))):
        off = 0
        for L in chunks:
            out = [m(prompts[r][:, off : off + L], off, c, logits_to_keep=keep)
                   for m, c in zip((fast, plain, whole), reqs[r])]
            compare(*out, f"request {r} chunk L={L} at {off}")
            off += L
        last.append(int(out[1][0, -1].float().argmax()))
    check(reqs[0][0].page_ids != reqs[0][2].page_ids, "the striped pool did not stripe")
    batches = [m.create_batching_kv_cache(3) for m in (fast, plain, whole)]
    for r in range(2):
        for b, c in zip(batches, reqs[r]):
            b.add_request(c, r)
    for step in range(8):
        toks = [[t] for t in last] + [[0]]  # slot 2 idle
        out = [m(toks, None, b, logits_to_keep=1) for m, b in zip((fast, plain, whole), batches)]
        compare(*(o[:2] for o in out), f"paged decode step {step}")
        last = out[1][:2, -1].float().argmax(-1).tolist()
    for b in batches:
        b.release()
    check(all(m.page_pool.live_pages == 0 for m in (fast, plain, whole)), "pages leaked")
    paged_counts = kernels.launches()
    for name, counts in (("flash_prefill_state", dense_counts),
                         ("flash_decode_state", dense_counts),
                         ("flash_prefill_state", paged_counts), ("paged_prefill", paged_counts),
                         ("paged_decode_state", paged_counts)):
        check(counts[name] > 0, f"{name} never launched in sp_parity")
    for t in tallies.values():
        check(t["agree"] == t["decided"], f"top-1 disagrees on a decided position: {tallies}")
    emit({"phase": "sp_parity", "layers": 4, "shards": SP_SHARDS, "max_seq": max_seq,
          "dense": "1500 tokens in chunks of 1024 and 476, 8 decode steps",
          "paged": "requests of 1500 (chunks 1024, 468, 8) and 268 (256, 12), 8 decode steps, "
                   "32-page pool striped",
          "tol": "5% of max |reference logit|", **tallies,
          "launches_dense": {k: v for k, v in dense_counts.items() if v},
          "launches_paged": {k: v for k, v in paged_counts.items() if v}})


def _sp_run(model, prompt, bursts=2):
    """Prefill `prompt` in SP_CHUNK-token chunks into a dense cache, then
    `bursts` greedy BURST-step bursts: (prefill s, decode s, tokens)."""
    cache = model.create_kv_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for off in range(0, prompt.shape[1], SP_CHUNK):
        logits = model(prompt[:, off : off + SP_CHUNK], off, cache, logits_to_keep=1)
    tok = logits[:, -1].float().argmax(-1).cpu().numpy()
    pre_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits.float()).all()), "non-finite SP prefill logits")
    check(tuple(logits.shape) == (1, 1, model.vocab_size), "SP prefill logits shape")
    toks = [tok]
    t0 = time.perf_counter()
    for _ in range(bursts):
        out = model.decode_burst_dense(cache, tok, BURST)
        toks.extend(out)
        tok = out[-1]
    dec_s = time.perf_counter() - t0
    cache.release()
    return pre_s, dec_s, np.stack(toks)


def phase_sp_model(sp, whole, cfg):
    """Dense SP at full width and depth (Qwen3-4B, max_seq SP_MAX_SEQ over
    SP_SHARDS shards): an SP_PROMPT-token prompt in SP_CHUNK-token chunks
    (row 7 per shard at virtual lengths) and two BURST-step greedy bursts
    (row 6 per shard; shards 6 and 7 hold none of the context), taken in
    turns with the same runs on the unsharded model of the same weights
    (A B B A), with exact launch counts over the SP runs; then B = 4 at
    prompts of SP_BATCH_PROMPTS tokens (each prefilled alone, then BURST
    batched steps over a batching cache), a device profile of one SP burst
    after the whole prompt as one chunk, and one SP burst under sync-debug
    "error"."""
    from tiny_llm_tpu_torch import kernels
    from tiny_llm_tpu_torch.models.qwen3 import forward_decode_burst_dense

    torch.cuda.reset_peak_memory_stats()
    Ly = cfg.num_hidden_layers
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, SP_PROMPT))
    k1 = _path_launches(cfg)[1]["quant_matmul"]
    per_step = dict.fromkeys(kernels.KERNELS, 0)
    per_step.update(quant_matmul=k1, flash_decode_state=SP_SHARDS * Ly)
    per_chunk = dict.fromkeys(kernels.KERNELS, 0)
    per_chunk.update(quant_matmul=k1, flash_prefill_state=SP_SHARDS * Ly)
    n_chunks = -(-SP_PROMPT // SP_CHUNK)
    _sp_run(sp, prompt[:, :SP_CHUNK], bursts=1)  # warm-up
    _sp_run(whole, prompt[:, :SP_CHUNK], bursts=1)
    got = {"sp": [], "unsharded": []}
    counts = collections.Counter()
    for name in ("sp", "unsharded", "unsharded", "sp"):
        kernels.reset_launches()
        got[name].append(_sp_run(sp if name == "sp" else whole, prompt))
        if name == "sp":
            counts.update(kernels.launches())
    expected = {k: 2 * (n_chunks * per_chunk[k] + 2 * BURST * per_step[k]) for k in per_step}
    check({k: counts[k] for k in expected} == expected,
          f"SP launch counts {dict(counts)} != expected {expected}")
    toks = [r[2] for r in got["sp"]]
    check(np.array_equal(toks[0], toks[1]), "the SP runs' tokens differ")
    check(bool(((toks[0] >= 0) & (toks[0] < cfg.vocab_size)).all()), "token out of range")
    agree = float((toks[0] == got["unsharded"][0][2]).mean())

    def rates(runs):
        return ({"prefill_tok_s": float(np.median([SP_PROMPT / r[0] for r in runs])),
                 "decode_tok_s": float(np.median([2 * BURST / r[1] for r in runs]))})

    # B = 4 at lengths crossing the shards: each prefilled alone, then batched steps.
    batch = sp.create_batching_kv_cache(len(SP_BATCH_PROMPTS))
    first = []
    for slot, n_tok in enumerate(SP_BATCH_PROMPTS):
        c = sp.create_kv_cache()
        lg = sp(rng.integers(0, cfg.vocab_size, size=(1, n_tok)), 0, c, logits_to_keep=1)
        first.append(int(lg[0, -1].float().argmax()))
        batch.add_request(c, slot)
        c.release()
    toks_b = torch.tensor(first, device=sp.device)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BURST):
        lg = sp(toks_b[:, None], None, batch, logits_to_keep=1)
        toks_b = lg[:, -1].float().argmax(-1)
    check(bool(torch.isfinite(lg.float()).all()), "non-finite B = 4 SP logits")
    b4_s = time.perf_counter() - t0
    b4_counts = kernels.launches()
    check(b4_counts == {k: BURST * v for k, v in per_step.items()},
          f"B = 4 SP launch counts {b4_counts}")
    batch.release()
    profile = _profile_burst(sp, prompt)  # one burst at the prompt's full context
    # One burst under sync-debug "error" at the prompt's full context.
    cache = sp.create_kv_cache()
    for off in range(0, SP_PROMPT, SP_CHUNK):
        tok = sp(prompt[:, off : off + SP_CHUNK], off, cache, logits_to_keep=1)
    tok = tok[:, -1].float().argmax(-1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = forward_decode_burst_dense(sp.params, sp.cfg, sp._rope_tables, tok, cache.offset,
                                         cache.keys, cache.values, steps=BURST,
                                         attn_impl=sp.attn_impl)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(tuple(out.cpu().shape) == (BURST, 1), "sync-free SP burst shape")
    cache.release()
    emit({"phase": "sp_model", "model": "qwen3-4b", "layers": Ly, "shards": SP_SHARDS,
          "max_seq": SP_MAX_SEQ, "s_loc": SP_MAX_SEQ // SP_SHARDS, "prompt_len": SP_PROMPT,
          "prefill_chunk": SP_CHUNK, "decode_steps": 2 * BURST, "sp": rates(got["sp"]),
          "unsharded_in_turns": rates(got["unsharded"]), "order": "ABBA",
          "sp_unsharded_token_agreement": agree,
          "sp_decode_tok_s_all": [2 * BURST / r[1] for r in got["sp"]],
          "launches_2_runs": {k: v for k, v in counts.items() if v},
          "launches_per_decode_step": {k: v for k, v in per_step.items() if v},
          "launches_per_prefill_chunk": {k: v for k, v in per_chunk.items() if v},
          "b4_prompts": list(SP_BATCH_PROMPTS), "b4_decode_tok_s": len(first) * BURST / b4_s,
          "b4_launches": {k: v for k, v in b4_counts.items() if v}, "decode_profile": profile,
          "sync_free_burst": {"steps": BURST, "mode": "error", "host_syncs_in_burst": 0},
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return {k: counts.get(k, 0) for k in kernels.KERNELS}


def phase_sp_serving(sp, cfg):
    """long_serving's prompts (LONG_REQUESTS of LONG_MIN_PROMPT..LONG_PROMPT
    tokens) through batch_generate on the SP model over a page pool of
    SP_PAGES striped over SP_SHARDS shards (batch 4, prefill step 1024): a
    warm-up and one campaign. Decode steps and chunks of <= 16 tokens run
    row 14 per shard; first chunks row 7 per shard on their own k/v; later
    chunks the paged prefill kernel over the pool."""
    from tiny_llm_tpu_torch.kv import PagePool

    torch.cuda.reset_peak_memory_stats()
    sp.enable_paged_attention(num_pages=SP_SHARDS, page_size=PAGE_SIZE)  # the width; pool below
    sp.page_pool = PagePool(cfg.num_hidden_layers, SP_PAGES, cfg.num_key_value_heads, PAGE_SIZE,
                            cfg.head_dim, device=sp.device, stripe_shards=SP_SHARDS)
    rng = np.random.default_rng(0)
    lens = rng.integers(LONG_MIN_PROMPT, LONG_PROMPT + 1, size=LONG_REQUESTS)
    max_out = int(rng.integers(32, 129, size=LONG_REQUESTS).mean())
    kw = dict(max_seq_len=SP_MAX_SEQ, batch_size=SERVING_BATCH, prefill_step=LONG_CHUNK,
              decode_burst=BURST)
    rows, counts = _campaigns(sp, cfg, lens, max_out, kw, ["x" * (LONG_MIN_PROMPT + 1)], 1)
    for kern in ("quant_matmul", "paged_decode_state", "flash_prefill_state", "paged_prefill"):
        check(counts[kern] > 0, f"{kern} never launched on the SP serving path")
    for kern in ("fused_paged_decode_attention", "paged_decode", "paged_prefix_state",
                 "flash_decode_state"):
        check(counts[kern] == 0, f"{kern} ran on the SP serving path")
    r = rows[0]
    emit({"phase": "sp_serving", "model": "qwen3-4b", "layers": cfg.num_hidden_layers,
          "shards": SP_SHARDS, "requests": LONG_REQUESTS, "batch": SERVING_BATCH,
          "max_seq": SP_MAX_SEQ, "page_size": PAGE_SIZE, "pool_pages": SP_PAGES,
          "prefill_step": LONG_CHUNK, "decode_burst": BURST, "max_output_tokens": max_out,
          "prompt_lens": lens.tolist(), "prompt_tokens": int(lens.sum()),
          "output_tok_s": r["output_tok_s"], "input_tok_s": int(lens.sum()) / r["wall_s"],
          "ttft_p50_ms": r["ttft_p50_ms"], "ttft_p95_ms": r["ttft_p95_ms"],
          "request_latency_p50_ms": r["request_latency_p50_ms"],
          "mean_batch_occupancy": r["mean_batch_occupancy"], "wall_s": r["wall_s"],
          "launches_1_campaign": {k: v for k, v in counts.items() if v},
          "pool_full_after_the_campaign": True,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return counts


# ---------------------------------------------------------------------------
# The last Pallas rows: explicit-mask attention (row 5), the three-launch
# paged decode (row 8's prep kernel) and the axpby tutorial kernel (row 22).


def _kernel_path(run, name):
    """Launch counts over run(), every count set to 0 just before: `name`
    must have launched and no other kernel. Returns the counts."""
    from tiny_llm_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    run()
    torch.cuda.synchronize()
    counts = kernels.launches()
    check(counts[name] > 0 and not any(n for k, n in counts.items() if k != name),
          f"{name}'s path launched {counts}")
    return counts


def _state_tol(q, k, v, ok, scale, want, bias=None):
    """Per element, how far an attention kernel's o may be from its plain
    version `want` (the same rounding points; ok [B, L, S] marks each row's
    visible keys, `bias` an additive mask): 2 bf16 ulps of the plain value
    (each side's final rounding), plus the drift of the probabilities' bf16
    rounding. A kernel rounds each p against its running max and the plain
    version against the row's max, so each weight w_i = p_i / l may move by
    2^-8 of itself: at most 2^-8 * sum_i w_i |v_i| (attention over |v|);
    where many keys share the weight the moves cancel, about 2^-9 *
    sqrt(sum_i w_i^2 v_i^2) a standard deviation, which is at most
    sqrt(W v^2 / l) (every w_i <= 1 / l): six of those. The smaller of the
    two bounds counts. Scores and sums in another order (SIMT lanes or
    tensor-core fragments) move o by f32 ulps, far inside this."""
    from tiny_llm_tpu_torch.kernels import flash_attention as ka

    vf = v.float()
    over_abs = ka.attention_state_plain(q, k, vf.abs(), ok, scale, bias=bias)[0].float()
    over_sq, _, l = ka.attention_state_plain(q, k, vf * vf, ok, scale, bias=bias)
    spread = torch.sqrt(over_sq.float() / l.clamp(min=1.0)[..., None])
    w = want.float()
    _, e = torch.frexp(w)  # |w| in [2^(e-1), 2^e): one bf16 ulp is 2^(e-8)
    ulps = torch.ldexp(torch.full_like(w, 2.0), e - 8) * (w != 0)
    return ulps + torch.minimum(2.0**-8 * over_abs, 6 * 2.0**-9 * spread)


def _attention_tol(q, k, v, lens, mask, scale, want):
    """_state_tol for the masked kernel: every key below lens[b] visible,
    plus the additive mask."""
    B, _, L, _ = q.shape
    S = k.shape[2]
    ok = (torch.arange(S, device=q.device)[None, :] < lens[:, None].long())[:, None, :]
    return _state_tol(q, k, v, ok.expand(B, L, S), scale, want, bias=mask)


def _over_tol(got, want, tol):
    """Per batch row, max |got - want| / tol (0 where both are equal)."""
    diff = (got.float() - want.float()).abs()
    ratio = torch.where(diff == 0, 0.0, diff / tol)
    return ratio.flatten(1).amax(1).tolist()


# The masked kernel's times on the SIMT tile it ran before the split-key
# and tensor-core walks (PERF.md's kernel table, NVIDIA H100 80GB HBM3 at
# 700 W), by head shape and case letter.
MASK_SIMT_MS = {("qwen3-4b", "a"): 1.0686, ("qwen3-4b", "b"): 0.5626, ("qwen3-4b", "c"): 3.600,
               ("qwen3-4b", "d"): 1.046, ("qwen3-4b", "e"): 0.311, ("qwen3-4b", "g"): 0.0514,
               ("n_rep 8", "a"): 0.859, ("n_rep 8", "b"): 0.729, ("n_rep 8", "c"): 3.531,
               ("n_rep 8", "d"): 1.048}


def phase_mask_kernels(cfg, moe_cfg, contract):
    """The explicit-mask kernel (row 5) against its plain version on the card
    at Qwen3-4B's heads and at n_rep 8 (Qwen3-30B-A3B's): (a) decode, B = 4,
    S = 8192, lens 8192/6000/2500/130, a 4096-key sliding window per row as
    [B, L, S]; (b) decode, B = 2, L = 4, S = 4096, per-head windows and
    bias; (c) prefill, L = S = 2048, a shared block-document mask [L, S]
    (batch stride 0); (d) prefill, L = S = 1024, a per-head causal mask with
    a random bias (128 MB of f32 planes); (e) S = 1000, not a multiple of the
    32-key tile; then, at 4B's heads, (f) fully masked rows (-inf and -1e30),
    which must give exactly 0 and no NaN, and (g) an additive causal mask at
    L = 128 against K3. Each case within a per-element tolerance
    (_attention_tol: 2 bf16 ulps plus the drift the probabilities' bf16
    rounding against a running max allows), and the plain version with the
    mask shifted by one key must miss it in every batch row (a control; not
    for (f), whose rows are all zeros or all hidden). Kernel, plain and SDPA
    times (the same float mask, lengths folded in, enable_gqa) and the bound:
    K/V bytes and QK/PV operations of the keys the length and the mask leave
    visible, the mask's bytes below each length in full; beside them the
    share of (plane, 16-row group, 64-key tile) blocks below the lengths that
    mask_tile_map_plain marks live, and the SIMT tile's time. Then the edges of the
    two designs (_mask_edge_cases) at both head shapes and at n_rep 1 and 2.
    Then the route a user calls, flash_attention(mask=...), with the counts
    set to 0 just before: only the masked kernel launches."""
    from tiny_llm_tpu_torch.kernels import flash_attention as ka

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    inf, lib_tol = float("inf"), 2e-2  # SDPA, a yardstick: its own rounding points
    cases, errs = [], []

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def qkv(B, Hkv, n_rep, L, S, D=128):
        return randn(B, Hkv * n_rep, L, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)

    def visible_from(pos, S, window):
        """f32 [..., S]: 0 for the keys in (pos - window, pos], else -inf."""
        k = torch.arange(S, device=dev)
        ok = (k <= pos[..., None]) & (k > pos[..., None] - window)
        return torch.where(ok, 0.0, -inf)

    def run_case(label, what, q, k, v, lens, mask, shared_plane=False, control=True,
                 profile=False):
        """Hold one case to the tolerance; returns (got, want, case). profile:
        also the device ms of each kernel the entry launches (map and walk,
        or split walk and combine), from torch.profiler over 5 calls."""
        B, Hq, L, D = q.shape
        Hkv, S = k.shape[1], k.shape[2]
        sc = D**-0.5
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        m4 = None if mask is None else ka._mask_planes(mask, B, Hq, L, S, dev)
        got = ka.flash_attention_masked_cuda(q, k, v, lens_t, m4, sc)
        want = ka.flash_attention_masked_plain(q, k, v, lens_t, m4, sc)
        torch.cuda.synchronize()
        tol = _attention_tol(q, k, v, lens_t, m4, sc, want)
        err, rows = max_err(got, want), _over_tol(got, want, tol)
        check(bool(torch.isfinite(got.float()).all()), f"masked {label} {what}: not finite")
        check(max(rows) <= 1, f"masked {label} {what}: {err}, {rows} of the tolerance")
        errs.append(err)
        # The control: the plain version with the mask shifted by one key
        # (each row sees the key before each of its own instead) must miss
        # the same tolerance in every batch row, or the check could not tell
        # an off-by-one mask, even among a 4096-key window.
        ctl = None
        if control:
            shifted = ka._mask_planes(torch.roll(mask, -1, dims=-1), B, Hq, L, S, dev)
            ctl = _over_tol(got, ka.flash_attention_masked_plain(q, k, v, lens_t, shifted, sc),
                            tol)
            check(min(ctl) > 1, f"masked {label} {what}: the shifted-mask control passed {ctl}")
        # The mask SDPA takes: the lengths folded in, hidden keys at -1e30
        # rather than -inf (the same probabilities, 0), in q's dtype. Given
        # the f32 mask with bf16 q, SDPA's default route on the H100 gives
        # rows far off the plain version (recorded as library_f32_mask_err).
        below = torch.arange(S, device=dev)[None, :] < lens_t[:, None]  # [B, S]
        full = torch.where(below[:, None, None, :], 0.0 if m4 is None else m4, ka.NEG_INF)
        full = full.clamp(min=ka.NEG_INF)
        # The pairs (query row, key) the length and the mask leave visible,
        # per head, and per KV head the keys any of its rows sees: the work
        # the function needs (a hidden key's K/V need not be read).
        vis = (full > ka.NEG_INF).expand(B, full.shape[1], L, S)
        seen = vis.any(-1).expand(B, Hq, L)
        if vis.shape[1] == 1:
            pairs, kv_keys = int(vis.sum()) * Hq, int(vis.any(2).sum()) * Hkv
        else:
            pairs = int(vis.sum())
            kv_keys = int(vis.reshape(B, Hkv, Hq // Hkv, L, S).any(3).any(2).sum())
        f32_err = max_err(sdpa(q, k, v, attn_mask=full, scale=sc, enable_gqa=True)[seen],
                          want[seen])
        full = full.to(q.dtype)
        check(not bool(got[~seen].any()), f"masked {label} {what}: a row with no key is not 0")

        def lib_fn():
            return sdpa(q, k, v, attn_mask=full, scale=sc, enable_gqa=True)

        lib_err = max_err(lib_fn()[seen], want[seen])
        check(lib_err <= lib_tol, f"SDPA yardstick {label} {what} differs: {lib_err}")
        kern = graph_ms(lambda: ka.flash_attention_masked_cuda(q, k, v, lens_t, m4, sc))
        plain = event_ms(lambda: ka.flash_attention_masked_plain(q, k, v, lens_t, m4, sc), reps=1)
        lib = graph_ms(lib_fn)
        # The mask's bytes: each plane's entries below each row's length,
        # all read (the kernel cannot know a hidden entry without reading it).
        keys = [min(t, S) for t in lens]
        if m4 is None:
            mask_bytes = 0
        elif shared_plane:  # one [L, S] plane for the whole batch
            mask_bytes = L * max(keys) * 4
        else:
            mask_bytes = m4.shape[1] * sum(L * t * 4 for t in keys)
        bms, by = bound(2 * kv_keys * D * 2 + 2 * B * Hq * L * D * 2 + mask_bytes,
                        4 * pairs * D)
        case = {"kernel": "flash_attention_masked",
                "tpu_kernel": ka.TPU_KERNEL_MASKED_SHORT if L <= ka.DECODE_MAX_L
                else ka.TPU_KERNEL_MASKED,
                "shape": f"{what}: B={B} L={L} S={S} lens={lens} Hq={Hq} Hkv={Hkv} D={D}, mask "
                         + ("none" if m4 is None else f"{tuple(mask.shape)} {mask.dtype}"),
                "head_shape": label, "max_err": err, "err_over_tol_per_batch_row": rows,
                "tol": TOL_ATTENTION, "control_err_over_tol_per_batch_row": ctl,
                "kernel_ms": kern, "plain_ms": plain, "library_ms": lib,
                "library": "SDPA, the same mask in bf16 with the lengths folded in, enable_gqa",
                "library_max_err": lib_err, "library_tol": lib_tol,
                "library_f32_mask_err": f32_err,
                "bound_ms": bms, "bound_by": by, "visible_pairs_all_heads": pairs,
                "kv_keys_read": kv_keys, "mask_bytes": mask_bytes,
                "rows_with_no_key": int((~seen).sum()),
                "live_tile_share": _live_share(m4, lens_t, S),
                "simt_tile_kernel_ms": MASK_SIMT_MS.get((label.split(" (")[0], what[1])),
                "decode_chunk": (ka.decode_chunk(B, Hkv, S, _sms())
                                 if L <= ka.DECODE_MAX_L else None)}
        if profile:
            def five():
                for _ in range(5):
                    ka.flash_attention_masked_cuda(q, k, v, lens_t, m4, sc)

            case["device_ms_by_kernel"] = _device_profile(five, 5)["top_kernels_ms_per_step"]
        cases.append(case)
        return got, want, case

    shapes = [("qwen3-4b", cfg.num_key_value_heads,
               cfg.num_attention_heads // cfg.num_key_value_heads),
              ("n_rep 8 (qwen3-30b-a3b)", moe_cfg.num_key_value_heads,
               moe_cfg.num_attention_heads // moe_cfg.num_key_value_heads)]
    path = []  # (q, k, v, lens, mask) of the cases the path run repeats
    for label, Hkv, n_rep in shapes:
        Hq = Hkv * n_rep
        # (a) decode, per-row 4096-key sliding windows as [B, L, S].
        lens = [8192, 6000, 2500, 130]
        q, k, v = qkv(4, Hkv, n_rep, 1, 8192)
        pos = torch.tensor(lens, device=dev)[:, None] - 1  # [B, L]: every row at lens - 1
        mask = visible_from(pos, 8192, 4096)
        _, _, case = run_case(label, "(a) decode, sliding window 4096", q, k, v, lens, mask,
                              profile=True)
        if label == "qwen3-4b":
            contract["flash_attention_masked"] = {
                "name": "flash_attention_masked", "route": "cuda", "source": ka.SOURCE_MASKED,
                "replaces": "tiny_llm_tpu/kernels/flash_attention_pallas.py:133",
                "case": case["shape"], "ms": case["kernel_ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
                "library_ms": case["library_ms"]}
            path.append((q, k, v, lens, mask))
        # (b) decode, L = 4, per-head windows plus a random bias [B, Hq, L, S].
        lens = [4096, 3000]
        q, k, v = qkv(2, Hkv, n_rep, 4, 4096)
        pos = torch.tensor(lens, device=dev)[:, None] - 4 + torch.arange(4, device=dev)
        w = 256 * (1 + torch.arange(Hq, device=dev))[None, :, None, None]
        kk = torch.arange(4096, device=dev)
        ok = (kk <= pos[:, None, :, None]) & (kk > pos[:, None, :, None] - w)
        mask = torch.where(ok, 0.5 * torch.randn((2, Hq, 4, 4096), generator=gen, device=dev),
                           -inf)
        run_case(label, "(b) decode L=4, per-head windows + bias", q, k, v, lens, mask,
                 profile=True)
        if label == "qwen3-4b":
            path.append((q, k, v, lens, mask))
        # (c) prefill, a shared block-document mask [L, S] (three documents).
        L = 2048
        q, k, v = qkv(1, Hkv, n_rep, L, L)
        doc = torch.bucketize(torch.arange(L, device=dev), torch.tensor([512, 1212], device=dev),
                              right=True)
        i = torch.arange(L, device=dev)
        mask = torch.where((doc[:, None] == doc[None, :]) & (i[None, :] <= i[:, None]), 0.0, -inf)
        run_case(label, "(c) prefill, shared document mask", q, k, v, [L], mask,
                 shared_plane=True, profile=True)
        if label == "qwen3-4b":
            path.append((q, k, v, [L], mask))
        # (d) prefill, a per-head causal mask with a random bias [1, Hq, L, S].
        L = 1024
        q, k, v = qkv(1, Hkv, n_rep, L, L)
        i = torch.arange(L, device=dev)
        mask = torch.where(i[None, :] <= i[:, None],
                           torch.randn((1, Hq, L, L), generator=gen, device=dev), -inf)
        run_case(label, "(d) prefill, per-head causal + bias", q, k, v, [L], mask, profile=True)
        if label == "qwen3-4b":
            path.append((q, k, v, [L], mask))
        del mask
        # (e) S = 1000 (not a multiple of the 32-key tile), L = 16, a random bias.
        q, k, v = qkv(2, Hkv, n_rep, 16, 1000)
        mask = torch.randn((2, 16, 1000), generator=gen, device=dev)
        run_case(label, "(e) S=1000, bias", q, k, v, [1000, 777], mask, profile=True)
        torch.cuda.empty_cache()

    Hkv, n_rep = shapes[0][1], shapes[0][2]
    # (f) fully masked rows: row 7 all -inf, row 9 all -1e30.
    q, k, v = qkv(1, Hkv, n_rep, 64, 512)
    mask = torch.zeros((64, 512), device=dev)
    mask[7], mask[9] = -inf, ka.NEG_INF
    got, _, case = run_case("qwen3-4b", "(f) fully masked rows 7 and 9", q, k, v, [512], mask,
                            control=False)  # shifting a row of zeros changes nothing
    check(not bool(got[:, :, [7, 9]].any()) and case["rows_with_no_key"] == 2 * q.shape[1],
          "fully masked rows are not exactly 0")
    # (g) an additive causal mask through the masked kernel against K3.
    q, k, v = qkv(1, Hkv, n_rep, 128, 128)
    i = torch.arange(128, device=dev)
    mask = torch.where(i[None, :] <= i[:, None], 0.0, -inf)
    got, _, case = run_case("qwen3-4b", "(g) additive causal mask, against K3", q, k, v, [128],
                            mask)
    l128 = torch.tensor([128], dtype=torch.int32, device=dev)
    k3 = ka.flash_attention_cuda(q, k, v, l128, 128**-0.5)
    m4 = ka._mask_planes(mask, 1, q.shape[1], 128, 128, dev)
    want = ka.flash_attention_masked_plain(q, k, v, l128, m4, 128**-0.5)
    case["vs_k3_max_err"] = max_err(got, k3)
    # Each kernel within the tolerance of the plain version: twice it apart.
    case["vs_k3_err_over_tol"] = _over_tol(
        got, k3, 2 * _attention_tol(q, k, v, l128, m4, 128**-0.5, want))[0]
    case["k3_ms"] = graph_ms(lambda: ka.flash_attention_cuda(q, k, v, l128, 128**-0.5))
    check(case["vs_k3_err_over_tol"] <= 1, f"masked causal against K3: {case['vs_k3_max_err']}")
    _mask_edge_cases(shapes, qkv, run_case)
    contract["flash_attention_masked"]["max_abs_err"] = max(errs)

    # The route a user calls: flash_attention(mask=...), as given (f32 or
    # [L, S]), and mask=None (no causality), each once.
    def route():
        for q, k, v, lens, mask in path:
            lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            ka.flash_attention(q, k, v, lens_t, mask=mask)
        q, k, v, lens, _ = path[0]
        ka.flash_attention(q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev), mask=None)

    counts = _kernel_path(route, "flash_attention_masked")
    check(counts["flash_attention_masked"] == len(path) + 1, f"masked route launches {counts}")
    del path
    torch.cuda.empty_cache()
    emit({"phase": "mask_kernels", "cases": cases,
          "route_launches": {"flash_attention_masked": counts["flash_attention_masked"]}})
    return counts


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def _live_share(m4, lens, S):
    """The share of (plane, 16-row group, 64-key tile) blocks below each
    batch row's length that mask_tile_map_plain marks live (None: no mask)."""
    from tiny_llm_tpu_torch.kernels import flash_attention as ka

    if m4 is None:
        return None
    live = ka.mask_tile_map_plain(m4, lens)
    tiles = (torch.clamp(lens.long(), 0, S) + ka.MAP_KEYS - 1) // ka.MAP_KEYS  # [B]
    below = torch.arange(live.shape[-1], device=live.device)[None, :] < tiles[:, None]
    return float(live.sum()) / max(1, int(below.sum()) * live.shape[1] * live.shape[2])


def _mask_edge_cases(shapes, qkv, run_case):
    """The masked kernel at the edges of its two designs, at both models'
    heads and at n_rep 1 and 2 (8 KV heads), each case held by run_case:
    (h) decode L = 16, D = 128, B = 3, S = 2048: one row's window per query
    position, with edges on keys 63 / 64 / 65 and on the decode split's
    chunk boundary (c - 1 / c / c + 1), batch row 2 at a length of 40; (i)
    the same windows at L = 17, the first row of the tensor-core walk; (j)
    decode L = 1, D = 64, per-head windows, head 0's row at -1e29 everywhere
    (every key below the length visible at equal scores: the uniform
    average) and head 1's mixing -inf and -1e30 (hidden: exactly 0); (k)
    prefill L = 64, D = 64, per-head, the same special rows. Every V row no
    query of its KV head may see holds 1e15: a skipped or partly hidden
    tile that leaked would show at once."""
    from tiny_llm_tpu_torch.kernels import flash_attention as ka

    dev = torch.device("cuda")
    inf, big = float("inf"), 1e15
    heads = [(label, Hkv, n_rep) for label, Hkv, n_rep in shapes] + [
        ("n_rep 1", 8, 1), ("n_rep 2", 8, 2)]

    def hide_v(v, mask, lens, n_rep):
        """Fill the V rows no query row of their KV head sees with `big`."""
        B, Hkv, S, _ = v.shape
        m4 = ka._mask_planes(mask, B, Hkv * n_rep, mask.shape[-2], S, dev)
        below = torch.arange(S, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        seen = (m4 > ka.NEG_INF) & below[:, None, None, :]
        seen = seen.expand(B, Hkv * n_rep, *seen.shape[2:]).reshape(B, Hkv, n_rep, -1, S)
        v = v.clone()
        v[~seen.any(3).any(2)] = big
        return v

    def windows(L, S, c, short):
        """[3, L, S]: query row i of batch row b sees keys lo .. hi."""
        edges = [(0, 63), (64, 128), (65, c + 63), (63, c), (c, c + 64), (c + 1, S - 1),
                 (c - 1, c + 1), (129, 191)]
        lo = torch.tensor([edges[i % 8][0] for i in range(L)], device=dev)
        hi = torch.tensor([edges[i % 8][1] for i in range(L)], device=dev)
        k = torch.arange(S, device=dev)
        rows = (k >= lo[:, None]) & (k <= hi[:, None])
        near = (k >= (torch.arange(L, device=dev) % short)[:, None]) & (k < short)
        ok = torch.stack([rows, rows.flip(0), near])
        return torch.where(ok, 0.0, -inf)

    def special(B, Hq, L, S, lens):
        """[B, Hq, L, S] per-head windows with a bias; head 0's row 0 at
        -1e29, head 1's row 0 alternating -inf and -1e30."""
        k = torch.arange(S, device=dev)
        w = 64 * (1 + torch.arange(Hq, device=dev))[None, :, None, None]
        pos = torch.tensor(lens, device=dev)[:, None, None, None] - 1
        ok = (k <= pos) & (k > pos - w - torch.arange(L, device=dev)[None, None, :, None])
        m = torch.where(ok, 0.3 * torch.randn((B, Hq, L, S), device=dev), -inf)
        m[:, 0, 0] = -1e29
        m[:, 1, 0] = torch.where(k % 2 == 0, -inf, ka.NEG_INF)
        return m

    def check_special(what, got, want, v, lens):
        check(not bool(got[:, 1, 0].any()), f"masked {what}: the -inf / -1e30 row is not 0")
        for b, n in enumerate(lens):
            mean = v[b, 0, :n].float().mean(0)
            check(max_err(want[b, 0, 0], mean) < 2e-2 and bool(got[b, 0, 0].any()),
                  f"masked {what}: the -1e29 row is not the uniform average")

    S = 2048
    for label, Hkv, n_rep in heads:
        short = 40
        c = ka.decode_chunk(3, Hkv, S, _sms())
        lens = [S, 1500, short]
        for L in (16, 17):
            q, k, v = qkv(3, Hkv, n_rep, L, S)
            mask = windows(L, S, c, short)
            run_case(label, f"({'h' if L == 16 else 'i'}) edges L={L}, chunk {c}", q, k,
                     hide_v(v, mask, lens, n_rep), lens, mask)
        lens = [1000, 300]
        for L, letter in ((1, "j"), (64, "k")):
            q, k, v = qkv(2, Hkv, n_rep, L, 1000, D=64)
            mask = special(2, Hkv * n_rep, L, 1000, lens)
            v = hide_v(v, mask, lens, n_rep)
            what = f"({letter}) D=64 L={L}, -1e29 and -inf/-1e30 rows"
            got, want, _ = run_case(label, what, q, k, v, lens, mask)
            check_special(what, got, want, v, lens)
    torch.cuda.empty_cache()


def _prep_cases(contract, Ly):
    """The prep kernel (row 8) against its plain version at Qwen3-4B's heads
    (Hkv 8, n_rep 4) and at n_rep 8 (Hkv 4), D = 128: the returning route at
    B = 1 and 4 (q and the k row within 2^-7 of max |plain|, one bf16 ulp:
    rsqrt's last bit may move a rounding; the v row bit-equal), then the
    writing route the three-launch step takes (pages given) over a 16-page
    pool of PAGE_SIZE slots: B = 1 at offset PAGE_SIZE - 1, B = 4 at offsets
    PAGE_SIZE - 1, PAGE_SIZE, PAGE_SIZE + 1 (a page's boundary +-1) beside an
    idle row (its table row -1: the trash page 0): q within 2^-7 of max, the
    written k slots within 2^-7 of max of the plain version's, the written v
    slots bit-equal, every other slot of both pools untouched, one launch a
    call; each timed over Ly layers' pools. The kernel line takes the
    writing route at B = 4, Qwen3-4B's heads."""
    from tiny_llm_tpu_torch import kernels
    from tiny_llm_tpu_torch.kernels import fused_decode_attention as kf
    from tiny_llm_tpu_torch.models.qwen3 import _page_targets
    from tiny_llm_tpu_torch.ops.rope import rope_tables

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    D, eps, pages = 128, 1e-6, 16
    cos_t, sin_t = rope_tables(D, MAX_SEQ, base=1e6, device=dev)
    qw = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
    kw = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(torch.bfloat16)
    cases, worst = [], 0.0
    tol = "2^-7 max|plain| (q, k row); v row bit-equal"
    write_tol = tol + "; every other slot untouched; one launch a call"
    for Hkv, n_rep in ((8, 4), (4, 8)):
        pools = torch.randn((Ly, 2, pages, Hkv, PAGE_SIZE, D), generator=gen, device=dev).to(
            torch.bfloat16)
        for offs, idle in (([700], None), ([100, 700, 37, 999], None), ([PAGE_SIZE - 1], None),
                           ([PAGE_SIZE - 1, PAGE_SIZE, 5, PAGE_SIZE + 1], 2)):
            B, write = len(offs), idle is not None or offs == [PAGE_SIZE - 1]
            qkv = (3 * torch.randn((B, Hkv, n_rep + 2, D), generator=gen, device=dev)).to(
                torch.bfloat16)
            off = torch.tensor(offs, dtype=torch.int32, device=dev)
            args = (qkv, off, cos_t[off.long()], sin_t[off.long()], qw, kw)
            if not write:
                got = kf.fused_qkv_prep_cuda(*args, eps=eps)
                want = kf.fused_qkv_prep_plain(*args, eps=eps)
                torch.cuda.synchronize()
                err = 0.0
                for part, g, w in (("q", got[0], want[0]), ("k row", got[1], want[1])):
                    e = max_err(g, w)
                    check(e <= 2**-7 * float(w.float().abs().max()), f"prep {part} B={B}: {e}")
                    err = max(err, e)
                worst = max(worst, err)
                check(torch.equal(got[2], want[2]), "prep v row not bit-equal")
                kern = graph_ms(lambda: [kf.fused_qkv_prep_cuda(*args, eps=eps)
                                         for _ in range(Ly)]) / Ly
                plain = event_ms(lambda: kf.fused_qkv_prep_plain(*args, eps=eps))
            else:
                table = torch.arange(1, 1 + 2 * B, device=dev, dtype=torch.int32).view(B, 2)
                if idle is not None:
                    table[idle] = -1
                page, slot = _page_targets(table, off.long()[:, None], PAGE_SIZE)
                before = pools[0].clone()
                want_pool = pools[0].clone()
                want = kf.fused_qkv_prep_plain(*args, eps=eps, pages=(
                    want_pool[0], want_pool[1], page, slot))
                kernels.reset_launches()
                got = kf.fused_qkv_prep_cuda(*args, eps=eps, pages=(
                    pools[0, 0], pools[0, 1], page, slot))
                torch.cuda.synchronize()
                check(kernels.launches()["fused_qkv_prep"] == 1, "prep: one launch a call")
                err = max_err(got, want)
                check(err <= 2**-7 * float(want.float().abs().max()), f"prep q B={B}: {err}")
                hit = torch.zeros((pages, PAGE_SIZE), dtype=torch.bool, device=dev)
                hit[page[:, 0], slot[:, 0]] = True
                for what, name in ((0, "k"), (1, "v")):
                    got_p, want_p = pools[0, what].transpose(1, 2), want_pool[what].transpose(1, 2)
                    check(torch.equal(got_p[~hit], before[what].transpose(1, 2)[~hit]),
                          f"prep wrote {name} outside its slots, B={B}")
                    if name == "v":
                        check(torch.equal(got_p[hit], want_p[hit]), "prep v slots not bit-equal")
                    else:
                        k_err = max_err(got_p[hit], want_p[hit])
                        check(k_err <= 2**-7 * float(want_p[hit].float().abs().max()),
                              f"prep k slots B={B}: {k_err}")
                        err = max(err, k_err)
                worst = max(worst, err)
                kern = graph_ms(lambda: [kf.fused_qkv_prep_cuda(*args, eps=eps, pages=(
                    pools[i, 0], pools[i, 1], page, slot)) for i in range(Ly)]) / Ly
                plain = event_ms(lambda: kf.fused_qkv_prep_plain(*args, eps=eps, pages=(
                    want_pool[0], want_pool[1], page, slot)))
            rows = B * Hkv * (n_rep + 2) * D
            # Read the rows, the RoPE rows and the weights; write q, k, v
            # (the pages' slots or the k / v rows).
            bms, by = bound(2 * rows * 2 + B * D * 4 + 2 * D * 2, 12 * rows, FP32_FLOPS)
            shape = f"B={B} offsets={offs} Hkv={Hkv} n_rep={n_rep} D={D}"
            if write:
                shape += (f", writing the pages (page size {PAGE_SIZE}"
                          + (f", row {idle} idle: the trash page)" if idle is not None else ")"))
            case = {"kernel": "fused_qkv_prep", "tpu_kernel": kf.TPU_KERNEL_PREP, "shape": shape,
                    "max_err": err, "tol": write_tol if write else tol, "kernel_ms": kern,
                    "plain_ms": plain, "library_ms": None, "bound_ms": bms, "bound_by": by}
            cases.append(case)
            if (Hkv, B, write) == (8, 4, True):
                contract["fused_qkv_prep"] = {
                    "name": "fused_qkv_prep", "route": "cuda", "source": kf.SOURCE,
                    "replaces": "tiny_llm_tpu/kernels/fused_decode_attention.py:183",
                    "case": case["shape"], "ms": kern, "plain_ms": plain, "bound_ms": bms,
                    "bound_by": by, "library_ms": None}
        del pools
    contract["fused_qkv_prep"]["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return cases


def phase_paged3_parity(cfg, contract):
    """The three-launch paged decode (Qwen3Model(paged_fused_one=False)) at
    the 4B widths, 4 layers, teacher-forced as paged_parity (three requests
    in chunks of 128, 128 and 8, then 8 batched decode steps beside an idle
    slot; installed rows only): the kernel route against its plain route and
    against the fused route, within 5 % of the largest reference logit; the
    exact launches of one decode step (per layer: the prep kernel and the
    paged decode kernel, no fused paged step); one paged burst under
    set_sync_debug_mode("error"); and the prep kernel against its plain
    version (_prep_cases)."""
    from tiny_llm_tpu_torch import kernels
    from tiny_llm_tpu_torch.models import Qwen3Model, synthetic_quantized_params
    from tiny_llm_tpu_torch.models.qwen3 import forward_decode_burst_paged

    cfg4 = dataclasses.replace(cfg, num_hidden_layers=4)
    Ly = cfg4.num_hidden_layers
    params = synthetic_quantized_params(cfg4, seed=2)
    fast, plain, fused = (Qwen3Model(params, cfg4, max_seq_len=MAX_SEQ, impl=impl,
                                     paged_fused_one=one)
                          .enable_paged_attention(num_pages=16, page_size=PAGE_SIZE)
                          for impl, one in ((None, False), ("torch", False), (None, True)))
    models = (fast, plain, fused)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(3, 264))
    caches = [[m.create_kv_cache() for _ in range(3)] for m in models]
    vs_plain = {"worst": 0.0, "decided": 0, "agree": 0}
    vs_fused = {"worst": 0.0, "decided": 0, "agree": 0}
    off, last = 0, [None] * 3
    for L in (128, 128, 8):
        for r in range(3):
            chunk = prompts[r : r + 1, off : off + L]
            lf, lp, lu = (m(chunk, off, c[r]) for m, c in zip(models, caches))
            _parity_check(lf, lp, f"three-launch request {r} chunk L={L} at {off}", vs_plain)
            _parity_check(lf, lu, f"three-launch against fused, request {r} chunk L={L}",
                          vs_fused)
            last[r] = int(lp[0, -1].float().argmax())
        off += L
    batches = [m.create_batching_kv_cache(4) for m in models]
    for b, c in zip(batches, caches):
        for r in range(3):
            b.add_request(c[r], r)
    steps = {}
    for step in range(8):
        toks = [[t] for t in last] + [[0]]  # slot 3 idle
        kernels.reset_launches()
        lf = fast(toks, None, batches[0], logits_to_keep=1)
        torch.cuda.synchronize()
        steps = kernels.launches()
        lp, lu = (m(toks, None, b, logits_to_keep=1) for m, b in zip(models[1:], batches[1:]))
        _parity_check(lf[:3], lp[:3], f"three-launch decode step {step}", vs_plain)
        _parity_check(lf[:3], lu[:3], f"three-launch against fused, decode step {step}", vs_fused)
        last = lp[:3, -1].float().argmax(-1).tolist()  # teacher-forced: the plain route's
    want = {"fused_qkv_prep": Ly, "paged_decode": Ly, "fused_paged_decode_attention": 0,
            "fused_decode_attention": 0}
    check({k: steps[k] for k in want} == want, f"three-launch step launches {steps}")
    for tally, what in ((vs_plain, "plain"), (vs_fused, "fused")):
        check(tally["agree"] == tally["decided"], f"three-launch against {what}: top-1 differs")
    # One more step, profiled: the device's kernels a step (the prep writes
    # the pages: no scatter kernels beside it).
    toks = [[t] for t in last] + [[0]]
    profile = _device_profile(lambda: fast(toks, None, batches[0], logits_to_keep=1), 1, top=12)
    # One paged burst with no host sync inside.
    batch, dev = batches[0], fast.device
    for slot in batch.slots:
        if slot is not None:
            slot.ensure_capacity(slot.offset + BURST)
    args = dict(tokens0=torch.as_tensor(last + [0], device=dev),
                offsets0=torch.as_tensor(batch.offsets, device=dev),
                key_pages=fast.page_pool.key_pages, value_pages=fast.page_pool.value_pages,
                block_table=torch.as_tensor(batch.block_table(fast._paged_width), device=dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = forward_decode_burst_paged(fast.params, cfg4, fast._rope_tables, steps=BURST,
                                         fused_one=False, **args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(tuple(out.cpu().shape) == (BURST, 4), "sync-free three-launch burst shape")
    for b in batches:
        b.release()
    check(all(m.page_pool.live_pages == 0 for m in models), "pages leaked")
    prep = _prep_cases(contract, cfg.num_hidden_layers)
    emit({"phase": "paged3_parity", "path": "paged, paged_fused_one=False", "layers": Ly,
          "requests": 3, "chunks": [128, 128, 8], "decode_steps": 8,
          "vs_plain_worst_err_over_tol": vs_plain["worst"],
          "vs_fused_worst_err_over_tol": vs_fused["worst"], "tol": "5% of max |reference logit|",
          "top1_decided_vs_plain": vs_plain["decided"], "top1_decided_vs_fused":
          vs_fused["decided"], "launches_per_decode_step": {k: steps[k] for k in want},
          "decode_step_profile": profile,
          "sync_free_burst": {"steps": BURST, "mode": "error", "host_syncs_in_burst": 0},
          "prep_cases": prep})


def phase_paged3_serving(m3, cfg, turns):
    """bench.py --mode serving's default campaign through Qwen3-4B with
    paged_fused_one=False (m3) on the fused model's weights: its two
    campaigns were taken in turns with `serving`'s two (three-launch, W4A8,
    fused, twice; `turns` holds both sides),
    each model after its own warm-up: output tok/s and TTFT of both routes,
    the three-launch campaigns' launches (the prep kernel and the paged
    decode kernel, never the fused paged step), and, at full depth, one
    decode step's exact launches (36 prep, 36 paged decode, 145 K1) and one
    burst under set_sync_debug_mode("error")."""
    from tiny_llm_tpu_torch import kernels
    from tiny_llm_tpu_torch.models.qwen3 import forward_decode_burst_paged

    lens, _, _ = _serving_campaign()
    got = {"fused": turns["a_rows"], "three_launch": turns["rows"]}
    counts, counts3 = turns["a_launches"], turns["launches"]
    check(counts["fused_qkv_prep"] == 0 and counts["fused_paged_decode_attention"] > 0,
          f"the fused route's campaigns launched {counts}")
    check(counts3["fused_qkv_prep"] > 0 and counts3["paged_decode"] > 0
          and counts3["fused_paged_decode_attention"] == 0
          and counts3["fused_decode_attention"] == 0,
          f"the three-launch campaigns launched {counts3}")
    fused, three = turns["a_ids"][0], turns["ids"][0]
    same = sum(a == b for r in fused for a, b in zip(fused[r], three[r]))
    total = sum(len(t) for t in fused.values())
    # One decode step at full depth over 4 installed requests, and one burst.
    batch = m3.create_batching_kv_cache(SERVING_BATCH)
    for slot, n in enumerate(lens[:SERVING_BATCH]):
        c = m3.create_kv_cache()
        m3([[ord("x")] * int(n)], 0, c, logits_to_keep=1)
        batch.add_request(c, slot)
    toks = [[ord("x")]] * SERVING_BATCH
    torch.cuda.synchronize()
    kernels.reset_launches()
    m3(toks, None, batch, logits_to_keep=1)
    torch.cuda.synchronize()
    step = kernels.launches()
    L = cfg.num_hidden_layers
    want = {"fused_qkv_prep": L, "paged_decode": L, "fused_paged_decode_attention": 0,
            "quant_matmul": 4 * L + 1}
    check({k: step[k] for k in want} == want, f"three-launch decode step launches {step}")
    for slot in batch.slots:
        slot.ensure_capacity(slot.offset + BURST)
    dev = m3.device
    args = dict(tokens0=torch.full((SERVING_BATCH,), ord("x"), device=dev),
                offsets0=torch.as_tensor(batch.offsets, device=dev),
                key_pages=m3.page_pool.key_pages, value_pages=m3.page_pool.value_pages,
                block_table=torch.as_tensor(batch.block_table(m3._paged_width), device=dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = forward_decode_burst_paged(m3.params, cfg, m3._rope_tables, steps=BURST,
                                         fused_one=False, **args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(tuple(out.cpu().shape) == (BURST, SERVING_BATCH), "sync-free burst shape")
    batch.release()
    check(m3.page_pool.live_pages == 0, "pages leaked")

    def med(name, key):
        return float(np.median([r[key] for r in got[name]]))

    emit({"phase": "paged3_serving", "model": "qwen3-4b", "layers": L,
          "paged_fused_one": False, "requests": SERVING_REQUESTS, "batch": SERVING_BATCH,
          "max_seq": MAX_SEQ, "pool_pages": POOL_PAGES,
          "order": "three-launch, W4A8, fused, three-launch, W4A8, fused "
                   "(serving's campaigns)",
          **{f"{n}_{k}": med(n, k) for n in got for k in
             ("output_tok_s", "ttft_p50_ms", "ttft_p95_ms")},
          **{f"{n}_output_tok_s_all": [r["output_tok_s"] for r in got[n]] for n in got},
          f"three_launch_launches_{len(got['three_launch'])}_campaigns": counts3,
          "launches_per_decode_step_full_depth": {k: step[k] for k in want},
          "output_tokens_equal_to_fused": f"{same} of {total}",
          "sync_free_burst": {"steps": BURST, "mode": "error", "host_syncs_in_burst": 0}})
    return counts3


def phase_axpby(contract):
    """The tutorial kernel (row 22) against its plain version at 8192 x 8192
    in bf16 and f32 (x, y and out: three arrays of 128 MB, then 256 MB),
    alpha 0.1 and beta 0.7 (rounded to the dtype first): bit-equal, since
    both round after every op in the dtype; kernel and plain times and the
    bound (the three arrays' bytes; no PyTorch call computes alpha * x +
    beta * y in one). Then the route a user calls, axpby(), once per dtype,
    with the counts set to 0 just before."""
    from tiny_llm_tpu_torch.kernels import axpby as kx

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    M = N = 8192
    alpha, beta = 0.1, 0.7
    cases, inputs = [], []
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((M, N), generator=gen, device=dev).to(dtype)
        y = torch.randn((M, N), generator=gen, device=dev).to(dtype)
        got, want = kx.axpby_cuda(x, y, alpha, beta), kx.axpby_plain(x, y, alpha, beta)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"axpby {dtype}: not bit-equal ({max_err(got, want)})")
        del got, want
        kern = graph_ms(lambda: kx.axpby_cuda(x, y, alpha, beta))
        plain = event_ms(lambda: kx.axpby_plain(x, y, alpha, beta))
        bms, by = bound(3 * M * N * x.element_size(), 3 * M * N, FP32_FLOPS)
        case = {"kernel": "axpby", "tpu_kernel": kx.TPU_KERNEL,
                "shape": f"{M}x{N} {str(dtype).split('.')[-1]}, alpha {alpha} beta {beta}",
                "max_err": 0.0, "tol": "bit-equal", "kernel_ms": kern, "plain_ms": plain,
                "library_ms": None, "bound_ms": bms, "bound_by": by}
        cases.append(case)
        inputs.append((x, y))
        if dtype == torch.bfloat16:
            contract["axpby"] = {"name": "axpby", "route": "cuda", "source": kx.SOURCE,
                                 "replaces": "tiny_llm_tpu/kernels/axpby.py:38",
                                 "case": case["shape"], "max_abs_err": 0.0, "ms": kern,
                                 "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                                 "library_ms": None}
    counts = _kernel_path(lambda: [kx.axpby(x, y, alpha, beta) for x, y in inputs], "axpby")
    check(counts["axpby"] == 2, f"axpby route launches {counts}")
    del inputs
    torch.cuda.empty_cache()
    emit({"phase": "axpby", "cases": cases, "route_launches": {"axpby": counts["axpby"]}})
    return counts


# ---------------------------------------------------------------------------
# Checkpoint loading, speculative decoding and the CLIs.
# ---------------------------------------------------------------------------

SPEC_PROMPTS = ("hello", "The quick brown fox jumps over the lazy dog.",
                "def fibonacci(n):\n    return n if n < 2 else")
# 16 tokens a stream keep the script inside its time limit (32 until the
# pipeline phases came, 64 before).
SPEC_TOKENS, SPEC_K, SPEC_ROUNDS, SPEC_TURN_TOKENS = 16, 4, 4, 32
# Speculative and greedy streams part only at near-ties of the target's
# bf16 logits: the verify forward (K1's bf16 tile at M = K + 1, K3's walk)
# and a decode step (K1's GEMV, K2) round the same logits in other orders,
# about one ulp apart (random weights give flat logits: top-2 gaps of 0-1
# ulp every few dozen tokens). A divergent token must lie within this many
# ulps of the step's largest logit.
SPEC_TIE_ULPS = 4
# The target as its own draft proposes its own greedy tokens: only those
# near-ties reject, so it must accept at least this share.
SPEC_SELF_ACCEPT = 0.5



def _against_stream(model, what, prompt_ids, got, want):
    """Greedy stream `got` against `want` (both after `prompt_ids`): equal,
    or, from their first divergence on, teacher-forced through `model`'s
    own decode steps, every token the step's argmax or within SPEC_TIE_ULPS
    bf16 ulps of its largest logit (a near-tie, which two routes of other
    chunk shapes, and so of other rounding orders, may resolve either
    way). Returns the record of the comparison."""
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    check(len(got) == len(want), f"{what}: {len(got)} tokens, the other stream {len(want)}")
    rec = {"equal": first is None, "first_divergence": first}
    if first is None:
        return rec
    cache = model.create_kv_cache()
    logits = model([prompt_ids + got[:first]], 0, cache, logits_to_keep=1)
    ties, gaps = 0, []
    for i in range(first, len(got)):
        row = logits[0, -1].float()
        mx = float(row.max())
        ulp = 2.0 ** (int(np.floor(np.log2(abs(mx)))) - 7)
        gap = mx - float(row[got[i]])
        check(gap <= SPEC_TIE_ULPS * ulp,
              f"{what}: token {i} ({got[i]}) is {gap} below the step's max {mx}")
        if gap > 0 or int(row.argmax()) != got[i]:
            ties += 1
            gaps.append(gap / ulp)
        logits = model([[got[i]]], len(prompt_ids) + i, cache, logits_to_keep=1)
    cache.release()
    rec.update(near_ties=ties, tie_gaps_in_ulps=gaps)
    return rec

def _hf_config(cfg, **extra) -> dict:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["mlp_only_layers"] = list(d["mlp_only_layers"])
    return {"model_type": "qwen3", **d, **extra}


def _write_checkpoint(out: Path, cfg, tensors_of_layer, head: dict, tail: dict,
                      shards: int = 2, **config_extra) -> int:
    """A HF-layout checkpoint: config.json and `shards` safetensors files
    (the layers split evenly, the embedding in the first, the final norm in
    the last). Returns the bytes written."""
    from tiny_llm_tpu_torch.models.safetensors_io import save_file

    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps(_hf_config(cfg, **config_extra)))
    L, total = cfg.num_hidden_layers, 0
    for s in range(shards):
        part = dict(head) if s == 0 else {}
        for i in range(s * L // shards, (s + 1) * L // shards):
            part.update(tensors_of_layer(i))
        if s == shards - 1:
            part.update(tail)
        total += save_file(part, str(out / f"model-{s + 1:05d}-of-{shards:05d}.safetensors"))
    return total


def _mlx_triplet(name: str, qt) -> dict:
    """An MLX export's triplet of a port weight: the port's packing is MLX's
    (consecutive little-endian codes), so the words are stored as they are."""
    check(qt.k_padded == qt.in_features, f"{name}: K {qt.in_features} needs padding")
    return {f"{name}.weight": qt.packed.cpu().view(torch.uint32),
            f"{name}.scales": qt.scales.cpu(), f"{name}.biases": qt.biases.cpu()}


def _same_params(a, b) -> bool:
    """Every tensor of two unfused param sets bit-equal (QuantizedTensor
    fields and shapes too)."""
    from tiny_llm_tpu_torch.ops.quantize import QuantizedTensor

    def same(x, y):
        if isinstance(x, QuantizedTensor):
            return isinstance(y, QuantizedTensor) and all(
                torch.equal(getattr(x, k), getattr(y, k)) for k in ("packed", "scales", "biases")
            ) and (x.out_features, x.in_features, x.bits, x.group_size) == (
                y.out_features, y.in_features, y.bits, y.group_size)
        if x is None or y is None:
            return x is y
        return x.dtype == y.dtype and torch.equal(x, y)

    ok = same(a.embedding, b.embedding) and same(a.final_norm, b.final_norm)
    ok = ok and same(a.lm_head, b.lm_head) and len(a.layers) == len(b.layers)
    for la, lb in zip(a.layers, b.layers):
        ok = ok and same(la.input_layernorm, lb.input_layernorm) and same(
            la.post_attention_layernorm, lb.post_attention_layernorm)
        for k in ("wq", "wk", "wv", "wo", "q_norm", "k_norm"):
            ok = ok and same(getattr(la.attn, k), getattr(lb.attn, k))
        for k in ("w_gate", "w_up", "w_down"):
            ok = ok and same(getattr(la.mlp, k), getattr(lb.mlp, k))
    return ok


def _timed_load(path: Path, nbytes: int, **kw):
    from tiny_llm_tpu_torch.models import load_params

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, cfg = load_params(str(path), device="cuda", **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return params, cfg, {"seconds": secs, "gb": nbytes / 1e9, "gb_per_s": nbytes / 1e9 / secs}


def phase_checkpoint(params, cfg):
    """The 4B MLX export of `params` loaded back bit-equal, then the 0.6B HF
    BF16 export loaded quantized and dense. Returns (the loaded 4B params,
    the 0.6B W4A16 params, the 0.6B config)."""
    import shutil
    import tempfile

    from tiny_llm_tpu_torch.kernels.build import BUILD_DIR
    from tiny_llm_tpu_torch.models import QWEN3_CONFIGS
    from tiny_llm_tpu_torch.models.safetensors_io import load_file
    from tiny_llm_tpu_torch.ops.quantize import quantize

    t_phase = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=BUILD_DIR))
    try:
        # (i) Qwen3-4B, MLX 4-bit: the synthetic params as an export.
        def mlx_layer(i):
            lay, p = params.layers[i], f"model.layers.{i}"
            out = {}
            for k, n in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj")):
                out.update(_mlx_triplet(f"{p}.self_attn.{n}", getattr(lay.attn, k)))
            for k, n in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj")):
                out.update(_mlx_triplet(f"{p}.mlp.{n}", getattr(lay.mlp, k)))
            out.update({f"{p}.self_attn.q_norm.weight": lay.attn.q_norm.cpu(),
                        f"{p}.self_attn.k_norm.weight": lay.attn.k_norm.cpu(),
                        f"{p}.input_layernorm.weight": lay.input_layernorm.cpu(),
                        f"{p}.post_attention_layernorm.weight": lay.post_attention_layernorm.cpu()})
            return out

        t0 = time.perf_counter()
        n4 = _write_checkpoint(tmp / "qwen3-4b-mlx", cfg, mlx_layer,
                               _mlx_triplet("model.embed_tokens", params.embedding),
                               {"model.norm.weight": params.final_norm.cpu()},
                               quantization={"group_size": 128, "bits": 4})
        write4 = time.perf_counter() - t0
        loaded, lcfg, load4 = _timed_load(tmp / "qwen3-4b-mlx", n4)
        check(lcfg == cfg, f"4B config {lcfg} != {cfg}")
        check(_same_params(loaded, params), "the loaded 4B params differ from the synthetic ones")
        shutil.rmtree(tmp / "qwen3-4b-mlx")

        # (ii) Qwen3-0.6B, HF BF16: normal x 0.02 from a seed, norms 1.
        dcfg = QWEN3_CONFIGS["qwen3-0.6b"]
        dev = params.embedding.device  # the card
        gen = torch.Generator(device=dev).manual_seed(6)
        D, Dh, I = dcfg.hidden_size, dcfg.head_dim, dcfg.intermediate_size
        Hq, Hkv = dcfg.num_attention_heads, dcfg.num_key_value_heads

        def w(*shape):
            return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
                torch.bfloat16).cpu()

        def ones(n):
            return torch.ones((n,), dtype=torch.bfloat16)

        def hf_layer(i):
            p = f"model.layers.{i}"
            return {f"{p}.self_attn.q_proj.weight": w(Hq * Dh, D),
                    f"{p}.self_attn.k_proj.weight": w(Hkv * Dh, D),
                    f"{p}.self_attn.v_proj.weight": w(Hkv * Dh, D),
                    f"{p}.self_attn.o_proj.weight": w(D, Hq * Dh),
                    f"{p}.mlp.gate_proj.weight": w(I, D), f"{p}.mlp.up_proj.weight": w(I, D),
                    f"{p}.mlp.down_proj.weight": w(D, I),
                    f"{p}.self_attn.q_norm.weight": ones(Dh),
                    f"{p}.self_attn.k_norm.weight": ones(Dh),
                    f"{p}.input_layernorm.weight": ones(D),
                    f"{p}.post_attention_layernorm.weight": ones(D)}

        hf = tmp / "qwen3-0.6b-hf"
        n06 = _write_checkpoint(hf, dcfg, hf_layer,
                                {"model.embed_tokens.weight": w(dcfg.vocab_size, D)},
                                {"model.norm.weight": ones(D)}, torch_dtype="bfloat16")
        qparams, qcfg, load_q = _timed_load(hf, n06)  # W4A16 g128, quantized on the card
        check(qcfg == dcfg, "0.6B config")
        # The card's quantize against the CPU's on the same tensors.
        raw = {}
        for f in sorted(hf.glob("*.safetensors")):
            raw.update(load_file(str(f)))
        l0, same = qparams.layers[0], []
        pairs = [("model.embed_tokens", qparams.embedding)] + [
            (f"model.layers.0.self_attn.{n}", getattr(l0.attn, k))
            for k, n in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj"))
        ] + [(f"model.layers.0.mlp.{n}", getattr(l0.mlp, k))
             for k, n in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj"))]
        for name, card in pairs:
            cpu = quantize(raw[f"{name}.weight"].to(torch.float32))
            same.append(all(torch.equal(getattr(card, k).cpu(), getattr(cpu, k))
                            for k in ("packed", "scales", "biases")))
        del raw
        check(all(same), f"card quantize != CPU quantize: {[n for (n, _), s in zip(pairs, same) if not s]}")
        dparams, _, load_d = _timed_load(hf, n06, quantized=False)  # dense bf16
        check(dparams.embedding.dtype == torch.bfloat16, "dense load dtype")
        # The dense model's kernels (K3, K2; its projections are dense_linear
        # on both paths) against impl="torch": the parity phase's rule.
        phase_parity(dcfg, "checkpoint_dense_parity", bits=None, group_size=None,
                     params=dparams)
        del dparams
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "checkpoint", "seconds": time.perf_counter() - t_phase,
          "qwen3_4b_mlx4bit": {"bytes": n4, "shards": 2, "write_s": write4, "load": load4,
                               "bit_equal_to_synthetic": True},
          "qwen3_06b_hf_bf16": {"bytes": n06, "shards": 2, "load_w4a16": load_q,
                                "load_dense_bf16": load_d,
                                "card_quantize_bit_equal_to_cpu": [n for n, _ in pairs],
                                "dense_parity": "the checkpoint_dense_parity line"},
          "read": "warm (the files were just written; the page cache holds them)"})
    return loaded, qparams, dcfg


def phase_speculative(model, params, cfg, draft_params, dcfg):
    """Speculative decoding on the card: the loaded 4B (`model`, dense; its
    unfused `params`) as target, the 0.6B W4A16 as draft. Returns the
    launches of the device rounds' run."""
    from tiny_llm_tpu_torch import kernels
    from tiny_llm_tpu_torch.generate import (
        simple_generate_with_kv_cache,
        speculative_generate,
        speculative_max_speedup,
    )
    from tiny_llm_tpu_torch.kernels import flash_attention as k3
    from tiny_llm_tpu_torch.kernels.quant_matmul import k1_route
    from tiny_llm_tpu_torch.models import Qwen3Model
    from tiny_llm_tpu_torch.speculative import (
        SpecModel,
        greedy_continuation,
        speculative_decode_device,
    )
    from tiny_llm_tpu_torch.tokenizer import ByteTokenizer

    class IdTokenizer(ByteTokenizer):
        """Decodes to the ids themselves: equal texts are equal tokens (random
        weights pick ids past the byte range, which ByteTokenizer drops)."""

        def decode(self, ids):
            return " ".join(str(int(i)) for i in ids)

    t_phase = time.perf_counter()
    tok = IdTokenizer()
    draft = Qwen3Model(draft_params, dcfg, max_seq_len=MAX_SEQ)
    K, L = SPEC_K, cfg.num_hidden_layers
    check(k1_route(K + 1) == "b16", f"K1 at M = {K + 1}: {k1_route(K + 1)}, not the bf16 tile")
    check(K + 1 <= k3.DECODE_MAX_L, "K3 at L = K + 1 is not the split walk")
    runs = []
    self_draft = Qwen3Model(params, cfg, max_seq_len=MAX_SEQ)  # the target as its own draft
    for prompt in SPEC_PROMPTS:
        ids = tok.encode(prompt)
        want = [int(t) for t in simple_generate_with_kv_cache(
            model, tok, prompt, max_tokens=SPEC_TOKENS).split()]
        rec = {"prompt": prompt, "greedy_tokens": len(want)}
        for name, d in (("draft_0.6b", draft), ("self_draft", self_draft)):
            st = {}
            got = [int(t) for t in speculative_generate(
                d, model, tok, tok, prompt, proposal_length=K, max_tokens=SPEC_TOKENS,
                auto_disable=False, stats=st).split()]
            rec[name] = _against_stream(model, f"{name} on {prompt!r}", ids, got, want)
            rec[name]["acceptance"] = st["accepted"] / st["proposed"]
            rec[name]["rounds"] = st["rounds"]
        check(rec["self_draft"]["acceptance"] >= SPEC_SELF_ACCEPT,
              f"the target as its own draft accepted {rec['self_draft']['acceptance']}")
        runs.append(rec)
    del self_draft
    # The rounds over slabs, with exact launches over the run.
    target = SpecModel(model.params, cfg, model._rope_tables)
    dspec = SpecModel(draft.params, dcfg, draft._rope_tables)
    ids = tok.encode(SPEC_PROMPTS[1])
    want = greedy_continuation(target, ids, SPEC_TOKENS, max_seq=256)

    def device_rounds(name, d):
        """speculative_decode_device with draft d: its stream against
        greedy_continuation, its exact launches and its acceptance."""
        stats, DL = {}, d.cfg.num_hidden_layers
        kernels.reset_launches()
        got = speculative_decode_device(d, target, ids, max_tokens=SPEC_TOKENS,
                                        proposal_length=K, rounds_per_dispatch=SPEC_ROUNDS,
                                        max_seq=256, stats=stats)
        counts = kernels.launches()
        rec = _against_stream(model, f"speculative_decode_device ({name})", ids, got, want)
        rounds, steps = stats["dispatches"] * SPEC_ROUNDS, stats["catch_ups"]
        steps += rounds * K  # draft decode steps: K a round, one more after a full accept
        expected = dict.fromkeys(counts, 0)
        expected.update(quant_matmul=(4 * L + 1) + (4 * DL + 1) + steps * (4 * DL + 1)
                        + rounds * (4 * L + 1),
                        flash_attention=L + DL + rounds * L, fused_decode_attention=steps * DL)
        check(counts == expected, f"device rounds' ({name}) launches {counts} != {expected}")
        # Each round emits its accepted proposals and one token more.
        rec.update(dispatches=stats["dispatches"], emitted=stats["emitted"],
                   catch_ups=stats["catch_ups"],
                   acceptance=(stats["emitted"] - 1 - rounds) / (rounds * K),
                   launches={k: v for k, v in counts.items() if v})
        return rec, counts

    device_runs = {}
    device_runs["draft_0.6b"], counts = device_rounds("draft_0.6b", dspec)
    # The target as its own draft: the accepting branch (runs of K + 1
    # tokens, the slab advanced by K + 1, the draft slab after a full accept).
    device_runs["self_draft"], _ = device_rounds("self_draft", target)
    check(device_runs["self_draft"]["acceptance"] >= SPEC_SELF_ACCEPT,
          f"device rounds, the target as its own draft: acceptance "
          f"{device_runs['self_draft']['acceptance']}")
    forced = {}
    got = speculative_decode_device(dspec, target, ids, max_tokens=SPEC_TOKENS,
                                    proposal_length=K, rounds_per_dispatch=SPEC_ROUNDS,
                                    max_seq=256, forced_alpha=0.6, stats=forced)
    check(len(got) == SPEC_TOKENS and all(0 <= t < cfg.vocab_size for t in got),
          "forced_alpha = 0.6 did not emit its budget")
    # One verify forward and one draft step, counted exactly, and timed.
    tk, tv = target.empty_slabs(256)
    dk, dv = dspec.empty_slabs(256)
    verif = torch.tensor([ids[:K + 1]], device=model.device)
    kernels.reset_launches()
    target.step(verif, 0, tk, tv, K + 1)
    per_verify = {k: v for k, v in kernels.launches().items() if v}
    check(per_verify == {"quant_matmul": 4 * L + 1, "flash_attention": L},
          f"a verify forward launched {per_verify}")
    one, DL = verif[:, :1], dcfg.num_hidden_layers
    kernels.reset_launches()
    dspec.step(one, 0, dk, dv, 1)
    per_draft = {k: v for k, v in kernels.launches().items() if v}
    check(per_draft == {"quant_matmul": 4 * DL + 1, "fused_decode_attention": DL},
          f"a draft step launched {per_draft}")
    verify_ms = event_ms(lambda: target.step(verif, 8, tk, tv, K + 1), reps=5)
    draft_ms = event_ms(lambda: dspec.step(one, 8, dk, dv, 1), reps=5)
    target_ms = event_ms(lambda: target.step(one, 8, tk, tv, 1), reps=5)
    bound = speculative_max_speedup(target_ms, draft_ms, verify_ms, K)
    # Speculative (0.6B draft) against greedy decode, in turns (A B B A).
    prompt = SPEC_PROMPTS[1]
    tps = {"speculative": [], "greedy": []}
    for name in ("speculative", "greedy", "greedy", "speculative"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "greedy":
            simple_generate_with_kv_cache(model, tok, prompt, max_tokens=SPEC_TURN_TOKENS)
        else:
            speculative_generate(draft, model, tok, tok, prompt, proposal_length=K,
                                 max_tokens=SPEC_TURN_TOKENS, auto_disable=False)
        tps[name].append(SPEC_TURN_TOKENS / (time.perf_counter() - t0))
    del draft
    torch.cuda.empty_cache()
    emit({"phase": "speculative", "seconds": time.perf_counter() - t_phase,
          "target": "qwen3-4b W4A16 (loaded)", "draft": "qwen3-0.6b W4A16 (quantized at load)",
          "proposal_length": K, "tokens": SPEC_TOKENS, "host_loop_vs_greedy": runs,
          "tie_rule": f"a divergent token within {SPEC_TIE_ULPS} bf16 ulps of the step's max",
          "device_rounds": {"rounds_per_dispatch": SPEC_ROUNDS, **device_runs},
          "self_draft_min_acceptance": SPEC_SELF_ACCEPT,
          "forced_alpha_0.6": forced,
          "routes": {"k1_at_m5": k1_route(K + 1), "k3_at_l5": "split walk + combine"},
          "launches_per_verify": per_verify, "launches_per_draft_step": per_draft,
          "verify_forward_ms": verify_ms, "draft_step_ms": draft_ms, "target_step_ms": target_ms,
          "guard": {"max_speedup": bound, "verdict": "speculate" if bound >= 1 else "refuse",
                    "timing": "event_ms: device-clock ms of an eager call, host gaps in"},
          "tok_s_in_turns": {n: float(np.median(v)) for n, v in tps.items()},
          "tok_s_all": tps, "turn_tokens": SPEC_TURN_TOKENS, "order": "ABBA"})
    return counts


def _within_f32_sum(got, want, abs_sum, k: int) -> dict:
    """Check |got - want| <= 1 bf16 ulp of the larger + k * 2^-24 * abs_sum
    elementwise: both f32-accumulated (or exact) and rounded once to bf16
    (`abs_sum` is sum |x| |w| per element; k the length of the sums)."""
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    diff = (got - want).abs()
    lim = ulp + k * 2.0 ** -24 * abs_sum.float()
    check(bool(torch.isfinite(got).all()) and bool((diff <= lim).all()),
          f"worst {float((diff - lim).max())} past one ulp + the f32 sum bound")
    return {"max_err_over_limit": float((diff / lim).max()),
            "elements_not_equal": int((diff > 0).sum()), "elements": diff.numel()}


def phase_dense_moe(moe_cfg):
    """Dense bf16 weights on the card at the Qwen3-30B-A3B widths, 4 layers:
    the two products that are library calls (the JAX package computes them
    outside any Pallas kernel) held elementwise, a sync-free decode burst
    through the dense MoE layers, and the parity rule."""
    from tiny_llm_tpu_torch.models import Qwen3Model, random_params
    from tiny_llm_tpu_torch.ops.basics import dense_linear
    from tiny_llm_tpu_torch.ops.moe import grouped_matmul, sort_by_expert

    t_phase = time.perf_counter()
    cfg4 = dataclasses.replace(moe_cfg, num_hidden_layers=4)
    params = random_params(cfg4, seed=3, quantized=False, device="cuda")
    lay = params.layers[0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    lin, old_flag = {}, {}
    for name, w in (("q_proj", lay.attn.wq), ("o_proj", lay.attn.wo), ("router", lay.mlp.w_router),
                    ("lm_head", params.embedding if params.lm_head is None else params.lm_head)):
        for M in (1, 5, 64):
            x = torch.randn(M, w.shape[1], generator=gen, device="cuda").to(torch.bfloat16)
            exact = (x.double() @ w.double().t()).to(torch.bfloat16)
            abs_sum = x.double().abs() @ w.double().abs().t()
            lin[f"{name}_m{M}"] = _within_f32_sum(dense_linear(x, w), exact, abs_sum, w.shape[1])
            # PyTorch's default bf16 product (bf16 output), for the record.
            old_flag[f"{name}_m{M}"] = int((torch.matmul(x, w.t()) != exact).sum())
    # The grouped product: random top-8 routing of T tokens.
    E, k = cfg4.num_experts, cfg4.num_experts_per_tok
    grouped, ms = {}, {}
    for T in (1, 64):
        ids = torch.rand(T, E, generator=gen, device="cuda").argsort(-1)[:, :k]
        order, sizes = sort_by_expert(ids, E)
        xs = torch.randn(T * k, cfg4.hidden_size, generator=gen, device="cuda").to(torch.bfloat16)
        for wname in ("w_gate", "w_down"):
            w = getattr(lay.mlp, wname)
            x = xs if wname == "w_gate" else xs[:, : w.shape[2]].contiguous()
            got = grouped_matmul(x, w, sizes)
            want = grouped_matmul(x, w, sizes, impl="torch")
            abs_sum = grouped_matmul(x.float().abs(), w.float().abs(), sizes, impl="torch")
            grouped[f"{wname}_t{T}"] = _within_f32_sum(got, want, abs_sum, 2 * w.shape[2])
            grouped[f"{wname}_t{T}"]["empty_groups"] = int((sizes == 0).sum())
            if wname == "w_gate":
                ms[f"t{T}"] = {"grouped_mm": event_ms(lambda: grouped_matmul(x, w, sizes)),
                               "per_expert": event_ms(
                                   lambda: grouped_matmul(x, w, sizes, impl="torch"))}
    prompt = np.random.default_rng(3).integers(0, cfg4.vocab_size, size=(1, PROMPT_LEN))
    burst = _sync_free_burst(Qwen3Model(params, cfg4, max_seq_len=MAX_SEQ), prompt)
    with RouteForcer() as forcer:
        phase_parity(cfg4, "dense_moe_parity", forcer, bits=None, group_size=None, params=params)
    del params
    torch.cuda.empty_cache()
    emit({"phase": "dense_moe", "seconds": time.perf_counter() - t_phase,
          "model": "qwen3-30b-a3b dense bf16", "layers": 4,
          "dense_linear_vs_f64_rounded_once": lin,
          "torch_matmul_bf16_out_elements_not_equal": old_flag,
          "grouped_mm_vs_per_expert": grouped, "grouped_ms": ms, "sync_free_burst": burst,
          "parity": "the dense_moe_parity line",
          "rule": "|got - want| <= 1 bf16 ulp + K * 2^-24 * sum |x| |w|"})



# The coding agent (tiny_llm_tpu_torch.agent, agent_main): Qwen3-4B at
# agent_main's context of 4096, a scripted conversation of four turns of at
# most AGENT_TOKENS tokens each, on the dense kernel route, the plain route
# and the paged route.
AGENT_TOKENS = 32
AGENT_TASK = "In settings.py, change RETRY_LIMIT to 5 without touching anything else."
AGENT_SETTINGS = "# Service configuration.\nRETRY_LIMIT = 3\nTIMEOUT_S = 20\n"
# Turn 3's prompt ends this many tokens into a page (the observation is
# padded to it), so the replay's rewind (turn 3's tokens and one more)
# frees a whole page.
AGENT_PAGE_END = 120


class _TimedCalls:
    """A model whose calls are timed (synchronized after each): the list of
    (tokens in the call, seconds)."""

    def __init__(self, model):
        self._model = model
        self.calls: list[tuple[int, float]] = []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def __call__(self, inputs, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._model(inputs, *args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append((int(inputs.shape[-1]), time.perf_counter() - t0))
        return out


def _agent_conversation(system: str, reply: str) -> list[list[dict]]:
    """The four turns' messages: the task (cold); the task, `reply` and a
    tool observation (prefix reuse); the observation's last character
    changed (a rewind into it); the same messages again (the replay)."""
    from tiny_llm_tpu_torch.agent.generation import render_messages

    def turn(obs):
        return [{"role": "system", "content": system}, {"role": "user", "content": AGENT_TASK},
                {"role": "assistant", "content": reply}, {"role": "user", "content": obs}]

    obs = "tool_result: " + json.dumps({"content": AGENT_SETTINGS}) + " "
    n = len(render_messages(turn(obs + "1")).encode())  # ByteTokenizer: a token a byte
    obs += "." * ((AGENT_PAGE_END - n) % PAGE_SIZE)
    first = [{"role": "system", "content": system}, {"role": "user", "content": AGENT_TASK}]
    return [first, turn(obs + "0"), turn(obs + "1"), turn(obs + "1")]


def _expected_turn(ledger: list[int], prompt: list[int], out: list[int]) -> dict:
    """GenerationStats (latency apart) of a turn whose session held `ledger`
    and generated `out` for `prompt`, as the session's rule gives them."""
    common = 0
    for a, b in zip(ledger, prompt):
        if a != b:
            break
        common += 1
    if common == len(prompt):
        common -= 1  # the replay of the last prompt token
    return {"input_tokens": len(prompt), "reused_tokens": common,
            "rewound_tokens": len(ledger) - common, "prefilled_tokens": len(prompt) - common,
            "output_tokens": len(out), "cold_start": not ledger}


def _agent_launches(L: int, chunks: list[tuple[int, int]], steps: int, paged: bool) -> dict:
    """A turn's launches: K1 for every projection of every call (4 a layer
    and the head); a prefill chunk's attention (dense: K3, which at L <= 16
    is row 4's route; paged: K3 for the first chunk at offset 0, then row 12
    at L <= 16 and row 13 above; a chunk of one token, the replay: the decode
    kernel); a decode step's fused attention (K2, or row 9 paged)."""
    from tiny_llm_tpu_torch import kernels
    from tiny_llm_tpu_torch.kernels.paged_attention import DECODE_MAX_L

    step = "fused_paged_decode_attention" if paged else "fused_decode_attention"
    want = dict.fromkeys(kernels.KERNELS, 0)
    want["quant_matmul"] = (4 * L + 1) * (len(chunks) + steps)
    want[step] += L * steps
    for off, n in chunks:
        if n == 1:
            key = step
        elif paged and off > 0:
            key = "paged_decode" if n <= DECODE_MAX_L else "paged_prefill"
        else:
            key = "flash_attention"
        want[key] += L
    return want


def phase_agent(model, cfg):
    """The agent's generation on the card (Qwen3-4B on `model`'s fused
    weights, max_seq 4096, the byte tokenizer): the scripted four turns
    (_agent_conversation) on GenerationSession over the dense kernel
    route, each turn's stats held exactly to the session's rule, its K1,
    K2 and K3 launches exactly (_agent_launches), its prefill ms and decode
    tok/s, each warm turn's tokens against a cold session's on the same
    messages (_against_stream: warm and cold prefill other chunk shapes, so
    K1 and K3 take other routes); the same turns on the plain route
    (impl="torch", on the card: no launch) and on the paged route (rows 9,
    12 and 13 and K3), both against the dense kernel route's tokens under
    the same rule; the paged cache's pages after each turn and each rewind,
    every page back after reset(); then one run_agent call of two steps in
    a temporary workspace, its session log replayed from disk and its
    journal left with no pending mutation. Returns the launches of the
    dense and paged sessions' turns."""
    import math
    import tempfile

    from tiny_llm_tpu_torch import kernels
    from tiny_llm_tpu_torch.agent import (AgentLimits, GenerationSession, MutationJournal,
                                          SessionStore, ToolPolicy, Workspace,
                                          build_system_prompt, run_agent)
    from tiny_llm_tpu_torch.agent_main import MAX_SEQ_LEN
    from tiny_llm_tpu_torch.models import Qwen3Model
    from tiny_llm_tpu_torch.tokenizer import ByteTokenizer

    class IdsTokenizer(ByteTokenizer):
        """Records the ids of the last decode: a turn's output tokens."""

        last: list[int] = []

        def decode(self, ids):
            self.last = [int(i) for i in ids]
            return super().decode(ids)

    t_phase = time.perf_counter()
    L = cfg.num_hidden_layers
    tok = IdsTokenizer()
    total = collections.Counter()  # the launches of the dense and paged sessions' turns
    with tempfile.TemporaryDirectory() as root:
        system = build_system_prompt(ToolPolicy(root=root))
    dense = Qwen3Model(model.params, cfg, max_seq_len=MAX_SEQ_LEN)
    chunk = GenerationSession(dense, tok).prefill_chunk

    def run_turns(m, convo, paged=False, counted=True):
        """The turns on one session over m: each turn's record and ids."""
        timed = _TimedCalls(m)
        sess = GenerationSession(timed, tok, max_tokens=AGENT_TOKENS)
        ledger, rows, rewinds = [], [], []
        for t, messages in enumerate(convo):
            timed.calls.clear()
            torch.cuda.synchronize()
            kernels.reset_launches()
            _, st = sess(messages)
            counts = kernels.launches()
            out, prompt = tok.last, sess.encode_messages(messages)
            got = dataclasses.asdict(st)
            latency = got.pop("latency_s")
            check(got == _expected_turn(ledger, prompt, out),
                  f"turn {t + 1}: stats {got} != {_expected_turn(ledger, prompt, out)}")
            common = st.reused_tokens
            chunks = [(common + i, min(chunk, st.prefilled_tokens - i))
                      for i in range(0, st.prefilled_tokens, chunk)]
            want = _agent_launches(L, chunks, len(out), paged) if counted else \
                dict.fromkeys(counts, 0)
            check(counts == want, f"turn {t + 1}: launches {_nonzero(counts)} != "
                  f"{_nonzero(want)}")
            total.update(counts)
            check(len(timed.calls) == len(chunks) + len(out),
                  f"turn {t + 1}: {len(timed.calls)} model calls")
            pre = sum(s for _, s in timed.calls[:len(chunks)])
            dec = sum(s for _, s in timed.calls[len(chunks):])
            rec = {"turn": t + 1, "stats": got, "latency_s": latency,
                   "chunks": [n for _, n in chunks], "prefill_ms": pre * 1e3,
                   "decode_tok_s": len(out) / dec if dec else None,
                   "launches": _nonzero(counts)}
            if paged:
                cache, ps = sess._cache, m.page_pool.page_size
                check(cache.num_pages == math.ceil(cache.offset / ps)
                      == m.page_pool.live_pages,
                      f"turn {t + 1}: {cache.num_pages} pages, {m.page_pool.live_pages} live "
                      f"at offset {cache.offset}")
                rec["pages"] = cache.num_pages
                if t == 0:
                    rewind = cache.rewind

                    def recorded(n, cache=cache, rewind=rewind, ps=ps):
                        before, off = cache.num_pages, cache.offset
                        rewind(n)
                        check(cache.num_pages == math.ceil((off - n) / ps),
                              f"a rewind of {n} from {off} left {cache.num_pages} pages")
                        rewinds.append({"from": off, "tokens": n,
                                        "pages_freed": before - cache.num_pages})

                    cache.rewind = recorded
            rows.append((rec, prompt, out))
            ledger = prompt + out
        if paged:
            sess.reset()
            check(m.page_pool.live_pages == 0, f"{m.page_pool.live_pages} pages live after reset")
            check(sum(r["pages_freed"] for r in rewinds) >= 1, f"no rewind freed a page: {rewinds}")
        return rows, rewinds

    # Turn 1 alone sets the reply the later turns carry.
    first, _ = run_turns(dense, _agent_conversation(system, "")[:1])
    reply = ByteTokenizer().decode(first[0][2])
    convo = _agent_conversation(system, reply)
    warm, _ = run_turns(dense, convo)
    check(warm[0][2] == first[0][2], "turn 1 is not deterministic")
    # Each warm turn against a cold session on the same messages.
    cold = {}
    for t in (1, 2, 3):
        rec, prompt, out = warm[t]
        key = json.dumps(convo[t])
        if key not in cold:
            sess = GenerationSession(dense, tok, max_tokens=AGENT_TOKENS)
            sess(convo[t])
            cold[key] = tok.last
            sess.reset()
        rec["against_cold"] = _against_stream(dense, f"agent turn {t + 1} warm vs cold", prompt,
                                              out, cold[key])
    # The plain route on the card, and the paged route, against the dense
    # kernel route's tokens.
    plain = Qwen3Model(model.params, cfg, max_seq_len=MAX_SEQ_LEN, impl="torch")
    plain_rows, _ = run_turns(plain, convo, counted=False)
    del plain
    paged = Qwen3Model(model.params, cfg, max_seq_len=MAX_SEQ_LEN)
    paged.enable_paged_attention(num_pages=MAX_SEQ_LEN // PAGE_SIZE + 1, page_size=PAGE_SIZE)
    paged_rows, rewinds = run_turns(paged, convo, paged=True)
    del paged
    for name, rows in (("plain", plain_rows), ("paged", paged_rows)):
        for (rec, prompt, out), (_, _, want) in zip(rows, warm):
            rec["against_dense_kernels"] = _against_stream(
                dense, f"agent {name} turn {rec['turn']}", prompt, out, want)
    # One agent run of two steps on the card.
    with tempfile.TemporaryDirectory() as root:
        Path(root, "settings.py").write_text(AGENT_SETTINGS)
        store = SessionStore(root)
        session = store.create()
        policy = ToolPolicy(root=root)
        journal = MutationJournal(session, policy.root)
        workspace = Workspace(policy, session_log=session, journal=journal,
                              confirm=lambda action: True)
        gen = GenerationSession(dense, ByteTokenizer(), max_tokens=AGENT_TOKENS)
        t0 = time.perf_counter()
        run = run_agent(AGENT_TASK, gen, workspace, limits=AgentLimits(max_steps=2),
                        session=session)
        run_s = time.perf_counter() - t0
        gen.reset()
        replayed = store.load(store.session_id(session))
        check([(e.type, e.data) for e in replayed.events]
              == [(e.type, e.data) for e in session.events], "the session log does not replay")
        check(MutationJournal(replayed, policy.root).recover_pending() == [],
              "the journal holds a pending mutation")
        check(Path(root, "settings.py").read_text() == AGENT_SETTINGS,
              "a read-only run changed the workspace")
        agent_run = {"status": run.status, "steps": run.steps, "seconds": run_s,
                     "events": collections.Counter(e.type for e in session.events)}
    check(run.steps <= 2 and run.status in ("final", "step_limit", "invalid_limit", "loop"),
          f"run_agent ended {run.status} after {run.steps} steps")
    del dense
    torch.cuda.empty_cache()
    emit({"phase": "agent", "model": "qwen3-4b W4A16", "max_seq_len": MAX_SEQ_LEN,
          "system_prompt_bytes": len(system.encode()), "prefill_chunk": chunk,
          "max_tokens": AGENT_TOKENS,
          "tie_rule": f"a divergent token within {SPEC_TIE_ULPS} bf16 ulps of the step's max",
          "dense": [r for r, _, _ in warm], "plain_on_card": [r for r, _, _ in plain_rows],
          "paged": [r for r, _, _ in paged_rows], "paged_rewinds": rewinds,
          "run_agent": agent_run, "launches": _nonzero(total),
          "seconds": time.perf_counter() - t_phase})
    return _nonzero(total)


def phase_cli():
    """The CLIs as subprocesses, side by side on the card (synthetic 0.6B
    weights, the byte tokenizer): each must exit 0; main must print the
    target's greedy text (its break-even guard refuses a draft as slow as the
    target), which this process computes on the same weights, and batch_main
    a line per request and its summary; agent_main one step of a task in a
    temporary workspace and its status line; evaluate_agent grade the
    pristine workspace's result (this process grades the same package) and
    evaluate_agent run a one-step report on the package."""
    import os
    import tempfile

    from tiny_llm_tpu_torch import main as cli_main
    from tiny_llm_tpu_torch.agent import StaticHeldOutGrader, TaskPackage
    from tiny_llm_tpu_torch.agent.evaluation import StagedTask
    from tiny_llm_tpu_torch.generate import simple_generate_with_kv_cache
    from tiny_llm_tpu_torch.models import QWEN3_CONFIGS, Qwen3Model, synthetic_quantized_params
    from tiny_llm_tpu_torch.tokenizer import ByteTokenizer

    root = Path(__file__).resolve().parent
    package = str(root / "evals" / "localized-constant")
    pristine = Path(package, "workspace", "settings.py").read_text()
    workspace = tempfile.TemporaryDirectory()
    Path(workspace.name, "settings.py").write_text(AGENT_SETTINGS)
    runs = {"main": ["-m", "tiny_llm_tpu_torch.main", "--model", "qwen3-0.6b", "--draft-model",
                     "qwen3-0.6b", "--max-tokens", "16"],
            "batch_main": ["-m", "tiny_llm_tpu_torch.batch_main", "--model", "qwen3-0.6b",
                           "--max-output-tokens", "16"],
            "agent_main": ["-m", "tiny_llm_tpu_torch.agent_main", AGENT_TASK, "--model",
                           "qwen3-0.6b", "--no-session", "--yes", "--max-steps", "1",
                           "--max-tokens", "16", "--root", workspace.name],
            "evaluate_agent_grade": ["-m", "tiny_llm_tpu_torch.evaluate_agent", "grade", package],
            "evaluate_agent_run": ["-m", "tiny_llm_tpu_torch.evaluate_agent", "run", package,
                                   "--model", "qwen3-0.6b", "--max-steps", "1"]}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, *argv], cwd=root, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    env=dict(os.environ))
             for name, argv in runs.items()}
    out = {}
    try:
        cfg = QWEN3_CONFIGS["qwen3-0.6b"]
        ref = Qwen3Model(synthetic_quantized_params(cfg, seed=0), cfg,
                         max_seq_len=cli_main.parser().get_default("max_seq_len"))
        want = simple_generate_with_kv_cache(ref, ByteTokenizer(),
                                             cli_main.parser().get_default("prompt"),
                                             max_tokens=16)
        del ref
        staged = StagedTask.stage(TaskPackage.load(package), workspace.name + "/graded")
        graded = StaticHeldOutGrader(staged.package, staged.original).grade(staged.freeze())
        grade_line = (f"{sum(r.passed for r in graded)}/{len(graded)} checks pass on the "
                      "pristine workspace")
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            check(p.returncode == 0, f"{name} exited {p.returncode}: {stderr[-2000:]}")
            lines = stdout.rstrip("\n").split("\n")  # the texts may hold other line breaks
            if name == "main":
                check(stdout.endswith("\n" + want + "\n"),
                      f"main printed {stdout[-300:]!r}, not the greedy text {want!r}")
            elif name == "batch_main":
                check(sum(ln.startswith(f"[{i}]") for i in range(6) for ln in lines) == 6
                      and "-- 6 requests" in lines[-1], f"batch_main printed {stdout[-500:]!r}")
            elif name == "agent_main":
                check(bool(re.fullmatch(r"\[(final|step_limit|invalid_limit|loop) after 1 "
                                        r"steps\]", lines[0])),
                      f"agent_main printed {stdout[-500:]!r}")
            elif name == "evaluate_agent_grade":
                check(lines[-1] == grade_line, f"evaluate_agent grade printed {lines[-1]!r}, "
                      f"not {grade_line!r}")
            else:
                report = json.loads(stdout)
                check(report["task_id"] == "localized-constant"
                      and report["metrics"]["steps"] == 1 and not report["passed"],
                      f"evaluate_agent run reported {stdout[-500:]!r}")
            out[name] = {"seconds": time.perf_counter() - t0, "exit": p.returncode,
                         "last_line": lines[-1][-120:] if lines else "",
                         "guard_refused": "speculative decoding disabled" in stderr}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        workspace.cleanup()
    check(Path(package, "workspace", "settings.py").read_text() == pristine,
          "an agent run changed the package")
    emit({"phase": "cli", "side_by_side": True, **out})


# Tensor, data and expert parallelism: the JAX tests' meshes, every
# shard on this card (the mesh repeats cuda:0, as the JAX tests repeat 8
# virtual CPU devices). TP: Qwen3-4B at tp = 4, and the in-feature split at
# tp = 8, whose down shards (9728 / 8 = 1216 columns) cut a quant group;
# DP: the serving campaign's first DP_REQUESTS requests at dp = 2; EP:
# Qwen3-30B-A3B at ep = 4 and at ep = 2 x tp = 2.
TP_SHARDS, TP_CUT_SHARDS, TP_STEPS = 4, 8, 32
DP_REPLICAS, DP_REQUESTS = 2, 8
EP_MESHES = {"ep4": dict(ep=4, tp=1), "ep2_tp2": dict(ep=2, tp=2)}


def _mesh(**axes):
    from tiny_llm_tpu_torch.parallel import make_mesh

    n = int(np.prod(list(axes.values())))
    return make_mesh(devices=[torch.device("cuda", 0)] * n, **axes)


def _logit_check(got, want, what):
    """`got` within 5 % of want's largest logit, top-1 equal where want's
    top two differ by more than that. Returns (err / tol, decided rows)."""
    a, b = got.float().reshape(-1, got.shape[-1]), want.float().reshape(-1, want.shape[-1])
    tol = 5e-2 * float(b.abs().max())
    err = float((a - b).abs().max())
    check(bool(torch.isfinite(a).all()) and err <= tol, f"{what}: {err} > {tol}")
    top2 = b.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > tol
    check(bool((a.argmax(-1) == b.argmax(-1))[sure].all()), f"{what}: top-1 differs where decided")
    return err / tol, int(sure.sum())


def _step_launches(model, prompt, tok):
    """(the launches of a PROMPT_LEN prefill, of one decode step, the
    prefill's last logits, the step's logits), the step fed `tok`."""
    from tiny_llm_tpu_torch import kernels

    cache = model.create_kv_cache()
    torch.cuda.synchronize()
    kernels.reset_launches()
    lp = model(prompt, 0, cache, logits_to_keep=1)
    torch.cuda.synchronize()
    pre = kernels.launches()
    kernels.reset_launches()
    ld = model([[tok]], PROMPT_LEN, cache, logits_to_keep=1)
    torch.cuda.synchronize()
    step = kernels.launches()
    cache.release()
    return pre, step, lp, ld


def _expect(counts, want, what):
    """Launch counts equal `want` on its kernels and 0 on every other."""
    full = {k: want.get(k, 0) for k in counts}
    check(counts == full, f"{what}: launches {counts} != {full}")


def _head_shard_cases(cfg, tp):
    """K3 (L = 1: its walk; L = PROMPT_LEN: its tile) on one head shard of
    a dense slab [2, Hkv, MAX_SEQ, D], and the paged decode and prefill
    kernels on one head shard of a page pool [POOL_PAGES, Hkv, PAGE_SIZE,
    D], each shard a view read in place (the last of tp shards: heads
    [Hkv - Hkv / tp, Hkv)), at Qwen3-4B's heads: bit-equal to the same
    kernel on a contiguous copy of the shard, and within _state_tol of the
    plain version on the view (the paged cases through _paged_check, with
    its control). Returns one summary a case."""
    from tiny_llm_tpu_torch.kernels import flash_attention as ka
    from tiny_llm_tpu_torch.kernels import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(1818)
    D, hkv = cfg.head_dim, cfg.num_key_value_heads
    kh = slice(hkv - hkv // tp, hkv)
    hq = cfg.num_attention_heads // tp
    sc = D**-0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    out = []
    k, v = randn(2, hkv, MAX_SEQ, D), randn(2, hkv, MAX_SEQ, D)
    lens = torch.tensor([300, MAX_SEQ], dtype=torch.int32, device="cuda")
    for Lq in (1, PROMPT_LEN):
        q = randn(2, hq, Lq, D)
        ks, vs = k[:, kh], v[:, kh]
        got = ka.flash_attention_cuda(q, ks, vs, lens, sc)
        same = torch.equal(got, ka.flash_attention_cuda(q, ks.contiguous(), vs.contiguous(),
                                                        lens, sc))
        want = ka.flash_attention_plain(q, ks, vs, lens, sc)
        tol = _state_tol(q, ks, vs, ka._causal_mask(lens, Lq, MAX_SEQ, q.device), sc, want)
        rows = _over_tol(got, want, tol)
        check(same and max(rows) <= 1, f"K3 on a slab's head shard, L = {Lq}: equal to the "
              f"contiguous copy {same}, {max(rows)} of its tolerance")
        out.append({"kernel": "flash_attention", "L": Lq, "view": "slab[:, heads]",
                    "equal_to_contiguous": same, "err_over_tol_per_batch_row": rows})
    del k, v
    kp, vp = randn(POOL_PAGES, hkv, PAGE_SIZE, D), randn(POOL_PAGES, hkv, PAGE_SIZE, D)
    perm = torch.randperm(POOL_PAGES - 1, generator=torch.Generator().manual_seed(18)) + 1
    width = MAX_SEQ // PAGE_SIZE
    bt = perm[: 2 * width].reshape(2, width).to(device="cuda", dtype=torch.int32)
    bt[0, 3:] = -1  # row 0's 300 keys fill 3 pages
    for Lq, fn in ((1, pa.paged_decode_cuda), (PROMPT_LEN, pa.paged_prefill_cuda)):
        q = randn(2, hq, Lq, D)
        ks, vs = kp[:, kh], vp[:, kh]
        case, _ = _paged_check(f"{fn.__name__} on a pool's head shard", fn, q, ks, vs, bt, lens,
                               sc)
        same = torch.equal(fn(q, ks, vs, bt, lens, sc),
                           fn(q, ks.contiguous(), vs.contiguous(), bt, lens, sc))
        check(same, f"{fn.__name__} on a pool's head shard differs from the contiguous copy")
        out.append({"kernel": fn.__name__, "L": Lq, "view": "pool[:, heads]",
                    "equal_to_contiguous": same,
                    "err_over_tol_per_batch_row": case["err_over_tol_per_batch_row"],
                    "control_err_over_tol_per_batch_row":
                        case["control_err_over_tol_per_batch_row"]})
    return out


def phase_tp_model(model, cfg):
    """Tensor parallelism on Qwen3-4B W4A16 at full width and depth: the
    dense model's fused weights split over tp = TP_SHARDS (shard_params:
    qkv and gate/up on out-features, whole KV heads a shard; o and down on
    in-features, partial products summed in f32), run once with attention
    on the gathered heads (attn_impl None: K2 at decode) and once with
    TPAttention (K3, row 4's walk at L = 1, per head shard). A PROMPT_LEN
    prefill and a decode step teacher-forced on the unsharded model's
    token: logits within 5 % of the unsharded model's largest, top-1 equal
    where decided; exact launches (K1 at the shard shapes: 16 a layer + the
    head). The same over a page pool with TPAttention.paged (K3 per head
    shard on the first chunk, the paged decode kernel per head shard at the
    step, each shard's pages a view of the pool). TP_STEPS greedy steps in
    BURST-step bursts on the three dense-slab models, in turns (A B C C B
    A), decode tok/s recorded with no limit; a sync-free burst on each
    sharded model. K3 and the paged decode and prefill kernels on one head
    shard of a slab and of a pool, read in place (_head_shard_cases). Then
    Qwen3-4B's down at tp = TP_CUT_SHARDS (1216 columns a shard, 9.5
    groups: the cut groups' columns zeroed) against unsharded K1 at M = 1,
    4 and 128 (its three routes), within the per-shard rounding bound."""
    from tiny_llm_tpu_torch.kernels.quant_matmul import quant_matmul_cuda
    from tiny_llm_tpu_torch.models import Qwen3Model
    from tiny_llm_tpu_torch.ops.sharded import shard_weight, sharded_linear
    from tiny_llm_tpu_torch.parallel import ShardingConfig, TPAttention, shard_params

    scfg = ShardingConfig(_mesh(dp=1, tp=TP_SHARDS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = shard_params(model.params, scfg)  # fused already: the parts copied once
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    models = {"unsharded": model, "tp": Qwen3Model(params, cfg, max_seq_len=MAX_SEQ),
              "tp_attention": Qwen3Model(params, cfg, max_seq_len=MAX_SEQ,
                                         attn_impl=TPAttention(scfg))}
    paged = Qwen3Model(params, cfg, max_seq_len=MAX_SEQ, attn_impl=TPAttention(scfg))
    paged.enable_paged_attention(num_pages=POOL_PAGES, page_size=PAGE_SIZE)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, PROMPT_LEN))
    L, n = cfg.num_hidden_layers, TP_SHARDS
    with torch.no_grad():
        model(prompt, 0, model.create_kv_cache(), logits_to_keep=1)  # warm-up
        _, _, lp0, _ = _step_launches(model, prompt, 0)
        tok = int(lp0[0, -1].float().argmax())
        ref = _step_launches(model, prompt, tok)
        parity, launches = {}, {}
        for name in ("tp", "tp_attention"):
            m = models[name]
            _step_launches(m, prompt, tok)  # warm-up
            pre, step, lp, ld = _step_launches(m, prompt, tok)
            heads = name == "tp_attention"
            _expect(pre, {"quant_matmul": 16 * L + 1, "flash_attention": n * L if heads else L},
                    f"{name} prefill")
            _expect(step, {"quant_matmul": 16 * L + 1, "flash_attention": n * L if heads else 0,
                           "fused_decode_attention": 0 if heads else L}, f"{name} decode step")
            e1, d1 = _logit_check(lp, ref[2], f"{name} prefill logits")
            e2, d2 = _logit_check(ld, ref[3], f"{name} decode-step logits")
            parity[name] = {"prefill_err_over_tol": e1, "step_err_over_tol": e2,
                            "top1_decided": d1 + d2}
            launches[name] = {"prefill": {k: v for k, v in pre.items() if v},
                              "decode_step": {k: v for k, v in step.items() if v}}
        _step_launches(paged, prompt, tok)  # warm-up
        pre, step, lp, ld = _step_launches(paged, prompt, tok)
        _expect(pre, {"quant_matmul": 16 * L + 1, "flash_attention": n * L},
                "tp_attention_paged prefill")
        _expect(step, {"quant_matmul": 16 * L + 1, "paged_decode": n * L},
                "tp_attention_paged decode step")
        e1, d1 = _logit_check(lp, ref[2], "tp_attention_paged prefill logits")
        e2, d2 = _logit_check(ld, ref[3], "tp_attention_paged decode-step logits")
        parity["tp_attention_paged"] = {"prefill_err_over_tol": e1, "step_err_over_tol": e2,
                                        "top1_decided": d1 + d2}
        launches["tp_attention_paged"] = {"prefill": {k: v for k, v in pre.items() if v},
                                          "decode_step": {k: v for k, v in step.items() if v}}
        check(paged.page_pool.live_pages == 0, "tp_attention_paged leaked pages")
        del paged
        head_shards = _head_shard_cases(cfg, n)
        runs = {k: _decode_run(m, prompt, TP_STEPS)[2][:, 0] for k, m in models.items()}
        agree = {k: int((t == runs["unsharded"]).sum()) for k, t in runs.items() if k != "unsharded"}
        in_turns = _alternating(models, prompt, TP_STEPS)
        sync_free = {k: _sync_free_burst(models[k], prompt) for k in ("tp", "tp_attention")}
        # The in-feature split across quant groups (tp = TP_CUT_SHARDS).
        w = model.params.layers[0].mlp.w_down
        sw = shard_weight(w, "in", "tp", _mesh(dp=1, tp=TP_CUT_SHARDS).devices)
        gen = torch.Generator(device="cuda").manual_seed(18)
        cut = []
        for M in (1, 4, 128):
            x = torch.randn((M, w.in_features), generator=gen, device="cuda").to(torch.bfloat16)
            r = torch.randn((M, w.out_features), generator=gen, device="cuda").to(torch.bfloat16)
            got, want = sharded_linear(x, sw, residual=r), quant_matmul_cuda(x, w, r)
            parts = []
            for lo, hi in sw.bounds:
                xs = torch.zeros_like(x)
                xs[:, lo:hi] = x[:, lo:hi]
                parts.append(quant_matmul_cuda(xs, w))

            def ulp(v):
                _, e = torch.frexp(v.float())
                return torch.ldexp(torch.ones_like(v.float()), e - 8)

            bound_ = sum(ulp(p) for p in parts) + 2 * ulp(want) + 2.0**-20 * want.float().abs()
            over = float(((got.float() - want.float()).abs() / bound_).max())
            check(over <= 1.0, f"tp = {TP_CUT_SHARDS} down at M = {M}: {over} of the bound")
            cut.append({"M": M, "max_err_over_bound": over,
                        "max_abs_err": max_err(got, want)})
    k_loc = sorted({p.in_features for p in sw.parts})
    emit({"phase": "tp_model", "model": "qwen3-4b", "layers": L, "tp": n,
          "mesh": "[cuda:0] * 4", "shard_params_s": shard_s, "prompt_len": PROMPT_LEN,
          "decode_steps": TP_STEPS, "burst": BURST, "parity": parity,
          "tol": "5% of max |unsharded logit|", "launches": launches,
          "greedy_tokens_equal_unsharded": agree, "greedy_tokens": TP_STEPS + 1,
          "in_turns": in_turns, "sync_free_burst": sync_free, "head_shard_views": head_shards,
          "cut_groups": {"tp": TP_CUT_SHARDS, "shape": "down 2560x9728 +res",
                         "k_loc": 9728 // TP_CUT_SHARDS, "k_part": k_loc, "cases": cut,
                         "bound": "sum of the parts' bf16 ulps + 2 ulps + 2^-20 |want|"}})
    del models, params, sw
    torch.cuda.empty_cache()


def phase_dp_serving(model, cfg, serving_ids):
    """Data parallelism: Qwen3-4B paged serving through DPServing at dp =
    DP_REPLICAS (the mesh [cuda:0] * 2) with DPPagedAttention, the pool
    striped per replica (pinned pages, a trash page each): bench.py's
    serving campaign's first DP_REQUESTS requests, one campaign after a
    warm-up. Checks: every request returns; no request sits in a slot of
    another replica; each stripe's pages are all free again at the end;
    exact launches of one decode step over 4 slots (K1 4 a layer per
    replica, on the replica's copy of the weights (shard_params) at M =
    4 / DP_REPLICAS, the tied head once over every row; the paged decode
    kernel once per replica a layer, over its stripe) and one sync-free
    burst; every token equals the unsharded
    serving campaign's (`serving_ids`, the `serving` phase's) up to each
    request's first divergence, which must be a near-tie of the unsharded
    model's own teacher-forced logits (within SPEC_TIE_ULPS bf16 ulps of
    the step's largest). Output tok/s recorded with no limit."""
    from tiny_llm_tpu_torch import kernels
    from tiny_llm_tpu_torch.models import Qwen3Model
    from tiny_llm_tpu_torch.models import qwen3
    from tiny_llm_tpu_torch.parallel import (DPPagedAttention, DPPagedBatchingKVCache,
                                             DPServing, ShardingConfig, shard_params)
    from tiny_llm_tpu_torch.serving import ServingMetrics, batch_generate

    scfg = ShardingConfig(_mesh(dp=DP_REPLICAS, tp=1))
    pages = -(-POOL_PAGES // DP_REPLICAS) * DP_REPLICAS
    params = shard_params(model.params, scfg)  # one copy a replica (here the same tensors)
    wqkv = params.layers[0].attn.wqkv
    check(wqkv.dim == "batch" and len(wqkv.parts) == DP_REPLICAS, "the weights are not replicas")
    m = Qwen3Model(params, cfg, max_seq_len=MAX_SEQ, attn_impl=DPPagedAttention(scfg))
    m.enable_paged_attention(num_pages=pages, page_size=PAGE_SIZE)
    dp = DPServing(m, scfg)
    pool = m.page_pool
    lens, max_out, kw = _serving_campaign()
    lens = lens[:DP_REQUESTS]
    placed = []

    class Recording(DPPagedBatchingKVCache):
        def add_request(self, prefilled, slot):
            placed.append((prefilled.shard, self.slot_shard(slot)))
            super().add_request(prefilled, slot)

    dp.create_batching_kv_cache = lambda max_active_requests, max_seq_len=None: Recording(
        pool, max_active_requests, DP_REPLICAS)
    p_loc = pages // DP_REPLICAS
    with torch.no_grad():
        batch_generate(dp, _recorder(), SERVING_WARM, max_output_tokens=max(8, BURST), **kw)
        placed.clear()
        tok = _recorder()
        met = ServingMetrics(pool_capacity_pages=pool.num_pages, page_size=pool.page_size)
        met._bytes_per_slot = 2 * cfg.num_hidden_layers * cfg.num_key_value_heads \
            * cfg.head_dim * 2
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = batch_generate(dp, tok, ["x" * int(n) for n in lens], max_output_tokens=max_out,
                             metrics=met, **kw)
        met.wall_s = time.perf_counter() - t0
        counts = kernels.launches()
        check(sorted(i for i, _ in res) == list(range(DP_REQUESTS)), "a request did not return")
        check(len(placed) == DP_REQUESTS and all(a == b for a, b in placed),
              f"a request sat in another replica's slot: {placed}")
        check([len(f) for f in pool._free_by_shard] == [p_loc - 1] * DP_REPLICAS,
              "a stripe's pages are not all free")
        check(counts["fused_paged_decode_attention"] == 0 and counts["paged_decode"] > 0,
              f"the DP campaign launched {counts}")
        ids = {i: got for (i, _), got in zip(res, tok.decoded)}
        # Tokens against the unsharded campaign's, to each first divergence.
        equal, diverged, gaps = 0, 0, []
        for i, got in ids.items():
            want = serving_ids[i]
            first = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
            check(len(got) == len(want), f"request {i}: {len(got)} tokens, unsharded {len(want)}")
            if first is None:
                equal += len(got)
                continue
            equal += first
            diverged += 1
            ids_in = list(tok.encode("x" * int(lens[i]))) + got[:first]
            cache = model.create_kv_cache()
            row = model([ids_in], 0, cache, logits_to_keep=1)[0, -1].float()
            cache.release()
            mx = float(row.max())
            ulp = 2.0 ** (int(np.floor(np.log2(abs(mx)))) - 7)
            gap = mx - float(row[got[first]])
            check(gap <= SPEC_TIE_ULPS * ulp,
                  f"request {i}: token {first} is {gap} below the unsharded step's max {mx}")
            gaps.append(gap / ulp)
        # One decode step over 4 installed requests, exact launches, and a
        # sync-free burst.
        batch = dp.create_batching_kv_cache(SERVING_BATCH)
        for slot in range(SERVING_BATCH):
            c = m.create_kv_cache()
            c.shard = batch.slot_shard(slot)
            m([[ord("x")] * int(lens[slot])], 0, c, logits_to_keep=1)
            batch.add_request(c, slot)
        toks = [[ord("x")]] * SERVING_BATCH
        rows_m = []  # K1's M in the step
        k1 = qwen3.quant_matmul

        def counted(x, w, **kw):
            rows_m.append(x.numel() // x.shape[-1])
            return k1(x, w, **kw)

        torch.cuda.synchronize()
        kernels.reset_launches()
        qwen3.quant_matmul = counted
        try:
            m(toks, None, batch, logits_to_keep=1)
        finally:
            qwen3.quant_matmul = k1
        torch.cuda.synchronize()
        L = cfg.num_hidden_layers
        _expect(kernels.launches(), {"quant_matmul": DP_REPLICAS * 4 * L + 1,
                                     "paged_decode": DP_REPLICAS * L}, "dp decode step")
        per = SERVING_BATCH // DP_REPLICAS
        check(sorted(rows_m) == [per] * (DP_REPLICAS * 4 * L) + [SERVING_BATCH],
              f"K1 ran at M = {sorted(set(rows_m))}, not {per} a replica")
        for c in batch.slots:
            c.ensure_capacity(c.offset + BURST)
        dev = m.device
        args = dict(tokens0=torch.full((SERVING_BATCH,), ord("x"), device=dev),
                    offsets0=torch.as_tensor(batch.offsets, device=dev),
                    key_pages=pool.key_pages, value_pages=pool.value_pages,
                    block_table=torch.as_tensor(batch.block_table(m._paged_width), device=dev))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = qwen3.forward_decode_burst_paged(m.params, cfg, m._rope_tables, steps=BURST,
                                                   attn_impl=m.attn_impl, **args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(tuple(out.cpu().shape) == (BURST, SERVING_BATCH), "sync-free burst shape")
        batch.release()
        check(pool.live_pages == 0, "pages leaked")
    emit({"phase": "dp_serving", "model": "qwen3-4b", "layers": L, "dp": DP_REPLICAS,
          "mesh": "[cuda:0] * 2", "requests": DP_REQUESTS, "batch": SERVING_BATCH,
          "pool_pages": pages, "stripe_pages": p_loc, **met.as_dict(), "wall_s": met.wall_s,
          "launches": {k: v for k, v in counts.items() if v},
          "k1_m_per_replica": per, "tokens_equal_unsharded": equal,
          "tokens": sum(len(t) for t in ids.values()),
          "requests_diverged_at_near_tie": diverged, "tie_gaps_in_ulps": gaps,
          "slots_on_own_replica": len(placed),
          "sync_free_burst": {"steps": BURST, "mode": "error", "host_syncs_in_burst": 0}})
    del dp, m, params
    torch.cuda.empty_cache()


def phase_ep_moe(moe, moe_cfg):
    """Expert parallelism on Qwen3-30B-A3B at MOE_LAYERS, full width: the
    dense model's weights split at ep = 4 (experts over ep; tp = 1) and at
    ep = 2 x tp = 2 (experts over ep, each expert's features and the
    attention over tp), dropless: each shard's segment of the sorted token
    copies through the grouped kernel (row 18) on its local experts, the
    segments' start, length and the merge on the device. A PROMPT_LEN
    prefill and 8 decode steps teacher-forced on the unsharded model, its
    routing leading: logits within 5 % of the unsharded model's largest,
    top-1 equal where decided, expert choices equal except at near-ties
    (margin < TIE_MARGIN, the sharded model then takes the unsharded
    choice); exact launches of a prefill and a decode step (row 18: 3 a
    MoE layer per shard); one sync-free burst on each; TP_STEPS greedy
    steps on all three in turns (decode tok/s, no limit). Then EPMoE on
    layer 0's experts at ep = 4 with capacity_factor 1.0 (C = T / 4 rows a
    shard) on a 128-token batch: the kernels against the plain versions of
    the same drops (routing forced at near-ties), within 1 % of max, and
    some rows dropped."""
    from tiny_llm_tpu_torch import kernels
    from tiny_llm_tpu_torch.models import Qwen3Model
    from tiny_llm_tpu_torch.parallel import EPMoE, ShardingConfig, shard_params

    L = moe_cfg.num_hidden_layers
    prompt = np.random.default_rng(0).integers(0, moe_cfg.vocab_size, size=(1, PROMPT_LEN))
    lines, models = {}, {"unsharded": moe}
    with torch.no_grad():
        for name, axes in EP_MESHES.items():
            scfg = ShardingConfig(_mesh(dp=1, **axes), ep_axis="ep")
            m = Qwen3Model(shard_params(moe.params, scfg), moe_cfg, max_seq_len=MAX_SEQ)
            models[name] = m
            n_ep, n_tp = axes["ep"], axes["tp"]
            state = {"lead": True}
            with RouteForcer(lead=lambda impl: state["lead"]) as forcer:
                cu, cs = moe.create_kv_cache(), m.create_kv_cache()
                worst, decided = 0.0, 0
                toks, off = prompt, 0
                for step in range(9):
                    state["lead"] = True
                    lu = moe(toks, off, cu, logits_to_keep=1)
                    state["lead"] = False
                    ls = m(toks, off, cs, logits_to_keep=1)
                    e, d = _logit_check(ls, lu, f"{name} step {step}")
                    worst, decided = max(worst, e), decided + d
                    off += toks.shape[1] if step == 0 else 1
                    toks = np.asarray([[int(lu[0, -1].float().argmax())]])
                forced = forcer.summary(lambda b: True)
                cu.release()
                cs.release()
            _step_launches(m, prompt, 0)  # warm-up
            pre, step_c, _, _ = _step_launches(m, prompt, 0)
            per_layer_k1 = 2 * n_tp + 1  # qkv and o per tp shard, the router
            grouped = 3 * n_ep * n_tp  # gate, up, down per (ep, tp) shard
            _expect(pre, {"quant_matmul": per_layer_k1 * L + 1, "flash_attention": L,
                          "grouped_quant_matmul": grouped * L}, f"{name} prefill")
            _expect(step_c, {"quant_matmul": per_layer_k1 * L + 1, "fused_decode_attention": L,
                             "grouped_quant_matmul": grouped * L}, f"{name} decode step")
            lines[name] = {"mesh": axes, "worst_err_over_tol": worst, "top1_decided": decided,
                           **forced, "grouped_quant_matmul_per_layer": grouped,
                           "launches_decode_step": {k: v for k, v in step_c.items() if v},
                           "sync_free_burst": _sync_free_burst(m, prompt)}
        in_turns = _alternating(models, prompt, TP_STEPS)
        del models
        # Capacity 1.0 at ep = 4 on layer 0's experts: kernels against the
        # plain versions of the same drops.
        mlp = moe.params.layers[0].mlp
        scfg = ShardingConfig(_mesh(dp=1, ep=4, tp=1), ep_axis="ep")
        gen = torch.Generator(device="cuda").manual_seed(18)
        x = (torch.randn((1, PROMPT_LEN, moe_cfg.hidden_size), generator=gen, device="cuda")
             * 0.5).to(torch.bfloat16)
        cap_line, outs = {}, {}
        for cap in (1.0, None):
            with RouteForcer() as forcer:
                layer_k = EPMoE(scfg, mlp.w_router, mlp.w_gate, mlp.w_up, mlp.w_down,
                                moe_cfg.num_experts_per_tok, moe_cfg.norm_topk_prob,
                                capacity_factor=cap, axis="ep")
                layer_p = EPMoE(scfg, mlp.w_router, mlp.w_gate, mlp.w_up, mlp.w_down,
                                moe_cfg.num_experts_per_tok, moe_cfg.norm_topk_prob,
                                capacity_factor=cap, axis="ep", impl="torch")
                kernels.reset_launches()
                a = layer_k(x)
                torch.cuda.synchronize()
                n18 = kernels.launches()["grouped_quant_matmul"]
                b = layer_p(x)
                forced = forcer.summary(lambda r: True)
            tol = 1e-2 * float(b.float().abs().max())
            err = max_err(a, b)
            check(bool(torch.isfinite(a.float()).all()) and err <= tol,
                  f"EPMoE capacity {cap}: {err} > {tol}")
            check(n18 == 3 * 4, f"EPMoE launched {n18} grouped matmuls, not 12")
            cap_line[str(cap)] = {"max_abs_err": err, "tol": tol, **forced}
            outs[cap] = a
        dropped = max_err(outs[1.0], outs[None])
        check(dropped > 0, "capacity 1.0 dropped no row")
    emit({"phase": "ep_moe", "model": "qwen3-30b-a3b", "layers": L, "prompt_len": PROMPT_LEN,
          "decode_steps": 8, "tol": "5% of max |unsharded logit|", "meshes": lines,
          "in_turns": in_turns, "capacity": {"ep": 4, "tokens": PROMPT_LEN,
                                             "rows": PROMPT_LEN * moe_cfg.num_experts_per_tok,
                                             "capacity_rows": PROMPT_LEN
                                             * moe_cfg.num_experts_per_tok // 4,
                                             "cases": cap_line,
                                             "max_change_from_dropless": dropped,
                                             "tol": "1% of max |plain|"}})
    torch.cuda.empty_cache()


# Pipeline parallelism (every stage on this card, the devices [cuda:0] * S).
PP_STAGES = (2, 4)
PP_MICRO = ((4, 4), (2, 4))  # MicrobatchedPipeline's (S, M) over PP_PROMPTS prompts
PP_PROMPTS = 8
PP_DECODE = ((4, 1), (2, 2))  # DecodePipeline's (S, Bm): B = S * Bm = 4 prompts
PP_BATCH = 4
# The overlapped TP matmuls: Qwen3-4B's qkv and o projections at B = 4 over
# tp = 4, and the chain q -> o.
OVERLAP_TP, OVERLAP_B = 4, 4
LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE")


class _K1Rows:
    """Inside `with`: the rows of every K1 launch (its x's leading dims)."""

    def __enter__(self):
        from tiny_llm_tpu_torch.kernels import quant_matmul as k1

        self._k1, self._orig = k1, k1.quant_matmul_cuda
        self.rows = collections.Counter()

        def counted(x, *args, **kw):
            self.rows[x.shape[0]] += 1
            return self._orig(x, *args, **kw)

        k1.quant_matmul_cuda = counted
        return self

    def __exit__(self, *exc):
        self._k1.quant_matmul_cuda = self._orig


def _counted(run):
    """(run()'s result, the launches it made of every kernel, K1's rows)."""
    from tiny_llm_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    with _K1Rows() as rec:
        out = run()
        torch.cuda.synchronize()
    return out, kernels.launches(), dict(rec.rows)


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _first_tie(model, prompt, got, want):
    """Each row of greedy streams `got` and `want` ([steps + 1, B]) equal, or
    at the row's first divergence `got`'s token a near-tie of the
    unsharded model's teacher-forced logits on `got`'s stream (within
    SPEC_TIE_ULPS bf16 ulps of the step's largest). Returns (equal tokens,
    gaps in ulps of the rows that diverged)."""
    equal, gaps = 0, []
    for b in range(got.shape[1]):
        diff = np.nonzero(got[:, b] != want[:, b])[0]
        equal += int(diff[0]) if diff.size else got.shape[0]
        if not diff.size:
            continue
        j = int(diff[0])
        ids = [int(t) for t in prompt[b]] + [int(t) for t in got[:j, b]]
        cache = model.create_kv_cache()
        row = model([ids], 0, cache, logits_to_keep=1)[0, -1].float()
        cache.release()
        mx = float(row.max())
        ulp = 2.0 ** (int(np.floor(np.log2(abs(mx)))) - 7)
        gap = mx - float(row[int(got[j, b])])
        check(gap <= SPEC_TIE_ULPS * ulp,
              f"pipeline row {b}: token {j} is {gap} below the unsharded step's max {mx}")
        gaps.append(gap / ulp)
    return equal, gaps


def _pp_decode_run(pipe, prompts, steps):
    """Prefill and `steps` greedy steps in BURST-step bursts on a
    DecodePipeline (or, `pipe` a Qwen3Model, its dense B-row cache):
    (decode seconds, tokens [steps + 1, B])."""
    if hasattr(pipe, "prefill"):
        tok = pipe.prefill(prompts)
        toks = [tok.cpu().numpy()]

        def burst(t):
            return pipe.decode(t, BURST)
    else:
        cache = pipe.create_kv_cache(batch_size=prompts.shape[0])
        tok = pipe(prompts, 0, cache, logits_to_keep=1)[:, -1].float().argmax(-1)
        toks = [tok.cpu().numpy()]

        def burst(t):
            return pipe.decode_burst_dense(cache, t, BURST)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps // BURST):
        out = burst(tok)
        toks.extend(out)
        tok = out[-1]
    dec_s = time.perf_counter() - t0
    if not hasattr(pipe, "prefill"):
        cache.release()
    return dec_s, np.stack(toks).astype(np.int64)


def phase_pp_model(model, cfg, moe, moe_cfg):
    """Pipeline parallelism on Qwen3-4B W4A16 at full width and depth (every
    stage on this card: devices [cuda:0] * S, so `.to` moves nothing).
    PipelinedQwen3 at S = 2 and 4 on a PROMPT_LEN prompt, and on
    Qwen3-30B-A3B at MOE_LAYERS at S = 2: logits bit-equal to the unsharded
    forward_full (the same calls), exact launches. MicrobatchedPipeline at
    (S, M) = PP_MICRO over PP_PROMPTS prompts of PROMPT_LEN: logits within 5 %
    of the unsharded forward_full's largest, top-1 equal where decided;
    exact launches, K1's rows Bm * PROMPT_LEN on its staged tile (the head
    once over every row). DecodePipeline at (S, Bm) = PP_DECODE (B = 4
    distinct prompts): prefill, then two BURST-step bursts, the second
    continuing the first; tokens equal the unsharded B = 4 dense-slab
    greedy tokens up to each row's first divergence, which must be a
    near-tie of the unsharded model's teacher-forced logits (K1 runs its
    GEMV at M = Bm where the unsharded step runs the bf16 tile at M = 4);
    exact launches of a burst (each microbatch step: K1 4 a layer over
    every stage's layers and the head once on the last stage, K2 once a
    layer), K1's rows Bm; one burst under set_sync_debug_mode("error");
    decode tok/s of each against the unsharded B = 4 decode, in turns (A B
    B A), recorded with no limit."""
    from tiny_llm_tpu_torch.kernels.quant_matmul import k1_route
    from tiny_llm_tpu_torch.parallel import (DecodePipeline, MicrobatchedPipeline,
                                             PipelinedQwen3)

    dev = model.device  # cuda:0
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    rng = np.random.default_rng(19)
    line = {"phase": "pp_model", "model": "qwen3-4b", "layers": L, "prompt_len": PROMPT_LEN,
            "mesh": "[cuda:0] * S", "tol": "5% of max |unsharded logit|"}
    with torch.no_grad():
        # PipelinedQwen3: the unsharded prefill's calls, stage by stage.
        prompt = rng.integers(0, V, size=(1, PROMPT_LEN))
        base = model.forward_full(prompt)
        line["pipelined"] = {}
        for S in PP_STAGES:
            pipe = PipelinedQwen3(model.params, cfg, devices=[dev] * S, num_stages=S)
            pipe(prompt)  # warm-up
            got, counts, rows = _counted(lambda: pipe(prompt))
            check(torch.equal(got, base), f"PipelinedQwen3 S = {S}: logits differ from "
                  f"forward_full by {max_err(got, base)}")
            _expect(counts, {"quant_matmul": 4 * L + 1, "flash_attention": L},
                    f"PipelinedQwen3 S = {S}")
            line["pipelined"][f"S{S}"] = {"bit_equal_forward_full": True,
                                          "launches": _nonzero(counts), "k1_rows": rows}
        moe_base = moe.forward_full(prompt)
        pipe = PipelinedQwen3(moe.params, moe_cfg, devices=[dev] * 2, num_stages=2)
        got, counts, _ = _counted(lambda: pipe(prompt))
        check(torch.equal(got, moe_base), "PipelinedQwen3 S = 2 on Qwen3-30B-A3B: logits "
              f"differ from forward_full by {max_err(got, moe_base)}")
        Lm = moe_cfg.num_hidden_layers
        _expect(counts, {"quant_matmul": 3 * Lm + 1, "flash_attention": Lm,
                         "grouped_quant_matmul": 3 * Lm}, "PipelinedQwen3 S = 2, Qwen3-30B-A3B")
        line["pipelined"]["qwen3-30b-a3b_S2"] = {"layers": moe_cfg.num_hidden_layers,
                                                 "bit_equal_forward_full": True,
                                                 "launches": _nonzero(counts)}
        del pipe, base, moe_base
        # MicrobatchedPipeline: the GPipe schedule.
        prompts = rng.integers(0, V, size=(PP_PROMPTS, PROMPT_LEN))
        base = model.forward_full(prompts)
        line["microbatched"] = {}
        for S, M in PP_MICRO:
            pipe = MicrobatchedPipeline(model.params, cfg, num_stages=S, num_microbatches=M,
                                        devices=[dev] * S)
            pipe(prompts)  # warm-up
            t0 = time.perf_counter()
            got, counts, rows = _counted(lambda: pipe(prompts))
            wall = time.perf_counter() - t0
            e, d = _logit_check(got, base, f"MicrobatchedPipeline {(S, M)}")
            Bm = PP_PROMPTS // M
            _expect(counts, {"quant_matmul": M * 4 * L + 1, "flash_attention": M * L},
                    f"MicrobatchedPipeline {(S, M)}")
            check(rows == {Bm * PROMPT_LEN: M * 4 * L, PP_PROMPTS * PROMPT_LEN: 1}
                  and k1_route(Bm * PROMPT_LEN) == "staged",
                  f"MicrobatchedPipeline {(S, M)}: K1 rows {rows}")
            line["microbatched"][f"S{S}_M{M}"] = {
                "err_over_tol": e, "top1_decided": d, "launches": _nonzero(counts),
                "k1_rows": rows,
                "k1_route": k1_route(Bm * PROMPT_LEN), "prefill_tok_s":
                    PP_PROMPTS * PROMPT_LEN / wall}
            del pipe, got
        del base
        torch.cuda.empty_cache()
        # DecodePipeline: tokens round-robin, per-stage KV.
        prompts = rng.integers(0, V, size=(PP_BATCH, PROMPT_LEN))
        steps = 2 * BURST
        _, want = _pp_decode_run(model, prompts, steps)
        line["decode"], runs = {}, {"unsharded_b4": model}
        for S, Bm in PP_DECODE:
            pipe = DecodePipeline(model.params, cfg, num_stages=S, max_seq_len=MAX_SEQ,
                                  devices=[dev] * S)
            _, got = _pp_decode_run(pipe, prompts, steps)
            equal, gaps = _first_tie(model, prompts, got, want)
            tok = pipe.prefill(prompts)
            _, counts, rows = _counted(lambda: pipe.decode(tok, BURST))
            _expect(counts, {"quant_matmul": BURST * S * (4 * L + 1),
                             "fused_decode_attention": BURST * S * L}, f"DecodePipeline {(S, Bm)}")
            check(rows == {Bm: BURST * S * (4 * L + 1)}, f"DecodePipeline {(S, Bm)}: K1 rows {rows}")
            tok = torch.as_tensor(pipe.decode(tok, BURST)[-1], device=dev)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = pipe.decode_device(tok, BURST)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            check(tuple(out.cpu().shape) == (BURST, PP_BATCH), "sync-free burst shape")
            line["decode"][f"S{S}_Bm{Bm}"] = {
                "tokens_equal_unsharded": equal, "tokens": got.size,
                "rows_diverged_at_near_tie": len(gaps), "tie_gaps_in_ulps": gaps,
                "launches_per_burst": _nonzero(counts), "k1_rows": rows,
                "launches_per_microbatch_step": {"quant_matmul": 4 * L + 1,
                                                 "fused_decode_attention": L},
                "sync_free_burst": {"steps": BURST, "mode": "error", "host_syncs_in_burst": 0}}
            runs[f"pp_S{S}_Bm{Bm}"] = pipe
        names = list(runs)
        tps = {n: [] for n in names}
        for n in names + names[::-1]:
            dec_s, _ = _pp_decode_run(runs[n], prompts, steps)
            tps[n].append(PP_BATCH * steps / dec_s)
        line["in_turns"] = {"decode_tok_s": {n: float(np.median(v)) for n, v in tps.items()},
                            "decode_tok_s_all": tps, "batch": PP_BATCH, "steps": steps,
                            "order": "ABCCBA"}
        del runs
    emit(line)
    torch.cuda.empty_cache()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_overlap():
    """The overlapped TP matmuls (parallel/overlap.py) on the mesh [cuda:0] *
    OVERLAP_TP: allgather_matmul (qkv_style) and matmul_reducescatter
    (oproj_style) at Qwen3-4B's qkv (x [4, 2560], w [2560, 6144]) and o
    (x [4, 4096], w [4096, 2560]) shapes, bf16, and the chain
    oproj_style(qkv_style(x, w_q), w_o); each held per element to an f64
    product within one bf16 rounding plus the f32 sum's bound
    (_within_f32_sum), each one's ms beside one torch.matmul of the whole
    product. Then the runtime on the card: initialize() returns False with
    the launcher's environment cleared; a one-rank NCCL group through its
    explicit arguments (tcp://localhost), runtime_topology reads one
    process and one node, barrier returns, an all_reduce through the group
    is the identity; destroy_process_group. A second rank cannot run on one
    GPU (NCCL refuses two ranks on one card)."""
    import os

    import torch.distributed as dist

    from tiny_llm_tpu_torch.parallel import (barrier, initialize, overlapped_tp_matmuls,
                                             runtime_topology)

    n, B = OVERLAP_TP, OVERLAP_B
    qkv_style, oproj_style = overlapped_tp_matmuls(_mesh(dp=1, tp=n))
    gen = torch.Generator(device="cuda").manual_seed(19)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def held(got, x, w, what):
        exact = x.double() @ w.double()
        return _within_f32_sum(got, exact, x.double().abs() @ w.double().abs(), x.shape[1]) | {
            "what": what}

    cases = []
    with torch.no_grad():
        for shape, (K, N) in (("qkv", (2560, 6144)), ("o", (4096, 2560))):
            x, w = randn(B, K), randn(K, N, scale=0.02)
            xs = list(x.chunk(n, 1))
            for style, fn, ws in (("allgather_matmul", qkv_style, list(w.chunk(n, 1))),
                                  ("matmul_reducescatter", oproj_style, list(w.chunk(n, 0)))):
                got = torch.cat(fn(xs, ws), dim=1)
                rec = held(got, x, w, f"{style} {shape}")
                rec.update(shape=shape, x=[B, K], w=[K, N], style=style,
                           ms=event_ms(lambda: fn(xs, ws), reps=20),
                           matmul_ms=event_ms(lambda: torch.matmul(x, w), reps=20))
                cases.append(rec)
        x, wq, wo = randn(B, 2560), randn(2560, 4096, scale=0.02), randn(4096, 2560, scale=0.02)
        xs, wqs, wos = list(x.chunk(n, 1)), list(wq.chunk(n, 1)), list(wo.chunk(n, 0))
        y1 = qkv_style(xs, wqs)
        chain = torch.cat(oproj_style(y1, wos), dim=1)
        first = held(torch.cat(y1, dim=1), x, wq, "chain: q")
        rec = held(chain, torch.cat(y1, dim=1), wo, "chain: o on q's output parts")
        rec.update(q=first, ms=event_ms(lambda: oproj_style(qkv_style(xs, wqs), wos), reps=20),
                   matmul_ms=event_ms(lambda: torch.matmul(torch.matmul(x, wq), wo), reps=20))
        cases.append(rec)
    # The runtime on the card.
    saved = {k: os.environ.pop(k) for k in LAUNCHER_ENV if k in os.environ}
    try:
        check(initialize() is False, "initialize joined a group with no launcher")
        port = _free_port()
        t0 = time.perf_counter()
        check(initialize(f"tcp://localhost:{port}", num_processes=1, process_id=0) is True,
              "initialize with an address joined nothing")
        try:
            init_s = time.perf_counter() - t0
            backend = dist.get_backend()
            check(backend == "nccl", f"backend {backend}, not nccl")
            topo = runtime_topology()
            check((topo.num_processes, topo.process_index, topo.num_slices) == (1, 0, 1),
                  f"topology {topo}")
            barrier("chip_smoke")
            t = torch.arange(8, dtype=torch.float32, device="cuda")
            dist.all_reduce(t)
            check(torch.equal(t, torch.arange(8, dtype=torch.float32, device="cuda")),
                  "a one-rank all_reduce changed its input")
            check(initialize() is True, "initialize is not idempotent")
        finally:
            dist.destroy_process_group()
        check(not dist.is_initialized(), "the group outlived destroy_process_group")
    finally:
        os.environ.update(saved)
    emit({"phase": "overlap", "tp": n, "mesh": "[cuda:0] * 4", "dtype": "bf16",
          "tol": "1 bf16 ulp + K * 2^-24 * sum |x||w| of the f64 product", "cases": cases,
          "runtime": {"initialize_without_launcher": False, "backend": backend,
                      "init_method": "tcp://localhost", "init_s": init_s,
                      "topology": dataclasses.asdict(topo), "barrier": "returned",
                      "all_reduce_one_rank": "identity",
                      "second_rank": "not run: NCCL refuses two ranks on one GPU, and the "
                                     "machine has one"}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase line, the kernel line, the card "
                    "and ptxas's register and spill report to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from tiny_llm_tpu_torch.models import QWEN3_CONFIGS, Qwen3Model, synthetic_quantized_params

    torch.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi, ptxas = phase_build()
    cfg = QWEN3_CONFIGS["qwen3-4b"]
    # The synthetic 4B params go through an MLX export and load_params; the
    # loaded params (bit-equal) serve every later 4B phase.
    params, draft_params, draft_cfg = phase_checkpoint(synthetic_quantized_params(cfg, seed=0),
                                                       cfg)
    torch.cuda.empty_cache()
    model = Qwen3Model(params, cfg, max_seq_len=MAX_SEQ)
    a8 = Qwen3Model(params, cfg, max_seq_len=MAX_SEQ, act_quant="int8")  # shares the weights
    sg_model = Qwen3Model(synthetic_quantized_params(cfg, seed=0, group_size=64, bits=8), cfg,
                          max_seq_len=MAX_SEQ)
    moe_cfg = dataclasses.replace(QWEN3_CONFIGS["qwen3-30b-a3b"], num_hidden_layers=MOE_LAYERS)
    moe_params = synthetic_quantized_params(moe_cfg, seed=0)
    moe = Qwen3Model(moe_params, moe_cfg, max_seq_len=MAX_SEQ)
    contract = phase_kernels(model, cfg, moe, moe_cfg)
    phase_quant_kernels(model, cfg, sg_model, moe, moe_cfg, contract)
    mask_counts = phase_mask_kernels(cfg, moe_cfg, contract)
    axpby_counts = phase_axpby(contract)
    counts = phase_model(model, cfg, "model", "qwen3-4b")
    # The quant tiers' B = 1 runs, here: the W4A16 model still runs dense
    # (the serving phase attaches a page pool to it), so each tier's runs
    # alternate with its own.
    w4a16 = {"w4a16_" + k: PHASES[-1][k] for k in ("decode_tok_s", "prefill_tok_s")}
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, PROMPT_LEN))
    a8_counts = phase_model(a8, cfg, "a8_model", "qwen3-4b W4A8", beside={
        **w4a16, "in_turns": _alternating({"w4a16": model, "w4a8": a8}, prompt)})
    sg_counts = phase_model(sg_model, cfg, "sg_model", "qwen3-4b W8 g64", runs=1,
                            beside={**w4a16, "in_turns": _alternating(
                                {"w4a16": model, "w8g64": sg_model}, prompt)})
    phase_parity(cfg, "sg_model", bits=8, group_size=64)
    del sg_model
    torch.cuda.empty_cache()
    phase_parity(cfg)
    phase_generate(model)
    phase_speculative(model, params, cfg, draft_params, draft_cfg)
    del draft_params
    # The agent's generation sessions on the dense model's weights.
    agent_counts = phase_agent(model, cfg)
    torch.cuda.empty_cache()
    # Tensor parallelism on the dense model's weights (before serving
    # attaches a page pool to it).
    phase_tp_model(model, cfg)
    # Pipeline parallelism on the same weights (and Qwen3-30B-A3B's), then
    # the overlapped TP matmuls and the runtime on the card.
    phase_pp_model(model, cfg, moe, moe_cfg)
    phase_overlap()
    phase_paged_parity(cfg)
    # The three-launch paged decode (paged_fused_one=False) on the same
    # weights: its serving campaigns are taken in turns with `serving`'s.
    phase_paged3_parity(cfg, contract)
    # W4A8 on the same weights too: its campaigns follow the three-launch
    # ones (three-launch, W4A8, W4A16, twice).
    m3 = Qwen3Model(params, cfg, max_seq_len=MAX_SEQ, paged_fused_one=False)
    for m in (m3, a8):
        m.enable_paged_attention(num_pages=POOL_PAGES, page_size=PAGE_SIZE)
    turns = [{"model": m3, "warm": SERVING_WARM}, {"model": a8, "warm": SERVING_WARM}]
    serving_counts = phase_serving(model, cfg, "serving", "qwen3-4b", n_runs=SERVING_RUNS,
                                   turns=turns)
    paged3_counts = phase_paged3_serving(m3, cfg, turns[0])
    phase_a8_serving(a8, cfg, turns[1])
    # Data parallelism, held to the serving campaign's tokens.
    phase_dp_serving(model, cfg, turns[0]["a_ids"][0])
    del m3, turns
    torch.cuda.empty_cache()
    # The long-prompt and mixed routes (Qwen3-4B; the kernels at both head shapes).
    phase_split_kernels([("qwen3-4b", cfg), ("qwen3-30b-a3b", moe_cfg)], contract)
    phase_long_parity(cfg)
    long = Qwen3Model(params, cfg, max_seq_len=LONG_MAX_SEQ)  # the same weights, longer context
    # Sequence-parallel attention on the same weights, and the unsharded
    # model it is taken in turns with.
    sp = Qwen3Model(params, cfg, max_seq_len=SP_MAX_SEQ, attn_impl=_sp())
    whole = Qwen3Model(params, cfg, max_seq_len=SP_MAX_SEQ)
    del params
    long_counts = phase_long_prefill(long, cfg)
    phase_long_serving(long, cfg)
    del long
    torch.cuda.empty_cache()
    phase_sp_kernels(cfg, contract)
    phase_sp_parity(cfg)
    sp_counts = phase_sp_model(sp, whole, cfg)
    del whole
    torch.cuda.empty_cache()
    sp_serving_counts = phase_sp_serving(sp, cfg)
    del sp
    torch.cuda.empty_cache()
    phase_mixed_parity(cfg)
    # Two campaigns, not three, at MIXED_LAYERS of the 36 layers: the script
    # stays well inside its time limit.
    mixed_cfg = dataclasses.replace(cfg, num_hidden_layers=MIXED_LAYERS)
    mixed = Qwen3Model(dataclasses.replace(model.params, layers=model.params.layers[:MIXED_LAYERS]),
                       mixed_cfg, max_seq_len=MAX_SEQ)
    phase_serving(mixed, mixed_cfg, "mixed_serving", f"qwen3-4b, {MIXED_LAYERS} layers",
                  mixed=True, n_runs=2)
    del mixed
    # The rest of W4A8 on Qwen3-4B: parity.
    phase_parity(cfg, "a8_parity", act_quant="int8")
    del a8, model
    torch.cuda.empty_cache()
    moe_counts = phase_model(moe, moe_cfg, "moe_model", "qwen3-30b-a3b")
    # W4A8 on the same weights, its runs in turns with the W4A16 model's
    # while that still runs dense.
    moe_w4a16 = {"w4a16_decode_tok_s": PHASES[-1]["decode_tok_s"]}
    moe_a8 = Qwen3Model(moe_params, moe_cfg, max_seq_len=MAX_SEQ, act_quant="int8")
    a8_moe_counts = phase_model(moe_a8, moe_cfg, "a8_moe", "qwen3-30b-a3b W4A8", runs=1, beside={
        **moe_w4a16, "in_turns": _alternating({"w4a16": moe, "w4a8": moe_a8}, prompt)})
    del moe_a8
    with RouteForcer(A8_TIE_MARGIN) as forcer:
        phase_parity(moe_cfg, "a8_moe", forcer, act_quant="int8")
    with RouteForcer() as forcer:
        phase_parity(moe_cfg, "moe_parity", forcer)
        phase_paged_parity(moe_cfg, "moe_parity", forcer)
    # Expert parallelism on the same weights (while the model still runs
    # dense: moe_serving attaches a page pool).
    phase_ep_moe(moe, moe_cfg)
    phase_serving(moe, moe_cfg, "moe_serving", "qwen3-30b-a3b", n_runs=2)
    # W4 g64 on Qwen3-30B-A3B: one 30B model resident at a time.
    del moe, moe_params
    torch.cuda.empty_cache()
    sg_moe_counts = phase_sg_moe(moe_cfg, contract, moe_w4a16)
    phase_dense_moe(moe_cfg)
    phase_cli()
    # Launches on each kernel's own path: the dense 4B run for K1-K3, the
    # 4B serving campaigns for the paged kernels, the dense 30B-A3B run for
    # the grouped expert matmul, the 4B long-prompt prefills for the split's,
    # each quant tier's dense run for its kernel, and the SP paths for theirs:
    # the dense SP runs for row 6, the SP serving campaign for row 14; the
    # masked kernel's and axpby's routes as a user calls them, the prep
    # kernel's three-launch serving campaigns.
    own = {"flash_decode_state": sp_counts, "paged_decode_state": sp_serving_counts,
           "flash_attention_masked": mask_counts, "axpby": axpby_counts,
           "fused_qkv_prep": paged3_counts,
           "quant_matmul_a8": a8_counts, "quant_matmul_sg": sg_counts,
           "grouped_quant_matmul_a8": a8_moe_counts, "grouped_quant_matmul_sg": sg_moe_counts,
           "grouped_quant_matmul": moe_counts, **{n: serving_counts for n in PAGED},
           **{n: long_counts for n in SPLIT}}
    for name, entry in contract.items():
        entry["launches"] = own.get(name, counts)[name]
        if name in agent_counts:
            entry["agent_launches"] = agent_counts[name]
    kern_line = {"kernels": [contract[n] for n in
                             ("quant_matmul", "fused_decode_attention", "flash_attention",
                              *PAGED, "grouped_quant_matmul", *SPLIT, "quant_matmul_a8",
                              "quant_matmul_sg", "grouped_quant_matmul_a8",
                              "grouped_quant_matmul_sg", *SP, "flash_attention_masked",
                              "fused_qkv_prep", "axpby")]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"gpu": smi, "ptxas": ptxas, "phases": PHASES, **kern_line}, indent=1))
    print(smi, flush=True)
    emit(kern_line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
