"""Where the quantized matmuls' routes cross, on the card: each route of an
entry timed beside the others at the same rows.

    python -m tiny_llm_tpu_torch.kernels.qmm_crossover \
        [--kind k1|sg|a8|moe|moe_sg|moe_sg_gemv|prep|all] [--out FILE]

Run from the root of a checkout: it times and checks with `chip_smoke.py`'s
helpers (graph_ms, _close, _random_qt). Each entry picks its route by rows
against constants of its source, and nothing in the port forces a route.
To time every route at one row count, this compiles copies of the sources
with build.py's flags, the constants rewritten so that one route takes
every row:

  * k1 (csrc/quant_matmul.cu B16_MIN_ROWS / STAGED_MIN_ROWS): K1's GEMV,
    bf16 tile and staged wgmma tile. The GEMV against the bf16 tile at M =
    1-5, the bf16 tile against the staged tile at M = 16-160; dense
    Qwen3-4B qkv, gate_up, down + res and o + res and Qwen3-30B-A3B qkv, o +
    res and the router. The GEMV and bf16 tile held to quant_matmul_plain,
    the staged tile to quant_matmul_staged_plain (2 bf16 ulps + 1e-3 of
    max).
  * sg (csrc/quant_matmul_sg.cu B16_MIN_ROWS / STAGED_MIN_ROWS): the
    any-width matmul's three routes as k1's, on Qwen3-4B's qkv, gate_up,
    down + res and o + res at W8 g64 and W4 g32, at the same rows.
  * a8 (A8_GEMV_MAX_ROWS of csrc/quant_matmul.cu and csrc/moe_matmul.cu):
    the W4A8 GEMV against the int8 tile at M = 1-5 (dense: 4B qkv, gate_up,
    down + res, o + res, 30B-A3B qkv, o + res) and at 1-5 tokens' top-8
    (grouped: 30B-A3B gate and down over 128 experts), held to the W4A8
    plain versions.
  * moe (B16_MIN_T of csrc/moe_matmul.cu): the grouped W4A16 matmul's GEMV
    walk against its bf16 tile walk at T = 8, 9, 12, 16, 24, 32 and 64 rows,
    30B-A3B gate and down over 128 experts, under random top-8 routing
    (T = 9, 12: one token's top-8 and a row each of more experts) and with one
    expert holding every row, held to grouped_quant_matmul_plain.
  * moe_sg (SG_B16_MIN_T of csrc/moe_matmul_sg.cu): the grouped any-width
    matmul's GEMV walk against its bf16 tile walk at T = 8 to 1024 rows
    (MOE_SG_ROWS: tokens' top-8), 30B-A3B gate and down over 128 experts,
    W4 g64 and W8 g64, under the two routings a top-8 router bounds: random
    top-8, and one expert in every token's top-8 (T / 8 rows on it, the
    most a top-8 router gives an expert, the rest random). Held to
    grouped_quant_matmul_plain. A last line names the gate, of these rows,
    whose worst loss against the faster route is least.
  * moe_sg_gemv (GEMV_THREADS and GEMV_CHUNKS of csrc/moe_matmul_sg.cu):
    the any-width GEMV walk's block and k-split, each pair a copy, at
    30B-A3B gate and down over 128 experts, W4 g64 and W8 g64, T = 1, 2, 4,
    8 (a token's top-8), 12, 16, 32 and 64 (2, 4 and 8 tokens' top-8) and
    one expert holding 8 or 16 rows; then, as a side timing, the walk at W4
    g128 (the copy with SIDE_W4G128 = 1, which instantiates it there)
    beside the grouped W4A16 matmul's GEMV walk (row 18's moe_gemv, through
    its wrapper) at T = 1-8.
  * prep (PREP_ROWS of csrc/fused_decode_attention.cu): the prep kernel's
    writing route with 2, 4 or all rows of a (b, kv head) a block, at B = 1
    and 4, Qwen3-4B's heads and n_rep 8, held to fused_qkv_prep_plain with
    its pages.

Each copy's entry is called as the wrappers call it (the W4A8 entries with
the workspace their `_workspace` query asks for) and timed by CUDA-graph
replay over random weights (8 sets; 4 for the grouped a8 and moe kinds,
whose active experts' bytes then stay in the L2; the prep: 8 layers'
pools). One JSON line a case: each route's ms side by side."""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import build
from .moe_matmul import grouped_quant_matmul_a8_plain, grouped_quant_matmul_plain
from .quant_matmul import quant_matmul_a8_plain, quant_matmul_plain, quant_matmul_staged_plain

# route -> {source: {constant: value}}: the copy in which that route takes every row.
BIG = 1 << 20
K1_COPIES = {"gemv": {"quant_matmul": {"B16_MIN_ROWS": BIG, "STAGED_MIN_ROWS": BIG}},
             "b16": {"quant_matmul": {"B16_MIN_ROWS": 0, "STAGED_MIN_ROWS": BIG}},
             "staged": {"quant_matmul": {"B16_MIN_ROWS": 0, "STAGED_MIN_ROWS": 0}}}
SG_COPIES = {"sg_gemv": {"quant_matmul_sg": {"B16_MIN_ROWS": BIG, "STAGED_MIN_ROWS": BIG}},
             "sg_b16": {"quant_matmul_sg": {"B16_MIN_ROWS": 0, "STAGED_MIN_ROWS": BIG}},
             "sg_staged": {"quant_matmul_sg": {"B16_MIN_ROWS": 0, "STAGED_MIN_ROWS": 0}}}
SG_WIDTHS = ((8, 64), (4, 32))
A8_COPIES = {"a8_gemv": {n: {"A8_GEMV_MAX_ROWS": 128} for n in ("quant_matmul", "moe_matmul")},
             "a8_tile": {n: {"A8_GEMV_MAX_ROWS": 0} for n in ("quant_matmul", "moe_matmul")}}
K1_DENSE = (("qwen3-4b qkv", 6144, 2560, False), ("qwen3-4b gate_up", 19456, 2560, False),
            ("qwen3-4b down", 2560, 9728, True), ("qwen3-4b o", 2560, 4096, True),
            ("qwen3-30b-a3b qkv", 5120, 2048, False), ("qwen3-30b-a3b o", 2048, 4096, True),
            ("qwen3-30b-a3b router", 128, 2048, False))
K1_ROWS = {("gemv", "b16"): (1, 2, 3, 4, 5),
           ("b16", "staged"): (16, 32, 48, 64, 65, 80, 96, 128, 160)}
MOE_COPIES = {"moe_gemv": {"moe_matmul": {"B16_MIN_T": BIG}},
              "moe_b16": {"moe_matmul": {"B16_MIN_T": 0}}}
MOE_ROWS = (8, 9, 12, 16, 24, 32, 64)
MOE_SG_COPIES = {"sg_moe_gemv": {"moe_matmul_sg": {"SG_B16_MIN_T": BIG}},
                 "sg_moe_b16": {"moe_matmul_sg": {"SG_B16_MIN_T": 0}}}
MOE_SG_WIDTHS = ((4, 64), (8, 64))
MOE_SG_ROWS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 512, 1024)
HOT = 17  # the expert in every token's top-8
# Weight sets the moe_sg kinds replay over: 8 hold more than the 50 MB L2
# at a decode step's T = 8 (8 experts, 7 MB a set), as a step's layers do;
# the 4 of the other grouped kinds let those bytes stay in the L2.
SG_SETS = 8
# The GEMV walk's shape, each pair a copy (SG_B16_MIN_T past every row
# here), and the copy that instantiates the walk at W4 g128 too.
GEMV_SWEEP = {f"sg_gemv_t{th}_c{ch}": {"moe_matmul_sg": {
    "SG_B16_MIN_T": BIG, "GEMV_THREADS": th, "GEMV_CHUNKS": ch}}
    for th in (128, 256, 512) for ch in (2, 4, 8)}
GEMV_W4G128 = {"sg_gemv_w4g128": {"moe_matmul_sg": {"SG_B16_MIN_T": BIG, "SIDE_W4G128": 1}}}
GEMV_ROWS = (1, 2, 4, 8, 12, 16, 32, 64)
PREP_COPIES = {f"prep_rows{r}": {"fused_decode_attention": {"PREP_ROWS": r}} for r in (2, 4, 16)}
A8_DENSE = K1_DENSE[:6]
GROUPED = (("qwen3-30b-a3b gate", 768, 2048), ("qwen3-30b-a3b down", 2048, 768))
E, TOP_K = 128, 8


def _build_routes(tmp: Path, routes: dict) -> dict[str, dict[str, ctypes.CDLL]]:
    """A copy of the sources per route, its constants rewritten, compiled in
    parallel: {route: {source: library}}."""
    nvcc, procs = build._nvcc(), {}
    for route, sources in routes.items():
        src = tmp / route
        shutil.copytree(build.CSRC, src)
        for name, consts in sources.items():
            cu = src / f"{name}.cu"
            text = cu.read_text()
            for const, value in consts.items():
                text, n = re.subn(rf"constexpr int {const} = \d+;",
                                  f"constexpr int {const} = {value};", text)
                if n != 1:
                    raise RuntimeError(f"{cu.name}: {const} not found once")
            cu.write_text(text)
            so = tmp / f"{route}_{name}.so"
            procs[route, name] = (so, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-I", str(src), "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs: dict[str, dict[str, ctypes.CDLL]] = {r: {} for r in routes}
    for (route, name), (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {route} copy of {name}.cu:\n{out}")
        libs[route][name] = ctypes.CDLL(str(so))
    return libs


def _call(lib, fn_name, head, tail_ints, out, rows=None, k_padded=None):
    """Launch `fn_name` of `lib` as the wrappers do: six pointers, the ints,
    (for a W4A8 entry, `rows` given) the workspace its query asks for, the
    stream."""
    ws_args, ws_types = (), []
    if rows is not None:
        query = getattr(lib, fn_name + "_workspace")
        query.argtypes, query.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_size_t
        nbytes = query(rows, k_padded)
        ws = torch.empty(nbytes, dtype=torch.uint8, device="cuda") if nbytes else None
        ws_args, ws_types = (None if ws is None else ws.data_ptr(), nbytes), \
            [ctypes.c_void_p, ctypes.c_size_t]
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * len(tail_ints) + ws_types \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*head, out.data_ptr(), *tail_ints, *ws_args, torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, fn_name)
    return out


def dense(lib, x, qt, res, fn_name="tlt_quant_matmul"):
    out = torch.empty((x.shape[0], qt.out_features), dtype=torch.bfloat16, device="cuda")
    head = (x.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(), qt.biases.data_ptr(),
            None if res is None else res.data_ptr())
    a8, sg = fn_name.endswith("_a8"), fn_name.endswith("_sg")
    ints = (x.shape[0], qt.out_features, qt.k_padded) + ((qt.bits, qt.group_size) if sg else ())
    return _call(lib, fn_name, head, ints, out, x.shape[0] if a8 else None, qt.k_padded)


def grouped(lib, x, qt, sizes, fn_name="tlt_grouped_quant_matmul_a8"):
    out = torch.empty((x.shape[0], qt.out_features), dtype=torch.bfloat16, device="cuda")
    head = (x.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(), qt.biases.data_ptr(),
            sizes.data_ptr())
    a8, sg = fn_name.endswith("_a8"), fn_name.endswith("_sg")
    ints = (x.shape[0], qt.out_features, qt.k_padded, E) + ((qt.bits, qt.group_size) if sg
                                                             else ())
    return _call(lib, fn_name, head, ints, out, x.shape[0] if a8 else None, qt.k_padded)


def _stacked(random_qt, gen, N, K, copies, bits=4, group_size=128):
    """`copies` random stacked expert weights [E, N, K] at the width, drawn
    by `random_qt` (chip_smoke._random_qt)."""
    flat = random_qt(gen, E * N, K, bits, group_size, copies=copies)
    return [type(q)(q.packed.view(E, N, -1), q.scales.view(E, N, -1), q.biases.view(E, N, -1),
                    N, K, q.k_padded, group_size, bits) for q in flat]


def _moe_sizes(rng, routed_tokens, T, one=None):
    """Group sizes [E]: `routed_tokens` tokens' random top-8, then a row each
    of experts they left empty up to T rows; or, with `one`, every row on
    expert `one`."""
    from chip_smoke import _routing

    if one is not None:
        return np.bincount([one] * T, minlength=E)
    sz = _routing(rng, routed_tokens, E, TOP_K)
    for extra in range(T - routed_tokens * TOP_K):
        sz[int(np.flatnonzero(sz == 0)[0])] += 1
    return sz


def _hot_sizes(rng, T, hot=HOT):
    """Group sizes [E] of T / 8 tokens' top-8, expert `hot` in every token's
    and the other seven drawn at random: T / 8 rows on `hot`."""
    others = np.delete(np.arange(E), hot)
    sz = np.bincount([hot] * (T // TOP_K), minlength=E)
    for _ in range(T // TOP_K):
        sz[rng.choice(others, TOP_K - 1, replace=False)] += 1
    return sz


def gate_line(rows, pair):
    """Of the row counts measured, the gate (the first row count on pair[1])
    whose worst loss, time taken over the faster route's across every row
    and case, is least: {"gate", "worst_loss", "loss_by_gate"}."""
    loss = {}
    for gate in sorted({r["T"] for r in rows}) + [BIG]:
        loss[gate] = max(r[pair[r["T"] >= gate]] / min(r[pair[0]], r[pair[1]]) for r in rows)
    best = min(loss, key=loss.get)
    return {"gate": best, "worst_loss": loss[best], "loss_by_gate": loss}


def _prep(lib, args, pages):
    """The prep entry of `lib` with the pools of `pages` = (key_pages,
    value_pages, page [B], slot [B]): q [B, Hkv, n_rep, D] returned."""
    qkv, cos_row, sin_row, qw, kw, eps = args
    B, Hkv, r, D = qkv.shape
    q = torch.empty((B, Hkv, r - 2, D), dtype=torch.bfloat16, device="cuda")
    kp, vp, page, slot = pages
    fn = lib.tlt_fused_qkv_prep
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(qkv.data_ptr(), cos_row.data_ptr(), sin_row.data_ptr(), qw.data_ptr(),
             kw.data_ptr(), q.data_ptr(), kp.data_ptr(), vp.data_ptr(), page.data_ptr(),
             slot.data_ptr(), B, Hkv, D, r - 2, kp.shape[2], eps,
             torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "tlt_fused_qkv_prep")
    return q


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", choices=("k1", "sg", "a8", "moe", "moe_sg", "moe_sg_gemv", "prep",
                                       "all"), default="all")
    ap.add_argument("--out", help="also write every line to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("qmm_crossover needs the card")
    sys.path.insert(0, str(Path.cwd()))
    from chip_smoke import _close, _random_qt, _routing, graph_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = [{"gpu": smi.strip(), "timing": "CUDA-graph replay, ms a call"}]
    print(json.dumps(lines[0]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    routes = {**(K1_COPIES if args.kind in ("k1", "all") else {}),
              **(SG_COPIES if args.kind in ("sg", "all") else {}),
              **(A8_COPIES if args.kind in ("a8", "all") else {}),
              **(MOE_COPIES if args.kind in ("moe", "all") else {}),
              **(MOE_SG_COPIES if args.kind in ("moe_sg", "all") else {}),
              **({**GEMV_SWEEP, **GEMV_W4G128} if args.kind in ("moe_sg_gemv", "all") else {}),
              **(PREP_COPIES if args.kind in ("prep", "all") else {})}
    tmp = tempfile.TemporaryDirectory()
    libs = _build_routes(Path(tmp.name), routes)

    def case(row, pair, call, wants, weights, codes=True):
        """Each route of `pair` (two routes, or a sweep's copies): held to its
        plain version (`_close`), then timed."""
        for route in pair:
            got = call(libs[route], weights[0])
            torch.cuda.synchronize()
            ratio = _close(got, wants[route], codes)[1]
            if not ratio <= 1:
                raise AssertionError(f"{row} on the {route} copy: {ratio} x the tolerance")
            row[route] = graph_ms(lambda: [call(libs[route], w) for w in weights]) / len(weights)
        if len(pair) == 2:
            row[f"{pair[1]}_over_{pair[0]}"] = row[pair[1]] / row[pair[0]]
        else:
            row["fastest"] = min(pair, key=row.get)
        print(json.dumps(row), flush=True)
        lines.append(row)

    def dense_cases(kind, routes, lib_name, fn_name, bits, group_size, shapes):
        """One dense entry's routes ({"gemv": copy, "b16": copy, "staged":
        copy}) on `shapes` at K1_ROWS, each held to its route's plain
        version."""
        for label, N, K, residual in shapes:
            ws = _random_qt(gen, N, K, bits, group_size, copies=8)
            for pair, Ms in K1_ROWS.items():
                for M in Ms:
                    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                    r = torch.randn((M, N), generator=gen, device="cuda").to(
                        torch.bfloat16) if residual else None
                    f32_plain = quant_matmul_plain(x, ws[0], r)
                    wants = {routes["gemv"]: f32_plain, routes["b16"]: f32_plain,
                             routes["staged"]: quant_matmul_staged_plain(x, ws[0], r)}
                    case({"kind": kind, "shape": label + (" +res" if residual else ""),
                          "M": M}, tuple(routes[r_] for r_ in pair),
                         lambda lib, w: dense(lib[lib_name], x, w, r, fn_name), wants, ws)
            del ws

    with tmp:
        if args.kind in ("k1", "all"):
            dense_cases("k1", {"gemv": "gemv", "b16": "b16", "staged": "staged"}, "quant_matmul",
                        "tlt_quant_matmul", 4, 128, K1_DENSE)
        if args.kind in ("sg", "all"):
            for bits, group_size in SG_WIDTHS:
                dense_cases(f"sg W{bits} g{group_size}",
                            {"gemv": "sg_gemv", "b16": "sg_b16", "staged": "sg_staged"},
                            "quant_matmul_sg", "tlt_quant_matmul_sg", bits, group_size,
                            K1_DENSE[:4])
        if args.kind in ("a8", "all"):
            pair = ("a8_gemv", "a8_tile")
            for label, N, K, residual in A8_DENSE:
                ws = _random_qt(gen, N, K, 4, 128, copies=8)
                for M in range(1, 6):
                    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                    r = torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16) \
                        if residual else None
                    want = quant_matmul_a8_plain(x, ws[0], r)
                    case({"kind": "a8 dense", "shape": label + (" +res" if residual else ""),
                          "M": M}, pair,
                         lambda lib, w: dense(lib["quant_matmul"], x, w, r, "tlt_quant_matmul_a8"),
                         dict.fromkeys(pair, want), ws)
                del ws
            rng = np.random.default_rng(3)
            for label, N, K in GROUPED:
                ws = _stacked(_random_qt, gen, N, K, 4)
                for tokens in range(1, 6):
                    ids = np.stack([rng.choice(E, TOP_K, replace=False) for _ in range(tokens)])
                    sizes = torch.as_tensor(np.bincount(ids.ravel(), minlength=E),
                                            dtype=torch.int32, device="cuda")
                    T = tokens * TOP_K
                    x = torch.randn((T, K), generator=gen, device="cuda").to(torch.bfloat16)
                    want = grouped_quant_matmul_a8_plain(x, ws[0], sizes)
                    case({"kind": "a8 grouped", "shape": label, "T": T}, pair,
                         lambda lib, w: grouped(lib["moe_matmul"], x, w, sizes),
                         dict.fromkeys(pair, want), ws)
                del ws
        if args.kind in ("moe", "all"):
            pair, rng = ("moe_gemv", "moe_b16"), np.random.default_rng(18)
            for label, N, K in GROUPED:
                ws = _stacked(_random_qt, gen, N, K, 4)
                for T in MOE_ROWS:
                    routed = _routing(rng, T // TOP_K, E, TOP_K)
                    for extra in range(T % TOP_K):  # rows of experts the tokens left empty
                        routed[int(np.flatnonzero(routed == 0)[extra])] += 1
                    for routing, sz in (("random top-8", routed),
                                        ("one expert", np.bincount([17] * T, minlength=E))):
                        sizes = torch.as_tensor(sz, dtype=torch.int32, device="cuda")
                        x = torch.randn((T, K), generator=gen, device="cuda").to(torch.bfloat16)
                        want = grouped_quant_matmul_plain(x, ws[0], sizes)
                        case({"kind": "moe", "shape": label, "routing": routing, "T": T,
                              "experts": int((sz > 0).sum())}, pair,
                             lambda lib, w: grouped(lib["moe_matmul"], x, w, sizes,
                                                    "tlt_grouped_quant_matmul"),
                             dict.fromkeys(pair, want), ws)
                del ws
        if args.kind in ("moe_sg", "all"):
            pair, rng, first = ("sg_moe_gemv", "sg_moe_b16"), np.random.default_rng(20), len(lines)
            for bits, group_size in MOE_SG_WIDTHS:
                for label, N, K in GROUPED:
                    ws = _stacked(_random_qt, gen, N, K, SG_SETS, bits, group_size)
                    for T in MOE_SG_ROWS:
                        for routing, sz in (("random top-8", _routing(rng, T // TOP_K, E, TOP_K)),
                                            (f"expert {HOT} in every top-8", _hot_sizes(rng, T))):
                            sizes = torch.as_tensor(sz, dtype=torch.int32, device="cuda")
                            x = torch.randn((T, K), generator=gen, device="cuda").to(
                                torch.bfloat16)
                            want = grouped_quant_matmul_plain(x, ws[0], sizes)
                            case({"kind": f"moe_sg W{bits} g{group_size}", "shape": label,
                                  "routing": routing, "T": T,
                                  "experts": int((sz > 0).sum())}, pair,
                                 lambda lib, w: grouped(lib["moe_matmul_sg"], x, w, sizes,
                                                        "tlt_grouped_quant_matmul_sg"),
                                 dict.fromkeys(pair, want), ws, codes=False)
                    del ws
            row = {"kind": "moe_sg gate", **gate_line(lines[first:], pair)}
            print(json.dumps(row), flush=True)
            lines.append(row)
        if args.kind in ("moe_sg_gemv", "all"):
            from .moe_matmul import grouped_quant_matmul_cuda

            sweep, rng = tuple(GEMV_SWEEP), np.random.default_rng(21)
            for bits, group_size in MOE_SG_WIDTHS:
                for label, N, K in GROUPED:
                    ws = _stacked(_random_qt, gen, N, K, SG_SETS, bits, group_size)
                    specs = [(f"{T} rows, random top-8", _moe_sizes(rng, T // TOP_K, T))
                             for T in GEMV_ROWS]
                    specs += [(f"one expert holds {T} rows", _moe_sizes(rng, 0, T, one=17))
                              for T in (8, 16)]
                    for what, sz in specs:
                        T = int(sz.sum())
                        sizes = torch.as_tensor(sz, dtype=torch.int32, device="cuda")
                        x = torch.randn((T, K), generator=gen, device="cuda").to(torch.bfloat16)
                        want = grouped_quant_matmul_plain(x, ws[0], sizes)
                        case({"kind": f"moe_sg_gemv W{bits} g{group_size}", "shape": label,
                              "case": what, "T": T, "experts": int((sz > 0).sum())}, sweep,
                             lambda lib, w: grouped(lib["moe_matmul_sg"], x, w, sizes,
                                                    "tlt_grouped_quant_matmul_sg"),
                             dict.fromkeys(sweep, want), ws, codes=False)
                    del ws
            # The side timing: the walk at W4 g128 beside row 18's GEMV walk.
            for label, N, K in GROUPED:
                ws = _stacked(_random_qt, gen, N, K, SG_SETS)
                for T in range(1, TOP_K + 1):
                    sz = _moe_sizes(rng, 0, T)
                    sizes = torch.as_tensor(sz, dtype=torch.int32, device="cuda")
                    x = torch.randn((T, K), generator=gen, device="cuda").to(torch.bfloat16)
                    want = grouped_quant_matmul_plain(x, ws[0], sizes)
                    walk = libs["sg_gemv_w4g128"]["moe_matmul_sg"]
                    got = grouped(walk, x, ws[0], sizes, "tlt_grouped_quant_matmul_sg")
                    row = {"kind": "moe_sg_gemv at W4 g128, beside row 18's moe_gemv",
                           "shape": label, "T": T, "experts": T,
                           "walk_err_over_tol": _close(got, want)[1],
                           "row18_err_over_tol": _close(grouped_quant_matmul_cuda(
                               x, ws[0], sizes), want)[1]}
                    if not max(row["walk_err_over_tol"], row["row18_err_over_tol"]) <= 1:
                        raise AssertionError(f"{row}: over the tolerance")
                    row["sg_gemv_walk"] = graph_ms(lambda: [grouped(
                        walk, x, w, sizes, "tlt_grouped_quant_matmul_sg") for w in ws]) / len(ws)
                    row["row18_moe_gemv"] = graph_ms(lambda: [grouped_quant_matmul_cuda(
                        x, w, sizes) for w in ws]) / len(ws)
                    row["walk_over_row18"] = row["sg_gemv_walk"] / row["row18_moe_gemv"]
                    print(json.dumps(row), flush=True)
                    lines.append(row)
                del ws
        if args.kind in ("prep", "all"):
            from .fused_decode_attention import fused_qkv_prep_plain

            copies, D, ps, pages, Ly = tuple(PREP_COPIES), 128, 128, 16, 8
            cos_t = torch.rand((1024, D // 2), generator=gen, device="cuda")
            sin_t = torch.rand((1024, D // 2), generator=gen, device="cuda")
            for Hkv, n_rep in ((8, 4), (4, 8)):
                pools = [torch.randn((2, pages, Hkv, ps, D), generator=gen, device="cuda").to(
                    torch.bfloat16) for _ in range(Ly)]
                for offs in ([700], [100, 700, 37, 999]):
                    B = len(offs)
                    qkv = (3 * torch.randn((B, Hkv, n_rep + 2, D), generator=gen,
                                           device="cuda")).to(torch.bfloat16)
                    qw, kw = (1 + 0.1 * torch.randn((2, D), generator=gen, device="cuda")).to(
                        torch.bfloat16)
                    off = torch.tensor(offs, device="cuda")
                    args_ = (qkv, cos_t[off], sin_t[off], qw, kw, 1e-6)
                    page = torch.arange(1, B + 1, device="cuda", dtype=torch.int64)
                    slot = off.to(torch.int64) % ps
                    want_pool = pools[0].clone()
                    want = fused_qkv_prep_plain(qkv, off, cos_t[off], sin_t[off], qw, kw,
                                                eps=1e-6, pages=(want_pool[0], want_pool[1],
                                                                 page, slot))

                    def run(lib, pool):
                        return _prep(lib["fused_decode_attention"], args_,
                                     (pool[0], pool[1], page, slot))

                    case({"kind": "prep, writing the pages", "heads": f"Hkv {Hkv} n_rep {n_rep}",
                          "B": B, "offsets": offs}, copies, run, dict.fromkeys(copies, want),
                         pools, codes=False)
                    got_pool = pools[0]  # written by every copy: the same rows
                    for what in (0, 1):
                        ratio = _close(got_pool[what][page, :, slot],
                                       want_pool[what][page, :, slot])[1]
                        if not ratio <= 1:
                            raise AssertionError(f"prep pool {what}: {ratio} x the tolerance")
                del pools
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
