"""Where the quantized matmuls' routes cross, on the card: each route of an
entry timed beside the others at the same rows.

    python -m tiny_llm_tpu_torch.kernels.qmm_crossover [--kind k1|sg|a8|moe|all] [--out FILE]

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

Each copy's entry is called as the wrappers call it (the W4A8 entries with
the workspace their `_workspace` query asks for) and timed by CUDA-graph
replay over 8 random weights. One JSON line a case: each route's ms side
by side."""

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
    a8 = fn_name.endswith("_a8")
    return _call(lib, fn_name, head, (x.shape[0], qt.out_features, qt.k_padded, E), out,
                 x.shape[0] if a8 else None, qt.k_padded)


def _stacked(random_qt, gen, N, K, copies):
    """`copies` random stacked expert weights [E, N, K], W4 g128, drawn
    by `random_qt` (chip_smoke._random_qt)."""
    flat = random_qt(gen, E * N, K, 4, 128, copies=copies)
    return [type(q)(q.packed.view(E, N, -1), q.scales.view(E, N, -1), q.biases.view(E, N, -1),
                    N, K, q.k_padded, 128, 4) for q in flat]


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", choices=("k1", "sg", "a8", "moe", "all"), default="all")
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
              **(MOE_COPIES if args.kind in ("moe", "all") else {})}
    tmp = tempfile.TemporaryDirectory()
    libs = _build_routes(Path(tmp.name), routes)

    def case(row, pair, call, wants, weights):
        """Each route of `pair`: held to its plain version, then timed."""
        for route in pair:
            got = call(libs[route], weights[0])
            torch.cuda.synchronize()
            ratio = _close(got, wants[route], True)[1]
            if not ratio <= 1:
                raise AssertionError(f"{row} on the {route} copy: {ratio} x the tolerance")
            row[route] = graph_ms(lambda: [call(libs[route], w) for w in weights]) / len(weights)
        row[f"{pair[1]}_over_{pair[0]}"] = row[pair[1]] / row[pair[0]]
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
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
