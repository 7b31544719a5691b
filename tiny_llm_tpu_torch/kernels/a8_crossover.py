"""Where the W4A8 kernels' two routes cross: the GEMV against the int8 tile
at the same rows, on the card.

    python -m tiny_llm_tpu_torch.kernels.a8_crossover [--out FILE]

Run from the root of a checkout: it times and checks with `chip_smoke.py`'s
helpers (graph_ms, _close, _random_qt). Each W4A8 entry picks its route by
rows against the A8_GEMV_MAX_ROWS of its source (csrc/quant_matmul.cu,
csrc/moe_matmul.cu), and nothing in the port forces a route. To time both
at one row count, this compiles two copies of the sources with build.py's
flags, the constant rewritten: 0 puts every row on the tile, 128 every row
on the GEMV. Each copy's entry is called as the wrappers call it (the
workspace its `_workspace` query asks for), held to the plain version (2
bf16 ulps + 1e-3 of max) and timed by CUDA-graph replay over 8 random
weights: dense, Qwen3-4B's qkv, gate_up, down + res and o + res and
Qwen3-30B-A3B's qkv and o + res at M = 1-5; grouped, Qwen3-30B-A3B's gate
and down over 128 experts at 1-5 tokens' top-8 routing. One JSON line a
case: GEMV and tile ms side by side."""

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
from .moe_matmul import grouped_quant_matmul_a8_plain
from .quant_matmul import quant_matmul_a8_plain

ROUTES = {"gemv": 128, "tile": 0}  # A8_GEMV_MAX_ROWS of each copy
DENSE = (("qwen3-4b qkv", 6144, 2560, False), ("qwen3-4b gate_up", 19456, 2560, False),
         ("qwen3-4b down", 2560, 9728, True), ("qwen3-4b o", 2560, 4096, True),
         ("qwen3-30b-a3b qkv", 5120, 2048, False), ("qwen3-30b-a3b o", 2048, 4096, True))
GROUPED = (("qwen3-30b-a3b gate", 768, 2048), ("qwen3-30b-a3b down", 2048, 768))
E, TOP_K = 128, 8


def _build_routes(tmp: Path) -> dict[str, dict[str, ctypes.CDLL]]:
    """Both copies of quant_matmul.cu and moe_matmul.cu, compiled in
    parallel: {route: {source: library}}."""
    nvcc, procs = build._nvcc(), {}
    for route, rows in ROUTES.items():
        src = tmp / route
        shutil.copytree(build.CSRC, src)
        for name in ("quant_matmul", "moe_matmul"):
            cu = src / f"{name}.cu"
            text, n = re.subn(r"constexpr int A8_GEMV_MAX_ROWS = \d+;",
                              f"constexpr int A8_GEMV_MAX_ROWS = {rows};", cu.read_text())
            if n != 1:
                raise RuntimeError(f"{cu.name}: A8_GEMV_MAX_ROWS not found once")
            cu.write_text(text)
            so = tmp / f"{route}_{name}.so"
            procs[route, name] = (so, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-I", str(src), "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs: dict[str, dict[str, ctypes.CDLL]] = {r: {} for r in ROUTES}
    for (route, name), (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {route} copy of {name}.cu:\n{out}")
        libs[route][name] = ctypes.CDLL(str(so))
    return libs


def _call(lib, fn_name, head, rows, k_padded, tail_ints, out):
    """Launch `fn_name` of `lib` as the wrappers do: six pointers, the ints,
    the workspace its query asks for, the stream."""
    query = getattr(lib, fn_name + "_workspace")
    query.argtypes, query.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_size_t
    nbytes = query(rows, k_padded)
    ws = torch.empty(nbytes, dtype=torch.uint8, device="cuda") if nbytes else None
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * len(tail_ints) \
        + [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*head, out.data_ptr(), *tail_ints, None if ws is None else ws.data_ptr(), nbytes,
             torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, fn_name)
    return out


def dense(lib, x, qt, res):
    out = torch.empty((x.shape[0], qt.out_features), dtype=torch.bfloat16, device="cuda")
    head = (x.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(), qt.biases.data_ptr(),
            None if res is None else res.data_ptr())
    return _call(lib, "tlt_quant_matmul_a8", head, x.shape[0], qt.k_padded,
                 (x.shape[0], qt.out_features, qt.k_padded), out)


def grouped(lib, x, qt, sizes):
    out = torch.empty((x.shape[0], qt.out_features), dtype=torch.bfloat16, device="cuda")
    head = (x.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(), qt.biases.data_ptr(),
            sizes.data_ptr())
    return _call(lib, "tlt_grouped_quant_matmul_a8", head, x.shape[0], qt.k_padded,
                 (x.shape[0], qt.out_features, qt.k_padded, E), out)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every line to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("a8_crossover needs the card")
    sys.path.insert(0, str(Path.cwd()))
    from chip_smoke import _close, _random_qt, graph_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = [{"gpu": smi.strip(), "timing": "CUDA-graph replay, ms a call"}]
    print(json.dumps(lines[0]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    tmp = tempfile.TemporaryDirectory()
    libs = _build_routes(Path(tmp.name))

    def case(row, call, want, weights):
        for route, lib in libs.items():
            got = call(lib, weights[0])
            torch.cuda.synchronize()
            ratio = _close(got, want, True)[1]
            if not ratio <= 1:
                raise AssertionError(f"{row} on the {route} copy: {ratio} x the tolerance")
            row[route] = graph_ms(lambda: [call(lib, w) for w in weights]) / len(weights)
        row["tile_over_gemv"] = row["tile"] / row["gemv"]
        print(json.dumps(row), flush=True)
        lines.append(row)

    with tmp:
        for label, N, K, residual in DENSE:
            ws = _random_qt(gen, N, K, 4, 128, copies=8)
            for M in range(1, 6):
                x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                r = torch.randn((M, N), generator=gen, device="cuda").to(torch.bfloat16) \
                    if residual else None
                case({"kind": "dense", "shape": label + (" +res" if residual else ""), "M": M},
                     lambda lib, w: dense(lib["quant_matmul"], x, w, r),
                     quant_matmul_a8_plain(x, ws[0], r), ws)
            del ws
        rng = np.random.default_rng(3)
        for label, N, K in GROUPED:
            flat = _random_qt(gen, E * N, K, 4, 128, copies=4)
            ws = [type(q)(q.packed.view(E, N, -1), q.scales.view(E, N, -1),
                          q.biases.view(E, N, -1), N, K, q.k_padded, 128, 4) for q in flat]
            for tokens in range(1, 6):
                ids = np.stack([rng.choice(E, TOP_K, replace=False) for _ in range(tokens)])
                sizes = torch.as_tensor(np.bincount(ids.ravel(), minlength=E),
                                        dtype=torch.int32, device="cuda")
                T = tokens * TOP_K
                x = torch.randn((T, K), generator=gen, device="cuda").to(torch.bfloat16)
                case({"kind": "grouped", "shape": label, "T": T},
                     lambda lib, w: grouped(lib["moe_matmul"], x, w, sizes),
                     grouped_quant_matmul_a8_plain(x, ws[0], sizes), ws)
            del ws, flat
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
