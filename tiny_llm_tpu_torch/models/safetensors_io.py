"""A small reader of the safetensors format, in numpy, for the loader.

A file is an 8-byte little-endian header length n, n bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, optional
"__metadata__"}), then the raw little-endian data, offsets counted from
the end of the header. The file is memory-mapped copy-on-write: a tensor
is a view of the mapping until the caller copies it (to the card, say).

numpy has no bfloat16 type, so BF16 data is read as uint16 and viewed as
torch.bfloat16; U32 data (MLX's packed words) is viewed as torch.int32,
the dtype the port stores packed words in (the same bits). The reader
needs neither the `safetensors` package nor `ml_dtypes`. `save_file`
writes the same format (torch.uint32 tensors as U32), for the tests and
`chip_smoke.py`'s checkpoint exports.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the raw data, torch dtype to view it as or None)
DTYPES = {
    "F32": (np.float32, None),
    "F16": (np.float16, None),
    "BF16": (np.uint16, torch.bfloat16),
    "U32": (np.uint32, torch.int32),
    "I32": (np.int32, None),
    "I64": (np.int64, None),
    "U8": (np.uint8, None),
}


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, as CPU tensors over a
    copy-on-write memory map (a tensor whose data is not aligned to its
    element size is copied)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    base = 8 + n
    raw = np.memmap(path, dtype=np.uint8, mode="c") if os.path.getsize(path) > base else None
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, "
                             f"which the reader does not take ({sorted(DTYPES)})")
        np_dtype, view = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        itemsize = np.dtype(np_dtype).itemsize
        if end - begin != int(np.prod(shape, dtype=np.int64)) * itemsize:
            raise ValueError(f"{path}: tensor {name} holds {end - begin} bytes, not "
                             f"{shape} x {itemsize}")
        data = raw[base + begin : base + end] if end > begin else np.zeros(0, np.uint8)
        if (base + begin) % itemsize:
            data = data.copy()
        t = torch.from_numpy(data.view(np_dtype).reshape(shape))
        out[name] = t.view(view) if view is not None else t
    return out


def load_dir(model_dir: str) -> dict[str, torch.Tensor]:
    """Every tensor of every .safetensors file under `model_dir`, the shard
    files read in sorted order (a name in two shards keeps the later one)."""
    tensors: dict[str, torch.Tensor] = {}
    for name in sorted(os.listdir(model_dir)):
        if name.endswith(".safetensors"):
            tensors.update(load_file(os.path.join(model_dir, name)))
    if not tensors:
        raise FileNotFoundError(f"no .safetensors files under {model_dir}")
    return tensors


_TORCH_TO_ST = {
    torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16", torch.uint32: "U32",
    torch.int32: "I32", torch.int64: "I64", torch.uint8: "U8",
}


def save_file(tensors: dict[str, torch.Tensor], path: str) -> int:
    """Write `tensors` (any device; torch.uint32 as U32, bf16 as BF16) as
    one .safetensors file, in the order given. Returns the bytes written."""
    header, offset, parts = {}, 0, []
    for name, t in tensors.items():
        if t.dtype not in _TORCH_TO_ST:
            raise ValueError(f"tensor {name}: dtype {t.dtype} has no safetensors name here")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _TORCH_TO_ST[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        parts.append(t)
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in parts:
            raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
            f.write(memoryview(raw))
    return 8 + len(blob) + offset
