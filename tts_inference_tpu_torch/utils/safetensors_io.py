"""Reader and writer of the safetensors format, with torch and the standard
library only (the ``safetensors`` package is not a dependency of the port).

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` of str → str), then the tensors' raw
little-endian bytes, offsets counted from the end of the header.

``read_file`` maps the file copy-on-write and returns tensors that are views
of the mapping: nothing is read until a tensor is used, and moving a tensor
to the card reads its bytes once, so the host never holds a model twice.
bf16 goes through ``torch.frombuffer``; numpy has no bf16.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import sys
from typing import Dict, Mapping, Optional, Tuple

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}

if sys.byteorder != "little":   # pragma: no cover
    raise ImportError("safetensors_io reads and writes little-endian hosts "
                      "only")


def read_header(path: str) -> Tuple[int, dict]:
    """(start of the data, the header dict) of one file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", head)
        size = os.fstat(f.fileno()).st_size
        if n > size - 8:
            raise ValueError(f"{path}: header of {n} bytes in a file of "
                             f"{size}")
        header = json.loads(f.read(n))
    return 8 + n, header


def read_file(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of one file, as CPU views of a copy-on-write mapping."""
    data0, header = read_header(path)
    out: Dict[str, torch.Tensor] = {}
    mm = None
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size > data0:
            # ACCESS_COPY is writable (torch.frombuffer warns on read-only
            # memory) and never writes the file back
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(x) for x in info["data_offsets"])
        numel = 1
        for s in shape:
            numel *= s
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != numel * itemsize or begin < 0 \
                or data0 + end > size:
            raise ValueError(f"{path}: {name} {info['dtype']}{list(shape)} "
                             f"has data_offsets [{begin}, {end}]")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        offset = data0 + begin
        if offset % itemsize:
            # the format does not promise alignment: copy the odd one
            buf = bytearray(mm[offset:offset + numel * itemsize])
            t = torch.frombuffer(buf, dtype=dtype, count=numel)
        else:
            t = torch.frombuffer(mm, dtype=dtype, count=numel, offset=offset)
        out[name] = t.reshape(shape)
    return out


def read_metadata(path: str) -> Dict[str, str]:
    return dict(read_header(path)[1].get("__metadata__") or {})


def checkpoint_files(path: str) -> list:
    """The safetensors files of a checkpoint directory: those named by
    ``model.safetensors.index.json`` when it exists, else every
    ``*.safetensors`` in sorted order."""
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            names = sorted(set(json.load(f)["weight_map"].values()))
    else:
        names = sorted(f for f in os.listdir(path)
                       if f.endswith(".safetensors"))
    if not names:
        raise FileNotFoundError(f"no .safetensors in {path}")
    return [os.path.join(path, n) for n in names]


def read_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory (see ``checkpoint_files``)."""
    out: Dict[str, torch.Tensor] = {}
    for f in checkpoint_files(path):
        out.update(read_file(f))
    return out


def _header(tensors: Mapping[str, torch.Tensor],
            metadata: Optional[Mapping[str, str]]) -> Tuple[bytes, list]:
    # largest elements first, as the safetensors library orders them: with
    # the header padded to 8 bytes every tensor starts aligned to its size
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, pos = {}, 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for k in order:
        t = tensors[k]
        if t.dtype not in _NAMES:
            raise ValueError(f"{k}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [pos, pos + n]}
        pos += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    return struct.pack("<Q", len(raw)) + raw, order


def _host_bytes(t: torch.Tensor):
    """A tensor's bytes on the host, as a buffer for file.write."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return t.view(torch.uint8).numpy()


def write_file(path: str, tensors: Mapping[str, torch.Tensor],
               metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write `tensors` (on any device) to one file, one tensor at a time:
    the host holds one tensor's bytes at once. Returns the data bytes."""
    head, order = _header(tensors, metadata)
    total = 0
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        f.write(head)
        for k in order:
            if tensors[k].numel():
                buf = _host_bytes(tensors[k])
                f.write(buf)
                total += buf.nbytes
    os.replace(tmp, path)
    return total

