"""The safetensors file format in torch, with no package beyond torch.

A file is an 8-byte little-endian header length N, N bytes of UTF-8 JSON,
then the tensors' raw bytes. The header maps each name to ``{"dtype",
"shape", "data_offsets": [begin, end]}`` (offsets into the bytes after the
header) and may hold ``"__metadata__"``, a map of strings. F32, F16, BF16
and I8 are read and written; any other dtype raises ValueError naming it.

``SafeFile`` maps a file once and returns one tensor at a time as a view of
the mapping (copy-on-write, so the file never changes): a caller that copies
each tensor to its place holds one at a time, not the file. ``save_file``
knows every name, shape and dtype before it writes a byte: it writes the
header, then streams each tensor from wherever it lives, a CUDA tensor
through one pinned staging buffer. Its files open under the safetensors
package: the header is padded with spaces to a multiple of 8 bytes, and the
offsets run contiguously from 0 to the end of the file, larger elements
first, so every tensor starts aligned to its element size.
"""
from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Dict, List, Mapping, Optional

import torch

DTYPES: Dict[str, torch.dtype] = {"F32": torch.float32, "F16": torch.float16,
                                  "BF16": torch.bfloat16, "I8": torch.int8}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}
_STAGE_BYTES = 64 << 20  # the pinned buffer a CUDA tensor streams through


def _dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"safetensors dtype {name!r} is not supported "
                         f"(supported: {sorted(DTYPES)})") from None


def _dtype_name(dtype: torch.dtype) -> str:
    try:
        return _NAMES[dtype]
    except KeyError:
        raise ValueError(f"dtype {dtype} cannot be written as safetensors "
                         f"(supported: {sorted(DTYPES)})") from None


class SafeFile:
    """One .safetensors file, mapped once. ``get`` returns a tensor on the
    mapping: no bytes are read until it is used, and it stays valid while it
    lives (it holds the mapping)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: not a safetensors file ({size} bytes)")
            (n,) = struct.unpack("<Q", head)
            if n > size - 8:
                raise ValueError(f"{path}: header of {n} bytes in a file of {size}")
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._base = 8 + n
        self._entries = header
        for name, info in header.items():
            begin, end = info["data_offsets"]
            if not 0 <= begin <= end <= size - self._base:
                raise ValueError(f"{path}: {name} lies outside the file")

    def keys(self) -> List[str]:
        return list(self._entries)

    def get(self, name: str) -> torch.Tensor:
        info = self._entries[name]
        dtype = _dtype(info["dtype"])
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        count = math.prod(shape)
        if end - begin != count * dtype.itemsize:
            raise ValueError(f"{self.path}: {name} holds {end - begin} bytes, not the "
                             f"{count * dtype.itemsize} of {info['dtype']} {list(shape)}")
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self._map, dtype=dtype, count=count,
                                offset=self._base + begin).view(shape)


def _write_tensor(f, t: torch.Tensor, dtype: torch.dtype, stage: List[torch.Tensor]) -> None:
    """t's bytes in `dtype`, row-major; a CUDA tensor goes through the pinned
    buffer in stage[0] (made on first use)."""
    t = t.detach()
    if t.dtype != dtype:
        t = t.to(dtype)
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    if flat.device.type == "cpu":
        f.write(memoryview(flat.numpy()))
        return
    if not stage:
        stage.append(torch.empty(_STAGE_BYTES, dtype=torch.uint8, pin_memory=True))
    buf = stage[0]
    for lo in range(0, flat.numel(), _STAGE_BYTES):
        n = min(_STAGE_BYTES, flat.numel() - lo)
        buf[:n].copy_(flat[lo:lo + n])
        f.write(memoryview(buf[:n].numpy()))


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None,
              dtypes: Optional[Mapping[str, torch.dtype]] = None) -> None:
    """Write `tensors` (any device, any strides) to `path`, each in its own
    dtype or in dtypes[name]. A tensor is cast and made contiguous on its
    device only when its turn comes."""
    dtypes = dtypes or {}
    entries = [(name, t, dtypes.get(name, t.dtype)) for name, t in tensors.items()]
    entries.sort(key=lambda e: -e[2].itemsize)  # stable: the given order within a size
    header: Dict[str, object] = {}
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise ValueError("safetensors metadata maps strings to strings")
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t, dtype in entries:
        nbytes = t.numel() * dtype.itemsize
        header[name] = {"dtype": _dtype_name(dtype), "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    stage: List[torch.Tensor] = []
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t, dtype in entries:
            _write_tensor(f, t, dtype, stage)
