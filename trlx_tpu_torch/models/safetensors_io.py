"""The safetensors checkpoint format, read and written without the
``safetensors`` package (the counterpart of ``LazySafetensors`` in
``trlx_tpu.models.hf_import``).

A file is an 8-byte little-endian header length N, N bytes of JSON header
(``{"__metadata__": {...}, name: {"dtype", "shape", "data_offsets": [begin,
end]}, ...}``, padded with spaces to a multiple of 8), then the raw
little-endian tensor bytes, offsets counted from the end of the header. A
sharded checkpoint is ``model-0000i-of-0000n.safetensors`` files beside
``model.safetensors.index.json`` (``{"metadata": {"total_size"},
"weight_map": {name: file}}``), as ``save_pretrained`` writes them.

``SafetensorsReader`` is a lazy mapping: it parses the headers and maps each
file copy-on-write, and every lookup materialises one tensor as a view of
the mapping (the pages are read when the tensor is). ``write_safetensors``
streams: the header is computed from shapes and dtypes, then each tensor is
produced (a ``LazyTensor`` thunk), written and dropped, so host memory stays
O(largest tensor).
"""

import json
import mmap
import os
import struct
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Mapping, Tuple, Union

import numpy as np
import torch

SINGLE_FILE = "model.safetensors"
INDEX_FILE = "model.safetensors.index.json"
DEFAULT_MAX_SHARD_BYTES = 5 * 10**9  # transformers' save_pretrained default, "5GB"

# safetensors dtype name <-> torch dtype, for the dtypes a checkpoint of the
# supported families holds. Anything else raises by name.
_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
# The numpy dtype each is read through (bf16 as its 16-bit words, then viewed).
_NP = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16, "I64": np.int64, "I32": np.int32, "BOOL": np.bool_}


def dtype_name(dtype: torch.dtype) -> str:
    if dtype not in _NAMES:
        raise ValueError(f"safetensors: dtype {dtype} is not supported (supported: {sorted(_DTYPES)})")
    return _NAMES[dtype]


def read_header(path: str) -> Tuple[Dict, int]:
    """(header dict, byte offset of the data) of one safetensors file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n).decode("utf-8"))
    return header, 8 + n


class _File:
    """One mapped safetensors file: its tensors' entries and the mapping."""

    def __init__(self, path: str):
        self.path = path
        self.header, self.data_start = read_header(path)
        self.header.pop("__metadata__", None)
        for name, entry in self.header.items():
            if entry["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {entry['dtype']}, which is not supported "
                                 f"(supported: {sorted(_DTYPES)})")
        self._mm = None

    def tensor(self, name: str) -> torch.Tensor:
        entry = self.header[name]
        if self._mm is None:
            with open(self.path, "rb") as f:
                # Copy-on-write: a writable view without touching the file.
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        begin, end = entry["data_offsets"]
        shape = [int(s) for s in entry["shape"]]
        npdt = np.dtype(_NP[entry["dtype"]]).newbyteorder("<")
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * npdt.itemsize:
            raise ValueError(f"{self.path}: tensor {name!r} spans {end - begin} bytes, expected {count * npdt.itemsize}")
        arr = np.frombuffer(self._mm, dtype=npdt, count=count, offset=self.data_start + begin)
        t = torch.from_numpy(arr).reshape(shape)
        return t.view(torch.bfloat16) if entry["dtype"] == "BF16" else t


class SafetensorsReader(Mapping):
    """Lazy name → tensor mapping over a checkpoint directory (a single
    ``model.safetensors`` or a sharded index). Each lookup returns a CPU
    tensor viewing the file's mapping."""

    def __init__(self, path: str):
        index = os.path.join(path, INDEX_FILE)
        single = os.path.join(path, SINGLE_FILE)
        self._files: Dict[str, _File] = {}
        self._key2file: Dict[str, str] = {}
        if os.path.isfile(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            self._key2file = {k: os.path.join(path, v) for k, v in weight_map.items()}
            files = sorted(set(self._key2file.values()))
        elif os.path.isfile(single):
            files = [single]
        else:
            raise FileNotFoundError(f"no safetensors checkpoint under {path!r}")
        for fp in files:
            self._files[fp] = _File(fp)
        if not self._key2file:
            self._key2file = {k: fp for fp, fh in self._files.items() for k in fh.header}
        for k, fp in self._key2file.items():
            if k not in self._files[fp].header:
                raise KeyError(f"the index maps {k!r} to {os.path.basename(fp)}, which does not hold it")

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._files[self._key2file[key]].tensor(key)

    def __iter__(self) -> Iterator[str]:
        return iter(self._key2file)

    def __len__(self) -> int:
        return len(self._key2file)


@dataclass
class LazyTensor:
    """A tensor the writer produces when it writes it: ``fn()`` must return
    a tensor of exactly ``shape`` and ``dtype``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    fn: Callable[[], torch.Tensor]

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * torch.empty((), dtype=self.dtype).element_size()


TensorLike = Union[torch.Tensor, LazyTensor]


def _lazy(t: TensorLike) -> LazyTensor:
    if isinstance(t, LazyTensor):
        return t
    return LazyTensor(tuple(t.shape), t.dtype, lambda: t)


def _write_file(path: str, tensors: Dict[str, LazyTensor]):
    """Write one safetensors file: metadata ``{"format": "pt"}``, tensors
    ordered by descending item size, then name (as the safetensors package
    orders them, so each starts aligned to its item size), the header padded
    with spaces to 8 bytes."""
    order = sorted(tensors, key=lambda k: (-torch.empty((), dtype=tensors[k].dtype).element_size(), k))
    header: Dict[str, Dict] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name in order:
        lt = tensors[name]
        n = lt.nbytes
        header[name] = {"dtype": dtype_name(lt.dtype), "shape": [int(s) for s in lt.shape],
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            lt = tensors[name]
            t = lt.fn().detach()
            if tuple(t.shape) != tuple(lt.shape) or t.dtype != lt.dtype:
                raise ValueError(f"{name}: produced {tuple(t.shape)} {t.dtype}, declared {tuple(lt.shape)} {lt.dtype}")
            t = t.to("cpu").contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(memoryview(t.numpy()).cast("B"))
            del t
    os.replace(tmp, path)


def plan_shards(sizes: List[Tuple[str, int]], max_shard_bytes: int) -> List[List[str]]:
    """Split (name, bytes) in order into shards of at most
    ``max_shard_bytes``, greedily, as ``save_pretrained`` does: a tensor
    larger than the limit gets a shard of its own, and a shard is closed
    when the next tensor would take it past the limit."""
    shards: List[List[str]] = []
    cur: List[str] = []
    cur_bytes = 0
    for name, n in sizes:
        if n > max_shard_bytes:
            shards.append([name])
            continue
        if cur and cur_bytes + n > max_shard_bytes:
            shards.append(cur)
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += n
    if cur:
        shards.append(cur)
    return shards


def write_safetensors(out_dir: str, tensors: Mapping[str, TensorLike],
                      max_shard_bytes: int = DEFAULT_MAX_SHARD_BYTES) -> List[str]:
    """Write ``tensors`` into ``out_dir`` as ``save_pretrained`` lays them
    out: one ``model.safetensors``, or, past ``max_shard_bytes``, shards
    ``model-0000i-of-0000n.safetensors`` and ``model.safetensors.index.json``.
    A stale single file or index of the other layout is removed. Returns the
    files written."""
    os.makedirs(out_dir, exist_ok=True)
    lazy = {k: _lazy(v) for k, v in tensors.items()}
    shards = plan_shards([(k, v.nbytes) for k, v in lazy.items()], max_shard_bytes)
    for stale in (SINGLE_FILE, INDEX_FILE):
        if os.path.exists(os.path.join(out_dir, stale)):
            os.remove(os.path.join(out_dir, stale))
    if len(shards) <= 1:
        _write_file(os.path.join(out_dir, SINGLE_FILE), lazy)
        return [SINGLE_FILE]
    n = len(shards)
    names = [f"model-{i + 1:05d}-of-{n:05d}.safetensors" for i in range(n)]
    weight_map = {}
    for fname, keys in zip(names, shards):
        _write_file(os.path.join(out_dir, fname), {k: lazy[k] for k in keys})
        weight_map.update({k: fname for k in keys})
    index = {"metadata": {"total_size": sum(v.nbytes for v in lazy.values())},
             "weight_map": dict(sorted(weight_map.items()))}
    with open(os.path.join(out_dir, INDEX_FILE), "w") as f:
        json.dump(index, f, indent=2, sort_keys=True)
        f.write("\n")
    return names + [INDEX_FILE]
