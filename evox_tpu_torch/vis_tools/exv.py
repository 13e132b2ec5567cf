"""EvoXVision streaming storage (``.exv``) writer and reader (counterpart
of ``evox_tpu/vis_tools/exv.py``).

The exv v1 binary format:

| magic ``"exv1"`` (4B) | header length u32 LE (4B) | JSON metadata | chunks |

The metadata JSON carries two schemas — one for the initial iteration
(algorithms may emit a differently-sized first generation) and one for all
following iterations; each chunk is the concatenation of the schema's
fields (population then fitness, row-major bytes).  :func:`read_exv` reads
a file back.

The writer takes numpy arrays, as the JAX package's does, and torch tensors
on any device: a tensor is brought to the host with
``.detach().cpu().contiguous().numpy()``, so a non-contiguous view on the
card gives the same row-major bytes as its contiguous copy.  For the same
numpy inputs a file is byte for byte the JAX package's, JSON header
included.  A dtype numpy has no counterpart of (``bfloat16``) is refused
with the same ``ValueError`` as a dtype the format has no name for.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Union

import numpy as np
import torch

__all__ = ["EvoXVisionAdapter", "new_exv_metadata", "read_exv"]

_MAGIC = b"exv1"

_DTYPE_NAMES = {
    np.dtype(np.uint8): "u8",
    np.dtype(np.uint16): "u16",
    np.dtype(np.uint32): "u32",
    np.dtype(np.uint64): "u64",
    np.dtype(np.int16): "i16",
    np.dtype(np.int32): "i32",
    np.dtype(np.int64): "i64",
    np.dtype(np.float16): "f16",
    np.dtype(np.float32): "f32",
    np.dtype(np.float64): "f64",
}
_NAME_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}
# The torch dtypes of the format's numpy dtypes (torch.uint16 and the like
# have the numpy names).
_TORCH_DTYPES = {getattr(torch, dtype.name) for dtype in _DTYPE_NAMES}


def _unsupported(name: str) -> ValueError:
    return ValueError(f"Unsupported dtype: {name}")


def _host(x) -> np.ndarray:
    """``x`` as a numpy array: a tensor on any device is copied to the host
    (row-major); a dtype the format cannot store is refused before the
    copy."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in _TORCH_DTYPES:
            raise _unsupported(str(x.dtype).removeprefix("torch."))
        return x.detach().cpu().contiguous().numpy()
    return np.asarray(x)


def _type_name(dtype) -> str:
    dtype = np.dtype(dtype)
    if dtype not in _DTYPE_NAMES:
        raise _unsupported(str(dtype))
    return _DTYPE_NAMES[dtype]


def _field_schema(arrays: dict[str, np.ndarray]) -> dict:
    fields = []
    offset = 0
    for name, arr in arrays.items():
        size = arr.nbytes
        fields.append(
            {
                "name": name,
                "type": _type_name(arr.dtype),
                "size": size,
                "offset": offset,
                "shape": list(arr.shape),
            }
        )
        offset += size
    return {
        "population_size": next(iter(arrays.values())).shape[0],
        "chunk_size": offset,
        "fields": fields,
    }


def new_exv_metadata(population1, population2, fitness1, fitness2) -> dict:
    """Build the exv metadata from the first two iterations' data (the
    schema is inferred, so writing starts after two generations).  Each
    argument is a numpy array or a tensor on any device."""
    population1, population2, fitness1, fitness2 = map(_host, (population1, population2, fitness1, fitness2))
    n_objs = 1 if fitness1.ndim == 1 else fitness1.shape[1]
    return {
        "version": "v1",
        "n_objs": n_objs,
        "initial_iteration": _field_schema({"population": population1, "fitness": fitness1}),
        "rest_iterations": _field_schema({"population": population2, "fitness": fitness2}),
    }


def _field_bytes(field) -> bytes:
    if isinstance(field, (bytes, bytearray, memoryview)):
        return field
    return _host(field).tobytes()


class EvoXVisionAdapter:
    """Streams optimization data to an ``.exv`` file for the external
    EvoXVision viewer."""

    def __init__(self, file_path: Union[str, Path], buffering: int = 0):
        """
        :param file_path: output path.
        :param buffering: passed to ``open``; 0 = unbuffered (each write
            lands immediately — the format is designed for streaming).
        """
        # The format streams records to a live viewer as the run goes: a
        # torn trailing record is skipped by the reader, and the file is
        # never replayed, so it is written in place, not atomically.
        self.writer = open(file_path, "wb", buffering=buffering)
        self.metadata: dict | None = None
        self.header_written = False

    def set_metadata(self, metadata: dict) -> None:
        """Set the JSON header (schema) to be written by
        :meth:`write_header`."""
        self.metadata = metadata

    def write_header(self) -> None:
        """Write magic + length-prefixed JSON schema (must precede data)."""
        if self.metadata is None:
            raise AssertionError("Metadata must be set before writing the header.")
        blob = json.dumps(self.metadata).encode("utf-8")
        self.writer.write(_MAGIC)
        self.writer.write(len(blob).to_bytes(4, byteorder="little", signed=False))
        self.writer.write(blob)
        self.header_written = True

    def write(self, *fields) -> None:
        """Append one chunk: each schema field in order, as its bytes, a
        numpy array or a tensor on any device (written row-major)."""
        if not self.header_written:
            raise AssertionError("Header must be written before writing data.")
        self.writer.writelines([_field_bytes(f) for f in fields])

    def flush(self) -> None:
        """Flush buffered chunks to the underlying stream."""
        if self.writer:
            self.writer.flush()

    def close(self) -> None:
        """Close the underlying stream."""
        if self.writer:
            self.writer.close()


def _decode_chunk(schema: dict, blob: bytes) -> dict[str, np.ndarray]:
    out = {}
    for field in schema["fields"]:
        raw = blob[field["offset"] : field["offset"] + field["size"]]
        out[field["name"]] = np.frombuffer(raw, dtype=_NAME_DTYPES[field["type"]]).reshape(field["shape"])
    return out


def read_exv(file_path: Union[str, Path]) -> tuple[dict, list[dict[str, np.ndarray]]]:
    """Read back an exv file: ``(metadata, [per-iteration field dicts])``
    of numpy arrays."""
    data = Path(file_path).read_bytes()
    if data[:4] != _MAGIC:
        raise AssertionError(f"Not an exv file: magic {data[:4]!r}")
    header_len = int.from_bytes(data[4:8], byteorder="little", signed=False)
    metadata = json.loads(data[8 : 8 + header_len].decode("utf-8"))
    pos = 8 + header_len
    iterations = []
    init_schema = metadata["initial_iteration"]
    rest_schema = metadata["rest_iterations"]
    # Truncated chunks (a streaming writer may die mid-chunk) are dropped;
    # a truncated INITIAL chunk means no complete iteration exists at all.
    if pos + init_schema["chunk_size"] > len(data):
        return metadata, []
    iterations.append(_decode_chunk(init_schema, data[pos : pos + init_schema["chunk_size"]]))
    pos += init_schema["chunk_size"]
    while pos + rest_schema["chunk_size"] <= len(data):
        iterations.append(_decode_chunk(rest_schema, data[pos : pos + rest_schema["chunk_size"]]))
        pos += rest_schema["chunk_size"]
    return metadata, iterations
