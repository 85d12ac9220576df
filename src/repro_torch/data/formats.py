"""Stream data formats — RAW and AVRO (paper §III-D).

Kafka-ML ships producer/consumer libraries for two encodings and the
control message carries ``input_format`` + ``input_config`` so the training
job can decode without out-of-band coordination:

* **RAW** — "suitable for single-input data streams that may request a
  reshape, like images": each message is ``data_bytes || label_bytes`` with
  fixed dtypes/shapes given in the config.
* **AVRO** — "suitable for complex and multi-input datasets where a scheme
  specifies how the data stream is decoded": each message is a schema'd
  record of named fields. (True Avro wire-encoding is unavailable offline;
  we implement the same *contract* — a self-describing scheme in the
  control message, multi-input named fields, schema-checked decode — as a
  packed little-endian binary. DESIGN.md §2 records this substitution.)

Both codecs expose *vectorized* batch encode/decode: a RecordBatch of n
fixed-size messages decodes with one (n, record_bytes) uint8 view + per
field ``.view(dtype).reshape`` — no per-record Python loop on the hot path.

**Zero-copy framed decode** (DESIGN.md §10): the log's contiguous read
path hands out one payload memoryview per segment span
(:attr:`RecordBatch.spans`), and :meth:`_PackedCodec.decode_frames` turns
a span directly into per-field **strided ndarray views** over the segment
buffer — no per-record Python, no copy until the device transfer. The
fast path requires the aligned-stride layout (field offset and record
stride both multiples of the dtype's itemsize, measured from the span's
actual base address); an unaligned field falls back to one vectorized
column copy (the *measured* fallback — ``benchmarks/datapath.py`` records
both paths). Decoded views are read-only: the log's buffers are the
single source of truth and a consumer must not be able to rewrite
history through a borrowed view.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core.log import RecordBatch

__all__ = [
    "AvroCodec",
    "FieldSpec",
    "RawCodec",
    "codec_from_control",
    "decode_span_fields",
]


def _dtype_size(dtype: str) -> int:
    return np.dtype(dtype).itemsize


def _shape_elems(shape: Sequence[int]) -> int:
    return int(math.prod(shape)) if shape else 1


def decode_span_fields(
    view,
    n: int,
    fields: Sequence[FieldSpec],
    offsets: Sequence[int],
    record_bytes: int,
) -> tuple[dict[str, np.ndarray], bool]:
    """Decode ``n`` fixed-layout records packed back to back in ``view``.

    The zero-copy primitive behind :meth:`_PackedCodec.decode_frames`:
    each field becomes an ``np.ndarray`` **view** over the span's buffer
    with record stride ``record_bytes`` — provided the layout is aligned
    (the field's absolute base address and the record stride are both
    multiples of the dtype's itemsize). An unaligned field takes the
    fallback: one vectorized column copy, never a per-record loop.

    Returns ``(arrays, zero_copy)`` where ``zero_copy`` is True iff every
    field took the view path. View arrays are marked read-only (they
    alias live log segment buffers).
    """
    base = np.frombuffer(view, dtype=np.uint8)
    if base.nbytes != n * record_bytes:
        raise ValueError(
            f"span holds {base.nbytes} bytes, expected {n} x {record_bytes}"
        )
    if n == 0:
        return (
            {f.name: np.zeros((0,) + f.shape, f.dtype) for f in fields},
            True,
        )
    ptr = base.__array_interface__["data"][0]
    out: dict[str, np.ndarray] = {}
    zero_copy = True
    mat = None
    for f, off in zip(fields, offsets):
        item = _dtype_size(f.dtype)
        if (ptr + off) % item == 0 and record_bytes % item == 0:
            # aligned-stride fast path: a strided view, no bytes move.
            # Within one record the field's elements are contiguous, so
            # the inner strides are plain C strides; the outer (record)
            # stride is the full record width.
            strides = (record_bytes,) + tuple(
                item * _shape_elems(f.shape[i + 1 :])
                for i in range(len(f.shape))
            )
            arr = np.ndarray(
                shape=(n,) + f.shape,
                dtype=f.dtype,
                buffer=base,
                offset=off,
                strides=strides,
            )
            if arr.flags.writeable:
                arr.flags.writeable = False
            out[f.name] = arr
        else:
            if mat is None:
                mat = base.reshape(n, record_bytes)
            chunk = np.ascontiguousarray(mat[:, off : off + f.nbytes])
            out[f.name] = chunk.view(np.dtype(f.dtype)).reshape((n,) + f.shape)
            zero_copy = False
    return out, zero_copy


@dataclass(frozen=True)
class FieldSpec:
    """One named field of a scheme: dtype + per-record shape."""

    name: str
    dtype: str
    shape: tuple[int, ...] = ()

    @property
    def nbytes(self) -> int:
        return _shape_elems(self.shape) * _dtype_size(self.dtype)

    def to_config(self) -> dict[str, Any]:
        return {"name": self.name, "dtype": self.dtype, "shape": list(self.shape)}

    @classmethod
    def from_config(cls, d: Mapping[str, Any]) -> "FieldSpec":
        return cls(d["name"], d["dtype"], tuple(d.get("shape", ())))


class _PackedCodec:
    """Shared machinery: fixed-layout packed fields, vectorized both ways."""

    def __init__(self, fields: Sequence[FieldSpec]):
        if not fields:
            raise ValueError("codec needs at least one field")
        names = [f.name for f in fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate field names in {names}")
        self.fields = tuple(fields)
        self._offsets: list[int] = []
        pos = 0
        for f in self.fields:
            self._offsets.append(pos)
            pos += f.nbytes
        self.record_bytes = pos

    # ---------------------------------------------------------------- encode
    def encode_batch(self, arrays: Mapping[str, np.ndarray]) -> list[bytes]:
        """Encode n records; every array is (n, *field.shape)."""
        n = None
        cols: list[np.ndarray] = []
        for f in self.fields:
            if f.name not in arrays:
                raise KeyError(f"missing field {f.name!r}")
            a = np.asarray(arrays[f.name], dtype=f.dtype)
            want = (a.shape[0],) + f.shape
            if a.shape != want:
                a = a.reshape(want)  # raises if incompatible
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise ValueError("field batch sizes differ")
            cols.append(
                np.ascontiguousarray(a).reshape(n, -1).view(np.uint8).reshape(n, f.nbytes)
            )
        packed = np.concatenate(cols, axis=1) if len(cols) > 1 else cols[0]
        return [row.tobytes() for row in packed]

    def encode(self, record: Mapping[str, np.ndarray]) -> bytes:
        return self.encode_batch(
            {k: np.asarray(v)[None, ...] for k, v in record.items()}
        )[0]

    # ---------------------------------------------------------------- decode
    def decode_matrix(self, mat: np.ndarray) -> dict[str, np.ndarray]:
        """Decode an (n, record_bytes) uint8 matrix into named arrays."""
        if mat.ndim != 2 or mat.shape[1] != self.record_bytes:
            raise ValueError(
                f"expected (n, {self.record_bytes}) uint8 matrix, got {mat.shape}"
            )
        n = mat.shape[0]
        out: dict[str, np.ndarray] = {}
        for f, off in zip(self.fields, self._offsets):
            chunk = np.ascontiguousarray(mat[:, off : off + f.nbytes])
            out[f.name] = chunk.view(np.dtype(f.dtype)).reshape((n,) + f.shape)
        return out

    def decode_batch(self, batch: RecordBatch) -> dict[str, np.ndarray]:
        return self.decode_matrix(batch.to_matrix())

    def decode_span(
        self, view, n: int
    ) -> tuple[dict[str, np.ndarray], bool]:
        """Zero-copy decode of ``n`` records packed in one contiguous
        span; see :func:`decode_span_fields`."""
        return decode_span_fields(
            view, n, self.fields, self._offsets, self.record_bytes
        )

    def decode_frames(self, batch: RecordBatch) -> dict[str, np.ndarray]:
        """Decode a fetched batch through the zero-copy framed path.

        A single-span batch (the overwhelmingly common case: one fetch
        inside one segment) decodes into per-field strided views over the
        segment buffer — no copy at all on the aligned layout. A batch
        whose records cross a segment boundary decodes each span
        zero-copy and pays one C-level concatenate per field. A batch
        with no framing (filtered read, ragged records) falls back to the
        copying matrix path. Either way there is never per-record Python
        work.
        """
        if not batch.values:
            return {
                f.name: np.zeros((0,) + f.shape, f.dtype)
                for f in self.fields
            }
        spans = batch.framed(self.record_bytes)
        if spans is None:
            return self.decode_matrix(batch.to_matrix())
        if len(spans) == 1:
            return self.decode_span(spans[0][0], spans[0][1])[0]
        parts = [self.decode_span(mv, cnt)[0] for mv, cnt in spans]
        return {
            f.name: np.concatenate([p[f.name] for p in parts], axis=0)
            for f in self.fields
        }

    def decode(self, value: bytes | memoryview) -> dict[str, np.ndarray]:
        mat = np.frombuffer(bytes(value), dtype=np.uint8)[None, :]
        return {k: v[0] for k, v in self.decode_matrix(mat).items()}


class RawCodec(_PackedCodec):
    """RAW format: one ``data`` tensor + one ``label`` tensor per message."""

    FORMAT = "RAW"

    def __init__(
        self,
        data_dtype: str,
        data_shape: Sequence[int],
        label_dtype: str,
        label_shape: Sequence[int] = (),
    ):
        super().__init__(
            [
                FieldSpec("data", data_dtype, tuple(data_shape)),
                FieldSpec("label", label_dtype, tuple(label_shape)),
            ]
        )

    def input_config(self) -> dict[str, Any]:
        d, l = self.fields
        return {
            "data_type": d.dtype,
            "data_reshape": list(d.shape),
            "label_type": l.dtype,
            "label_reshape": list(l.shape),
        }

    @classmethod
    def from_config(cls, cfg: Mapping[str, Any]) -> "RawCodec":
        return cls(
            cfg["data_type"],
            tuple(cfg.get("data_reshape", ())),
            cfg["label_type"],
            tuple(cfg.get("label_reshape", ())),
        )


class AvroCodec(_PackedCodec):
    """AVRO format: named multi-input ``data_scheme`` + ``label_scheme``.

    Mirrors the paper's HCOPD validation example where age / smoking status
    / gender etc. are separate schema fields.
    """

    FORMAT = "AVRO"

    def __init__(self, data_scheme: Sequence[FieldSpec], label_scheme: Sequence[FieldSpec]):
        self.data_fields = tuple(data_scheme)
        self.label_fields = tuple(label_scheme)
        super().__init__(list(data_scheme) + list(label_scheme))

    def input_config(self) -> dict[str, Any]:
        return {
            "data_scheme": [f.to_config() for f in self.data_fields],
            "label_scheme": [f.to_config() for f in self.label_fields],
        }

    @classmethod
    def from_config(cls, cfg: Mapping[str, Any]) -> "AvroCodec":
        return cls(
            [FieldSpec.from_config(f) for f in cfg["data_scheme"]],
            [FieldSpec.from_config(f) for f in cfg["label_scheme"]],
        )

    def split(self, decoded: Mapping[str, np.ndarray]) -> tuple[dict, dict]:
        data = {f.name: decoded[f.name] for f in self.data_fields}
        label = {f.name: decoded[f.name] for f in self.label_fields}
        return data, label


def codec_from_control(input_format: str, input_config: Mapping[str, Any]):
    """Instantiate the codec a control message describes (paper §IV-E:
    inference auto-configures its decoder from the training control
    message)."""
    if input_format == "RAW":
        return RawCodec.from_config(input_config)
    if input_format == "AVRO":
        return AvroCodec.from_config(input_config)
    raise ValueError(f"unsupported input_format {input_format!r}")
