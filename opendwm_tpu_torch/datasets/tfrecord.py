"""TFRecord framing + protobuf wire-format utilities (pure Python; the
port's copy of ``opendwm_tpu/datasets/tfrecord.py``).

The reference reads Waymo Perception TFRecords through the
waymo-open-dataset protos with an offline random-access index
(src/dwm/datasets/waymo.py + tools/dataset_make_info_json.py). This module
needs no such package: it provides the two primitives from first
principles:

- TFRecord framing: [len:u64][len_crc:u32][payload][payload_crc:u32];
  :func:`iterate_tfrecord` yields (offset, payload) so an offset index gives
  random access, and :func:`read_tfrecord_at` reads one record by offset.
- :func:`parse_protobuf`: a schema-less protobuf wire-format decoder
  returning {field_number: [raw values]}; nested messages decode lazily via
  repeated calls. Field-number maps for specific schemas live with their
  dataset.
"""

from __future__ import annotations

import struct
from typing import Iterator


def iterate_tfrecord(fileobj) -> Iterator[tuple[int, bytes]]:
    """Yield (byte_offset, record_payload) over a TFRecord stream."""
    offset = 0
    while True:
        header = fileobj.read(12)
        if len(header) < 12:
            return
        (length,) = struct.unpack("<Q", header[:8])
        payload = fileobj.read(length)
        fileobj.read(4)  # payload crc
        if len(payload) < length:
            return
        yield offset, payload
        offset += 12 + length + 4


def read_tfrecord_at(fileobj, offset: int) -> bytes:
    fileobj.seek(offset)
    header = fileobj.read(12)
    (length,) = struct.unpack("<Q", header[:8])
    return fileobj.read(length)


def make_tfrecord_index(fileobj) -> list[int]:
    """Record offsets for random access (tools/dataset_make_info_json)."""
    return [offset for offset, _ in iterate_tfrecord(fileobj)]


def write_tfrecord(fileobj, payloads: list[bytes]) -> None:
    """Writer (tests/tools). CRCs are zero-filled — readers here skip them."""
    for p in payloads:
        fileobj.write(struct.pack("<Q", len(p)))
        fileobj.write(b"\x00" * 4)
        fileobj.write(p)
        fileobj.write(b"\x00" * 4)


# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_protobuf(buf: bytes) -> dict[int, list]:
    """Decode one message into {field_number: [values]}.

    varint → int, 64-bit → 8 raw bytes, length-delimited → bytes,
    32-bit → 4 raw bytes. Nested messages stay bytes; parse recursively.
    """
    out: dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field = tag >> 3
        wire = tag & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value = buf[pos: pos + 8]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos: pos + length]
            pos += length
        elif wire == 5:
            value = buf[pos: pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(value)
    return out


def encode_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_field(field: int, value) -> bytes:
    """Encoder for tests: int → varint; bytes → length-delimited;
    float → 64-bit."""
    if isinstance(value, int):
        return encode_varint(field << 3 | 0) + encode_varint(value)
    if isinstance(value, float):
        return encode_varint(field << 3 | 1) + struct.pack("<d", value)
    if isinstance(value, bytes):
        return (
            encode_varint(field << 3 | 2)
            + encode_varint(len(value))
            + value
        )
    raise TypeError(type(value))


def decode_double(raw: bytes) -> float:
    return struct.unpack("<d", raw)[0]


def decode_float(raw: bytes) -> float:
    return struct.unpack("<f", raw)[0]


def decode_packed_doubles(raw: bytes) -> list[float]:
    return list(struct.unpack(f"<{len(raw) // 8}d", raw))


def decode_packed_floats(raw: bytes) -> list[float]:
    return list(struct.unpack(f"<{len(raw) // 4}f", raw))


def decode_packed_varints(raw: bytes) -> list[int]:
    out, pos = [], 0
    while pos < len(raw):
        value, pos = _read_varint(raw, pos)
        out.append(value)
    return out
