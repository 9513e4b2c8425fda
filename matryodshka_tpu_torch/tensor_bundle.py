"""Pure-python reader of TensorFlow TensorBundle (TF-v1) checkpoints.

The reference releases its trained models as TF-v1 checkpoints; this module
reads them with numpy alone, no TensorFlow. It is the port's own copy of
the reader half of `tools/tensor_bundle.py` (the writer stays there: the
tests use it to make checkpoints).

Format (tensorflow/core/util/tensor_bundle; leveldb/table):

  <prefix>.index                an SSTable mapping
                                  ""            -> BundleHeaderProto
                                  <tensor name> -> BundleEntryProto
  <prefix>.data-%05d-of-%05d    raw little-endian tensor bytes

SSTable: data blocks (prefix-compressed key/value entries + restart
array), an index block of last-key -> BlockHandle, and a 48-byte footer
ending in the magic 0xdb4775248b80fb57. Block trailers carry a masked
CRC32C. TF writes these with compression disabled, which is all this
reader supports (snappy-compressed blocks raise).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 0xdb4775248b80fb57
_MASK_DELTA = 0xa282ead8

# TF DataType enum -> numpy
_DTYPES = {1: np.dtype("<f4"), 2: np.dtype("<f8"), 3: np.dtype("<i4"),
           9: np.dtype("<i8"), 19: np.dtype("<f2")}

_CRC_TABLE: List[int] = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli), table-driven."""
    tab = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """leveldb's masked CRC32C."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def _get_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _pb_fields(buf: bytes) -> List[Tuple[int, int, object]]:
    """Decode a protobuf message into (field, wire_type, value) items."""
    out = []
    pos = 0
    while pos < len(buf):
        tag, pos = _get_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, pos = _get_varint(buf, pos)
        elif wt == 2:
            n, pos = _get_varint(buf, pos)
            v = buf[pos:pos + n]
            pos += n
        elif wt == 5:
            v = struct.unpack("<I", buf[pos:pos + 4])[0]
            pos += 4
        elif wt == 1:
            v = struct.unpack("<Q", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.append((field, wt, v))
    return out


def _parse_block(block: bytes) -> List[Tuple[bytes, bytes]]:
    n_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 - 4 * n_restarts
    entries = []
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _get_varint(block, pos)
        non_shared, pos = _get_varint(block, pos)
        vlen, pos = _get_varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        entries.append((key, block[pos:pos + vlen]))
        pos += vlen
    return entries


def _read_block(buf: bytes, offset: int, size: int) -> bytes:
    raw = buf[offset:offset + size]
    ctype = buf[offset + size]
    crc = struct.unpack("<I", buf[offset + size + 1:offset + size + 5])[0]
    if masked_crc(buf[offset:offset + size + 1]) != crc:
        raise ValueError("sstable block crc mismatch")
    if ctype == 0:
        return raw
    raise NotImplementedError(
        "snappy-compressed sstable block; TF tensor bundles are written "
        "uncompressed — is this really a checkpoint index?")


def _sstable_read(path: str) -> List[Tuple[bytes, bytes]]:
    with open(path, "rb") as fh:
        buf = fh.read()
    magic = struct.unpack("<Q", buf[-8:])[0]
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an sstable (bad magic)")
    footer = buf[-48:-8]
    _, pos = _get_varint(footer, 0)          # metaindex offset
    _, pos = _get_varint(footer, pos)        # metaindex size
    ix_off, pos = _get_varint(footer, pos)
    ix_size, pos = _get_varint(footer, pos)
    index = _parse_block(_read_block(buf, ix_off, ix_size))
    entries: List[Tuple[bytes, bytes]] = []
    for _, handle in index:
        off, p = _get_varint(handle, 0)
        size, p = _get_varint(handle, p)
        entries.extend(_parse_block(_read_block(buf, off, size)))
    return entries


def _decode_shape(buf: bytes) -> Tuple[int, ...]:
    dims = []
    for field, wt, v in _pb_fields(buf):
        if field == 2 and wt == 2:
            size = 0
            for f2, _, v2 in _pb_fields(v):
                if f2 == 1:
                    size = v2
            dims.append(size)
    return tuple(dims)


def _decode_entry(buf: bytes):
    dtype_enum = shard = offset = size = crc = 0
    shape: Tuple[int, ...] = ()
    for field, _, v in _pb_fields(buf):
        if field == 1:
            dtype_enum = v
        elif field == 2:
            shape = _decode_shape(v)
        elif field == 3:
            shard = v
        elif field == 4:
            offset = v
        elif field == 5:
            size = v
        elif field == 6:
            crc = v
    return dtype_enum, shape, shard, offset, size, crc


def load(prefix: str, check_crc: bool = True) -> Dict[str, np.ndarray]:
    """Read a TF checkpoint: `prefix` as in tf.train.Saver.save's return
    (files <prefix>.index + <prefix>.data-...). Returns {name: array}."""
    entries = _sstable_read(prefix + ".index")
    if not entries or entries[0][0] != b"":
        raise ValueError("bundle header entry missing")
    num_shards = 1
    for field, _, v in _pb_fields(entries[0][1]):
        if field == 1:
            num_shards = v
    shards = {}
    for i in range(num_shards):
        p = f"{prefix}.data-{i:05d}-of-{num_shards:05d}"
        with open(p, "rb") as fh:
            shards[i] = fh.read()
    out = {}
    for key, value in entries[1:]:
        dtype_enum, shape, shard, offset, size, crc = _decode_entry(value)
        if dtype_enum not in _DTYPES:
            raise NotImplementedError(
                f"tensor {key.decode()}: TF dtype enum {dtype_enum} not "
                "mapped (add it to _DTYPES)")
        raw = shards[shard][offset:offset + size]
        if check_crc and crc and masked_crc(raw) != crc:
            raise ValueError(f"tensor {key.decode()}: data crc mismatch")
        out[key.decode()] = np.frombuffer(
            raw, dtype=_DTYPES[dtype_enum]).reshape(shape).copy()
    return out
