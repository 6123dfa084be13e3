"""TensorFlow's tensor-bundle checkpoint format in plain Python and numpy.

A bundle is what `tf.train.Checkpoint.write` and Keras `save_weights`
leave under a prefix: ``<prefix>.index``, a LevelDB-style table that maps
each tensor's key to its `BundleEntryProto`, and the shards
``<prefix>.data-0000k-of-0000n`` that hold the tensors' bytes.  Nothing
here imports TensorFlow or protobuf.

The index table (TF's `tsl::table::TableBuilder`, LevelDB's layout):

* data blocks of entries ``varint shared | varint unshared | varint
  value_len | key[shared:] | value``, the key prefix-compressed against the
  previous key and restarted every `BLOCK_RESTART_INTERVAL` entries, then
  the restart offsets (fixed32 each) and their count (fixed32); a block is
  closed once its size estimate reaches `BLOCK_SIZE`;
* after every block a 5-byte trailer: the compression type (the bundle
  writer stores blocks uncompressed) and the masked CRC-32C of the block
  and that byte;
* an empty metaindex block, then the index block (a restart at every key):
  one entry per data block, keyed by the shortest key between its last key
  and the next block's first (the short successor after the last block),
  its value the block's handle (varint64 offset, varint64 size);
* a 48-byte footer: the metaindex and index handles padded to 40 bytes,
  then `TABLE_MAGIC` as two little-endian fixed32.

The first key is the empty string, whose value is the `BundleHeaderProto`.
Numeric tensors are stored raw, little-endian, C order; a string tensor as
its lengths (varint64 each), the masked CRC-32C of the lengths (as uint32
each), then the bytes.  An entry's `crc32c` is the masked CRC-32C of its
stored bytes (of a string tensor: of its lengths as uint32, their checksum
and its bytes).  `write_bundle` writes what TF 2.21's `BundleWriter` writes
for the same tensors added in the same order, byte for byte.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
from typing import Iterable, Iterator, Mapping, Optional

import numpy as np

# tsl::table::Options: the data blocks' size threshold and restart interval
BLOCK_SIZE = 262144
BLOCK_RESTART_INTERVAL = 16
INDEX_RESTART_INTERVAL = 1
# BundleWriter::Options::data_alignment: tensors densely packed
DATA_ALIGNMENT = 1
NO_COMPRESSION = 0
BLOCK_TRAILER_SIZE = 5
BLOCK_HANDLE_MAX = 20           # BlockHandle::kMaxEncodedLength
FOOTER_SIZE = 2 * BLOCK_HANDLE_MAX + 8
TABLE_MAGIC = 0xDB4775248B80FB57
HEADER_KEY = b""
# kTensorBundleVersion and kTensorBundleMinConsumer
BUNDLE_VERSION = 1
BUNDLE_MIN_CONSUMER = 0
OBJECT_GRAPH_KEY = "_CHECKPOINTABLE_OBJECT_GRAPH"

# the DataType enum values the reader and writer take
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_STRING, DT_INT64 = 1, 2, 3, 7, 9
_NUMERIC = {DT_FLOAT: np.dtype("<f4"), DT_DOUBLE: np.dtype("<f8"),
            DT_INT32: np.dtype("<i4"), DT_INT64: np.dtype("<i8")}
_ENUM_OF = {np.dtype(np.float32): DT_FLOAT, np.dtype(np.float64): DT_DOUBLE,  # fp32-island(the format's dtype enum, not a compute dtype)
            np.dtype(np.int32): DT_INT32, np.dtype(np.int64): DT_INT64}


class DataLossError(ValueError):
    """A bundle whose bytes fail a check: a CRC, a bound, the magic number."""


# ---- CRC-32C (Castagnoli) ---------------------------------------------------


def _crc_table() -> list:
    poly = 0x82F63B78  # the Castagnoli polynomial, bit-reversed
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()
_MASK_DELTA = 0xA282EAD8


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C of `data`, extending `crc` (the CRC of what came before)."""
    table = _CRC_TABLE
    c = crc ^ 0xFFFFFFFF
    for byte in data:
        c = table[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    """TF's masked form of a CRC (stored so that a CRC of data holding CRCs
    is not degenerate): rotate right by 15 bits, add a constant."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + _MASK_DELTA) & 0xFFFFFFFF


def unmask_crc(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# ---- varints and the protobuf wire format -----------------------------------


def encode_varint(n: int) -> bytes:
    """Base-128 varint; a negative int as its 64-bit two's complement."""
    n &= (1 << 64) - 1
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def decode_varint(buf: bytes, pos: int) -> tuple:
    """(value, position after it) of the varint at `pos`."""
    value = shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise DataLossError("truncated or overlong varint")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if byte < 0x80:
            return value, pos
        shift += 7


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5


def _tag(field: int, wire: int) -> bytes:
    return encode_varint(field << 3 | wire)


def _int_field(field: int, value: int) -> bytes:
    """A proto3 integer field (omitted at its default, 0)."""
    return _tag(field, _VARINT) + encode_varint(value) if value else b""


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, _LEN) + encode_varint(len(payload)) + payload


def _fixed32_field(field: int, value: int) -> bytes:
    return _tag(field, _FIXED32) + struct.pack("<I", value) if value else b""


def proto_fields(buf: bytes) -> Iterator[tuple]:
    """(field number, wire type, value) of each field of a serialized
    message, in order: ints for varint and fixed fields, bytes for
    length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = decode_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, pos = decode_varint(buf, pos)
        elif wire == _LEN:
            n, pos = decode_varint(buf, pos)
            if pos + n > len(buf):
                raise DataLossError("truncated length-delimited field")
            value, pos = buf[pos:pos + n], pos + n
        elif wire in (_FIXED32, _FIXED64):
            width = 4 if wire == _FIXED32 else 8
            if pos + width > len(buf):
                raise DataLossError("truncated fixed-width field")
            value = int.from_bytes(buf[pos:pos + width], "little")
            pos += width
        else:
            raise DataLossError(f"unsupported wire type {wire}")
        yield field, wire, value


# ---- the bundle's messages --------------------------------------------------


def encode_shape(shape: Iterable[int]) -> bytes:
    """`TensorShapeProto`: one `dim {size}` (field 2) per axis."""
    return b"".join(_len_field(2, _int_field(1, int(d))) for d in shape)


def decode_shape(buf: bytes) -> tuple:
    dims = []
    for field, _, value in proto_fields(buf):
        if field == 2:
            size = 0
            for f, _, v in proto_fields(value):
                if f == 1:
                    size = _signed(v)
            dims.append(size)
        elif field == 3 and value:
            raise DataLossError("a tensor of unknown rank")
    return tuple(dims)


def encode_header() -> bytes:
    """`BundleHeaderProto` of a one-shard bundle: little-endian, version 1."""
    version = _int_field(1, BUNDLE_VERSION) + _int_field(2, BUNDLE_MIN_CONSUMER)
    return _int_field(1, 1) + _int_field(2, 0) + _len_field(3, version)


def decode_header(buf: bytes) -> dict:
    out = {"num_shards": 0, "endianness": 0, "producer": 0, "min_consumer": 0}
    for field, _, value in proto_fields(buf):
        if field == 1:
            out["num_shards"] = value
        elif field == 2:
            out["endianness"] = value
        elif field == 3:
            for f, _, v in proto_fields(value):
                if f == 1:
                    out["producer"] = v
                elif f == 2:
                    out["min_consumer"] = v
    return out


@dataclasses.dataclass
class BundleEntry:
    """`BundleEntryProto`: where one tensor lies and what it is."""

    dtype: int
    shape: tuple
    shard_id: int = 0
    offset: int = 0
    size: int = 0
    crc32c: int = 0         # masked
    slices: int = 0         # count of TensorSliceProto (partitioned variables)

    def encode(self) -> bytes:
        return (_int_field(1, self.dtype) + _len_field(2, encode_shape(self.shape))
                + _int_field(3, self.shard_id) + _int_field(4, self.offset)
                + _int_field(5, self.size) + _fixed32_field(6, self.crc32c))

    @classmethod
    def decode(cls, buf: bytes) -> "BundleEntry":
        e = cls(dtype=0, shape=())
        for field, _, value in proto_fields(buf):
            if field == 1:
                e.dtype = value
            elif field == 2:
                e.shape = decode_shape(value)
            elif field == 3:
                e.shard_id = value
            elif field == 4:
                e.offset = value
            elif field == 5:
                e.size = value
            elif field == 6:
                e.crc32c = value
            elif field == 7:
                e.slices += 1
        return e


@dataclasses.dataclass
class TrackableNode:
    """One `TrackableObjectGraph.TrackableObject`: its children (node id,
    local name), its serialized tensors (name, full name, checkpoint key)
    and `has_checkpoint_values`."""

    children: list = dataclasses.field(default_factory=list)
    attributes: list = dataclasses.field(default_factory=list)
    has_checkpoint_values: Optional[bool] = True


def encode_object_graph(nodes: Iterable[TrackableNode]) -> bytes:
    """A serialized `TrackableObjectGraph` (the `OBJECT_GRAPH_KEY` tensor)."""
    out = []
    for node in nodes:
        body = b"".join(_len_field(1, _int_field(1, i) + _len_field(2, name.encode()))
                        for i, name in node.children)
        body += b"".join(_len_field(2, _len_field(1, n.encode()) + _len_field(2, f.encode())
                                    + _len_field(3, k.encode()))
                         for n, f, k in node.attributes)
        if node.has_checkpoint_values is not None:
            body += _len_field(5, _int_field(1, int(node.has_checkpoint_values)))
        out.append(_len_field(1, body))
    return b"".join(out)


def decode_object_graph(buf: bytes) -> list:
    """The nodes of a serialized `TrackableObjectGraph` (slot variables and
    registered savers are skipped)."""
    nodes = []
    for field, _, value in proto_fields(buf):
        if field != 1:
            continue
        node = TrackableNode(has_checkpoint_values=None)
        for f, _, v in proto_fields(value):
            if f == 1:
                ref = {ff: vv for ff, _, vv in proto_fields(v)}
                node.children.append((ref.get(1, 0), bytes(ref.get(2, b"")).decode()))
            elif f == 2:
                t = {ff: vv for ff, _, vv in proto_fields(v)}
                node.attributes.append(tuple(bytes(t.get(k, b"")).decode() for k in (1, 2, 3)))
            elif f == 5:
                node.has_checkpoint_values = bool(
                    {ff: vv for ff, _, vv in proto_fields(v)}.get(1, 0))
        nodes.append(node)
    return nodes


# ---- the index table ---------------------------------------------------------


class _BlockBuilder:
    """A table block: prefix-compressed keys, restarts every `interval`."""

    def __init__(self, interval: int):
        self.interval = interval
        self.buf = bytearray()
        self.restarts = [0]
        self.counter = 0
        self.last = b""

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.counter < self.interval:
            limit = min(len(self.last), len(key))
            while shared < limit and self.last[shared] == key[shared]:
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.counter = 0
        self.buf += (encode_varint(shared) + encode_varint(len(key) - shared)
                     + encode_varint(len(value)) + key[shared:] + value)
        self.last = key
        self.counter += 1

    def empty(self) -> bool:
        return not self.buf

    def size_estimate(self) -> int:
        return len(self.buf) + 4 * len(self.restarts) + 4

    def finish(self) -> bytes:
        return bytes(self.buf) + struct.pack(f"<{len(self.restarts)}I", *self.restarts) \
            + struct.pack("<I", len(self.restarts))


def _handle(offset: int, size: int) -> bytes:
    return encode_varint(offset) + encode_varint(size)


def _shortest_separator(start: bytes, limit: bytes) -> bytes:
    """The bytewise comparator's short key in [start, limit)."""
    n = min(len(start), len(limit))
    i = 0
    while i < n and start[i] == limit[i]:
        i += 1
    if i < n:
        byte = start[i]
        if byte < 0xFF and byte + 1 < limit[i]:
            return start[:i] + bytes([byte + 1])
    return start


def _short_successor(key: bytes) -> bytes:
    """The bytewise comparator's short key >= `key`."""
    for i, byte in enumerate(key):
        if byte != 0xFF:
            return key[:i] + bytes([byte + 1])
    return key


def build_table(items: Iterable[tuple], block_size: int = BLOCK_SIZE,
                restart_interval: int = BLOCK_RESTART_INTERVAL) -> bytes:
    """The bytes of a table holding `items`, (key, value) pairs in
    ascending key order, uncompressed."""
    out = bytearray()

    def write_block(block: _BlockBuilder) -> bytes:
        contents = block.finish()
        handle = _handle(len(out), len(contents))
        trailer = bytes([NO_COMPRESSION])
        out.extend(contents + trailer
                   + struct.pack("<I", mask_crc(crc32c(trailer, crc32c(contents)))))
        return handle

    data = _BlockBuilder(restart_interval)
    index = _BlockBuilder(INDEX_RESTART_INTERVAL)
    pending, last = None, b""
    for key, value in items:
        if pending is not None:
            index.add(_shortest_separator(last, key), pending)
            pending = None
        data.add(key, value)
        last = key
        if data.size_estimate() >= block_size:
            pending = write_block(data)
            data = _BlockBuilder(restart_interval)
    if not data.empty():
        pending = write_block(data)
    meta = write_block(_BlockBuilder(restart_interval))
    if pending is not None:
        index.add(_short_successor(last), pending)
    footer = (meta + write_block(index)).ljust(2 * BLOCK_HANDLE_MAX, b"\0")
    out.extend(footer + struct.pack("<II", TABLE_MAGIC & 0xFFFFFFFF, TABLE_MAGIC >> 32))
    return bytes(out)


def _read_block(buf: bytes, handle: bytes) -> list:
    """The (key, value) entries of the block at `handle`, its trailer's
    CRC checked."""
    offset, pos = decode_varint(handle, 0)
    size, _ = decode_varint(handle, pos)
    end = offset + size
    if end + BLOCK_TRAILER_SIZE > len(buf) or size < 4:
        raise DataLossError(f"block at {offset} (+{size}) runs past the index file")
    contents, kind = buf[offset:end], buf[end]
    (stored,) = struct.unpack_from("<I", buf, end + 1)
    if unmask_crc(stored) != crc32c(bytes([kind]), crc32c(contents)):
        raise DataLossError(f"block at {offset}: checksum mismatch")
    if kind != NO_COMPRESSION:
        raise NotImplementedError(f"block at {offset}: compression type {kind}")
    (restarts,) = struct.unpack_from("<I", contents, size - 4)
    limit = size - 4 - 4 * restarts
    if restarts < 1 or limit < 0:
        raise DataLossError(f"block at {offset}: bad restart array")
    entries, pos, key = [], 0, b""
    while pos < limit:
        shared, pos = decode_varint(contents, pos)
        unshared, pos = decode_varint(contents, pos)
        n, pos = decode_varint(contents, pos)
        if shared > len(key) or pos + unshared + n > limit:
            raise DataLossError(f"block at {offset}: corrupt entry")
        key = key[:shared] + contents[pos:pos + unshared]
        pos += unshared
        entries.append((key, contents[pos:pos + n]))
        pos += n
    return entries


def read_table(buf: bytes) -> list:
    """Every (key, value) of a table, in key order, every block's CRC
    checked (the metaindex block's too)."""
    if len(buf) < FOOTER_SIZE:
        raise DataLossError(f"index of {len(buf)} bytes is shorter than its footer")
    footer = buf[-FOOTER_SIZE:]
    if struct.unpack_from("<II", footer, 2 * BLOCK_HANDLE_MAX) != (
            TABLE_MAGIC & 0xFFFFFFFF, TABLE_MAGIC >> 32):
        raise DataLossError("not a table: bad magic number")
    pos = 0
    handles = []
    for _ in range(2):
        start = pos
        _, pos = decode_varint(footer, pos)
        _, pos = decode_varint(footer, pos)
        handles.append(footer[start:pos])
    _read_block(buf, handles[0])
    entries = []
    for _, handle in _read_block(buf, handles[1]):
        entries.extend(_read_block(buf, handle))
    return entries


# ---- tensors -----------------------------------------------------------------


def _encode_tensor(arr: np.ndarray) -> tuple:
    """(dtype enum, stored bytes, unmasked CRC-32C of them)."""
    if arr.dtype.kind in "OSU":
        strings = [s.encode() if isinstance(s, str) else bytes(s) for s in arr.reshape(-1)]
        lengths = b"".join(encode_varint(len(s)) for s in strings)
        crc = _length_crc(len(s) for s in strings)
        checksum = struct.pack("<I", mask_crc(crc))
        crc = crc32c(checksum, crc)
        for s in strings:
            crc = crc32c(s, crc)
        return DT_STRING, lengths + checksum + b"".join(strings), crc
    enum = _ENUM_OF.get(arr.dtype)
    if enum is None:
        raise TypeError(f"dtype {arr.dtype} is not one the bundle takes "
                        "(float32, float64, int32, int64, string)")
    raw = np.ascontiguousarray(arr, dtype=_NUMERIC[enum]).tobytes()
    return enum, raw, crc32c(raw)


def _length_crc(lengths) -> int:
    """CRC-32C of string lengths as TF sums them: each as a uint32 (a
    uint64 above 2**32 - 1), not as the varints stored."""
    crc = 0
    for n in lengths:
        crc = crc32c(struct.pack("<I" if n <= 0xFFFFFFFF else "<Q", n), crc)
    return crc


def _decode_tensor(key: str, e: BundleEntry, data: bytes) -> np.ndarray:
    count = math.prod(e.shape)
    if e.dtype == DT_STRING:
        pos, lengths = 0, []
        for _ in range(count):
            n, pos = decode_varint(data, pos)
            lengths.append(n)
        crc = _length_crc(lengths)
        if pos + 4 > len(data) or struct.unpack_from("<I", data, pos)[0] != mask_crc(crc):
            raise DataLossError(f"{key}: string lengths fail their checksum")
        crc = crc32c(data[pos:], crc)
        pos += 4
        out = np.empty(count, dtype=object)
        for i, n in enumerate(lengths):
            out[i] = bytes(data[pos:pos + n])
            pos += n
        if pos != len(data):
            raise DataLossError(f"{key}: {len(data)} bytes stored, {pos} described")
    else:
        dtype = _NUMERIC.get(e.dtype)
        if dtype is None:
            raise NotImplementedError(f"{key}: DataType {e.dtype} is not read here")
        if count * dtype.itemsize != len(data):
            raise DataLossError(f"{key}: {len(data)} bytes for shape {e.shape}")
        crc = crc32c(data)
        out = np.frombuffer(data, dtype=dtype).astype(dtype.newbyteorder("="))
    if mask_crc(crc) != e.crc32c:
        raise DataLossError(f"{key}: checksum does not match its data")
    return out.reshape(e.shape)


def data_path(prefix: str, shard: int = 0, num_shards: int = 1) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def read_bundle(prefix: str) -> dict:
    """Every tensor of the bundle at `prefix` as ``{key: numpy array}``
    (a string tensor as an object array of bytes), in key order.  Every
    block's and every entry's checksum is checked; a mismatch, a bound
    overrun or a bad footer raises `DataLossError`."""
    with open(prefix + ".index", "rb") as f:
        entries = read_table(f.read())
    if not entries or entries[0][0] != HEADER_KEY:
        raise DataLossError(f"{prefix}.index has no bundle header")
    header = decode_header(entries[0][1])
    if header["endianness"] != 0:
        raise NotImplementedError(f"{prefix}: a big-endian bundle")
    if header["min_consumer"] > BUNDLE_VERSION:
        raise DataLossError(f"{prefix}: needs a reader of version {header['min_consumer']}")
    parsed = [(raw_key, BundleEntry.decode(value)) for raw_key, value in entries[1:]]
    sliced = [k for k, e in parsed if e.slices]
    if sliced:
        raise NotImplementedError(f"{prefix}: partitioned variables {sliced}")
    shards: dict = {}
    out = {}
    for raw_key, e in parsed:
        key = raw_key.decode()
        if e.shard_id >= header["num_shards"]:
            raise DataLossError(f"{key}: shard {e.shard_id} of {header['num_shards']}")
        if e.shard_id not in shards:
            with open(data_path(prefix, e.shard_id, header["num_shards"]), "rb") as f:
                shards[e.shard_id] = f.read()
        blob = shards[e.shard_id]
        if e.offset + e.size > len(blob):
            raise DataLossError(f"{key}: runs past the end of its data shard")
        out[key] = _decode_tensor(key, e, blob[e.offset:e.offset + e.size])
    return out


def write_bundle(prefix: str, tensors: Mapping[str, object],
                 block_size: int = BLOCK_SIZE) -> str:
    """Write `tensors` (key -> array: float32, float64, int32, int64 or
    strings) as a one-shard bundle at `prefix`, their data in the mapping's
    order, as TF's `BundleWriter` adds them; returns `prefix`.  Each file is
    written whole beside its name and moved into place."""
    data, entries = bytearray(), {}
    for key, value in tensors.items():
        arr = np.asarray(value)
        dtype, raw, crc = _encode_tensor(arr)
        entries[key.encode()] = BundleEntry(dtype=dtype, shape=arr.shape, offset=len(data),
                                            size=len(raw), crc32c=mask_crc(crc)).encode()
        data += raw
    index = build_table([(HEADER_KEY, encode_header())] + sorted(entries.items()),
                        block_size=block_size)
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    for path, blob in ((data_path(prefix), data), (prefix + ".index", index)):
        tmp = f"{path}.tempstate{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    return prefix
