"""TensorBoard scalar logging without TensorFlow.

Port of `multihop_offload_tpu/train/tb_logging.py:ScalarLogger`, which
writes through `tf.summary`.  Here the event file is written directly: a
TFRecord file of `Event` protobufs, each record framed as its length (8
bytes, little-endian), the masked CRC-32C of those 8 bytes, the payload
and the payload's masked CRC-32C (`models/tf_bundle.py`'s `crc32c`,
`mask_crc` and `encode_varint`).  The first event holds the file version
`brain.Event:2`; every scalar is an event in the form TF2's
`tf.summary.scalar` writes: a `Summary.Value` whose tensor is a float32
scalar (`dtype` DT_FLOAT, an empty shape, four bytes of `tensor_content`)
and whose metadata names the `scalars` plugin.  TensorBoard and
`tf.compat.v1.train.summary_iterator` read it as they read TF's own.

`ScalarLogger(logdir)`: no logdir, no logger (`active` False, every call a
no-op); otherwise the directory is made and the file opened at once, so a
bad logdir raises there.  Each scalar is flushed as it is written; `close`
ends the file.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from typing import Optional

from multihop_offload_tpu_torch.models.tf_bundle import crc32c, encode_varint, mask_crc

FILE_VERSION = "brain.Event:2"
WRITER = "multihop_offload_tpu_torch.train.tb_logging"
DT_FLOAT = 1
_LEN, _FIXED64 = 2, 1
_files = itertools.count()  # the file name's per-process counter, as TF's


def _key(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


def _bytes(field: int, payload: bytes) -> bytes:
    return _key(field, _LEN) + encode_varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, **body: bytes) -> bytes:
    """An `Event`: wall_time (1), step (2, left out at 0 as proto3 does),
    then file_version (3), summary (5) or source_metadata (10)."""
    out = _key(1, _FIXED64) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, 0) + encode_varint(step)
    fields = {"file_version": 3, "summary": 5, "source_metadata": 10}
    for name, payload in body.items():
        out += _bytes(fields[name], payload)
    return out


def scalar_summary(tag: str, value: float) -> bytes:
    """A `Summary` of one float32 scalar for the `scalars` plugin."""
    tensor = (_key(1, 0) + encode_varint(DT_FLOAT) + _bytes(2, b"")
              + _bytes(4, struct.pack("<f", value)))
    metadata = _bytes(1, _bytes(1, b"scalars"))
    return _bytes(1, _bytes(1, tag.encode()) + _bytes(8, tensor) + _bytes(9, metadata))


def record(payload: bytes) -> bytes:
    """One TFRecord frame around `payload`."""
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", mask_crc(crc32c(length))) + payload
            + struct.pack("<I", mask_crc(crc32c(payload))))


class ScalarLogger:
    """`log_scalar(tag, value, step)` onto a TensorBoard event file in
    `logdir`, `events.out.tfevents.<time>.<host>.<pid>.<n>.v2` as TF names
    it."""

    def __init__(self, logdir: Optional[str]):
        self._file = None
        if not logdir:
            return
        os.makedirs(logdir, exist_ok=True)
        now = time.time()  # nondet-ok(an event's wall time is what the format records)
        name = (f"events.out.tfevents.{int(now)}.{socket.gethostname()}."
                f"{os.getpid()}.{next(_files)}.v2")
        self.path = os.path.join(logdir, name)
        self._file = open(self.path, "wb")
        self._file.write(record(_event(
            float(int(now)), file_version=FILE_VERSION.encode(),
            source_metadata=_bytes(1, WRITER.encode()))))

    @property
    def active(self) -> bool:
        return self._file is not None

    def log_scalar(self, tag: str, value, step: int) -> None:
        if self._file is None:
            return
        wall = time.time()  # nondet-ok(an event's wall time is what the format records)
        self._file.write(record(_event(wall, int(step),
                                       summary=scalar_summary(tag, float(value)))))
        self._file.flush()  # a live TensorBoard reads each scalar as it lands

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
