"""TensorBoard export of training records
(transformer_stm_tpu/tools/tb_export.py:160-193).

The reference attaches a ``TensorBoard(log_dir='logs')`` callback to every
fit (models/CvT(Par).py:471-476).  Here the records sheet is the artifact
of record, and this tool mirrors it into a TensorBoard event file, apart
from the training loop.  It needs neither TensorFlow nor tensorboard: it
frames TFRecords (length, masked CRC32C, data, masked CRC32C) and encodes
the ``Event`` and ``Summary`` protos by hand.  Each scalar takes the form
TF2's ``tf.summary.scalar`` writes: a float32 scalar tensor value (its
bytes in ``tensor_content``) with the ``scalars`` plugin's metadata.

    from transformer_stm_tpu_torch.tools.tb_export import export_records
    export_records("Result/Records/.../cvt_records_50HZ_Bm_....xlsx",
                   "logs/50HZ_Bm")

or ``python -m transformer_stm_tpu_torch.tools.tb_export <records.xlsx>
<logdir>``.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional, Sequence


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of TFRecord framing."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: uint64 length, its masked CRC32C, the data, the data's
    masked CRC32C (all little-endian)."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data +
            struct.pack("<I", masked_crc32c(data)))


# -- protobuf wire format (proto3: fields at their default are left out) ----

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # a negative int64 as its ten-byte two's complement
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(data)) + data


def _event(wall_time: float, step: int = 0, file_version: str = "",
           summary: bytes = b"", writer: str = "") -> bytes:
    """tensorflow.Event: wall_time (1, double), step (2, int64),
    file_version (3), summary (5), source_metadata (10: writer, 1)."""
    out = b""
    if wall_time:
        out += _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _varint(2 << 3) + _varint(step)
    if file_version:
        out += _bytes_field(3, file_version.encode())
    if summary:
        out += _bytes_field(5, summary)
    if writer:
        out += _bytes_field(10, _bytes_field(1, writer.encode()))
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    """tensorflow.Summary with one Value: tag (1), tensor (8: a DT_FLOAT
    TensorProto, dtype 1, an empty shape 2, tensor_content 4) and metadata
    (9: plugin_data 1, plugin_name 1 "scalars")."""
    tensor = (_varint(1 << 3) + _varint(1) + _bytes_field(2, b"") +
              _bytes_field(4, struct.pack("<f", value)))
    metadata = _bytes_field(1, _bytes_field(1, b"scalars"))
    value_msg = (_bytes_field(1, tag.encode()) + _bytes_field(8, tensor) +
                 _bytes_field(9, metadata))
    return _bytes_field(1, value_msg)


def _event_file(logdir: str) -> str:
    """A new file name in TF2's pattern,
    events.out.tfevents.{seconds}.{host}.{pid}.{n}.v2."""
    base = (f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}")
    n = 0
    while os.path.exists(os.path.join(logdir, f"{base}.{n}.v2")):
        n += 1
    return os.path.join(logdir, f"{base}.{n}.v2")


def export_rows(rows: Sequence[Sequence], logdir: str,
                columns: Optional[Sequence[str]] = None) -> str:
    """rows: [epoch, loss, mae, val_loss, val_mae, lr]-style records
    (column names from ``columns``, default the CvT records schema).
    Writes one scalar series per column, at step ``int(row[0])``, into a
    new event file in ``logdir``; None cells are skipped."""
    columns = list(columns or
                   ["epoch", "loss", "mae", "val_loss", "val_mae", "lr"])
    os.makedirs(logdir, exist_ok=True)
    with open(_event_file(logdir), "wb") as f:
        f.write(tfrecord(_event(time.time(), file_version="brain.Event:2",
                                writer=__name__)))
        for row in rows:
            step = int(row[0])
            for name, val in zip(columns[1:], row[1:]):
                if val is None:
                    continue
                f.write(tfrecord(_event(time.time(), step,
                                        summary=_scalar_summary(
                                            name, float(val)))))
    return logdir


def export_records(records_path: str, logdir: str) -> str:
    """A records sheet (the reference's schema) -> a TensorBoard event
    file."""
    from ..data.xlsx import read_table

    cols, rows = read_table(records_path)
    return export_rows(rows, logdir, columns=cols)


if __name__ == "__main__":
    import sys

    print(export_records(sys.argv[1], sys.argv[2]))
