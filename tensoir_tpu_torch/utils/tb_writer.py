"""Self-contained TensorBoard event-file writer (the port's own copy of
tensoir_tpu.utils.tb_writer; numpy, struct and zlib only, no tensorboard
package).

* TFRecord framing: <u64 length LE> <u32 masked-crc32c(length)> <payload>
  <u32 masked-crc32c(payload)>, mask(c) = ((c >> 15) | (c << 17)) + 0xa282ead8.
* Protobuf wire encoding (varints + length-delimited fields) for the
  tensorflow `Event` / `Summary` / `Summary.Image` messages.
* A minimal zlib-based PNG encoder for image summaries.

Files written here load in any standard TensorBoard install.
"""
from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import Dict, List, Optional

import numpy as np

# ---------------------------------------------------------------- crc32c

_CRC32C_POLY = 0x82F63B78
_CRC_TABLE: List[int] = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC32C_POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _tag_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _tag_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _tag_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _tag_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def encode_png(img: np.ndarray) -> bytes:
    """Minimal PNG encoder: uint8 [H, W, 3] (RGB) or [H, W] (grayscale)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    h, w, _ = img.shape

    def chunk(typ: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _summary_value_scalar(tag: str, value: float) -> bytes:
    return _tag_bytes(1, _tag_bytes(1, tag.encode())
                      + _tag_float(2, float(value)))


def _summary_value_image(tag: str, img: np.ndarray) -> bytes:
    img = np.asarray(img)
    h, w = img.shape[:2]
    png = encode_png(img)
    image_msg = (_tag_varint(1, h) + _tag_varint(2, w)
                 + _tag_varint(3, 3) + _tag_bytes(4, png))
    return _tag_bytes(1, _tag_bytes(1, tag.encode()) + _tag_bytes(4, image_msg))


def _event(step: Optional[int] = None, summary: Optional[bytes] = None,
           file_version: Optional[str] = None,
           wall_time: Optional[float] = None) -> bytes:
    msg = _tag_double(1, wall_time if wall_time is not None else time.time())
    if step is not None:
        msg += _tag_varint(2, int(step))
    if file_version is not None:
        msg += _tag_bytes(3, file_version.encode())
    if summary is not None:
        msg += _tag_bytes(5, summary)
    return msg


# --------------------------------------------------------------- writer

class EventWriter:
    """Append-only TensorBoard event file in `log_dir`."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._write(_event(file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        hdr = struct.pack("<Q", len(payload))
        self._f.write(hdr + struct.pack("<I", _masked_crc(hdr))
                      + payload + struct.pack("<I", _masked_crc(payload)))

    def add_scalars(self, values: Dict[str, float], step: int,
                    prefix: str = "") -> None:
        summary = b"".join(
            _summary_value_scalar(prefix + k, v) for k, v in values.items())
        self._write(_event(step=step, summary=summary))

    def add_image(self, tag: str, img: np.ndarray, step: int) -> None:
        """img: [H, W, 3] float in [0,1] or uint8."""
        self._write(_event(step=step, summary=_summary_value_image(tag, img)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()

