"""TensorBoard event files without tensorboard (port of
``diffusiondepth_tpu/summary/tb_events.py``), and a reader for them.

The writer emits TFRecord-framed ``tensorboard.Event`` protos in
``events.out.tfevents.*`` files, the records the JAX package writes. The
protobuf wire encoding is done by hand for the messages the summaries use:

    Event    { double wall_time = 1; int64 step = 2;
               string file_version = 3; Summary summary = 5; }
    Summary  { repeated Value value = 1; }
    Value    { string tag = 1; float simple_value = 2; Image image = 4; }
    Image    { int32 height = 1; int32 width = 2; int32 colorspace = 3;
               bytes encoded_image_string = 4; }

TFRecord framing per record: uint64-LE length, uint32-LE masked CRC32C of
the length bytes, payload, uint32-LE masked CRC32C of the payload (the CRC
in C++, ``native/depthops.cpp``). Images are PNG-encoded by the port's own
writer (``native/png.py``).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, List, Optional

import numpy as np

from ..native.depthops import crc32c
from ..native.png import encode_png


def _masked_crc(data: bytes) -> int:
    """TFRecord CRC mask of the CRC-32C: rotate right 15, add a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _varint_field(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def _float_field(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _double_field(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _event(step: int, body: bytes = b"", wall_time: Optional[float] = None) -> bytes:
    ev = _double_field(1, time.time() if wall_time is None else wall_time)
    if step:
        ev += _varint_field(2, step)
    return ev + body


def _scalar_event(tag: str, value: float, step: int) -> bytes:
    val = _bytes_field(1, tag.encode("utf-8")) + _float_field(2, float(value))
    return _event(step, _bytes_field(5, _bytes_field(1, val)))


def _image_event(tag: str, png: bytes, h: int, w: int, colorspace: int, step: int) -> bytes:
    img = (_varint_field(1, h) + _varint_field(2, w)
           + _varint_field(3, colorspace) + _bytes_field(4, png))
    val = _bytes_field(1, tag.encode("utf-8")) + _bytes_field(4, img)
    return _event(step, _bytes_field(5, _bytes_field(1, val)))


class EventFileWriter:
    """Append TensorBoard events to ``{log_dir}/events.out.tfevents.*``:
    ``add_scalar(tag, value, step)`` and ``add_image(tag, hwc_uint8, step)``,
    the part of ``SummaryWriter`` the summaries use."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = "events.out.tfevents.{:.6f}.{}.{}".format(
            time.time(), socket.gethostname(), os.getpid())
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        # every event file leads with a version stamp record
        self._write_record(_event(0, _bytes_field(3, b"brain.Event:2")))
        self.flush()

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_scalar_event(tag, value, int(step)))

    def add_image(self, tag: str, image: np.ndarray, step: int):
        """``image`` is HWC uint8, RGB or grayscale."""
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            raise ValueError(f"add_image expects uint8, got {arr.dtype}")
        if arr.ndim == 2:
            arr = arr[..., None]
        h, w, c = arr.shape
        if c not in (1, 3):
            raise ValueError(f"add_image takes 1 or 3 channels, got {c}")
        png = encode_png(arr[..., 0] if c == 1 else arr)
        # colorspace codes of summary.proto: 1 grayscale, 3 RGB
        self._write_record(_image_event(tag, png, h, w, c, int(step)))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()


# ------------------------------------------------------------------ reader
def read_records(path: str) -> List[bytes]:
    """The payloads of a TFRecord file, each record's two CRCs checked."""
    with open(path, "rb") as f:
        data = f.read()
    out, off = [], 0
    while off < len(data):
        if off + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at byte {off}")
        header = data[off:off + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[off + 8:off + 12])
        if hcrc != _masked_crc(header):
            raise ValueError(f"{path}: bad length CRC at byte {off}")
        end = off + 12 + length + 4
        if end > len(data):
            raise ValueError(f"{path}: truncated record at byte {off}")
        payload = data[off + 12:off + 12 + length]
        (pcrc,) = struct.unpack("<I", data[end - 4:end])
        if pcrc != _masked_crc(payload):
            raise ValueError(f"{path}: bad payload CRC at byte {off}")
        out.append(payload)
        off = end
    return out


def _fields(msg: bytes) -> List[tuple]:
    """(field, wire type, value) of a protobuf message, in order."""
    out, off = [], 0
    while off < len(msg):
        key, off = _read_varint(msg, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, off = _read_varint(msg, off)
        elif wire == 1:
            val, off = msg[off:off + 8], off + 8
        elif wire == 5:
            val, off = msg[off:off + 4], off + 4
        elif wire == 2:
            n, off = _read_varint(msg, off)
            val, off = msg[off:off + n], off + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        out.append((field, wire, val))
    return out


def _read_varint(buf: bytes, off: int):
    n, shift = 0, 0
    while True:
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, off


def parse_event(payload: bytes) -> Dict:
    """An Event payload -> {wall_time, step, file_version?, values: [{tag,
    simple_value? | image: {height, width, colorspace, png}}]}."""
    ev: Dict = {"step": 0, "values": []}
    for field, _, val in _fields(payload):
        if field == 1:
            ev["wall_time"] = struct.unpack("<d", val)[0]
        elif field == 2:
            ev["step"] = val
        elif field == 3:
            ev["file_version"] = val.decode()
        elif field == 5:
            for f_sum, _, v in _fields(val):
                if f_sum != 1:
                    continue
                item: Dict = {}
                for f_val, _, x in _fields(v):
                    if f_val == 1:
                        item["tag"] = x.decode()
                    elif f_val == 2:
                        item["simple_value"] = struct.unpack("<f", x)[0]
                    elif f_val == 4:
                        img = {1: "height", 2: "width", 3: "colorspace", 4: "png"}
                        item["image"] = {img[f]: y for f, _, y in _fields(x)}
                ev["values"].append(item)
    return ev


def read_events(path: str) -> List[Dict]:
    """Every event of an event file, parsed, after the CRC checks."""
    return [parse_event(p) for p in read_records(path)]
