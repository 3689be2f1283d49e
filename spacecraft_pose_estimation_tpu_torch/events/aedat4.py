"""Native AEDAT-4 (iniVation DV) event-recording reader/writer.

Port of the JAX package's ``events/aedat4.py``. The reference decodes
AEDAT-4 with the `aedat` package (v2e/aedat_to_csv.py:16-45); this module
reads the documented container format itself:

    "#!AER-DAT4.0\\r\\n"
    <size-prefixed flatbuffer IOHeader {compression, dataTablePosition,
                                        infoNode}>          (id "IOHE")
    repeated packets:
        int32 StreamID, int32 Size, byte[Size] payload
        payload (per-header compression: NONE / LZ4 / ZSTD) =
            size-prefixed flatbuffer EventPacket {elements:[Event]}
            (id "EVTS"), Event = struct {int64 timestamp_us, int16 x,
            int16 y, bool polarity} (16 bytes, 8-aligned)
    optional FileDataTable at dataTablePosition (seek index — ignored)

LZ4 frames are handled by the repository's C++ codec (``native/lz4.cpp``),
built with the host's ``g++`` into the port's ``_build/`` at first use and
loaded with ctypes; ZSTD by the `zstandard` module. The writer encodes
with the official `flatbuffers` library so reader and writer do not
share serialization code (round-trip tests are meaningful).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

# CompressionType enum (dv-processing io support)
COMPRESSION_NONE = 0
COMPRESSION_LZ4 = 1
COMPRESSION_LZ4_HIGH = 2
COMPRESSION_ZSTD = 3
COMPRESSION_ZSTD_HIGH = 4

_EVENT_STRUCT_SIZE = 16  # int64 t + int16 x + int16 y + bool p + 3 pad

LZ4_SOURCE = Path(__file__).resolve().parents[2] / "native" / "lz4.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")  # native/Makefile's

_lz4_lib = None
_lz4_lock = threading.Lock()


def build_lz4() -> Path:
    """Compile ``native/lz4.cpp`` into ``_build/spelz4-<hash>.so`` unless
    that file exists (the hash covers the source and the flags)."""
    if not LZ4_SOURCE.exists():
        raise RuntimeError(f"{LZ4_SOURCE} is missing: the LZ4 codec is built from the repository's native/")
    h = hashlib.sha256(LZ4_SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    target = BUILD_DIR / f"spelz4-{h.hexdigest()[:12]}.so"
    if not target.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++) found to build the LZ4 codec")
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(LZ4_SOURCE)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building the LZ4 codec failed:\n{r.stdout}{r.stderr}")
        os.replace(tmp, target)
    return target


def _load_lz4():
    global _lz4_lib
    with _lz4_lock:
        if _lz4_lib is not None:
            return _lz4_lib
        lib = ctypes.CDLL(str(build_lz4()))
        for name in ("spe_lz4_frame_decompress", "spe_lz4_frame_compress"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ]
        _lz4_lib = lib
        return lib


def lz4_frame_decompress(data: bytes, max_out: int | None = None) -> bytes:
    lib = _load_lz4()
    src = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    cap = max_out or max(64, len(data) * 4)
    while True:
        dst = (ctypes.c_uint8 * cap)()
        n = lib.spe_lz4_frame_decompress(src, len(data), dst, cap)
        if n >= 0:
            return bytes(dst[: int(n)])
        if n != -1:  # -2: malformed input (the C ABI distinguishes)
            raise ValueError("malformed LZ4 frame")
        if max_out is not None or cap > (1 << 31):
            raise ValueError("LZ4 frame output exceeds capacity bound")
        cap *= 4  # -1 = insufficient dst; grow and retry


def lz4_frame_compress(data: bytes) -> bytes:
    lib = _load_lz4()
    src = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    cap = len(data) + len(data) // 128 + 64
    dst = (ctypes.c_uint8 * cap)()
    n = lib.spe_lz4_frame_compress(src, len(data), dst, cap)
    if n < 0:
        raise ValueError("LZ4 frame compression failed")
    return bytes(dst[: int(n)])


def _decompress(payload: bytes, compression: int) -> bytes:
    if compression == COMPRESSION_NONE:
        return payload
    if compression in (COMPRESSION_LZ4, COMPRESSION_LZ4_HIGH):
        return lz4_frame_decompress(payload)
    if compression in (COMPRESSION_ZSTD, COMPRESSION_ZSTD_HIGH):
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            payload, max_output_size=1 << 30
        )
    raise ValueError(f"unsupported AEDAT4 compression type {compression}")


def _compress(payload: bytes, compression: int) -> bytes:
    if compression == COMPRESSION_NONE:
        return payload
    if compression in (COMPRESSION_LZ4, COMPRESSION_LZ4_HIGH):
        return lz4_frame_compress(payload)
    if compression in (COMPRESSION_ZSTD, COMPRESSION_ZSTD_HIGH):
        import zstandard

        return zstandard.ZstdCompressor().compress(payload)
    raise ValueError(f"unsupported AEDAT4 compression type {compression}")


# ---------------------------------------------------------------------------
# Minimal flatbuffer readers (hand-rolled on purpose — the writer below
# uses the official flatbuffers Builder, keeping the two independent).
# ---------------------------------------------------------------------------


def _fb_root(buf: bytes, expect_id: bytes):
    """Returns the root table position, accepting both size-prefixed and
    bare flatbuffers (DV writes size-prefixed)."""
    for base in (4, 0):  # prefer size-prefixed
        if len(buf) < base + 8:
            continue
        root = struct.unpack_from("<I", buf, base)[0]
        ident = buf[base + 4 : base + 8]
        if ident == expect_id and base + root <= len(buf):
            return base + root
    raise ValueError(f"flatbuffer identifier {expect_id!r} not found")


def _fb_field(buf: bytes, table_pos: int, field_index: int) -> int | None:
    """Absolute position of a table field's value, or None if absent."""
    soffset = struct.unpack_from("<i", buf, table_pos)[0]
    vtable = table_pos - soffset
    vtable_len = struct.unpack_from("<H", buf, vtable)[0]
    entry = 4 + 2 * field_index
    if entry + 2 > vtable_len:
        return None
    off = struct.unpack_from("<H", buf, vtable + entry)[0]
    if off == 0:
        return None
    return table_pos + off


def _fb_string(buf: bytes, field_pos: int) -> str:
    spos = field_pos + struct.unpack_from("<I", buf, field_pos)[0]
    slen = struct.unpack_from("<I", buf, spos)[0]
    return buf[spos + 4 : spos + 4 + slen].decode("utf-8", "replace")


def parse_ioheader(buf: bytes):
    """-> (compression, data_table_position, info_node_xml, bytes_consumed)."""
    root = _fb_root(buf, b"IOHE")
    # DV writes the IOHeader size-prefixed; consumed = prefix + payload
    prefix = struct.unpack_from("<I", buf, 0)[0]
    consumed = 4 + prefix
    compression = COMPRESSION_NONE
    table_pos = -1
    info = ""
    p = _fb_field(buf, root, 0)
    if p is not None:
        compression = struct.unpack_from("<i", buf, p)[0]
    p = _fb_field(buf, root, 1)
    if p is not None:
        table_pos = struct.unpack_from("<q", buf, p)[0]
    p = _fb_field(buf, root, 2)
    if p is not None:
        info = _fb_string(buf, p)
    return compression, table_pos, info, consumed


def parse_event_packet(payload: bytes) -> np.ndarray:
    """Decompressed EventPacket flatbuffer -> (N, 4) int64 [t_us, x, y, p]."""
    root = _fb_root(payload, b"EVTS")
    vec_field = _fb_field(payload, root, 0)
    if vec_field is None:
        return np.zeros((0, 4), np.int64)
    vec = vec_field + struct.unpack_from("<I", payload, vec_field)[0]
    count = struct.unpack_from("<I", payload, vec)[0]
    start = vec + 4
    raw = np.frombuffer(
        payload, dtype=np.uint8, count=count * _EVENT_STRUCT_SIZE, offset=start
    ).reshape(count, _EVENT_STRUCT_SIZE)
    t = raw[:, 0:8].copy().view("<i8")[:, 0]
    x = raw[:, 8:10].copy().view("<i2")[:, 0].astype(np.int64)
    y = raw[:, 10:12].copy().view("<i2")[:, 0].astype(np.int64)
    p = raw[:, 12].astype(np.int64)
    return np.stack([t, x, y, p], axis=1)


def read_aedat4(path: str) -> np.ndarray:
    """AEDAT-4 file -> (N, 4) int64 [t_us, x, y, polarity 0/1], in file
    order (aedat_to_csv.py semantics, before the first-timestamp shift)."""
    with open(path, "rb") as f:
        data = f.read()
    magic = b"#!AER-DAT4.0\r\n"
    if not data.startswith(magic):
        raise ValueError(f"{path}: not an AEDAT-4 file")
    pos = len(magic)
    compression, table_pos, _info, consumed = parse_ioheader(data[pos:])
    pos += consumed
    end = table_pos if table_pos and table_pos > 0 else len(data)

    chunks = []
    while pos + 8 <= end:
        _stream_id, size = struct.unpack_from("<ii", data, pos)
        pos += 8
        if size <= 0 or pos + size > len(data):
            break
        payload = _decompress(data[pos : pos + size], compression)
        pos += size
        try:
            chunks.append(parse_event_packet(payload))
        except ValueError:
            continue  # non-event stream packet (frames/imu/triggers)
    if not chunks:
        return np.zeros((0, 4), np.int64)
    return np.concatenate(chunks, axis=0)


# ---------------------------------------------------------------------------
# Writer (official flatbuffers Builder — independent encoding path)
# ---------------------------------------------------------------------------


def _build_event_packet(events_us: np.ndarray) -> bytes:
    import flatbuffers

    b = flatbuffers.Builder(1024)
    n = len(events_us)
    # vector of 16-byte structs, built back to front
    b.StartVector(_EVENT_STRUCT_SIZE, n, 8)
    for t, x, y, p in reversed(np.asarray(events_us, np.int64)):
        b.Prep(8, _EVENT_STRUCT_SIZE)
        b.Pad(3)
        b.PrependBool(bool(p > 0))
        b.PrependInt16(int(y))
        b.PrependInt16(int(x))
        b.PrependInt64(int(t))
    vec = b.EndVector()
    b.StartObject(1)
    b.PrependUOffsetTRelativeSlot(0, vec, 0)
    pkt = b.EndObject()
    b.FinishSizePrefixed(pkt, file_identifier=b"EVTS")
    return bytes(b.Output())


def _build_ioheader(compression: int, info_node: str) -> bytes:
    import flatbuffers

    b = flatbuffers.Builder(256)
    info = b.CreateString(info_node)
    b.StartObject(3)
    b.PrependInt32Slot(0, compression, 0)
    b.PrependInt64Slot(1, -1, -1)  # no data table
    b.PrependUOffsetTRelativeSlot(2, info, 0)
    hdr = b.EndObject()
    b.FinishSizePrefixed(hdr, file_identifier=b"IOHE")
    return bytes(b.Output())


def write_aedat4(
    path: str,
    events: np.ndarray,
    compression: int = COMPRESSION_NONE,
    packet_size: int = 4096,
    width: int = 346,
    height: int = 260,
) -> None:
    """(N, 4) [t_seconds, x, y, p(+-1 or 0/1)] -> AEDAT-4 file."""
    ev = np.asarray(events, np.float64)
    ev_us = np.stack(
        [
            np.round(ev[:, 0] * 1e6),
            ev[:, 1],
            ev[:, 2],
            (ev[:, 3] > 0).astype(np.float64),
        ],
        axis=1,
    ).astype(np.int64)
    info = (
        '<dv version="2.0"><node name="outInfo">'
        f'<node name="0"><attr key="typeIdentifier">EVTS</attr>'
        f'<node name="info"><attr key="sizeX">{width}</attr>'
        f'<attr key="sizeY">{height}</attr></node></node></node></dv>'
    )
    with open(path, "wb") as f:
        f.write(b"#!AER-DAT4.0\r\n")
        f.write(_build_ioheader(compression, info))
        for start in range(0, max(len(ev_us), 1), packet_size):
            chunk = ev_us[start : start + packet_size]
            if len(chunk) == 0 and start > 0:
                break
            payload = _compress(_build_event_packet(chunk), compression)
            f.write(struct.pack("<ii", 0, len(payload)))
            f.write(payload)
