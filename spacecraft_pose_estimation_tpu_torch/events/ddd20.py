"""DDD20 (DAVIS driving dataset) HDF5 recording reader.

A copy of the JAX package's numpy-only ``events/ddd20.py``.

Native replacement for the reference's DDD20SimpleReader + caer unpacker
(v2e/v2ecore/ddd20_utils/ddd_h5_reader.py:23-141,
v2ecore/ddd20_interfaces/caer.py:50-96): recordings are HDF5 files with
a ``dvs/data`` dataset of caer packets ``[system_ts, header, payload]``;
the 28-byte caer header is ``struct 'hhiiiiii'`` (etype, esource, esize,
eoffset, eoverflow, ecapacity, enumber, evalid); polarity-event payloads
are (capacity, esize/4) uint32 rows of (addr, timestamp_us) with
``pol = addr>>1 & 1``, ``y = addr>>2 & 0x7FFF``, ``x = addr>>17``;
frame-event payloads are a 36-byte header + uint16 DVS_SHAPE image.
The reference optionally rotates everything 180 deg (DDD recordings are
mounted upside down) — preserved here.
"""

from __future__ import annotations

import struct

import numpy as np

DVS_SHAPE = (260, 346)  # rows, cols (DAVIS346)

EVENT_TYPES = {
    "special_event": 0,
    "polarity_event": 1,
    "frame_event": 2,
    "imu6_event": 3,
    "imu9_event": 4,
}
ETYPE_BY_ID = {v: k for k, v in EVENT_TYPES.items()}
_HEADER_FIELDS = (
    "etype", "esource", "esize", "eoffset", "eoverflow", "ecapacity",
    "enumber", "evalid",
)
_HEADER_STRUCT = "hhiiiiii"


def unpack_header(raw: bytes) -> dict:
    vals = struct.unpack(_HEADER_STRUCT, raw)
    hdr = dict(zip(_HEADER_FIELDS, vals))
    hdr["etype"] = ETYPE_BY_ID.get(hdr["etype"], hdr["etype"])
    return hdr


def unpack_events(header: dict, payload: bytes, rotate180: bool = True):
    """-> (first_ts_seconds, (N, 4) [t_us, x, y, p]) or None."""
    if header["etype"] != "polarity_event":
        return None
    arr = np.frombuffer(payload, np.uint32).reshape(
        header["ecapacity"], header["esize"] // 4
    )
    if arr.shape[0] == 0:  # empty polarity packet (ecapacity=0): skip
        return None
    data, ts = arr[:, 0], arr[:, 1]
    pol = (data >> 1) & 0b1
    y = (data >> 2) & 0x7FFF
    x = data >> 17
    if rotate180:
        x = DVS_SHAPE[1] - x - 1
        y = DVS_SHAPE[0] - y - 1
    ev = np.stack(
        [ts.astype(np.int64), x.astype(np.int64), y.astype(np.int64),
         pol.astype(np.int64)],
        axis=1,
    )
    return float(ts[0]) * 1e-6, ev


def unpack_frame(header: dict, payload: bytes, rotate180: bool = True):
    """-> (timestamp_seconds, (H, W) uint16 APS frame) or None."""
    if header["etype"] != "frame_event":
        return None
    img_head = np.frombuffer(payload[:36], np.uint32)
    img = np.frombuffer(payload[36:], np.uint16).reshape(DVS_SHAPE)
    if rotate180:
        img = np.rot90(img, k=2)
    return float(img_head[2]) * 1e-6, img


class DDD20Reader:
    """Sequential packet reader (DDD20SimpleReader semantics: skip
    unparseable leading/trailing packets, report duration)."""

    def __init__(self, path: str, rotate180: bool = True):
        import h5py

        self.f = h5py.File(path, "r")
        if "dvs" not in self.f:
            raise ValueError(f"{path}: no DAVIS data (missing 'dvs' group)")
        self.data = self.f["dvs"]["data"]
        self.rotate180 = rotate180
        self.num_packets = self.data.shape[0]

    def read_packet(self, i: int):
        """-> dict with etype + ('events' | 'frame') + timestamp, or None."""
        if not (0 <= i < self.num_packets):
            return None
        row = self.data[i]
        header_raw = bytes(row[1])
        if len(header_raw) < struct.calcsize(_HEADER_STRUCT):
            return None
        hdr = unpack_header(header_raw[: struct.calcsize(_HEADER_STRUCT)])
        payload = bytes(row[2])
        if hdr["etype"] == "polarity_event":
            out = unpack_events(hdr, payload, self.rotate180)
            if out is None:
                return None
            hdr["timestamp"], hdr["events"] = out
        elif hdr["etype"] == "frame_event":
            out = unpack_frame(hdr, payload, self.rotate180)
            if out is None:
                return None
            hdr["timestamp"], hdr["frame"] = out
        else:
            return None
        return hdr

    def events(self) -> np.ndarray:
        """All polarity events -> (N, 4) int64 [t_us, x, y, p]."""
        chunks = []
        for i in range(self.num_packets):
            p = self.read_packet(i)
            if p and "events" in p:
                chunks.append(p["events"])
        if not chunks:
            return np.zeros((0, 4), np.int64)
        return np.concatenate(chunks, axis=0)

    def frames(self):
        """All APS frames -> list of (timestamp_s, (H, W) uint16)."""
        out = []
        for i in range(self.num_packets):
            p = self.read_packet(i)
            if p and "frame" in p:
                out.append((p["timestamp"], p["frame"]))
        return out

    def close(self):
        self.f.close()


def write_ddd20(
    path: str,
    events_us: np.ndarray,  # (N, 4) [t_us, x, y, p 0/1] in SENSOR coords
    frames: list | None = None,  # [(t_s, (H, W) uint16)]
    packet_size: int = 4096,
    rotate180: bool = True,
) -> None:
    """Synthesize a spec-conformant DDD20 recording (test oracle +
    simulation export). Coordinates are flipped on write when rotate180,
    matching how real recordings are stored."""
    import h5py

    rows = []

    def add_packet(etype, payload, capacity, esize):
        hdr = struct.pack(
            _HEADER_STRUCT, EVENT_TYPES[etype], 0, esize, 0, 0, capacity,
            capacity, capacity,
        )
        rows.append((np.int64(0), np.frombuffer(hdr, np.uint8),
                     np.frombuffer(payload, np.uint8)))

    ev = np.asarray(events_us, np.int64)
    for start in range(0, len(ev), packet_size):
        chunk = ev[start : start + packet_size]
        x = chunk[:, 1].astype(np.uint32)
        y = chunk[:, 2].astype(np.uint32)
        if rotate180:
            x = DVS_SHAPE[1] - 1 - x
            y = DVS_SHAPE[0] - 1 - y
        addr = (x << np.uint32(17)) | (y << np.uint32(2)) | (
            (chunk[:, 3].astype(np.uint32) & 1) << np.uint32(1)
        )
        arr = np.stack([addr, chunk[:, 0].astype(np.uint32)], axis=1)
        add_packet("polarity_event", arr.astype(np.uint32).tobytes(),
                   len(chunk), 8)

    for t_s, img in frames or []:
        img = np.asarray(img, np.uint16)
        if rotate180:
            img = np.rot90(img, k=2)
        head = np.zeros(9, np.uint32)
        head[2] = np.uint32(round(t_s * 1e6))
        payload = head.tobytes() + img.tobytes()
        add_packet("frame_event", payload, 1, len(payload))

    dt = h5py.special_dtype(vlen=np.uint8)
    with h5py.File(path, "w") as f:
        g = f.create_group("dvs")
        ds = g.create_dataset(
            "data", (len(rows), 3),
            dtype=h5py.special_dtype(vlen=np.uint8),
        )
        for i, (ts, hdr, payload) in enumerate(rows):
            ds[i, 0] = np.frombuffer(np.int64(ts).tobytes(), np.uint8)
            ds[i, 1] = hdr
            ds[i, 2] = payload
