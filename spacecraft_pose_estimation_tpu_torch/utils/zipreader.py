"""Read images from zip archives (port of ``utils/zipreader.py``, HRNet's ``lib/utils/zipreader.py``).

Paths of the form ``archive.zip@inner/path.png`` are read from the
archive (handles cached per archive); plain paths fall through to cv2,
which is imported only by :func:`imread`.
"""

from __future__ import annotations

import threading
import zipfile

import numpy as np

_SPLIT = "@"
_cache: dict[str, zipfile.ZipFile] = {}
_lock = threading.Lock()


def is_zip_path(path: str) -> bool:
    return _SPLIT in path and ".zip" in path


def read_bytes(archive_path: str, inner: str) -> bytes:
    """Raw bytes of one archive member, through the cached handles."""
    with _lock:
        zf = _cache.get(archive_path)
        if zf is None:
            zf = zipfile.ZipFile(archive_path)
            _cache[archive_path] = zf
        return zf.read(inner)


def imread(path: str, flags=None):
    import cv2

    if flags is None:
        flags = cv2.IMREAD_COLOR
    if not is_zip_path(path):
        return cv2.imread(path, flags)
    archive_path, inner = path.split(_SPLIT, 1)
    data = read_bytes(archive_path, inner)
    buf = np.frombuffer(data, np.uint8)
    return cv2.imdecode(buf, flags)


def close_all() -> None:
    with _lock:
        for zf in _cache.values():
            zf.close()
        _cache.clear()
