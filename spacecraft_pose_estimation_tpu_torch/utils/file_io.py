"""PathManager (port of ``utils/file_io.py``, detectron2's ``utils/file_io.py``).

Pluggable path handlers over one `open/exists/ls/...` surface. Ships
three handlers: local filesystem, `zip://archive.zip!inner/path` (via
utils/zipreader, the HRNet zipreader contract), and `spe://` for
package-relative resources (the analogue of the reference's
`detectron2://` zoo scheme, local only), which resolves inside this
package's tree.
"""

from __future__ import annotations

import io
import os
import shutil
import zipfile
from typing import IO, Any, Dict, List


class PathHandler:
    def supported_prefixes(self) -> List[str]:
        raise NotImplementedError

    def open(self, path: str, mode: str = "r", **kw: Any) -> IO:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def get_local_path(self, path: str) -> str:
        raise NotImplementedError


class LocalPathHandler(PathHandler):
    def supported_prefixes(self) -> List[str]:
        return [""]

    def open(self, path: str, mode: str = "r", **kw: Any) -> IO:
        if "w" in mode or "a" in mode:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        return open(path, mode, **kw)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def get_local_path(self, path: str) -> str:
        return path


class ZipPathHandler(PathHandler):
    """zip://archive.zip!inner/name — read-only, backed by zipreader's
    cached archives (utils/zipreader.py)."""

    PREFIX = "zip://"

    def supported_prefixes(self) -> List[str]:
        return [self.PREFIX]

    def _split(self, path: str):
        body = path[len(self.PREFIX):]
        archive, _, inner = body.partition("!")
        return archive, inner

    def open(self, path: str, mode: str = "r", **kw: Any) -> IO:
        if mode not in ("r", "rb"):
            raise ValueError(f"zip:// is read-only, got mode {mode!r}")
        from .zipreader import read_bytes

        data = read_bytes(*self._split(path))
        return io.BytesIO(data) if mode == "rb" else io.StringIO(data.decode())

    def exists(self, path: str) -> bool:
        archive, inner = self._split(path)
        if not os.path.exists(archive):
            return False
        with zipfile.ZipFile(archive) as z:
            return inner in z.namelist()

    def get_local_path(self, path: str) -> str:
        raise OSError("zip:// entries have no standalone local path")


class PackageResourceHandler(PathHandler):
    """spe://relative/path -> file inside the installed package tree."""

    PREFIX = "spe://"

    def supported_prefixes(self) -> List[str]:
        return [self.PREFIX]

    def _resolve(self, path: str) -> str:
        pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        return os.path.join(pkg_dir, path[len(self.PREFIX):])

    def open(self, path: str, mode: str = "r", **kw: Any) -> IO:
        return open(self._resolve(path), mode, **kw)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._resolve(path))

    def get_local_path(self, path: str) -> str:
        return self._resolve(path)


class PathManagerBase:
    def __init__(self) -> None:
        self._handlers: Dict[str, PathHandler] = {}
        self._local = LocalPathHandler()

    def register_handler(self, handler: PathHandler) -> None:
        for p in handler.supported_prefixes():
            if p:
                self._handlers[p] = handler

    def _h(self, path: str) -> PathHandler:
        for prefix, h in self._handlers.items():
            if path.startswith(prefix):
                return h
        return self._local

    def open(self, path: str, mode: str = "r", **kw: Any) -> IO:
        return self._h(path).open(path, mode, **kw)

    def exists(self, path: str) -> bool:
        return self._h(path).exists(path)

    def get_local_path(self, path: str) -> str:
        return self._h(path).get_local_path(path)

    def isfile(self, path: str) -> bool:
        h = self._h(path)
        if isinstance(h, LocalPathHandler):
            return os.path.isfile(path)
        return h.exists(path)

    def ls(self, path: str) -> List[str]:
        return sorted(os.listdir(self.get_local_path(path)))

    def mkdirs(self, path: str) -> None:
        os.makedirs(self.get_local_path(path), exist_ok=True)

    def copy(self, src: str, dst: str) -> None:
        with self.open(src, "rb") as fsrc, self.open(dst, "wb") as fdst:
            shutil.copyfileobj(fsrc, fdst)


PathManager = PathManagerBase()
PathManager.register_handler(ZipPathHandler())
PathManager.register_handler(PackageResourceHandler())
