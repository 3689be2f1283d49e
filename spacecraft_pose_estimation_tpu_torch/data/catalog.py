"""Dataset and metadata catalogs, detectron2's ``data/catalog.py`` (port of ``data/catalog.py``).

``DatasetCatalog`` maps names to zero-argument loaders returning COCO dicts
or example lists; ``MetadataCatalog`` holds each dataset's metadata
(keypoint names, landmark files, camera paths).
``register_coco_instances`` is the helper the reference's detector trainer
calls (``train_object_detection.py:46``), on :func:`coco_io.load_coco`.
"""

from __future__ import annotations

import types
from typing import Any, Callable


class _DatasetCatalog:
    def __init__(self):
        self._map: dict[str, Callable[[], Any]] = {}

    def register(self, name: str, fn: Callable[[], Any]) -> None:
        if name in self._map:
            raise KeyError(f"dataset {name!r} already registered")
        self._map[name] = fn

    def get(self, name: str) -> Any:
        if name not in self._map:
            raise KeyError(f"dataset {name!r} not registered; have {sorted(self._map)}")
        return self._map[name]()

    def list(self) -> list[str]:
        return sorted(self._map)

    def remove(self, name: str) -> None:
        self._map.pop(name, None)

    def clear(self) -> None:
        self._map.clear()


class _MetadataCatalog:
    def __init__(self):
        self._map: dict[str, types.SimpleNamespace] = {}

    def get(self, name: str) -> types.SimpleNamespace:
        if name not in self._map:
            self._map[name] = types.SimpleNamespace(name=name)
        return self._map[name]

    def clear(self) -> None:
        self._map.clear()


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()


def register_coco_instances(name: str, json_file: str, image_root: str) -> None:
    """Register a COCO-format dataset by path: its loader reads the json at
    each ``DatasetCatalog.get``; its metadata keeps both paths."""
    from . import coco_io

    DatasetCatalog.register(name, lambda: coco_io.load_coco(json_file))
    meta = MetadataCatalog.get(name)
    meta.json_file = json_file
    meta.image_root = image_root
