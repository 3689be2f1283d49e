"""Name -> object registry (port of ``utils/registry.py``, detectron2's ``utils/registry.py``)."""

from __future__ import annotations

from typing import Any, Iterator


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._map: dict[str, Any] = {}

    def register(self, obj: Any = None, *, name: str | None = None):
        if obj is None:  # decorator with kwargs
            return lambda o: self.register(o, name=name)
        key = name or obj.__name__
        if key in self._map:
            raise KeyError(f"{key!r} already registered in {self._name}")
        self._map[key] = obj
        return obj

    def get(self, name: str) -> Any:
        if name not in self._map:
            raise KeyError(f"{name!r} not found in registry {self._name}; "
                           f"have {sorted(self._map)}")
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def __iter__(self) -> Iterator[tuple[str, Any]]:
        return iter(self._map.items())
