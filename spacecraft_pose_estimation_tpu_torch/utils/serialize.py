"""Serialization helpers (port of ``utils/serialize.py``, detectron2's ``utils/serialize.py``):
:class:`PicklableWrapper` lets lambda/closure-carrying objects cross
pickle boundaries (multiprocessing dataloader workers, checkpoint
metadata) by routing through cloudpickle.

cloudpickle is imported only where it is used: :func:`robust_loads` and a
plain :func:`robust_dumps` need none, and a call that needs it raises a
``RuntimeError`` where it is not installed.
"""

from __future__ import annotations

import pickle
from typing import Any


def _cloudpickle():
    try:
        import cloudpickle
    except ImportError as e:
        raise RuntimeError("pickling lambdas and local objects needs cloudpickle, which is not installed") from e
    return cloudpickle


class PicklableWrapper:
    """Wrap an object so plain pickle works even when the object itself
    only survives cloudpickle (lambdas, local classes). Transparent
    call/attribute proxy, like detectron2's (utils/serialize.py)."""

    def __init__(self, obj: Any):
        while isinstance(obj, PicklableWrapper):
            obj = obj._obj
        self._obj = obj

    def __reduce__(self):
        cloudpickle = _cloudpickle()
        return cloudpickle.loads, (cloudpickle.dumps(self._obj),)

    def __call__(self, *args, **kwargs):
        return self._obj(*args, **kwargs)

    def __getattr__(self, attr: str):
        if attr not in ("_obj",):
            return getattr(self._obj, attr)
        return getattr(self, attr)


def robust_dumps(obj: Any) -> bytes:
    """pickle if possible (fast, portable), else cloudpickle."""
    try:
        return pickle.dumps(obj)
    except Exception:
        return _cloudpickle().dumps(obj)


def robust_loads(data: bytes) -> Any:
    return pickle.loads(data)  # cloudpickle output is pickle-loadable
