"""Graceful OOM degradation (port of ``utils/memory.py``, the reference's ``retry_if_cuda_oom``).

`retry_if_oom(fn)` re-runs the function with successively halved batch
(splitting the leading axis of tensor or array args and concatenating
tensor results with ``torch.cat``, arrays with numpy's) when the card runs out of memory: a
``torch.OutOfMemoryError``, or an error whose text holds XLA's markers or
``"out of memory"``. The splits, the recursion into chunks and the
re-raise follow the JAX package's order.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _is_oom(err: Exception) -> bool:
    text = str(err)
    return (isinstance(err, torch.OutOfMemoryError) or "RESOURCE_EXHAUSTED" in text or "Out of memory" in text
            or "out of memory" in text)


def retry_if_oom(fn: Callable, max_splits: int = 3) -> Callable:
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            if not _is_oom(e):
                raise
            # the traceback's frames hold the failed attempt's tensors: drop them before retrying
            last = e.with_traceback(None)
        for split in range(1, max_splits + 1):
            parts = 2**split
            logger.warning("OOM: retrying %s with batch split into %d", fn.__name__, parts)
            lead = None
            for a in args:
                if hasattr(a, "ndim") and a.ndim >= 1:
                    lead = a.shape[0]
                    break
            if lead is None or lead < parts:
                raise last
            chunks = []
            try:
                step = (lead + parts - 1) // parts
                for s in range(0, lead, step):
                    sub = tuple(
                        a[s : s + step] if hasattr(a, "ndim") and a.ndim >= 1 and a.shape[0] == lead else a
                        for a in args
                    )
                    chunks.append(fn(*sub, **kwargs))
                if isinstance(chunks[0], torch.Tensor):
                    return torch.cat(chunks, dim=0)
                if hasattr(chunks[0], "ndim"):
                    return np.concatenate(chunks, axis=0)
                return chunks
            except Exception as e2:
                if not _is_oom(e2):
                    raise
                last = e2.with_traceback(None)
                del chunks  # the finished chunks of the failed split, before the next one allocates
        raise MemoryError(f"{fn.__name__} OOM even after {2**max_splits}-way split")

    return wrapped
