"""Host input pipeline: a thread pool decodes while batches are consumed (port of ``data/loader.py``).

The reference hides cv2 decoding in DataLoader worker processes
(``detectron2/data/build.py:282,483``). cv2 releases the interpreter lock
while it reads a file, so a thread pool overlaps the same work without
pickling; :func:`parallel_batches` keeps ``prefetch_batches`` whole
batches decoding ahead of the consumer and yields them strictly in order.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator


def default_num_workers() -> int:
    n = os.cpu_count() or 4
    return max(2, min(8, n - 2))


def parallel_batches(batch_indices: Iterable[Any], make_example: Callable[[Any], dict],
                     collate: Callable[[Any, list], dict], num_workers: int | None = None,
                     prefetch_batches: int = 4) -> Iterator[dict]:
    """``batch_indices`` yields one (meta, [example_key, ...]) pair a batch;
    ``make_example`` decodes each key on the pool and ``collate(meta,
    examples)`` assembles the batch. ``num_workers=0`` decodes in the
    calling thread."""
    workers = num_workers if num_workers is not None else default_num_workers()
    if workers <= 0:
        for meta, keys in batch_indices:
            yield collate(meta, [make_example(k) for k in keys])
        return

    pool = ThreadPoolExecutor(max_workers=workers)
    it = iter(batch_indices)
    pending: deque = deque()

    def submit_next() -> bool:
        try:
            meta, keys = next(it)
        except StopIteration:
            return False
        pending.append((meta, [pool.submit(make_example, k) for k in keys]))
        return True

    try:
        for _ in range(max(prefetch_batches, 1)):
            if not submit_next():
                break
        while pending:
            meta, futs = pending.popleft()
            examples = [f.result() for f in futs]
            submit_next()
            yield collate(meta, examples)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
