"""Background-thread input prefetch (counterpart of
gens_tpu/utils/prefetch.py): a worker thread prepares items i+1..i+depth
while the device runs step i. A thread suffices because the heavy work,
PNG and PFM decoding and the copy into pinned memory, runs in native code
that releases the interpreter lock.

One worker, where the JAX function runs two: the datasets draw their rays
from the runner's one ``RandomState``, and a single thread makes those
draws in item order, so a run is reproducible.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence


def prefetch_map(fn: Callable, items: Sequence, depth: int = 2) -> Iterator:
    """Yield ``fn(item)`` for each item in order, computing up to ``depth``
    items ahead on one worker thread. An exception surfaces at the yield
    of its item. ``depth`` 0 is ``map(fn, items)`` with no thread."""
    if depth <= 0:
        for it in items:
            yield fn(it)
        return
    with ThreadPoolExecutor(max_workers=1) as ex:
        futures = [ex.submit(fn, it) for it in items[:depth]]
        for i in range(len(items)):
            out = futures[i].result()
            if i + depth < len(items):
                futures.append(ex.submit(fn, items[i + depth]))
            yield out
