"""Host-side batch prefetching (port of ``ishara_tpu/utils/prefetch.py``).

One background thread assembles the next host batch while the device runs
the current step. Cancellation-safe: if the consumer abandons the generator
(an exception in the training loop, a preemption), closing it sets a stop
flag, the worker's bounded ``put`` times out, and the thread exits instead of
pinning the source iterable forever. An exception in the worker is raised in
the consumer.
"""

from __future__ import annotations

import queue
import threading


def prefetch(iterable, depth: int = 2):
    """Iterate ``iterable`` on a background thread, ``depth`` items ahead."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    error: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item):
                    return
        except BaseException as e:  # propagate into the consumer
            error.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
