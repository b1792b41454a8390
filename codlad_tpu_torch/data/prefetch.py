"""Background host-side batch prefetch (codlad_tpu/data/prefetch.py's, with a stop).

The trainers' per-step host work (batch assembly, normalisation, padding,
the copy to the device) runs serially with the device step unless
overlapped. `prefetch` pulls a wrapped iterator on a daemon thread into a
bounded queue, so that batch i+1's host pipeline runs while the device
executes step i. The thread keeps the iterator's order. The reference gets
the same overlap from torch DataLoader workers (train_latent.py uses
num_workers > 0 loaders). Unlike the JAX package's, the thread stops when
the consumer stops early (a `break` out of the loop closes the generator),
instead of waiting on the full queue, with its batches, for the rest of
the process.
"""

from __future__ import annotations

import queue
import threading

_SENTINEL = object()


def prefetch(iterator, size=2):
    """Yield from `iterator`, computed `size` elements ahead on a daemon
    thread. Exceptions in the producer re-raise at the consumer."""
    q = queue.Queue(maxsize=size)
    err = []
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
