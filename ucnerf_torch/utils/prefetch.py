"""Host-side background prefetching: one thread builds the next samples'
numpy payloads while the device runs the step (the reference uses 8
DataLoader workers, train.py:94-101; one thread is enough because the
dataset's arrays are precomputed per scene).  The host-to-device copy stays
with the consumer."""

from __future__ import annotations

import queue
import threading


class ThreadPrefetcher:
    """Iterate over thunks, computing up to ``depth`` results ahead on a
    background thread.  ``close()`` (or leaving a ``with`` block) stops the
    thread when the consumer quits early."""

    _DONE = object()

    def __init__(self, thunks, depth: int = 2):
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(thunks,),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, thunks):
        try:
            for thunk in thunks:
                if not self._put(thunk()):
                    return
        except BaseException as e:  # re-raised on the consumer thread: a
            self._err = e           # swallowed loader error would silently
        finally:                    # truncate the epoch
            self._put(self._DONE)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self, timeout: float = 10.0):
        self._stop.set()
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
