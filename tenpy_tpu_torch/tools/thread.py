"""A worker thread with a task queue that reports its death.

Port of ``tenpy_tpu/tools/thread.py``: the threaded cache storage
(:class:`~tenpy_tpu_torch.tools.cache.ThreadedStorage`) writes and
preloads its files on such a worker, so that a sweep does not wait on the
disk.
"""

from __future__ import annotations

import logging
import queue
import threading

logger = logging.getLogger(__name__)

__all__ = ['WorkerDied', 'Worker']


class WorkerDied(Exception):
    """Raised when the worker thread died."""


class Worker:
    """A daemon thread running queued tasks; a context manager.

    Usage::

        with Worker('io') as w:
            results = {}
            w.put_task(fn, arg, return_dict=results, return_key='x')
            w.join_tasks()     # block until the queue is drained
            use(results['x'])
    """

    def __init__(self, name='worker', max_queue_size=0, daemon=True):
        self.name = name
        self.tasks = queue.Queue(maxsize=max_queue_size)
        self._thread = None
        self._exit = threading.Event()
        self._exc = None
        self.daemon = daemon

    def __enter__(self):
        self._thread = threading.Thread(target=self._run, name=self.name,
                                        daemon=self.daemon)
        self._thread.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._exit.set()
        self.tasks.put(None)  # wake up
        self._thread.join()
        self._thread = None
        if self._exc is not None and exc_type is None:
            raise self._exc

    def _run(self):
        while True:
            item = self.tasks.get()
            try:
                if item is None or self._exit.is_set():
                    return
                fn, args, kwargs, return_dict, return_key = item
                res = fn(*args, **kwargs)
                if return_dict is not None:
                    return_dict[return_key] = res
            except Exception as e:  # noqa: BLE001 - raised in the caller
                self._exc = e
                logger.exception("worker %s died", self.name)
                return
            finally:
                self.tasks.task_done()

    def _check_alive(self):
        if self._thread is None or not self._thread.is_alive():
            raise WorkerDied(f"worker {self.name}") from self._exc

    def put_task(self, fn, *args, return_dict=None, return_key=None,
                 **kwargs):
        """Queue ``fn(*args, **kwargs)``; its result goes to
        ``return_dict[return_key]``."""
        self._check_alive()
        self.tasks.put((fn, args, kwargs, return_dict, return_key))

    def join_tasks(self):
        """Block until every queued task has run."""
        self.tasks.join()
        if self._exc is not None:
            raise WorkerDied(f"worker {self.name}") from self._exc
