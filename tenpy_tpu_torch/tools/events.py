"""Priority-ordered events: the checkpoint hook of the algorithms.

Port of ``Listener`` and ``EventHandler`` from ``tenpy_tpu/tools/events.py``.
An :class:`~tenpy_tpu_torch.algorithms.algorithm.Algorithm` emits its
``checkpoint`` event between iterations; callbacks connected to it run in
descending priority.
"""

from __future__ import annotations

import importlib
import logging

logger = logging.getLogger(__name__)

__all__ = ['EventHandler', 'Listener']


class Listener:
    __slots__ = ('listener_id', 'callback', 'priority')

    def __init__(self, listener_id, callback, priority):
        self.listener_id = listener_id
        self.callback = callback
        self.priority = priority


class EventHandler:
    """An event with several listeners, called in descending priority.

    Parameters
    ----------
    arg_descr : str, optional
        What :meth:`emit` passes to the callbacks.
    """

    def __init__(self, arg_descr=None):
        self.arg_descr = arg_descr
        self.listeners = []
        self._next_id = 0

    @property
    def id_of_last_connected(self):
        return self._next_id - 1

    def copy(self):
        res = EventHandler(self.arg_descr)
        res.listeners = list(self.listeners)
        res._next_id = self._next_id
        return res

    def connect(self, callback, priority=0):
        """Register ``callback`` (higher priority runs first); returns it,
        so that this works as a decorator."""
        self.listeners.append(Listener(self._next_id, callback, priority))
        self._next_id += 1
        return callback

    def connect_by_name(self, module_name, func_name, priority=0):
        mod = importlib.import_module(module_name)
        self.connect(getattr(mod, func_name), priority)

    def disconnect(self, listener_id):
        for i, listener in enumerate(self.listeners):
            if listener.listener_id == listener_id:
                del self.listeners[i]
                return
        logger.warning("disconnect: no listener with id %d", listener_id)

    def emit(self, *args, **kwargs):
        """Call every listener in priority order; their results as a list."""
        return [listener.callback(*args, **kwargs)
                for listener in self._ordered()]

    def emit_until_result(self, *args, **kwargs):
        """Call listeners until one returns something other than None, and
        return that."""
        for listener in self._ordered():
            res = listener.callback(*args, **kwargs)
            if res is not None:
                return res
        return None

    def _ordered(self):
        return sorted(self.listeners, key=lambda listener: -listener.priority)

    def __repr__(self):
        return f"<EventHandler with {len(self.listeners)} listeners>"
