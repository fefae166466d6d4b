"""Bounded thread-safe LRU cache for device-resident auxiliary structures, a
copy of ``sublinear_tpu/utils/lru.py``.

Long-running serving processes solve arbitrarily many distinct matrices;
any module-level cache keyed by ``Matrix.uid`` must be bounded or it pins
device buffers forever.  The operator cache lives on the Matrix object
itself (dies with the matrix); these LRUs cover the module-level derived
tables (random-walk CDFs, BMSSP in-edge tables).
"""
from __future__ import annotations

import threading
from collections import OrderedDict


class LRUCache:
    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, default=None):
        with self._lock:
            if key not in self._d:
                return default
            self._d.move_to_end(key)
            return self._d[key]

    def put(self, key, value):
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)
        return value

    def __contains__(self, key):
        with self._lock:
            return key in self._d

    def __len__(self):
        with self._lock:
            return len(self._d)

    def clear(self):
        with self._lock:
            self._d.clear()
