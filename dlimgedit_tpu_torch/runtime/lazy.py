"""Thread-safe lazy cache (counterpart of dlimgedit_tpu/runtime/lazy.py)."""

from __future__ import annotations

import threading
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class Lazy(Generic[T]):
    def __init__(self):
        # RLock: a factory that re-enters the same Lazy must recurse instead
        # of deadlocking silently.
        self._lock = threading.RLock()
        self._value: Optional[T] = None
        self._created = False

    def get_or_create(self, factory: Callable[[], T]) -> T:
        if self._created:
            return self._value  # type: ignore[return-value]
        with self._lock:
            if not self._created:
                self._value = factory()
                self._created = True
        return self._value  # type: ignore[return-value]

    @property
    def created(self) -> bool:
        return self._created
