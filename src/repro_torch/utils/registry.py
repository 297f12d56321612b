"""Minimal string-keyed registry used for architectures, optimizers, datasets."""
from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, T] = {}

    def register(self, name: str, item: T | None = None):
        """Register directly or as a decorator."""
        if item is not None:
            self._register(name, item)
            return item

        def deco(fn: T) -> T:
            self._register(name, fn)
            return fn

        return deco

    def _register(self, name: str, item: T) -> None:
        if name in self._items:
            raise KeyError(f"{self.kind} '{name}' already registered")
        self._items[name] = item

    def get(self, name: str) -> T:
        if name not in self._items:
            known = ", ".join(sorted(self._items))
            raise KeyError(f"unknown {self.kind} '{name}'; known: {known}")
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._items))

    def names(self) -> list[str]:
        return sorted(self._items)

    def items(self):
        return sorted(self._items.items())
