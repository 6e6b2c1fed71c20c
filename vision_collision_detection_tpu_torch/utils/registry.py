"""Tiny name→factory registry (the backbones)."""

from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable] = {}

    def register(self, name: str) -> Callable:
        def deco(fn):
            if name in self._entries:
                raise KeyError(f"{self.kind} {name!r} already registered")
            self._entries[name] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; available: {sorted(self._entries)}"
            )
        return self._entries[name]
