"""Tiny name→factory registry (the backbones), each factory stored with the
keyword metadata it was registered with."""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str, **meta) -> Callable:
        def deco(fn):
            if name in self._entries:
                raise KeyError(f"{self.kind} {name!r} already registered")
            self._entries[name] = (fn, meta)
            return fn

        return deco

    def get(self, name: str) -> Callable:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} {name!r}; available: {sorted(self._entries)}"
            )
        return self._entries[name][0]

    def meta(self, name: str) -> dict:
        return self._entries[name][1]

    def names(self) -> List[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries
