"""Tiny string -> factory registry used for archs, optimizers, selectors."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator


class Registry:
    """A named registry mapping string keys to factories.

    Used so that ``--arch granite-moe-3b-a800m`` style CLI flags resolve to
    config/model factories without import cycles.
    """

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable[..., Any]] = {}

    def register(self, key: str) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
        def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
            if key in self._entries:
                raise KeyError(f"{self.name}: duplicate key {key!r}")
            self._entries[key] = fn
            return fn

        return deco

    def get(self, key: str) -> Callable[..., Any]:
        try:
            return self._entries[key]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"{self.name}: unknown key {key!r}. Known: {known}") from None

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def keys(self):
        return sorted(self._entries)

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def __len__(self) -> int:
        return len(self._entries)
