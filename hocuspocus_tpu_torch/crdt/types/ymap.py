"""YMap — shared key/value type (Y.js-compatible)."""

from __future__ import annotations

from typing import Any, Iterable, Optional

from ..structs import Item
from .base import (
    AbstractType,
    YMAP_REF,
    YEvent,
    call_type_observers,
    type_map_delete,
    type_map_get,
    type_map_has,
    type_map_set,
)


class YMapEvent(YEvent):
    def __init__(self, target, transaction, keys_changed: set) -> None:
        super().__init__(target, transaction)
        self.keys_changed = keys_changed


class YMap(AbstractType):
    _type_ref = YMAP_REF

    def __init__(self, initial: Optional[dict] = None) -> None:
        super().__init__()
        self._prelim: Optional[dict] = dict(initial) if initial is not None else {}

    def _integrate(self, doc, item: Optional[Item]) -> None:
        super()._integrate(doc, item)
        prelim = self._prelim
        self._prelim = None
        if prelim:
            for key, value in prelim.items():
                self.set(key, value)

    def _call_observer(self, transaction, parent_subs) -> None:
        call_type_observers(self, transaction, YMapEvent(self, transaction, parent_subs))

    def set(self, key: str, value: Any) -> Any:
        if self._prelim is not None:
            self._prelim[key] = value
            return value
        self._transact(lambda tr: type_map_set(tr, self, key, value))
        return value

    def get(self, key: str, default: Any = None) -> Any:
        if self._prelim is not None:
            return self._prelim.get(key, default)
        value = type_map_get(self, key)
        return default if value is None else value

    def has(self, key: str) -> bool:
        if self._prelim is not None:
            return key in self._prelim
        return type_map_has(self, key)

    def __contains__(self, key: str) -> bool:
        return self.has(key)

    def delete(self, key: str) -> None:
        if self._prelim is not None:
            self._prelim.pop(key, None)
            return
        self._transact(lambda tr: type_map_delete(tr, self, key))

    def keys(self) -> Iterable[str]:
        if self._prelim is not None:
            return list(self._prelim.keys())
        return [k for k, item in self._map.items() if not item.deleted]

    def values(self) -> list:
        return [self.get(k) for k in self.keys()]

    def entries(self) -> list[tuple[str, Any]]:
        return [(k, self.get(k)) for k in self.keys()]

    @property
    def size(self) -> int:
        return len(list(self.keys()))

    def __len__(self) -> int:
        return self.size

    def to_json(self) -> dict:
        if self._prelim is not None:
            return dict(self._prelim)
        result: dict[str, Any] = {}
        for key, item in self._map.items():
            if not item.deleted:
                value = item.content.get_content()[item.length - 1]
                result[key] = value.to_json() if isinstance(value, AbstractType) else value
        return result

    def __iter__(self):
        return iter(self.keys())
