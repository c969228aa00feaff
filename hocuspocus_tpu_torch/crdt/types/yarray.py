"""YArray — shared sequence type (Y.js-compatible)."""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

from ..structs import Item
from .base import (
    AbstractType,
    YARRAY_REF,
    YEvent,
    call_type_observers,
    type_list_delete,
    type_list_get,
    type_list_insert_generics,
    type_list_push_generics,
    type_list_slice,
    type_list_to_array,
)


class YArrayEvent(YEvent):
    pass


class YArray(AbstractType):
    _type_ref = YARRAY_REF

    def __init__(self, initial: Optional[Iterable[Any]] = None) -> None:
        super().__init__()
        self._search_markers = []
        self._prelim: Optional[list] = list(initial) if initial is not None else []

    def _integrate(self, doc, item: Optional[Item]) -> None:
        super()._integrate(doc, item)
        prelim = self._prelim
        self._prelim = None
        if prelim:
            self.insert(0, prelim)

    def _call_observer(self, transaction, parent_subs) -> None:
        call_type_observers(self, transaction, YArrayEvent(self, transaction))

    @property
    def length(self) -> int:
        return len(self._prelim) if self._prelim is not None else self._length

    def __len__(self) -> int:
        return self.length

    def insert(self, index: int, contents: list) -> None:
        if self._prelim is not None:
            self._prelim[index:index] = contents
            return
        self._transact(lambda tr: type_list_insert_generics(tr, self, index, contents))

    def push(self, contents: list) -> None:
        if self._prelim is not None:
            self._prelim.extend(contents)
            return
        self._transact(lambda tr: type_list_push_generics(tr, self, contents))

    def unshift(self, contents: list) -> None:
        self.insert(0, contents)

    def delete(self, index: int, length: int = 1) -> None:
        if self._prelim is not None:
            del self._prelim[index : index + length]
            return
        self._transact(lambda tr: type_list_delete(tr, self, index, length))

    def get(self, index: int) -> Any:
        if self._prelim is not None:
            return self._prelim[index]
        return type_list_get(self, index)

    def __getitem__(self, index: int) -> Any:
        return self.get(index)

    def slice(self, start: int = 0, end: Optional[int] = None) -> list:
        if self._prelim is not None:
            return self._prelim[start:end]
        return type_list_slice(self, start, end if end is not None else self._length)

    def to_array(self) -> list:
        if self._prelim is not None:
            return list(self._prelim)
        return type_list_to_array(self)

    def to_json(self) -> list:
        return [
            value.to_json() if isinstance(value, AbstractType) else value
            for value in self.to_array()
        ]

    def __iter__(self):
        return iter(self.to_array())

    def for_each(self, fn: Callable) -> None:
        for i, value in enumerate(self.to_array()):
            fn(value, i, self)

    def map(self, fn: Callable) -> list:
        return [fn(value, i, self) for i, value in enumerate(self.to_array())]
