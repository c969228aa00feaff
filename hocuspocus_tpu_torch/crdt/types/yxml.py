"""YXmlFragment / YXmlElement / YXmlText / YXmlHook (Y.js-compatible).

These back the ProseMirror/Tiptap transformer (reference
`packages/transformer/src/Prosemirror.ts` builds docs out of
XmlFragment/XmlElement/XmlText nodes).
"""

from __future__ import annotations

from html import escape
from typing import Any, Iterable, Optional

from ..encoding import Encoder
from ..structs import Item
from .base import (
    AbstractType,
    YXML_ELEMENT_REF,
    YXML_FRAGMENT_REF,
    YXML_HOOK_REF,
    YXML_TEXT_REF,
    YEvent,
    call_type_observers,
    type_list_delete,
    type_list_get,
    type_list_insert_generics,
    type_list_push_generics,
    type_list_to_array,
    type_map_delete,
    type_map_get,
    type_map_set,
)
from .ymap import YMap
from .ytext import YText


class YXmlEvent(YEvent):
    def __init__(self, target, subs: set, transaction) -> None:
        super().__init__(target, transaction)
        self.child_list_changed = False
        self.attributes_changed: set = set()
        for sub in subs:
            if sub is None:
                self.child_list_changed = True
            else:
                self.attributes_changed.add(sub)


class YXmlFragment(AbstractType):
    _type_ref = YXML_FRAGMENT_REF

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
        call_type_observers(self, transaction, YXmlEvent(self, parent_subs, transaction))

    @property
    def length(self) -> int:
        return len(self._prelim) if self._prelim is not None else self._length

    def __len__(self) -> int:
        return self.length

    @property
    def first_child(self) -> Any:
        return self.get(0) if self.length > 0 else None

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

    def delete(self, index: int, length: int = 1) -> None:
        if self._prelim is not None:
            del self._prelim[index : index + length]
            return
        self._transact(lambda tr: type_list_delete(tr, self, index, length))

    def get(self, index: int) -> Any:
        if self._prelim is not None:
            return self._prelim[index]
        return type_list_get(self, index)

    def to_array(self) -> list:
        if self._prelim is not None:
            return list(self._prelim)
        return type_list_to_array(self)

    def __iter__(self):
        return iter(self.to_array())

    def to_string(self) -> str:
        return "".join(
            child.to_string() if hasattr(child, "to_string") else str(child)
            for child in self.to_array()
        )

    def __str__(self) -> str:
        return self.to_string()

    def to_json(self) -> str:
        return self.to_string()


class YXmlElement(YXmlFragment):
    _type_ref = YXML_ELEMENT_REF

    def __init__(self, node_name: str = "UNDEFINED", initial: Optional[Iterable[Any]] = None) -> None:
        super().__init__(initial)
        self.node_name = node_name
        self._prelim_attrs: Optional[dict] = {}

    def _integrate(self, doc, item: Optional[Item]) -> None:
        prelim_attrs = self._prelim_attrs
        self._prelim_attrs = None
        super()._integrate(doc, item)
        if prelim_attrs:
            for key, value in prelim_attrs.items():
                self.set_attribute(key, value)

    def _copy(self) -> "YXmlElement":
        return YXmlElement(self.node_name)

    def _write(self, encoder: Encoder) -> None:
        encoder.write_var_uint(self._type_ref)
        encoder.write_var_string(self.node_name)

    def set_attribute(self, key: str, value: Any) -> None:
        if self._prelim_attrs is not None:
            self._prelim_attrs[key] = value
            return
        self._transact(lambda tr: type_map_set(tr, self, key, value))

    def get_attribute(self, key: str) -> Any:
        if self._prelim_attrs is not None:
            return self._prelim_attrs.get(key)
        return type_map_get(self, key)

    def remove_attribute(self, key: str) -> None:
        if self._prelim_attrs is not None:
            self._prelim_attrs.pop(key, None)
            return
        self._transact(lambda tr: type_map_delete(tr, self, key))

    def get_attributes(self) -> dict:
        if self._prelim_attrs is not None:
            return dict(self._prelim_attrs)
        return {
            key: item.content.get_content()[item.length - 1]
            for key, item in self._map.items()
            if not item.deleted
        }

    def to_string(self) -> str:
        attrs = self.get_attributes()
        attr_str = "".join(
            f' {key}="{escape(str(value), quote=True)}"' for key, value in sorted(attrs.items())
        )
        children = "".join(
            child.to_string() if hasattr(child, "to_string") else str(child)
            for child in self.to_array()
        )
        name = self.node_name.lower()
        return f"<{name}{attr_str}>{children}</{name}>"


class YXmlText(YText):
    _type_ref = YXML_TEXT_REF

    def to_string(self) -> str:
        parts: list[str] = []
        for op in self.to_delta():
            text = op["insert"]
            if not isinstance(text, str):
                continue
            attrs = op.get("attributes", {})
            for node_name in sorted(attrs.keys(), reverse=True):
                value = attrs[node_name]
                attr_str = ""
                if isinstance(value, dict):
                    attr_str = "".join(
                        f' {k}="{escape(str(v), quote=True)}"' for k, v in sorted(value.items())
                    )
                text = f"<{node_name}{attr_str}>{text}</{node_name}>"
            parts.append(text)
        return "".join(parts)

    def __str__(self) -> str:
        return self.to_string()


class YXmlHook(YMap):
    _type_ref = YXML_HOOK_REF

    def __init__(self, hook_name: str = "undefined", initial: Optional[dict] = None) -> None:
        super().__init__(initial)
        self.hook_name = hook_name

    def _copy(self) -> "YXmlHook":
        return YXmlHook(self.hook_name)

    def _write(self, encoder: Encoder) -> None:
        encoder.write_var_uint(self._type_ref)
        encoder.write_var_string(self.hook_name)
