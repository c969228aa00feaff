"""ProseMirror JSON ⇄ CRDT doc transformer.

Equivalent of reference `packages/transformer/src/Prosemirror.ts` +
y-prosemirror's prosemirrorJSONToYDoc / yDocToProsemirrorJSON: maps
ProseMirror JSON structurally onto YXmlFragment/YXmlElement/YXmlText
(marks become text formatting attributes). Works without a ProseMirror
schema — the JSON shape itself drives the mapping.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Union

from ..crdt import (
    Doc,
    YXmlElement,
    YXmlFragment,
    YXmlText,
    apply_update,
    encode_state_as_update,
)


def _marks_to_attributes(marks: Optional[list[dict]]) -> dict:
    attributes: dict = {}
    for mark in marks or []:
        attributes[mark["type"]] = mark.get("attrs", {})
    return attributes


def _json_to_xml_nodes(nodes: Iterable[dict]) -> list:
    """Convert a run of ProseMirror JSON nodes to XML type instances.
    Consecutive text nodes collapse into one YXmlText (y-prosemirror
    behavior)."""
    result: list = []
    text_delta: list[dict] = []

    def flush_text() -> None:
        nonlocal text_delta
        if text_delta:
            text = YXmlText()
            # applied when the type integrates into a doc
            delta = text_delta
            text._pending.append(lambda d=delta: text.apply_delta(d))
            result.append(text)
            text_delta = []

    for node in nodes:
        if node.get("type") == "text":
            op: dict = {"insert": node.get("text", "")}
            attributes = _marks_to_attributes(node.get("marks"))
            if attributes:
                op["attributes"] = attributes
            text_delta.append(op)
        else:
            flush_text()
            element = YXmlElement(node["type"])
            for key, value in (node.get("attrs") or {}).items():
                if value is not None:
                    element.set_attribute(key, value)
            children = _json_to_xml_nodes(node.get("content") or [])
            if children:
                element.push(children)
            result.append(element)
    flush_text()
    return result


def _coalesce_strings(children: list) -> list:
    """Merge consecutive str content entries into runs.

    `to_array()` on a text-bearing type yields one str PER UTF-16
    position (ContentString.get_content semantics); emitting a text
    node per character would blow up payloads ~30x and diverge from
    the merged runs y-prosemirror produces.
    """
    out: list = []
    run: list[str] = []
    for child in children:
        if isinstance(child, str):
            run.append(child)
        else:
            if run:
                out.append("".join(run))
                run = []
            out.append(child)
    if run:
        out.append("".join(run))
    return out


def _xml_node_to_json(node: Any) -> list[dict]:
    if isinstance(node, YXmlText):
        ops = []
        for op in node.to_delta():
            entry: dict = {"type": "text", "text": op["insert"]}
            attributes = op.get("attributes")
            if attributes:
                entry["marks"] = [
                    {"type": mark_type, **({"attrs": attrs} if attrs else {})}
                    for mark_type, attrs in attributes.items()
                ]
            ops.append(entry)
        return ops
    if isinstance(node, str):
        # a plain-text root read through the XML view (e.g. the webhook
        # transforming a Y.Text document): string runs become text
        # nodes, as y-prosemirror yields for text content (callers
        # coalesce per-character content entries into runs first)
        return [{"type": "text", "text": node}] if node else []
    result: dict = {"type": node.node_name}
    attrs = node.get_attributes()
    if attrs:
        result["attrs"] = attrs
    content: list = []
    for child in _coalesce_strings(node.to_array()):
        content.extend(_xml_node_to_json(child))
    if content:
        result["content"] = content
    return [result]


class Prosemirror:
    """`to_ydoc` / `from_ydoc` between ProseMirror JSON and CRDT docs."""

    def from_ydoc(self, document: Doc, field_name: Union[str, list, None] = None) -> Any:
        if isinstance(field_name, str):
            return self._fragment_to_json(document.get_xml_fragment(field_name))
        if not field_name:
            field_name = list(document.share.keys())
        return {
            field: self._fragment_to_json(document.get_xml_fragment(field))
            for field in field_name
        }

    def _fragment_to_json(self, fragment: YXmlFragment) -> dict:
        content: list = []
        for child in _coalesce_strings(fragment.to_array()):
            content.extend(_xml_node_to_json(child))
        return {"type": "doc", "content": content}

    def to_ydoc(
        self,
        document: Any,
        field_name: Union[str, list] = "prosemirror",
        schema: Any = None,
    ) -> Doc:
        if not document:
            raise ValueError(
                "empty or invalid document passed to the transformer; "
                f"expected ProseMirror-compatible JSON, got {document!r}"
            )
        fields = [field_name] if isinstance(field_name, str) else list(field_name)
        ydoc = Doc()
        for field in fields:
            fragment = ydoc.get_xml_fragment(field)
            nodes = _json_to_xml_nodes(document.get("content") or [])
            if nodes:
                fragment.push(nodes)
        return ydoc


ProsemirrorTransformer = Prosemirror()
