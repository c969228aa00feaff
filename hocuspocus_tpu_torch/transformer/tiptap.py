"""Tiptap transformer (reference `packages/transformer/src/Tiptap.ts`).

Tiptap documents are ProseMirror documents with field name "default";
schema extensions are accepted for API parity but the structural JSON
mapping needs none.
"""

from __future__ import annotations

from typing import Any, Union

from ..crdt import Doc
from .prosemirror import ProsemirrorTransformer


class Tiptap:
    def __init__(self) -> None:
        self.default_extensions: list = []

    def extensions(self, extensions: list) -> "Tiptap":
        self.default_extensions = extensions
        return self

    def from_ydoc(self, document: Doc, field_name: Union[str, list, None] = None) -> Any:
        return ProsemirrorTransformer.from_ydoc(document, field_name)

    def to_ydoc(
        self, document: Any, field_name: Union[str, list] = "default", extensions: Any = None
    ) -> Doc:
        return ProsemirrorTransformer.to_ydoc(document, field_name)


TiptapTransformer = Tiptap()
