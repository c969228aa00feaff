"""ProseMirror / Tiptap JSON to a Y.Doc's XML tree and back. A copy of
the JAX package's `transformer/`."""

from .prosemirror import Prosemirror, ProsemirrorTransformer
from .tiptap import Tiptap, TiptapTransformer

__all__ = ["Prosemirror", "ProsemirrorTransformer", "Tiptap", "TiptapTransformer"]
