"""Y.js-compatible CRDT engine for the PyTorch port.

A copy of the JAX package's pure-Python engine, so the port imports
nothing of that package. Public API mirrors the yjs surface the server
uses: Doc, apply_update, encode_state_as_update, encode_state_vector,
merge_updates, diff_update, snapshots, and the shared types. Undo,
permanent user data and relative positions are not part of the serve
path and are left out. The bulk varint helpers and the idempotent-
redelivery scan run in the port's native codec
(`hocuspocus_tpu_torch.native`), built at first use.
"""

from .delete_set import DeleteSet, merge_delete_sets
from .doc import Doc, Observable, Transaction
from .encoding import Decoder, Encoder, UNDEFINED
from .ids import ID, compare_ids
from .structs import GC, Item, Skip, StructStore
from .types import (
    AbstractType,
    YArray,
    YArrayEvent,
    YEvent,
    YMap,
    YMapEvent,
    YText,
    YTextEvent,
    YXmlElement,
    YXmlEvent,
    YXmlFragment,
    YXmlHook,
    YXmlText,
)
from .update import (
    Snapshot,
    apply_update,
    create_doc_from_snapshot,
    decode_state_vector,
    diff_update,
    encode_state_as_update,
    encode_state_vector,
    encode_state_vector_from_update,
    is_visible,
    merge_updates,
    snapshot,
    snapshot_contains_update,
    split_snapshot_affected_structs,
)

__all__ = [
    "DeleteSet",
    "merge_delete_sets",
    "Doc",
    "Observable",
    "Transaction",
    "Decoder",
    "Encoder",
    "UNDEFINED",
    "ID",
    "compare_ids",
    "GC",
    "Item",
    "Skip",
    "StructStore",
    "AbstractType",
    "YArray",
    "YArrayEvent",
    "YEvent",
    "YMap",
    "YMapEvent",
    "YText",
    "YTextEvent",
    "YXmlElement",
    "YXmlEvent",
    "YXmlFragment",
    "YXmlHook",
    "YXmlText",
    "Snapshot",
    "apply_update",
    "decode_state_vector",
    "diff_update",
    "encode_state_as_update",
    "encode_state_vector",
    "encode_state_vector_from_update",
    "merge_updates",
    "snapshot",
    "create_doc_from_snapshot",
    "is_visible",
    "split_snapshot_affected_structs",
    "snapshot_contains_update",
]
