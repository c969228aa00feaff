"""Durability plane: per-document write-ahead log, crash recovery,
fault injection (docs/guides/durability.md).

The storage subsystem makes the server crash-safe without touching
merge semantics: `wal.py` appends every captured Y-update to a
segmented CRC-framed log ahead of broadcast (group-committed, one
fsync per document per event-loop tick), `extension.py` replays the
log suffix over the fetched snapshot at load and truncates segments a
successful store covers, and `faults.py` is the injection seam the
crash/disk test harness drives. A copy of the JAX package's modules of
the same names: the same record and journal bytes on disk, so either
package replays the other's log.
"""

from .extension import Durability
from .faults import FaultInjector, FlakyStore
from .wal import (
    REC_SNAPSHOT,
    REC_UPDATE,
    DocumentWal,
    WalManager,
    decode_records,
    encode_record,
)

__all__ = [
    "Durability",
    "DocumentWal",
    "FaultInjector",
    "FlakyStore",
    "REC_SNAPSHOT",
    "REC_UPDATE",
    "WalManager",
    "decode_records",
    "encode_record",
]
