"""Segmented, CRC-framed per-document write-ahead log.

The debounced `on_store_document` pipeline persists FULL document state
every few seconds at best — a crash between debounce windows silently
loses every edit since the last store. Eg-walker (arXiv:2409.14252)
makes the case that an append-only log of operations is the natural
durable representation of a CRDT editing trace, and CRDT convergence
(Shapiro et al., arXiv:0907.0929) guarantees that replaying logged
updates in ANY order on top of ANY stored snapshot reproduces the same
state — so durability reduces to: append the raw Y-update before it is
broadcast, replay the log suffix on load. No merge semantics change.

Layout: `<wal_dir>/<quoted-doc-name>/<index>.wal`, each segment a run
of framed records::

    [u32 crc32][u32 payload_len][u8 type][payload bytes]

The CRC covers length+type+payload, so a torn tail (kill -9 or torn
write mid-record) is detected and skipped at recovery, never applied.
Records carry a per-document monotonically increasing sequence number
(implicit: position in the log), which is how snapshot coverage maps to
truncation — when a successful `on_store_document` covers everything up
to seq N, every segment whose records are all <= N is deleted (the
snapshot + log-suffix model; partially covered segments are retained
because replaying covered updates again is idempotent).

Group commit: appends buffer in the manager and flush ONCE per event
loop tick — one `write()` of the concatenated batch and one `fsync`
per dirty document per tick, run OFF the loop in an executor (the same
batch-amortization shape as the replication lane's one-flush-per-tick
publish outbox, net/resp.py). Callers receive the tick's shared
durability future; the broadcast fan-out gates on it so no client is
ever shown an update the log could still lose.
"""

from __future__ import annotations

import asyncio
import os
import struct
import threading
import time
import zlib
from typing import Any, Iterable, Optional
from urllib.parse import quote

from .faults import FaultInjector

# record framing: crc32(length+type+payload), payload length, type
_CRC = struct.Struct("<I")
_LEN_TYPE = struct.Struct("<IB")
HEADER_BYTES = _CRC.size + _LEN_TYPE.size

REC_UPDATE = 1  # a raw Y-update as captured from the document
REC_SNAPSHOT = 2  # a full-state update (eviction/compaction checkpoint)
REC_JENTRY = 3  # commit-journal wrapper: doc name + an inner record

_RECORD_TYPES = (REC_UPDATE, REC_SNAPSHOT, REC_JENTRY)

# the shared commit journal lives beside the per-doc directories; the
# trailing bare "%" can never collide with a quoted doc name (quote()
# only ever emits "%" as part of a %XX escape)
_JOURNAL_DIR = "journal%"


def encode_journal_entry(name: str, rec_type: int, payload: bytes) -> bytes:
    name_bytes = name.encode("utf-8")
    return encode_record(
        struct.pack("<HB", len(name_bytes), rec_type) + name_bytes + payload,
        REC_JENTRY,
    )


def decode_journal_entry(payload: bytes) -> "tuple[str, int, bytes]":
    name_len, rec_type = struct.unpack_from("<HB", payload, 0)
    name = payload[3 : 3 + name_len].decode("utf-8")
    return name, rec_type, payload[3 + name_len :]


def encode_record(payload: bytes, rec_type: int = REC_UPDATE) -> bytes:
    body = _LEN_TYPE.pack(len(payload), rec_type) + payload
    return _CRC.pack(zlib.crc32(body) & 0xFFFFFFFF) + body


def decode_records(data: bytes) -> "tuple[list[tuple[int, bytes]], int, int]":
    """-> (records, valid_bytes, invalid_tail_records).

    Stops at the first record that is short, CRC-corrupt, or of an
    unknown type: everything after a bad frame is unreachable (record
    boundaries are lost). The caller decides whether the stop point is
    a torn tail (last segment: expected after a crash) or corruption.
    """
    records: "list[tuple[int, bytes]]" = []
    pos = 0
    size = len(data)
    while pos + HEADER_BYTES <= size:
        (crc,) = _CRC.unpack_from(data, pos)
        length, rec_type = _LEN_TYPE.unpack_from(data, pos + _CRC.size)
        end = pos + HEADER_BYTES + length
        if end > size:
            return records, pos, 1  # short final record (torn write)
        body = data[pos + _CRC.size : end]
        if (zlib.crc32(body) & 0xFFFFFFFF) != crc or rec_type not in _RECORD_TYPES:
            return records, pos, 1  # corrupt frame
        records.append((rec_type, data[pos + HEADER_BYTES : end]))
        pos = end
    if pos != size:
        return records, pos, 1  # trailing partial header
    return records, pos, 0


def _doc_dirname(name: str) -> str:
    # doc names are arbitrary strings ("reports/q3"); quote EVERYTHING
    # non-alphanumeric so the mapping is bijective and path-safe
    return quote(name, safe="")


class _Segment:
    __slots__ = ("path", "index", "first_seq", "last_seq", "size")

    def __init__(self, path: str, index: int, first_seq: int, last_seq: int, size: int) -> None:
        self.path = path
        self.index = index
        self.first_seq = first_seq
        self.last_seq = last_seq
        self.size = size


class DocumentWal:
    """One document's segment chain. All file I/O runs on the manager's
    executor thread (one batch at a time), so no internal locking is
    needed; the event-loop side only reads counters."""

    def __init__(self, root: str, name: str, segment_max_bytes: int) -> None:
        self.name = name
        self.directory = os.path.join(root, _doc_dirname(name))
        self.segment_max_bytes = segment_max_bytes
        self.segments: "list[_Segment]" = []
        self.next_seq = 0
        self._fh = None
        self._scanned = False
        # torn/corrupt frames repaired away at scan time (restart path)
        self.scan_torn_records = 0
        self.scan_corrupt_records = 0

    # -- disk scan ---------------------------------------------------------

    def scan(self) -> None:
        """Discover existing segments (executor thread). Sequence
        numbers restart from the on-disk record count — they are
        per-process monotonic positions, not persisted ids.

        A segment with bytes past its last valid record (the torn tail
        a kill -9 leaves) is REPAIRED here — truncated back to the
        valid boundary — because the chain is opened append-mode:
        without the cut, post-restart appends would land after the
        corrupt frame and be unreachable at the next recovery. The cut
        records are counted (`scan_torn_records`) so recovery reports
        stay honest."""
        if self._scanned:
            return
        self._scanned = True
        try:
            entries = sorted(
                e for e in os.listdir(self.directory) if e.endswith(".wal")
            )
        except FileNotFoundError:
            return
        seq = 0
        for position, entry in enumerate(entries):
            path = os.path.join(self.directory, entry)
            try:
                index = int(entry[: -len(".wal")])
                data = _read_file(path)
            except (ValueError, OSError):
                continue
            records, valid_bytes, bad = decode_records(data)
            if valid_bytes < len(data):
                try:
                    os.truncate(path, valid_bytes)
                    if position == len(entries) - 1:
                        self.scan_torn_records += bad
                    else:
                        self.scan_corrupt_records += bad
                except OSError:
                    pass  # unrepaired: replay still stops at the frame
            if not records:
                # empty or fully-torn segment: recovery skips it; keep
                # the file out of the chain so truncation can't count it
                continue
            first = seq
            seq += len(records)
            self.segments.append(_Segment(path, index, first, seq - 1, valid_bytes))
        self.next_seq = seq

    def replay(self) -> "tuple[list[tuple[int, bytes]], dict]":
        """Read every valid record, in order (executor thread).

        -> (records, report). The report counts torn tail records
        (expected after a crash: only ever at the end of the NEWEST
        segment) separately from mid-chain corruption (skipped segment
        suffixes before the last segment)."""
        self.scan()
        out: "list[tuple[int, bytes]]" = []
        # frames the scan repaired away ARE this chain's torn tail — the
        # truncated files below can no longer show them
        report = {
            "records": 0,
            "bytes": 0,
            "torn_tail_records": self.scan_torn_records,
            "corrupt_records": self.scan_corrupt_records,
        }
        # include any segment file present on disk even if scan() saw it
        # empty — a record may have landed after the scan
        try:
            entries = sorted(
                e for e in os.listdir(self.directory) if e.endswith(".wal")
            )
        except FileNotFoundError:
            return out, report
        for position, entry in enumerate(entries):
            path = os.path.join(self.directory, entry)
            try:
                data = _read_file(path)
            except OSError:
                continue
            records, valid_bytes, bad = decode_records(data)
            out.extend(records)
            report["records"] += len(records)
            report["bytes"] += valid_bytes
            if bad:
                if position == len(entries) - 1:
                    report["torn_tail_records"] += bad
                else:
                    report["corrupt_records"] += bad
        return out, report

    # -- append path (executor thread) -------------------------------------

    def _open_segment(self) -> None:
        current = self.segments[-1] if self.segments else None
        if current is None or current.size >= self.segment_max_bytes:
            index = current.index + 1 if current is not None else 0
            path = os.path.join(self.directory, f"{index:08d}.wal")
            current = _Segment(path, index, self.next_seq, self.next_seq - 1, 0)
            self.segments.append(current)
        if self._fh is None or self._fh.name != current.path:
            os.makedirs(self.directory, exist_ok=True)
            if self._fh is not None:
                # rolling past a full segment: settle it on the way out
                # so the journal never has to re-cover a closed file
                try:
                    os.fsync(self._fh.fileno())
                except OSError:
                    pass
                self._fh.close()
            self._fh = open(current.path, "ab")

    def rotate(self) -> None:
        """Force the next append into a fresh segment (checkpoints)."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        current = self.segments[-1] if self.segments else None
        if current is not None and current.size > 0:
            # make the open segment look full so _open_segment rolls
            current.size = max(current.size, self.segment_max_bytes)

    def append_batch(
        self,
        frames: "list[bytes]",
        count: int,
        faults: FaultInjector,
        flush_now: bool = True,
    ) -> int:
        """Write `frames` (already-encoded records) to the open segment.
        Returns bytes written. Raises OSError on injected/real failures;
        a torn-write injection writes a partial final frame first, so
        recovery tests see exactly what a crash leaves behind.

        With `flush_now=False` (tick mode) the bytes may sit in the
        Python file buffer — no per-doc syscall on the hot path. That is
        safe ONLY because the commit journal carries the window's
        durability; `fsync()` flushes before syncing."""
        self.scan()
        self._open_segment()
        faults.check_disk_full()
        blob = b"".join(frames)
        torn_at = faults.torn_write_bytes(len(blob))
        if torn_at is not None:
            self._fh.write(blob[:torn_at])
            self._fh.flush()
            raise OSError("injected torn write")
        self._fh.write(blob)
        if flush_now:
            self._fh.flush()
        segment = self.segments[-1]
        segment.size += len(blob)
        segment.last_seq = self.next_seq + count - 1
        self.next_seq += count
        return len(blob)

    def fsync(self, faults: FaultInjector) -> None:
        faults.check_fsync()
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
        elif self.segments:
            # handle released (doc unloaded) with the tail segment
            # possibly page-cache-only: settle it before the journal
            # stops covering it
            with open(self.segments[-1].path, "rb") as fh:
                os.fsync(fh.fileno())

    # -- truncation --------------------------------------------------------

    def truncate_through(self, seq: int) -> int:
        """Delete whole segments whose every record is covered by a
        durable snapshot at `seq`. Partially covered segments stay
        (replaying covered updates is idempotent). Returns segments
        removed."""
        removed = 0
        keep: "list[_Segment]" = []
        for segment in self.segments:
            if segment.last_seq <= seq and segment.last_seq >= segment.first_seq:
                if self._fh is not None and self._fh.name == segment.path:
                    self._fh.close()
                    self._fh = None
                try:
                    os.unlink(segment.path)
                except OSError:
                    keep.append(segment)
                    continue
                removed += 1
            else:
                keep.append(segment)
        self.segments = keep
        return removed

    def drop_segments_before(self, index: int) -> int:
        """Delete every segment older than `index` (checkpoint path:
        the snapshot record in segment `index` subsumes them)."""
        removed = 0
        keep: "list[_Segment]" = []
        for segment in self.segments:
            if segment.index < index:
                try:
                    os.unlink(segment.path)
                    removed += 1
                    continue
                except OSError:
                    pass
            keep.append(segment)
        self.segments = keep
        return removed

    def repair_tail(self) -> None:
        """After a failed batch write (torn write, ENOSPC mid-batch):
        cut the open segment back to its last known-valid record
        boundary. Without this, the NEXT successful append would land
        beyond the corrupt frame and be unreachable at recovery (frame
        boundaries are lost past a bad record). Falls back to rotating
        into a fresh segment when even the truncate fails."""
        self.close()
        current = self.segments[-1] if self.segments else None
        if current is None:
            return
        try:
            os.truncate(current.path, current.size)
        except OSError:
            self.rotate()

    def pending_records(self) -> int:
        """Records on disk not yet covered by a store (loop side)."""
        return sum(
            segment.last_seq - segment.first_seq + 1
            for segment in self.segments
            if segment.last_seq >= segment.first_seq
        )

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


def _read_file(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


FSYNC_MODES = ("tick", "always", "off")


class WalManager:
    """Process-wide WAL: per-doc segment chains + the group-commit lane.

    `append()` buffers and returns the current tick's shared durability
    future; one flush per tick commits every dirty doc's batch off the
    loop. `--wal-fsync` modes:

    - `tick` (default): per-doc segments are WRITTEN (page cache) but
      the tick's durability comes from the shared **commit journal** —
      every entry in the batch is appended to one journal file with ONE
      write and ONE fsync per tick, regardless of how many documents
      were dirty. When the journal grows past `journal_max_bytes`, the
      dirty doc segments are batch-fsynced and the journal resets —
      fsync cost amortizes over the whole window. Recovery replays doc
      segments PLUS surviving journal entries; duplicates are harmless
      because CRDT update application is idempotent.
    - `always`: fsync the doc segment after every record (differential
      testing / paranoia).
    - `off`: write without fsync — the OS decides durability; group
      commit still batches writes.
    """

    def __init__(
        self,
        directory: str,
        fsync: str = "tick",
        segment_max_bytes: int = 4 * 1024 * 1024,
        journal_max_bytes: int = 1 * 1024 * 1024,
        faults: Optional[FaultInjector] = None,
    ) -> None:
        if fsync not in FSYNC_MODES:
            raise ValueError(f"fsync mode must be one of {FSYNC_MODES}, got {fsync!r}")
        self.directory = directory
        self.fsync_mode = fsync
        self.segment_max_bytes = segment_max_bytes
        self.journal_max_bytes = journal_max_bytes
        self.faults = faults or FaultInjector()
        self._docs: "dict[str, DocumentWal]" = {}
        # name -> [(rec_type, payload, rotate_before, drop_older_after)]
        self._pending: "dict[str, list]" = {}
        self._tick_future: Optional[asyncio.Future] = None
        self._flush_task: Optional[asyncio.Task] = None
        self._flush_lock = asyncio.Lock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False
        # commit journal state (executor thread only, except the cache
        # which the replay path reads under the mutex)
        self._journal_fh = None
        self._journal_size = 0
        self._journal_index = 0
        self._unsynced_docs: "set[str]" = set()
        # lazily-built name -> [(rec_type, payload)] index of the live
        # journal window; None until the first replay scan builds it
        self._journal_cache: "Optional[dict[str, list]]" = None
        self._journal_torn = 0
        self._journal_mutex = threading.Lock()
        self.stats = {
            "appended_records": 0,
            "appended_bytes": 0,
            "fsyncs": 0,
            "commit_batches": 0,
            "commit_batch_records_last": 0,
            "append_errors": 0,
            "checkpoints": 0,
            "segments_truncated": 0,
            "journal_bytes": 0,
            "journal_rotations": 0,
            "recovered_docs": 0,
            "replayed_records": 0,
            "replayed_bytes": 0,
            "torn_tail_records": 0,
            "corrupt_records": 0,
            # last group-commit duration: the overload ladder's
            # wal_commit_ms signal (server/overload.py) — a disk that
            # starts taking hundreds of ms per tick is backpressure the
            # front door must see
            "commit_last_ms": 0.0,
        }

    @property
    def _journal_dir(self) -> str:
        return os.path.join(self.directory, _JOURNAL_DIR)

    # -- plumbing ----------------------------------------------------------

    def doc(self, name: str) -> DocumentWal:
        wal = self._docs.get(name)
        if wal is None:
            wal = self._docs[name] = DocumentWal(
                self.directory, name, self.segment_max_bytes
            )
        return wal

    def position(self, name: str) -> int:
        """Sequence number the NEXT appended record will get — capture
        before a store begins; `truncate_through(position - 1)` after
        it succeeds covers exactly the records the store could see."""
        wal = self.doc(name)
        if not wal._scanned:
            wal.scan()
        return wal.next_seq + len(self._pending.get(name, ()))

    # -- append / group commit ---------------------------------------------

    def append(
        self, name: str, payload: bytes, rec_type: int = REC_UPDATE
    ) -> "asyncio.Future":
        """Buffer one record into the current tick's group commit and
        return the tick's shared durability future."""
        self._pending.setdefault(name, []).append((rec_type, payload, False, False))
        return self._schedule()

    def checkpoint(self, name: str, snapshot: bytes) -> "asyncio.Future":
        """Append a full-state snapshot record into a FRESH segment and,
        once it is durable, drop every older segment — the snapshot
        subsumes them (an eviction/compaction checkpoint bounds the log
        without waiting for the next debounced store)."""
        self.stats["checkpoints"] += 1
        self._pending.setdefault(name, []).append((REC_SNAPSHOT, snapshot, True, True))
        return self._schedule()

    def _schedule(self) -> "asyncio.Future":
        # the loop lookup sits on the per-update capture path: cache it
        # (one manager serves one loop; cross-loop reuse in tests goes
        # through the is_closed() check)
        loop = self._loop
        if loop is None or loop.is_closed():
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                # no loop (unit/direct use): commit synchronously
                future: "asyncio.Future" = _SyncFuture()
                self._commit(self._take_pending())
                future.set_result(None)
                return future
            self._loop = loop
        if self._tick_future is None or self._tick_future.done():
            self._tick_future = loop.create_future()
        if self._flush_task is None or self._flush_task.done():
            self._flush_task = loop.create_task(self._flush_async())
        return self._tick_future

    def _take_pending(self) -> "dict[str, list]":
        pending, self._pending = self._pending, {}
        return pending

    async def _flush_async(self) -> None:
        # serialize batches; appends landing mid-write join the NEXT
        # iteration (the task loops until the buffer is empty, so a
        # tick future created while a commit is on the executor is
        # always picked up and resolved)
        async with self._flush_lock:
            while True:
                pending = self._take_pending()
                future, self._tick_future = self._tick_future, None
                if pending:
                    try:
                        await asyncio.to_thread(self._commit, pending)
                    except Exception:
                        # never let a disk fault leak into the event loop
                        pass
                if future is not None and not future.done():
                    # resolve even on failure: a broadcast gated on a
                    # dead disk must not hang forever — the error is
                    # counted and the records stay recoverable from the
                    # store path
                    future.set_result(None)
                if not self._pending or self._closed:
                    return

    def _commit(self, pending: "dict[str, list]") -> None:
        """Executor thread: write every dirty doc's batch, then make the
        whole tick durable with ONE journal fsync (tick mode)."""
        commit_started = time.perf_counter()
        batch_records = 0
        journal_entries: "list[bytes]" = []
        journal_meta: "list[tuple[str, int, bytes]]" = []
        # tick mode: a checkpoint's older segments may only be dropped
        # AFTER the journal fsync makes the snapshot durable — dropping
        # first would leave a crash window where the history is gone
        # and the snapshot exists only in page cache
        deferred_drops: "list[DocumentWal]" = []
        for name, entries in pending.items():
            wal = self.doc(name)
            appended = 0
            try:
                drop_older = False
                frames: "list[bytes]" = []

                def flush_frames() -> None:
                    nonlocal frames, appended
                    if not frames:
                        return
                    written = wal.append_batch(
                        frames,
                        len(frames),
                        self.faults,
                        # tick mode: the journal fsync below is the
                        # durability barrier; skip the per-doc syscalls
                        flush_now=self.fsync_mode != "tick",
                    )
                    self.stats["appended_records"] += len(frames)
                    self.stats["appended_bytes"] += written
                    appended += len(frames)
                    frames = []

                for rec_type, payload, rotate_before, drop_after in entries:
                    if rotate_before:
                        flush_frames()
                        wal.rotate()
                    frames.append(encode_record(payload, rec_type))
                    batch_records += 1
                    if self.fsync_mode == "always":
                        flush_frames()
                        wal.fsync(self.faults)
                        self.stats["fsyncs"] += 1
                    drop_older = drop_older or drop_after
                flush_frames()
                if self.fsync_mode == "tick":
                    # the doc segment stays page-cache-only for now; the
                    # journal below carries this tick's durability
                    self._unsynced_docs.add(name)
                    for rec_type, payload, _rot, _drop in entries:
                        journal_entries.append(
                            encode_journal_entry(name, rec_type, payload)
                        )
                        journal_meta.append((name, rec_type, payload))
                if drop_older and wal.segments:
                    # the snapshot record subsumes older segments — but
                    # only once it is durable: `always` mode fsynced it
                    # per record above; `tick` mode must wait for the
                    # journal fsync below
                    if self.fsync_mode == "tick":
                        deferred_drops.append(wal)
                    else:
                        self.stats["segments_truncated"] += wal.drop_segments_before(
                            wal.segments[-1].index
                        )
            except OSError:
                self.stats["append_errors"] += 1
                # cut the segment back to its last valid record so the
                # next append stays recoverable; the records that failed
                # stay covered by the store pipeline
                wal.repair_tail()
                # BURN the lost records' sequence numbers: a store that
                # captured its position while they were buffered counted
                # them — if later records re-used those seqs, a
                # successful store's truncate_through could cover (and
                # delete) updates that arrived after its encode
                wal.next_seq += len(entries) - appended
        if journal_entries:
            committed = self._journal_commit(journal_entries, journal_meta)
            if committed and deferred_drops:
                # the journal fsync landed: the checkpoint snapshots are
                # durable, so their older segments can finally go; then
                # rotate so the subsume-everything property holds on
                # disk too (checkpoints are rare — eviction-rate, not
                # edit-rate — so the extra segment fsyncs amortize)
                for wal in deferred_drops:
                    if wal.segments:
                        self.stats["segments_truncated"] += wal.drop_segments_before(
                            wal.segments[-1].index
                        )
                self._journal_rotate()
        self.stats["commit_batches"] += 1
        self.stats["commit_batch_records_last"] = batch_records
        commit_s = time.perf_counter() - commit_started
        self.stats["commit_last_ms"] = round(commit_s * 1000, 3)
        from ..observability.costs import get_cost_ledger

        ledger = get_cost_ledger()
        if ledger.enabled and batch_records:
            # wal_append: group-commit cost on the EXECUTOR thread —
            # visible in /debug/costs attribution but excluded from the
            # loop-thread headroom sum (OFF_LOOP_SITES)
            ledger.record(
                "wal_append",
                "Sync",
                int(commit_s * 1e9),
                sum(len(e) for e in journal_entries),
            )

    # -- commit journal (executor thread) ----------------------------------

    def _journal_commit(
        self,
        entries: "list[bytes]",
        meta: "list[tuple[str, int, bytes]]",
    ) -> bool:
        """ONE write + ONE fsync covers every doc dirtied this tick —
        the batch-fsync amortization the per-doc layout alone can't
        give (N dirty docs would mean N serial fsyncs per tick).
        Returns True when the fsync landed (checkpoint drops gate on
        it)."""
        blob = b"".join(entries)
        try:
            if self._journal_fh is None:
                os.makedirs(self._journal_dir, exist_ok=True)
                # NEVER append to a journal left by an earlier process:
                # its tail may be torn (crash mid-write), and entries
                # written past a corrupt frame would be unreachable at
                # replay. Old files stay readable until rotation
                # deletes the whole directory's worth.
                try:
                    existing = [
                        int(e[: -len(".journal")])
                        for e in os.listdir(self._journal_dir)
                        if e.endswith(".journal")
                    ]
                except (OSError, ValueError):
                    existing = []
                if existing:
                    self._journal_index = max(
                        self._journal_index, max(existing) + 1
                    )
                path = os.path.join(
                    self._journal_dir, f"{self._journal_index:08d}.journal"
                )
                self._journal_fh = open(path, "ab")
                self._journal_size = 0
            self.faults.check_disk_full()
            self._journal_fh.write(blob)
            self._journal_fh.flush()
            self.faults.check_fsync()
            # fdatasync: data + the metadata needed to read it back
            # (file size) — skips timestamp flushes the recovery scan
            # never looks at
            os.fdatasync(self._journal_fh.fileno())
            self.stats["fsyncs"] += 1
            self._journal_size += len(blob)
            self.stats["journal_bytes"] += len(blob)
        except OSError:
            self.stats["append_errors"] += 1
            if self._journal_fh is not None:
                try:
                    self._journal_fh.close()
                except OSError:
                    pass
                self._journal_fh = None
            return False
        with self._journal_mutex:
            if self._journal_cache is not None:
                for name, rec_type, payload in meta:
                    self._journal_cache.setdefault(name, []).append(
                        (rec_type, payload)
                    )
        if self._journal_size >= self.journal_max_bytes:
            self._journal_rotate()
        return True

    def _journal_rotate(self) -> None:
        """Batch-fsync every doc segment the journal was covering, then
        drop the journal — from here the segments carry their own
        durability. On ANY fsync failure the journal survives (it is
        still the only durable copy of that doc's window)."""
        all_synced = True
        for name in list(self._unsynced_docs):
            wal = self._docs.get(name)
            try:
                if wal is None:
                    # doc unloaded since its last append: fsync its tail
                    # segment file directly (no scan — decoding a whole
                    # chain here would stall the group-commit lane for
                    # every gated broadcast in the process)
                    self._fsync_tail_file(name)
                else:
                    wal.fsync(self.faults)
                self.stats["fsyncs"] += 1
                self._unsynced_docs.discard(name)
            except OSError:
                self.stats["append_errors"] += 1
                all_synced = False
        if not all_synced:
            return
        if self._journal_fh is not None:
            try:
                self._journal_fh.close()
            except OSError:
                pass
            self._journal_fh = None
        try:
            for entry in os.listdir(self._journal_dir):
                if entry.endswith(".journal"):
                    os.unlink(os.path.join(self._journal_dir, entry))
        except OSError:
            pass
        self._journal_index += 1
        self._journal_size = 0
        with self._journal_mutex:
            # settled entries no longer need redo at recovery
            self._journal_cache = {}
            self._journal_torn = 0
        self.stats["journal_rotations"] += 1

    def _fsync_tail_file(self, name: str) -> None:
        """Settle an unloaded doc's newest segment file (filename order
        is segment order) without reading or decoding any content."""
        self.faults.check_fsync()
        directory = os.path.join(self.directory, _doc_dirname(name))
        try:
            tail = max(e for e in os.listdir(directory) if e.endswith(".wal"))
        except (FileNotFoundError, ValueError):
            return  # nothing on disk: nothing to settle
        with open(os.path.join(directory, tail), "rb") as fh:
            os.fsync(fh.fileno())

    def _journal_replay(self, name: str) -> "tuple[list[tuple[int, bytes]], int]":
        """Surviving journal entries for `name` (executor thread):
        records whose doc-segment copy may never have been fsynced.
        Duplicates vs the segment replay are expected and harmless —
        CRDT update application is idempotent.

        The journal directory is decoded ONCE into a name-indexed cache
        (kept current by commits, cleared by rotation) — a restart
        join-storm of N docs costs one journal scan, not N."""
        with self._journal_mutex:
            if self._journal_cache is None:
                cache: "dict[str, list]" = {}
                torn = 0
                try:
                    entries = sorted(
                        e
                        for e in os.listdir(self._journal_dir)
                        if e.endswith(".journal")
                    )
                except FileNotFoundError:
                    entries = []
                for entry in entries:
                    try:
                        data = _read_file(os.path.join(self._journal_dir, entry))
                    except OSError:
                        continue
                    records, _valid, bad = decode_records(data)
                    torn += bad
                    for rec_type, payload in records:
                        if rec_type != REC_JENTRY:
                            continue
                        try:
                            rec_name, inner_type, inner_payload = (
                                decode_journal_entry(payload)
                            )
                        except (struct.error, UnicodeDecodeError):
                            continue
                        cache.setdefault(rec_name, []).append(
                            (inner_type, inner_payload)
                        )
                self._journal_cache = cache
                self._journal_torn = torn
            return list(self._journal_cache.get(name, ())), self._journal_torn

    async def flush(self) -> None:
        """Force-commit everything buffered and wait for durability
        (the drain path's first step)."""
        while self._pending or (
            self._flush_task is not None and not self._flush_task.done()
        ):
            if self._pending:
                await self._schedule()
            else:
                await self._flush_task

    # -- recovery / truncation ---------------------------------------------

    async def replay(self, name: str) -> "tuple[list[tuple[int, bytes]], dict]":
        wal = self.doc(name)
        records, report = await asyncio.to_thread(wal.replay)
        # the commit journal may hold the newest window (doc segments
        # written but not yet fsynced at crash time); its entries come
        # last, duplicates are idempotent
        journal_records, journal_torn = await asyncio.to_thread(
            self._journal_replay, name
        )
        if journal_records:
            records = records + journal_records
        report["journal_records"] = len(journal_records)
        report["journal_torn_records"] = journal_torn
        if records:
            self.stats["recovered_docs"] += 1
        self.stats["replayed_records"] += report["records"] + len(journal_records)
        self.stats["replayed_bytes"] += report["bytes"]
        self.stats["torn_tail_records"] += (
            report["torn_tail_records"] + journal_torn
        )
        self.stats["corrupt_records"] += report["corrupt_records"]
        return records, report

    def truncate_through(self, name: str, seq: int) -> int:
        if seq < 0:
            return 0
        wal = self._docs.get(name)
        if wal is None:
            return 0
        removed = wal.truncate_through(seq)
        self.stats["segments_truncated"] += removed
        return removed

    def pending_records(self, name: str) -> int:
        wal = self._docs.get(name)
        uncommitted = len(self._pending.get(name, ()))
        return uncommitted + (0 if wal is None else wal.pending_records())

    def forget(self, name: str) -> None:
        """Release the doc's open file handle (unload). Files stay: the
        WAL suffix must survive unload exactly like the store row."""
        wal = self._docs.pop(name, None)
        if wal is not None:
            wal.close()

    def close(self) -> None:
        self._closed = True
        for wal in self._docs.values():
            wal.close()
        self._docs.clear()
        if self._journal_fh is not None:
            try:
                self._journal_fh.close()
            except OSError:
                pass
            self._journal_fh = None


class _SyncFuture:
    """Minimal already-done future for no-loop contexts (quacks enough
    of the asyncio.Future surface for gate checks)."""

    def __init__(self) -> None:
        self._result = None

    def set_result(self, value: Any) -> None:
        self._result = value

    def done(self) -> bool:
        return True

    def result(self) -> Any:
        return self._result

    def __await__(self):
        if False:  # pragma: no cover - makes this a generator
            yield
        return self._result
