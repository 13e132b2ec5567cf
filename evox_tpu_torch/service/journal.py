"""Crash-safe request journal — the service's durable source of truth
(counterpart of ``evox_tpu/service/journal.py``, a copy: stdlib only and
the same wire format, canonical body and sha256, so a journal written by
either package replays in the other).  Its consumers in the port are the
control plane's decision journal (``Controller(journal=)``) and the
serving daemon (:class:`~evox_tpu_torch.service.ServiceDaemon`), the
daemon this docstring speaks of.

An ``OptimizationService`` is in-memory: a daemon
SIGKILLed between accepting a tenant and that tenant's first checkpoint
forgets the submission ever happened.  The journal closes that hole.
Every externally-visible state transition — submit, readmit, evict,
retire, complete, preempt — is one **atomic, fsync'd, checksummed
record** appended *before* the operation is acknowledged to the caller,
so a restarted daemon reconstructs the exact set of live tenants by
replaying the journal and letting each tenant's checkpoint namespace
supply the values (the runner's resume machinery).  The guarantee is
**at-least-once**: a crash can lose at most the one record whose append
had not yet returned (the caller never got an ack for it and must
retry), and replay is idempotent — duplicate records for a uid collapse
onto the newest state.

**Record format** (one JSON object per line, greppable and
``jq``-friendly)::

    {"body": {"seq": 12, "kind": "submit", "at": 1722..., "data": {...}},
     "sha": "<sha256 of the canonical body JSON>"}

``seq`` is strictly increasing; ``sha`` covers the canonically-encoded
body, so a torn append (truncated line), a bit flip anywhere in the
record, or a forged/reordered line all fail validation.  Appends are
``flush`` + ``fsync`` per record (durability is the point; the record
rate is bounded by admission, not by generations), and a failed append
(``ENOSPC``) truncates the file back to the pre-append offset so the
journal never grows an internally-torn middle.

**Replay discipline** (:meth:`RequestJournal.replay`): records are
validated in order; the FIRST invalid record ends the trusted prefix.
Everything from that byte on is the **damaged tail** — it is quarantined
to ``<journal>.corrupt[.N]`` (evidence, never deleted) and the journal
file is truncated back to the last valid record, so subsequent appends
extend a clean prefix.  Because every acknowledged record was fsync'd
before its ack, the damaged tail can only contain unacknowledged (or
post-crash garbage) bytes — the at-most-one-lost-record bound.

Every *mutating* file operation — appends, the repair truncate, the
quarantine-tail write — routes through the
:class:`~evox_tpu_torch.utils.CheckpointStore` seam, so
``resilience.FaultyStore`` injects torn records, bit flips, and
``ENOSPC`` mid-append deterministically;
replay's read is a plain file read, since damaged bytes are exactly what
it exists to classify.

**Compaction** (:meth:`RequestJournal.compact`): an append-only journal
makes restart cost scale with process *lifetime*, not *live state*.
Compaction folds the whole history into one schema-versioned,
checksummed **snapshot** (canonical sorted-key JSON, same envelope as a
record) and swaps in a one-record journal whose ``snapshot-anchor``
record binds the snapshot by name + sha.  The protocol is ordered so
that every crash point leaves a recoverable disk state:

1. publish ``<stem>.snapshot.<seq>`` (temp → fsync → rename → dir
   fsync);
2. publish ``<journal>.compacted.<seq>`` — a byte-for-byte quarantined
   copy of the full pre-compaction journal (the loud fallback);
3. atomically publish the anchored one-record journal over the journal
   path (the swap);
4. only then GC superseded snapshots/copies — and even then the prior
   anchor's snapshot is retained, because the fresh fallback copy's own
   first record still references it (the never-delete-before-the-
   successor-is-durable discipline).

Replay loads the anchor's snapshot as the base state and folds the
suffix records onto it.  A torn / bit-flipped / missing snapshot — or a
torn swap that destroyed the anchor itself — falls back **loudly**
(``replay_notes`` + a warning) to the quarantined full-journal copy;
only when both the snapshot and its fallback are unusable does replay
raise, because proceeding would silently drop acknowledged records.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Union

from ..utils.checkpoint import CheckpointStore, quarantine_target

__all__ = [
    "RequestJournal",
    "JournalRecord",
    "JournalError",
    "JournalDamage",
    "JournalSnapshot",
    "CompactionResult",
    "SNAPSHOT_SCHEMA",
    "ANCHOR_KIND",
]

#: Snapshot payload schema version.  Replay refuses snapshots from a
#: schema it does not understand (falling back to the quarantined full
#: journal) instead of guessing at field meanings.
SNAPSHOT_SCHEMA = 1

#: Record kind of the compaction anchor — the only record kind with
#: journal-level meaning; every other kind is opaque caller payload.
ANCHOR_KIND = "snapshot-anchor"


class JournalError(RuntimeError):
    """An append could not be made durable (or the journal has an unhealed
    torn tail).  The operation it guarded must be treated as
    unacknowledged — the caller retries or rejects upstream."""


@dataclass
class JournalRecord:
    """One validated journal record."""

    seq: int
    kind: str
    at: float
    data: dict[str, Any]


@dataclass
class JournalDamage:
    """What :meth:`RequestJournal.replay` found past the trusted prefix."""

    offset: int  # byte offset the trusted prefix ends at
    reason: str  # why the first rejected record failed validation
    bytes_quarantined: int
    quarantine_path: Path | None  # None when the tail could not be saved
    truncated: bool  # whether the journal was cut back to the prefix


@dataclass
class JournalSnapshot:
    """A validated, loaded journal snapshot: the folded state of every
    record up to and including ``seq - 1``, anchored at ``seq``."""

    seq: int  # the anchor record's seq (first live suffix seq is seq+1)
    at: float  # wall time the snapshot was taken
    schema: int
    state: dict[str, Any]  # caller-defined folded state
    path: Path  # the snapshot file the anchor bound


@dataclass
class CompactionResult:
    """What one successful :meth:`RequestJournal.compact` did."""

    seq: int
    snapshot_path: Path
    fallback_path: Path  # quarantined full pre-compaction journal
    folded_records: int  # suffix records folded into the snapshot
    bytes_before: int
    bytes_after: int
    removed: list[str] = field(default_factory=list)  # GC'd predecessors


def _canonical(body: dict[str, Any]) -> str:
    return json.dumps(body, sort_keys=True, separators=(",", ":"))




class RequestJournal:
    """Append-only, checksummed, fsync-per-record journal.

    :param path: journal file (created on first append).
    :param store: the :class:`~evox_tpu_torch.utils.CheckpointStore` appends,
        truncations, and quarantine writes route through
        (chaos-injectable; a read-only store refuses appends with
        ``EROFS``).
    :param durable: ``fsync`` after every record (default True — an
        un-fsync'd ack is a lie).
    :param registry: optional metrics registry (duck-typed
        :class:`~evox_tpu_torch.obs.MetricsRegistry`): the durability hot path
        publishes ``evox_journal_append_seconds`` /
        ``evox_journal_fsync_seconds`` histograms and an
        ``evox_journal_records_total{kind=}`` counter — the fsync is the
        admission ack's latency floor, and it was unobserved.
        Failure-isolated, same contract as
        ``AsyncCheckpointWriter(registry=)``: a broken registry never
        fails an append.
    """

    def __init__(
        self,
        path: Union[str, Path],
        *,
        store: CheckpointStore | None = None,
        durable: bool = True,
        registry: Any | None = None,
    ):
        self.path = Path(path)
        self.store = store if store is not None else CheckpointStore()
        self.durable = bool(durable)
        self._registry = registry
        self.next_seq = 0
        self.records_appended = 0
        self.append_failures = 0
        self._f: Any | None = None
        # Set when a failed append left bytes we could not truncate away:
        # appending onto an unhealed torn middle would corrupt the clean
        # prefix, so the journal refuses until replay() repairs the file.
        self._dirty = False
        # Compaction state, primed by replay()/compact().
        self.snapshot: JournalSnapshot | None = None
        self.compactions = 0
        self.snapshot_fallbacks = 0
        # Every snapshot/fallback file the last replay's base chain
        # actually used — compaction's GC keep-set, so reaping can never
        # sever the recovery chain the current journal depends on.
        self._base_refs: set[str] = set()
        # Human-readable recovery anomalies from the last replay()
        # (snapshot fallback, gap warnings) — the caller's loudness
        # channel; the daemon surfaces each as a warning event.
        self.replay_notes: list[str] = []

    # -- snapshot accessors --------------------------------------------------
    @property
    def snapshot_state(self) -> dict[str, Any] | None:
        return None if self.snapshot is None else self.snapshot.state

    @property
    def snapshot_seq(self) -> int | None:
        return None if self.snapshot is None else self.snapshot.seq

    @property
    def snapshot_at(self) -> float | None:
        return None if self.snapshot is None else self.snapshot.at

    @property
    def records_since_snapshot(self) -> int:
        """Suffix records replay must fold on a cold start — the number
        compaction would collapse into the next snapshot."""
        if self.snapshot is None:
            return self.next_seq
        return max(0, self.next_seq - self.snapshot.seq - 1)

    @property
    def size_bytes(self) -> int:
        try:
            return int(self.path.stat().st_size)
        except OSError:
            return 0

    # -- append -------------------------------------------------------------
    def _open(self) -> Any:
        if self._f is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = self.store.open_append(self.path)
            if self.durable:
                # A freshly-created journal's DIRECTORY ENTRY must survive
                # power loss too: fsyncing the file alone persists data
                # blocks a crashed filesystem may never link — replay
                # would find no journal and every acked tenant would
                # silently vanish.  Failure propagates: the caller's
                # append is then unacknowledged, same as any append fault.
                self.store.fsync_dir(self.path.parent)
        return self._f

    def append(self, kind: str, **data: Any) -> int:
        """Durably append one record; returns its ``seq``.  Raises
        :class:`JournalError` when the record could not be made durable —
        the caller must NOT ack the operation it guards."""
        if self._dirty:
            raise JournalError(
                f"journal {self.path} has an unhealed torn tail from a "
                f"failed append; replay() repairs it"
            )
        body = {
            "seq": self.next_seq,
            "kind": str(kind),
            "at": time.time(),
            "data": data,
        }
        line = self._encode_record(body)
        try:
            f = self._open()
        except OSError as e:
            # A read-only store (non-primary fleet process) or a vanished
            # directory: the operation is unacknowledged either way.
            self.append_failures += 1
            raise JournalError(
                f"journal {self.path} could not be opened for append "
                f"({type(e).__name__}: {e}); the operation is "
                f"unacknowledged"
            ) from e
        offset = f.tell()
        t0 = time.perf_counter()
        fsync_seconds = 0.0
        try:
            written = self.store.append_record(f, line)
            f.flush()
            if self.durable:
                t_sync = time.perf_counter()
                os.fsync(f.fileno())
                fsync_seconds = time.perf_counter() - t_sync
        except (OSError, RuntimeError) as e:
            self.append_failures += 1
            self._heal(f, offset)
            raise JournalError(
                f"journal append of {kind!r} record failed "
                f"({type(e).__name__}: {e}); the operation is "
                f"unacknowledged"
            ) from e
        if written != len(line):
            # A store that silently wrote a short record (a lying disk):
            # the on-disk tail is torn.  Cut it back — acking a torn
            # record would break the at-most-one-lost-record bound.
            self.append_failures += 1
            self._heal(f, offset)
            raise JournalError(
                f"journal append of {kind!r} record was torn "
                f"({written}/{len(line)} bytes); the operation is "
                f"unacknowledged"
            )
        self.next_seq += 1
        self.records_appended += 1
        self._observe(kind, time.perf_counter() - t0, fsync_seconds)
        return body["seq"]

    @staticmethod
    def _encode_record(body: dict[str, Any]) -> bytes:
        """One wire-format journal line: canonical body + its sha, in a
        fixed envelope so the sha always covers exactly the body bytes
        replay will recompute over."""
        body_json = _canonical(body)
        sha = hashlib.sha256(body_json.encode()).hexdigest()
        return ('{"body":' + body_json + ',"sha":"' + sha + '"}\n').encode()

    def _observe(
        self, kind: str, append_seconds: float, fsync_seconds: float
    ) -> None:
        """Registry feed, failure-isolated (the AsyncCheckpointWriter
        contract): the durability hot path must never fail on account of
        its own observation."""
        if self._registry is None:
            return
        try:
            self._registry.histogram(
                "evox_journal_append_seconds",
                "Wall seconds per durable journal append (write + flush "
                "+ fsync) — the admission ack's latency floor.",
            ).observe(append_seconds)
            self._registry.histogram(
                "evox_journal_fsync_seconds",
                "Wall seconds of the fsync alone within each append.",
            ).observe(fsync_seconds)
            self._registry.counter(
                "evox_journal_records_total",
                "Journal records durably appended, by record kind.",
                kind=str(kind),
            ).inc()
        except Exception:  # pragma: no cover - broken registry
            pass

    def _heal(self, f: Any, offset: int) -> None:
        """Cut a failed append's partial bytes back off.  If even that
        fails (the disk is gone), poison the journal: future appends
        refuse instead of extending garbage."""
        try:
            f.flush()
        except OSError:
            pass
        try:
            os.ftruncate(f.fileno(), offset)
        except OSError:
            self._dirty = True

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            finally:
                self._f = None

    # -- replay -------------------------------------------------------------
    def replay(
        self, *, quarantine: bool = True
    ) -> tuple[list[JournalRecord], JournalDamage | None]:
        """Validate the journal and return ``(records, damage)``.

        ``records`` is the trusted prefix — every record whose checksum
        and sequence check out, in order.  On the first invalid record the
        rest of the file is the damaged tail: with ``quarantine=True`` it
        is saved to ``<journal>.corrupt[.N]`` and the journal is truncated
        back to the trusted prefix (both route through the store; a
        read-only store leaves the file untouched and only reports).
        ``damage`` is ``None`` for a clean journal.  Also primes
        ``next_seq`` so subsequent appends continue the sequence.

        A journal whose first record is a ``snapshot-anchor`` loads the
        referenced snapshot into :attr:`snapshot` and returns only the
        suffix records — the caller folds the suffix onto
        :attr:`snapshot_state`.  An unusable snapshot (torn, flipped,
        missing, wrong schema) falls back loudly to the quarantined
        pre-compaction journal copy named in the anchor; a destroyed
        anchor (torn swap) restores the journal from the newest
        quarantined copy.  Only when every fallback is exhausted does
        replay raise :class:`JournalError` — acknowledged records are
        never dropped silently."""
        self.close()
        self.replay_notes = []
        self.snapshot = None
        self._base_refs = set()
        try:
            raw = self.path.read_bytes()
        except FileNotFoundError:
            self.next_seq = 0
            return [], None
        anchor, records, reason, offset, next_seq = self._scan(raw)
        if anchor is None and not records and reason is not None:
            # Record 0 itself is damaged.  A torn or bit-flipped
            # compaction swap does exactly this — before declaring total
            # loss, recover from the newest quarantined pre-compaction
            # copy (the step-2 artifact, published before the swap).
            restored = self._restore_from_fallback(
                raw, reason, quarantine=quarantine
            )
            if restored is not None:
                return restored
        if anchor is not None:
            base, err = self._anchor_base(anchor)
            if err is not None:
                raise JournalError(err)
            records = base + records
        self.next_seq = next_seq
        if reason is None:
            self._dirty = False
            return records, None
        tail = raw[offset:]
        qpath: Path | None = None
        truncated = False
        if quarantine:
            qpath = self._quarantine_tail(tail)
            try:
                self.store.truncate(self.path, offset)
                truncated = True
            except OSError:
                pass
        # Appends may only resume once the damaged tail is actually gone:
        # with quarantine=False (or a failed truncate — read-only store,
        # vanished file) an append would extend the garbage and the NEXT
        # replay would cut the acked record away with it, breaking the
        # at-most-one-lost-record bound.
        self._dirty = not truncated
        return records, JournalDamage(
            offset=offset,
            reason=reason,
            bytes_quarantined=len(tail),
            quarantine_path=qpath,
            truncated=truncated,
        )

    def _scan(
        self, raw: bytes
    ) -> tuple[
        JournalRecord | None, list[JournalRecord], str | None, int, int
    ]:
        """Validate one journal byte stream.  Returns ``(anchor,
        records, reason, offset, next_seq)``: the leading
        ``snapshot-anchor`` record when present (never included in
        ``records``), the trusted records after it, the first validation
        failure (``None`` when clean), the byte offset the trusted
        prefix ends at, and the seq the next append would take."""
        anchor: JournalRecord | None = None
        records: list[JournalRecord] = []
        offset = 0
        reason: str | None = None
        expected_seq = 0
        while offset < len(raw):
            nl = raw.find(b"\n", offset)
            if nl < 0:
                reason = "truncated record (no terminating newline)"
                break
            line = raw[offset : nl + 1]
            try:
                obj = json.loads(line)
                body = obj["body"]
                sha = obj["sha"]
            except (
                json.JSONDecodeError,
                UnicodeDecodeError,
                KeyError,
                TypeError,
            ) as e:
                reason = f"unparseable record ({type(e).__name__})"
                break
            actual = hashlib.sha256(_canonical(body).encode()).hexdigest()
            if actual != sha:
                reason = (
                    f"checksum mismatch (recorded {str(sha)[:12]}…, "
                    f"recomputed {actual[:12]}…) — bit flip or tamper"
                )
                break
            try:
                seq = int(body["seq"])
                kind = str(body["kind"])
                at = float(body.get("at", 0.0))
                data = dict(body.get("data") or {})
            except (KeyError, TypeError, ValueError) as e:
                reason = f"malformed record body ({type(e).__name__})"
                break
            if kind == ANCHOR_KIND:
                # The anchor seeds the sequence: it consumed the seq the
                # compaction observed, so the suffix continues from
                # seq + 1.  Anywhere but record 0 it is spliced damage.
                if offset != 0:
                    reason = (
                        "snapshot-anchor out of position (not record 0) "
                        "— spliced or replayed compaction record"
                    )
                    break
                if not str(data.get("snapshot") or ""):
                    reason = "snapshot-anchor carries no snapshot name"
                    break
                anchor = JournalRecord(seq=seq, kind=kind, at=at, data=data)
                expected_seq = seq + 1
                offset = nl + 1
                continue
            if seq != expected_seq:
                reason = (
                    f"sequence break (expected seq {expected_seq}, "
                    f"found {seq}) — reordered or spliced records"
                )
                break
            records.append(JournalRecord(seq=seq, kind=kind, at=at, data=data))
            expected_seq = seq + 1
            offset = nl + 1
        return anchor, records, reason, offset, expected_seq

    def _note(self, message: str) -> None:
        """The loudness channel: recovery anomalies are recorded for the
        caller (the daemon turns each into a warning event) and warned,
        never swallowed."""
        self.replay_notes.append(message)
        warnings.warn(f"journal {self.path.name}: {message}", RuntimeWarning)

    def _load_snapshot(self, anchor: JournalRecord) -> None:
        """Load and validate the snapshot an anchor binds; raises
        :class:`JournalError` on any mismatch (the caller falls back)."""
        name = str(anchor.data.get("snapshot") or "")
        spath = self.path.parent / name
        try:
            sraw = spath.read_bytes()
        except OSError as e:
            raise JournalError(
                f"snapshot {name!r} unreadable ({type(e).__name__}: {e})"
            ) from e
        try:
            obj = json.loads(sraw)
            body = obj["body"]
            sha = obj["sha"]
        except (
            json.JSONDecodeError,
            UnicodeDecodeError,
            KeyError,
            TypeError,
        ) as e:
            raise JournalError(
                f"snapshot {name!r} unparseable ({type(e).__name__}) — "
                f"torn write"
            ) from e
        actual = hashlib.sha256(_canonical(body).encode()).hexdigest()
        if actual != sha:
            raise JournalError(
                f"snapshot {name!r} checksum mismatch — bit flip or torn "
                f"write"
            )
        if str(anchor.data.get("sha") or "") != str(sha):
            raise JournalError(
                f"snapshot {name!r} does not match its anchor's sha "
                f"binding — stale or swapped snapshot file"
            )
        try:
            schema = int(body.get("schema", -1))
            seq = int(body.get("seq", -1))
            at = float(body.get("at", 0.0))
            state = dict(body.get("state") or {})
        except (TypeError, ValueError) as e:
            raise JournalError(
                f"snapshot {name!r} malformed body ({type(e).__name__})"
            ) from e
        if schema != SNAPSHOT_SCHEMA:
            raise JournalError(
                f"snapshot {name!r} schema {schema} unsupported "
                f"(this build understands {SNAPSHOT_SCHEMA})"
            )
        if seq != anchor.seq:
            raise JournalError(
                f"snapshot {name!r} is anchored at seq {seq}, anchor "
                f"says {anchor.seq}"
            )
        self.snapshot = JournalSnapshot(
            seq=seq, at=at, schema=schema, state=state, path=spath
        )
        self._base_refs.add(name)

    def _anchor_base(
        self, anchor: JournalRecord, depth: int = 0
    ) -> tuple[list[JournalRecord], str | None]:
        """The base state an anchor stands for.  Primary: its snapshot
        (loaded into :attr:`snapshot`, base records empty).  Fallback:
        the quarantined full-journal copy the anchor names — loud, and
        recursive when that copy begins with an older anchor.  Returns
        ``(base_records, error)``; ``error`` is a refusal (acked records
        would be silently lost) when every source is unusable."""
        if depth > 8:
            return [], (
                "compaction fallback chain deeper than 8 — refusing "
                "(corrupt or cyclic anchor references)"
            )
        fallback = str(anchor.data.get("fallback") or "")
        try:
            self._load_snapshot(anchor)
            return [], None
        except JournalError as e:
            self.snapshot_fallbacks += 1
            self._note(
                f"snapshot for anchor seq {anchor.seq} is unusable ({e}); "
                f"falling back to quarantined full journal {fallback!r}"
            )
        if not fallback:
            return [], (
                f"snapshot for anchor seq {anchor.seq} is unusable and "
                f"the anchor records no fallback copy; refusing to "
                f"silently drop acked records"
            )
        src = self.path.parent / fallback
        try:
            fraw = src.read_bytes()
        except OSError as e:
            return [], (
                f"snapshot for anchor seq {anchor.seq} is unusable and "
                f"its fallback {fallback!r} is unreadable "
                f"({type(e).__name__}: {e}); refusing to silently drop "
                f"acked records"
            )
        self._base_refs.add(fallback)
        fanchor, frecords, freason, _foffset, fnext = self._scan(fraw)
        if freason is not None:
            self._note(
                f"fallback journal {fallback!r} has a damaged tail "
                f"({freason}); folding its trusted prefix"
            )
        base: list[JournalRecord] = []
        if fanchor is not None:
            base, err = self._anchor_base(fanchor, depth + 1)
            if err is not None:
                return [], err
        if fnext != anchor.seq:
            self._note(
                f"fallback journal {fallback!r} ends at seq {fnext - 1} "
                f"but the anchor expects seq {anchor.seq - 1}; records "
                f"in the gap are lost — inspect the quarantine files"
            )
        return base + frecords, None

    def _restore_from_fallback(
        self, raw: bytes, reason: str, *, quarantine: bool
    ) -> tuple[list[JournalRecord], JournalDamage | None] | None:
        """Record 0 of the journal is damaged (the signature of a torn
        or bit-flipped compaction swap): quarantine the wreck and
        restore the journal from the newest ``<journal>.compacted.<seq>``
        copy.  Returns the full replay result, or ``None`` when no copy
        exists (the caller reports ordinary damage)."""
        candidates = sorted(
            self.path.parent.glob(self.path.name + ".compacted.*")
        )
        candidates = [c for c in candidates if ".tmp." not in c.name]
        if not candidates:
            return None
        src = candidates[-1]
        try:
            fraw = src.read_bytes()
        except OSError:
            return None
        self.snapshot_fallbacks += 1
        self._note(
            f"record 0 is damaged ({reason}) — the signature of a torn "
            f"compaction swap; restoring from quarantined copy {src.name}"
        )
        qpath: Path | None = None
        restored = False
        if quarantine:
            qpath = self._quarantine_tail(raw)
            try:
                self._publish_bytes(fraw, self.path)
                restored = True
            except (OSError, RuntimeError) as e:
                self._note(
                    f"could not restore the journal from {src.name} "
                    f"({type(e).__name__}: {e}); replaying the copy "
                    f"read-only"
                )
        self._dirty = not restored
        fanchor, records, freason, foffset, fnext = self._scan(fraw)
        if fanchor is not None:
            base, err = self._anchor_base(fanchor)
            if err is not None:
                raise JournalError(err)
            records = base + records
        self.next_seq = fnext
        if freason is not None:
            self._note(
                f"quarantined copy {src.name} has a damaged tail "
                f"({freason}); using its trusted prefix"
            )
            if restored:
                try:
                    self.store.truncate(self.path, foffset)
                except OSError:
                    self._dirty = True
        return records, JournalDamage(
            offset=0,
            reason=f"{reason}; recovered from {src.name}",
            bytes_quarantined=len(raw),
            quarantine_path=qpath,
            truncated=restored,
        )

    def _quarantine_tail(self, tail: bytes) -> Path | None:
        """Save the damaged tail as evidence (atomic, via the store);
        failure to save must not block the repair — report ``None``."""
        target = quarantine_target(self.path)
        try:
            self._publish_bytes(tail, target)
        except (OSError, RuntimeError):
            return None
        return target

    # -- compaction ---------------------------------------------------------
    def _publish_bytes(self, data: bytes, final: Path) -> None:
        """Atomically publish ``data`` at ``final`` through the store:
        same-directory temp → write → fsync → rename → directory fsync.
        Any fault raises with the previous ``final`` intact (the rename
        is the commit point) and the temp unlinked."""
        fd, tmp = self.store.open_temp(final.parent, final.name + ".tmp.")
        try:
            with os.fdopen(fd, "wb") as f:
                self.store.write_bytes(f, data)
                f.flush()
                if self.durable:
                    self.store.fsync_file(f)
            self.store.publish(tmp, final)
        except BaseException:
            try:
                self.store.unlink(tmp)
            except OSError:
                pass
            raise
        if self.durable:
            self.store.fsync_dir(final.parent)

    def compact(
        self,
        fold: Callable[[dict[str, Any] | None, list[JournalRecord]], dict],
    ) -> CompactionResult:
        """Fold the whole journal into one snapshot and swap in a
        one-record anchored journal.  ``fold(base_state, records)``
        must be a pure function of the prior snapshot state (``None``
        before the first compaction) and the suffix records — the exact
        fold replay uses, so a compacted cold start is bit-for-bit the
        state a full replay would build.

        Ordering is the crash-safety argument (see the module
        docstring): snapshot first, full-journal quarantine copy second,
        the atomic swap third, GC last — a kill between any two steps
        leaves either the old journal intact or a swap whose anchor can
        reach a durable base.  Raises :class:`JournalError` on any
        fault, with the journal still valid (the swap's rename is the
        only commit point)."""
        records, _damage = self.replay(quarantine=True)
        if self._dirty:
            raise JournalError(
                f"journal {self.path} has an unhealed damaged tail; "
                f"compaction refused until replay can repair it"
            )
        base = self.snapshot_state
        # Everything the base chain the replay just walked still needs:
        # the prior snapshot in the healthy case, or the fallback
        # copies (recursively) when a snapshot was unusable.  The fresh
        # full-journal copy's record 0 keeps referencing that chain, so
        # GC below must not sever it.
        base_refs = set(self._base_refs)
        if not records and base is None:
            raise JournalError("nothing to compact (empty journal)")
        seq = self.next_seq
        at = time.time()
        state = fold(base, records)
        body = {
            "schema": SNAPSHOT_SCHEMA,
            "seq": seq,
            "at": at,
            "state": state,
        }
        try:
            body_json = _canonical(body)
        except (TypeError, ValueError) as e:
            raise JournalError(
                f"snapshot state is not canonically JSON-serializable "
                f"({type(e).__name__}: {e})"
            ) from e
        sha = hashlib.sha256(body_json.encode()).hexdigest()
        snap_bytes = (
            '{"body":' + body_json + ',"sha":"' + sha + '"}\n'
        ).encode()
        snap_name = f"{self.path.stem}.snapshot.{seq:08d}"
        fallback_name = f"{self.path.name}.compacted.{seq:08d}"
        try:
            raw = self.path.read_bytes()
        except FileNotFoundError:
            raw = b""
        anchor_line = self._encode_record(
            {
                "seq": seq,
                "kind": ANCHOR_KIND,
                "at": at,
                "data": {
                    "snapshot": snap_name,
                    "sha": sha,
                    "schema": SNAPSHOT_SCHEMA,
                    "fallback": fallback_name,
                    "folded": len(records),
                },
            }
        )
        try:
            # Step 1 — the snapshot, durable before anything references
            # it.
            self._publish_bytes(snap_bytes, self.path.parent / snap_name)
            # Step 2 — quarantine the FULL pre-compaction journal.  From
            # here on there is no instant without a complete readable
            # history on disk: if the snapshot later turns out torn,
            # replay falls back to this copy.
            self._publish_bytes(raw, self.path.parent / fallback_name)
            # Step 3 — the swap: one rename replaces the journal with a
            # single anchor record binding the snapshot by name + sha.
            self._publish_bytes(anchor_line, self.path)
        except (OSError, RuntimeError) as e:
            # Orphaned step-1/2 artifacts are GC'd by the next
            # successful compaction; the journal itself is unchanged.
            raise JournalError(
                f"compaction at seq {seq} failed "
                f"({type(e).__name__}: {e}); serving continues on the "
                f"uncompacted journal"
            ) from e
        self.snapshot = JournalSnapshot(
            seq=seq,
            at=at,
            schema=SNAPSHOT_SCHEMA,
            state=state if isinstance(state, dict) else dict(state),
            path=self.path.parent / snap_name,
        )
        self.next_seq = seq + 1
        self.compactions += 1
        self._base_refs = {snap_name}
        # Step 4 — GC, strictly after the successor is durable.  The
        # prior base chain stays: the fresh fallback copy's own record 0
        # still references it (single-failure tolerance); the NEXT
        # compaction retires whatever its replay no longer walks.
        keep = {snap_name, fallback_name} | base_refs
        removed: list[str] = []
        stale = sorted(
            self.path.parent.glob(f"{self.path.stem}.snapshot.*")
        ) + sorted(self.path.parent.glob(f"{self.path.name}.compacted.*"))
        for p in stale:
            if p.name in keep:
                continue
            try:
                self.store.unlink(p)
            except OSError:
                continue  # advisory — retried by the next compaction
            removed.append(p.name)
        return CompactionResult(
            seq=seq,
            snapshot_path=self.path.parent / snap_name,
            fallback_path=self.path.parent / fallback_name,
            folded_records=len(records),
            bytes_before=len(raw),
            bytes_after=len(anchor_line),
            removed=removed,
        )
