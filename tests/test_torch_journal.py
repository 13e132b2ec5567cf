"""The port's request journal (``evox_tpu_torch/service/journal.py``)
against the JAX package's (``evox_tpu/service/journal.py``), on the CPU.

The wire format is the same bytes: a canonical body and its sha256.  With
the wall clock pinned the two packages write the same file for the same
appends; otherwise the records differ only in ``at``.  Each package
replays the other's files — a torn or bit-flipped tail is healed and
quarantined alike, and a compacted journal (snapshot + anchor) folds alike,
its fallbacks included."""

import json

import pytest

from evox_tpu.resilience import FaultyStore as JFaultyStore  # noqa: E402
from evox_tpu.service import journal as jjournal  # noqa: E402

from evox_tpu_torch.obs import MetricsRegistry  # noqa: E402
from evox_tpu_torch.resilience import FaultyStore  # noqa: E402
from evox_tpu_torch.service import journal as tjournal  # noqa: E402

MODULES = {"jax": jjournal, "torch": tjournal}
RECORDS = [
    ("submit", {"uid": 1, "tenant_id": "a", "spec": {"pop": 16, "lb": [-1.5, 2.0]}}),
    ("decision", {"decision": {"schema": 1, "seq": 0, "kind": "trend", "generation": 8, "action": "stagnation",
                               "policy": "trend", "evidence": {"span": 10.0, "best_slope": None}, "tenant_id": None}}),
    ("complete", {"uid": 1, "unicode": "é—✓", "nested": {"b": [1, 2, {"z": None}], "a": True}}),
    ("evict", {"uid": 2, "reason": "storm", "at_gen": 12}),
]


def _write(mod, path, records=RECORDS, monkeypatch=None, at=1_700_000_000.25, **kw):
    if monkeypatch is not None:
        monkeypatch.setattr(mod.time, "time", lambda: at)
    journal = mod.RequestJournal(path, **kw)
    seqs = [journal.append(kind, **data) for kind, data in records]
    journal.close()
    return seqs


def _records(records):
    return [(r.seq, r.kind, r.at, r.data) for r in records]


def _fold(base, records):
    state = dict(base or {})
    for r in records:
        state[str(r.seq)] = [r.kind, r.data]
    return state


def test_same_appends_write_the_same_bytes(tmp_path, monkeypatch):
    """With ``time.time`` pinned in both modules the files are equal byte
    for byte; unpinned, the records differ only in ``at``."""
    assert _write(jjournal, tmp_path / "j.jsonl", monkeypatch=monkeypatch) == [0, 1, 2, 3]
    assert _write(tjournal, tmp_path / "t.jsonl", monkeypatch=monkeypatch) == [0, 1, 2, 3]
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    monkeypatch.undo()
    _write(jjournal, tmp_path / "j2.jsonl")
    _write(tjournal, tmp_path / "t2.jsonl")

    def bodies(p):
        out = []
        for line in p.read_text().splitlines():
            body = json.loads(line)["body"]
            body.pop("at")
            out.append(body)
        return out

    assert bodies(tmp_path / "t2.jsonl") == bodies(tmp_path / "j2.jsonl")


@pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax")])
def test_each_package_replays_the_others_journal(tmp_path, writer, reader):
    path = tmp_path / "journal.jsonl"
    _write(MODULES[writer], path)
    theirs, damage = MODULES[writer].RequestJournal(path).replay()
    mine, my_damage = MODULES[reader].RequestJournal(path).replay()
    assert damage is None and my_damage is None
    assert _records(mine) == _records(theirs)
    assert [(r.kind, r.data) for r in mine] == [(k, d) for k, d in RECORDS]
    # The reader appends on, and the writer replays the longer journal.
    j = MODULES[reader].RequestJournal(path)
    j.replay()
    assert j.append("retire", uid=9) == len(RECORDS)
    j.close()
    again, damage = MODULES[writer].RequestJournal(path).replay()
    assert damage is None and [r.kind for r in again][-1] == "retire"


def _damage(path, how):
    raw = path.read_bytes()
    if how == "torn":  # a torn append: the last record without its end
        path.write_bytes(raw[:-17])
    elif how == "bitflip":  # a bit flip inside the third record
        lines = raw.split(b"\n")
        pos = sum(len(x) + 1 for x in lines[:2]) + len(lines[2]) // 2
        b = bytearray(raw)
        b[pos] ^= 0x04
        path.write_bytes(bytes(b))
    elif how == "garbage":  # post-crash garbage after the records
        path.write_bytes(raw + b'{"body": {"seq": 99}, "sha": "00"}\n\x00\x01')
    elif how == "reorder":  # two records swapped
        lines = raw.split(b"\n")
        lines[1], lines[2] = lines[2], lines[1]
        path.write_bytes(b"\n".join(lines))


@pytest.mark.parametrize("how", ["torn", "bitflip", "garbage", "reorder"])
def test_a_damaged_tail_is_healed_and_quarantined_alike(tmp_path, how):
    _write(jjournal, tmp_path / "pristine.jsonl")
    out = {}
    for name, mod in MODULES.items():
        d = tmp_path / name
        d.mkdir()
        (d / "journal.jsonl").write_bytes((tmp_path / "pristine.jsonl").read_bytes())
        _damage(d / "journal.jsonl", how)
        j = mod.RequestJournal(d / "journal.jsonl")
        records, damage = j.replay()
        seq = j.append("after-heal", ok=True)
        j.close()
        out[name] = (
            _records(records), damage.offset, damage.reason, damage.bytes_quarantined, damage.truncated,
            damage.quarantine_path.name, damage.quarantine_path.read_bytes(), seq,
            [r.kind for r in mod.RequestJournal(d / "journal.jsonl").replay()[0]],
        )
    assert out["torch"] == out["jax"]
    assert out["torch"][4] is True and out["torch"][5] == "journal.jsonl.corrupt"


@pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax"), ("torch", "torch")])
def test_compaction_and_snapshots_fold_alike(tmp_path, writer, reader):
    path = tmp_path / "journal.jsonl"
    _write(MODULES[writer], path)
    result = MODULES[writer].RequestJournal(path).compact(_fold)
    assert result.folded_records == len(RECORDS) and result.seq == len(RECORDS)
    assert result.snapshot_path.name == "journal.snapshot.00000004"
    assert result.fallback_path.name == "journal.jsonl.compacted.00000004"
    assert result.bytes_after < result.bytes_before
    # The suffix after a compaction, then a second compaction on top.
    j = MODULES[writer].RequestJournal(path)
    j.replay()
    j.append("submit", uid=5)
    j.close()
    mine = MODULES[reader].RequestJournal(path)
    records, damage = mine.replay()
    assert damage is None and [r.kind for r in records] == ["submit"]
    assert mine.snapshot_seq == 4 and mine.snapshot_state == _fold(None, MODULES[writer].RequestJournal(
        tmp_path / "journal.jsonl.compacted.00000004").replay()[0])
    assert mine.records_since_snapshot == 1
    second = mine.compact(_fold)
    assert second.seq == 6 and second.folded_records == 1
    theirs = MODULES[writer].RequestJournal(path)
    assert theirs.replay() == ([], None) and theirs.snapshot_seq == 6
    assert set(theirs.snapshot_state) == {"0", "1", "2", "3", "5"}
    # A bit-flipped snapshot falls back loudly to the quarantined full copy.
    snap = tmp_path / "journal.snapshot.00000006"
    snap.write_bytes(snap.read_bytes().replace(b'"submit"', b'"sUbmit"'))
    with pytest.warns(RuntimeWarning, match="unusable"):
        fallen, damage = MODULES[reader].RequestJournal(path).replay()
    assert damage is None and [r.seq for r in fallen] == [5]


def test_failed_appends_are_unacknowledged_and_healed(tmp_path):
    reg = MetricsRegistry()
    store = FaultyStore(enospc_saves=[1])
    j = tjournal.RequestJournal(tmp_path / "j.jsonl", store=store, registry=reg)
    assert j.append("submit", uid=0) == 0
    with pytest.raises(tjournal.JournalError, match="unacknowledged"):
        j.append("submit", uid=1)
    assert j.append("submit", uid=2) == 1 and j.append_failures == 1
    j.close()
    records, damage = tjournal.RequestJournal(tmp_path / "j.jsonl").replay()
    assert damage is None and [r.data["uid"] for r in records] == [0, 2]
    snap = reg.snapshot()
    assert snap["evox_journal_append_seconds_count"] == 2.0
    assert snap["evox_journal_fsync_seconds_count"] == 2.0
    assert snap['evox_journal_records_total{kind="submit"}'] == 2.0
    # The JAX package's store through the same journal sequence.
    jj = jjournal.RequestJournal(tmp_path / "jj.jsonl", store=JFaultyStore(enospc_saves=[1]))
    jj.append("submit", uid=0)
    with pytest.raises(jjournal.JournalError):
        jj.append("submit", uid=1)
    jj.append("submit", uid=2)
    jj.close()
    assert [r.data for r in tjournal.RequestJournal(tmp_path / "jj.jsonl").replay()[0]] == [r.data for r in records]


def test_empty_and_refusals(tmp_path):
    j = tjournal.RequestJournal(tmp_path / "none.jsonl")
    assert j.replay() == ([], None) and j.next_seq == 0 and j.size_bytes == 0
    with pytest.raises(tjournal.JournalError, match="nothing to compact"):
        j.compact(_fold)
    assert tjournal.SNAPSHOT_SCHEMA == jjournal.SNAPSHOT_SCHEMA and tjournal.ANCHOR_KIND == jjournal.ANCHOR_KIND
    assert set(tjournal.__all__) == set(jjournal.__all__)
