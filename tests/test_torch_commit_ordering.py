"""Power-loss ordering of the port's snapshot commit protocol.

The reference's ``tests/test_commit_ordering.py``, held against the port's
``server.durability`` and ``checkpoint``. A process crash (SIGKILL) loses
only user-space buffers, which the flush before every ACK covers
(``tests/test_torch_durability.py``). POWER LOSS also loses what the OS had
not written back, including the *directory entries* a rename or a new file
made. A commit protocol survives it only if it orders its barriers:

    npz data fsync  <  commit-record rename  <  snapshot-dir fsync  <  prune

Two ways of pinning it:

  * **Op-sequence recorder** — ``os.fsync`` (fd resolved to a path through
    ``/proc/self/fd``), ``os.replace`` and ``durability._unlink_quiet`` are
    monkeypatched to record one global sequence while a journaled pool
    snapshots; the barriers above must appear in order, the npz bytes
    fsynced under their tmp name before any rename, and a new WAL segment
    followed by an fsync of the store directory.
  * **Simulated power loss** — from the same record plus deferred
    deletions, an adversarial post-power-loss image of the directory is
    built: content not fsynced by the barrier is torn to a prefix, renames
    with no later fsync of their directory are undone, recorded deletions
    persist. Recovery from the image must reach a consistent state: the
    same weights bitwise when the barrier covers the commit, and a fall
    back to the previous snapshot plus WAL replay (the same final weights)
    when the power failed between the commit rename and the directory
    fsync.
"""
import os
import pathlib
import shutil

import numpy as np
import pytest

import torch

from repro_torch.core.sufficient_stats import compute_stats
from repro_torch.fed import wire
from repro_torch.server import EnginePool, durability
from repro_torch.server.durability import DurableStore

SIGMA = 0.1


def _int_rows(rng, n, d):
    A = rng.integers(-3, 4, (n, d)).astype(np.float32)
    b = rng.integers(-3, 4, (n,)).astype(np.float32)
    return torch.from_numpy(A), torch.from_numpy(b)


def _pool(journal_dir=None, **kw):
    return EnginePool(device="cpu", journal_dir=journal_dir, **kw)


def _stats_raw(A, b, client_id):
    frame = wire.StatsFrame.from_stats(compute_stats(A, b),
                                       client_id=client_id)
    return wire.encode_frame(frame, dtype="f32")


def _admit_raw(pool, tenant, raw):
    return pool.admit_frame(tenant, wire.decode_frame(raw),
                            encoded_len=len(raw), placement="dense",
                            raw=raw)


def _crash(pool):
    if pool._journal is not None:
        pool._journal.close()
    pool._closed = True
    pool.stop_flusher()


def _w(pool, name, sigma=SIGMA):
    return pool.solve_lifted(name, sigma).numpy()


class OpRecorder:
    """One global sequence of durability-relevant filesystem operations.

    Ops are ``("fsync", path)`` — a file OR directory fsync, fd resolved
    through ``/proc/self/fd`` so the path is known even for directory
    handles — ``("replace", src, dst)`` and ``("unlink", path)``.
    Deletions are recorded but DEFERRED (the file stays on disk) so the
    power-loss simulator can choose whether the metadata writeback
    happened; real behavior is unchanged for everything else.
    """

    def __init__(self, monkeypatch):
        self.ops: list[tuple] = []
        real_fsync, real_replace = os.fsync, os.replace

        def rec_fsync(fd):
            try:
                path = os.readlink(f"/proc/self/fd/{fd}")
            except OSError:              # pragma: no cover - non-procfs host
                path = ""
            real_fsync(fd)
            self.ops.append(("fsync", path))

        def rec_replace(src, dst):
            real_replace(src, dst)
            self.ops.append(("replace", str(src), str(dst)))

        def rec_unlink(path):
            self.ops.append(("unlink", str(path)))    # deferred

        monkeypatch.setattr(os, "fsync", rec_fsync)
        monkeypatch.setattr(os, "replace", rec_replace)
        monkeypatch.setattr(durability, "_unlink_quiet", rec_unlink)

    # -- queries over the sequence -------------------------------------------

    def index(self, kind, predicate, start=0):
        for i, op in enumerate(self.ops[start:], start):
            if op[0] == kind and predicate(op):
                return i
        raise AssertionError(
            f"no {kind!r} op matching predicate after index {start} in:\n"
            + "\n".join(map(str, self.ops)))


def _reconstruct(live_root: pathlib.Path, out_root: pathlib.Path,
                 ops: list[tuple], barrier: int) -> None:
    """Adversarial post-power-loss image of ``live_root`` after ``ops[:barrier]``.

    Worst-case-but-legal filesystem semantics: content survives only if
    fsynced; a rename's directory entry survives only if the parent
    directory was fsynced after it (otherwise the old name is back);
    recorded deletions persist (metadata may be written back any time).
    """
    shutil.copytree(live_root, out_root)

    def tr(p):      # live path -> image path
        return out_root / pathlib.Path(p).relative_to(live_root)

    synced: set[str] = set()
    renames: list[tuple[int, str, str]] = []
    for i, op in enumerate(ops[:barrier]):
        if op[0] == "fsync":
            synced.add(op[1])
        elif op[0] == "replace":
            # fsynced content keeps its durability across a rename.
            if op[1] in synced:
                synced.add(op[2])
            renames.append((i, op[1], op[2]))
        elif op[0] == "unlink":
            tgt = tr(op[1])
            if tgt.exists():
                tgt.unlink()

    # Undo renames whose directory entry never became durable (no parent
    # fsync between the rename and the barrier), newest first.
    for i, src, dst in reversed(renames):
        parent = str(pathlib.Path(dst).parent)
        covered = any(o[0] == "fsync" and o[1] == parent
                      for o in ops[i + 1:barrier])
        if not covered and tr(dst).exists():
            os.rename(tr(dst), tr(src))

    # Tear every file whose surviving content was never fsynced.
    for path in sorted(out_root.rglob("*")):
        if not path.is_file():
            continue
        live_name = str(live_root / path.relative_to(out_root))
        if live_name not in synced and path.stat().st_size:
            with open(path, "r+b") as f:
                f.truncate(path.stat().st_size // 2)


def _run_pool(journal_dir, *, uploads=6, snapshot_every=None, seed=0):
    """Ingest ``uploads`` dense frames, snapshot, return (pool, raws)."""
    rng = np.random.default_rng(seed)
    raws = [_stats_raw(*_int_rows(rng, 8, 5), f"c{i}") for i in range(uploads)]
    pool = _pool(str(journal_dir), snapshot_every=snapshot_every)
    for raw in raws:
        _admit_raw(pool, "t", raw)
    return pool, raws


# -- op-sequence ordering pins ------------------------------------------------

class TestCommitOrdering:
    def test_snapshot_barrier_order(self, tmp_path, monkeypatch):
        """The four-step pin: npz fsync (under the tmp name, BEFORE any
        rename exposes the final name) < commit rename < snapshot-dir
        fsync < prune. Fails on a protocol that writes the npz straight
        to its final name with no fsync and never fsyncs the directory."""
        pool, _ = _run_pool(tmp_path / "j")
        rec = OpRecorder(monkeypatch)
        seq = pool.snapshot()
        _crash(pool)
        assert seq is not None

        snapdir = str(tmp_path / "j" / "snapshots")
        npz_tmp = f"step_{seq:08d}.npz.tmp"
        commit = f"commit_{seq:08d}.json"

        i_npz_fsync = rec.index(
            "fsync", lambda op: op[1].endswith(npz_tmp))
        i_npz_rename = rec.index(
            "replace", lambda op: op[2].endswith(f"step_{seq:08d}.npz"))
        i_commit_rename = rec.index(
            "replace", lambda op: op[2].endswith(commit))
        i_dir_fsync = rec.index(
            "fsync", lambda op: op[1] == snapdir, start=i_commit_rename)
        i_prune = rec.index(
            "unlink", lambda op: True)

        assert i_npz_fsync < i_npz_rename < i_commit_rename \
            < i_dir_fsync < i_prune, rec.ops

    def test_commit_record_content_fsynced_before_rename(
            self, tmp_path, monkeypatch):
        """A commit record whose *content* is torn is worse than a missing
        one (it names a snapshot that cannot load); its bytes must be
        durable under the tmp name before the rename publishes them."""
        pool, _ = _run_pool(tmp_path / "j", seed=1)
        rec = OpRecorder(monkeypatch)
        seq = pool.snapshot()
        _crash(pool)
        i_tmp_fsync = rec.index(
            "fsync", lambda op: op[1].endswith(f"commit_{seq:08d}.json.tmp"))
        i_rename = rec.index(
            "replace", lambda op: op[2].endswith(f"commit_{seq:08d}.json"))
        assert i_tmp_fsync < i_rename

    def test_new_wal_segment_fsyncs_store_dir(self, tmp_path, monkeypatch):
        """A journaled frame is not durable if the segment file holding it
        can vanish: creating wal_<seq>.log must fsync the store directory
        (both at pool construction and at the snapshot's segment switch)."""
        rec = OpRecorder(monkeypatch)
        store_dir = str(tmp_path / "j")
        pool, _ = _run_pool(store_dir, uploads=2)
        rec.index("fsync", lambda op: op[1] == store_dir)

        n_before = len(rec.ops)
        seq = pool.snapshot()       # switches the journal to wal_<seq>.log
        _crash(pool)
        rec.index("fsync", lambda op: op[1] == store_dir, start=n_before)
        assert (tmp_path / "j" / f"wal_{seq:08d}.log").exists()

    def test_prune_only_after_commit_durable(self, tmp_path, monkeypatch):
        """Two snapshots: the second's prune (which deletes the first
        snapshot and its WAL segments) must sit after the second commit's
        directory fsync — otherwise power loss can leave NO usable
        snapshot at all (the old one deleted, the new one un-named)."""
        pool, raws = _run_pool(tmp_path / "j", seed=2)
        pool.snapshot()
        rec = OpRecorder(monkeypatch)
        for raw in raws[:2]:        # re-admitted frames dedup, but journal
            _admit_raw(pool, "t", raw)     # activity keeps the WAL moving
        seq2 = pool.snapshot()
        _crash(pool)

        i_dir_fsync = rec.index(
            "fsync",
            lambda op: op[1] == str(tmp_path / "j" / "snapshots"),
            start=rec.index("replace",
                            lambda op: op[2].endswith(f"commit_{seq2:08d}.json")))
        first_unlink = rec.index("unlink", lambda op: True)
        assert i_dir_fsync < first_unlink, rec.ops


# -- simulated power loss ------------------------------------------------------

class TestPowerLoss:
    def _reference(self, raws):
        ref = _pool()
        for raw in raws:
            _admit_raw(ref, "t", raw)
        return _w(ref, "t")

    def test_loss_after_full_commit_recovers_bit_identical(
            self, tmp_path, monkeypatch):
        """Barrier = end of the run: every barrier the protocol issued has
        executed. The adversarial image must recover to weights
        bit-identical to a never-crashed pool. Without the npz fsync the
        image would hold a torn npz under a live commit record, and
        recovery would die loading it."""
        live = tmp_path / "live"
        rec = OpRecorder(monkeypatch)
        pool, raws = _run_pool(live, seed=3)
        pool.snapshot()
        _crash(pool)

        img = tmp_path / "img"
        _reconstruct(live, img, rec.ops, barrier=len(rec.ops))
        monkeypatch.undo()          # recovery runs on real filesystem ops

        recovered = _pool(str(img))
        got = _w(recovered, "t")
        _crash(recovered)
        assert got.tobytes() == self._reference(raws).tobytes()

    def test_loss_between_rename_and_dirfsync_falls_back(
            self, tmp_path, monkeypatch):
        """Barrier = just after the commit rename but BEFORE the snapshot
        directory fsync: the adversary undoes the un-fsynced rename, so
        the new snapshot never happened. Recovery must fall back to the
        journal (plus any earlier snapshot) and still produce the same
        final weights — the WAL holds every admitted frame."""
        live = tmp_path / "live"
        rec = OpRecorder(monkeypatch)
        pool, raws = _run_pool(live, seed=4)
        seq = pool.snapshot()
        _crash(pool)

        barrier = rec.index(
            "replace", lambda op: op[2].endswith(f"commit_{seq:08d}.json")) + 1
        img = tmp_path / "img"
        _reconstruct(live, img, rec.ops, barrier=barrier)
        monkeypatch.undo()

        # The commit rename was undone: seq is NOT a committed snapshot.
        assert seq not in DurableStore(img).committed_snapshot_seqs()
        recovered = _pool(str(img))
        got = _w(recovered, "t")
        assert recovered.tenant("t").wire_frames == len(raws)   # full replay
        _crash(recovered)
        assert got.tobytes() == self._reference(raws).tobytes()

    def test_loss_mid_second_commit_keeps_first_snapshot(
            self, tmp_path, monkeypatch):
        """Power loss between the second snapshot's commit rename and its
        directory fsync: prune has not run (it is ordered after the
        fsync), so the FIRST snapshot plus its WAL tail must still
        recover the full state. Had prune run straight after the rename,
        the adversarial image would have applied the deletions and lost
        both snapshots at once."""
        live = tmp_path / "live"
        rec = OpRecorder(monkeypatch)
        rng = np.random.default_rng(5)
        raws = [_stats_raw(*_int_rows(rng, 8, 5), f"c{i}") for i in range(8)]
        pool = _pool(str(live))
        for raw in raws[:4]:
            _admit_raw(pool, "t", raw)
        seq1 = pool.snapshot()
        for raw in raws[4:]:
            _admit_raw(pool, "t", raw)
        seq2 = pool.snapshot()
        _crash(pool)

        barrier = rec.index(
            "replace", lambda op: op[2].endswith(f"commit_{seq2:08d}.json")) + 1
        img = tmp_path / "img"
        _reconstruct(live, img, rec.ops, barrier=barrier)
        monkeypatch.undo()

        store = DurableStore(img)
        assert store.committed_snapshot_seqs() == [seq1]
        recovered = _pool(str(img))
        got = _w(recovered, "t")
        _crash(recovered)
        assert got.tobytes() == self._reference(raws).tobytes()


# -- the hazard the ordering prevents is real -----------------------------------

class TestUnorderedHazard:
    def test_torn_npz_under_live_commit_is_fatal(self, tmp_path):
        """What the op-sequence pins prevent: the exact on-disk state the
        unordered protocol could leave after power loss (commit record
        present, npz content torn) makes the snapshot unloadable. With
        the ordering this state is unreachable — npz fsync precedes the
        commit rename — so recovery never faces it."""
        pool, _ = _run_pool(tmp_path / "j", seed=6)
        seq = pool.snapshot()
        _crash(pool)
        npz = tmp_path / "j" / "snapshots" / f"step_{seq:08d}.npz"
        with open(npz, "r+b") as f:
            f.truncate(npz.stat().st_size // 2)
        with pytest.raises(Exception):
            DurableStore(tmp_path / "j").load_snapshot()
