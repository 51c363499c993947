"""Crash-safe pool state: write-ahead journal + snapshot/compaction.

The paper's one-shot contract — every client transmits its sufficient
statistics ONCE — is only as strong as the server's memory. This module
makes the fused state durable without ever re-contacting a client:

  * :class:`Journal` — an append-only write-ahead log of admitted wire
    frames. The on-disk record format IS the ``fed.wire`` frame encoding
    (12-byte header + payload + CRC32 trailer): records are self-delimiting
    and self-validating, so the torn tail a crash leaves behind is detected
    by the same CRC that guards the network and cleanly truncated — a
    half-written record is never half-applied. Tenant binding (a session
    property the frames themselves do not carry) is journaled as interleaved
    ``Hello(tenant)`` marker frames whenever the bound tenant changes, making
    each segment a replayable session stream.
  * :class:`DurableStore` — the directory layout around the journal:
    numbered WAL segments (``wal_<seq>.log``) plus periodic snapshots of
    every tenant's fused ``(G, h)``, client ledger, feature-map identity,
    dropped set, dedup index, and wire counters, written through
    the port's ``checkpoint`` (``save_pytree``/``load_pytree``; arrays
    round-trip bitwise through npz, under the JAX package's key strings). A snapshot's JSON commit record is written
    tmp -> fsync -> rename, so the commit is atomic: recovery loads the
    latest COMMITTED snapshot and replays the journal from the per-tenant
    offsets it recorded — a crash mid-snapshot just falls back to the
    previous one plus a longer replay.

Consistency model (why replay is exact):

  Every tenant mutation is serialized under its tenant lock, and the journal
  append happens under that same lock BEFORE the mutation is applied
  (classic WAL ordering). A snapshot first switches the journal to a fresh
  segment, then captures tenants one lock at a time, recording for each the
  segment offset at capture — every frame a tenant applied before its
  capture is inside the snapshot, every frame after is in the new segment at
  an offset >= the recorded one. Replay therefore applies exactly the
  journaled frames the snapshot has not absorbed, in the tenant's original
  admission order, onto the snapshot's bitwise-exact arrays: a recovered
  pool's Phase-3 solve is bit-identical to a never-crashed one (both
  factorize cold from identical fused stats).

Process-crash vs power-loss guarantees:

  A *process crash* (SIGKILL, OOM, uncaught exception) loses only what the
  process had not yet handed to the OS — data in user-space buffers. Every
  write here goes through ``flush()`` before the caller proceeds, so all
  four cells below survive a process crash regardless of ``fsync``.
  *Power loss* (kernel panic, yanked cord) additionally loses whatever the
  OS had not yet hit the platter with — including metadata the filesystem
  only persists on a DIRECTORY fsync: a rename (``os.replace``) and a newly
  created file are not power-loss-durable until their parent directory is
  fsynced. The commit protocol therefore orders, per snapshot:

      npz data fsync  <  commit-record rename  <  snapshot-dir fsync
                                                       <  prune

  so a commit record that survives power loss always points at complete
  array data, and the WAL segments a snapshot supersedes are deleted only
  once the snapshot that replaces them is fully durable. New WAL segments
  fsync the store directory at creation for the same reason — a journaled
  frame is not durable if the segment holding it can vanish.

  ==============  =======================  ==============================
  ``fsync=``      process crash            power loss
  ==============  =======================  ==============================
  ``True``        nothing lost: every      nothing lost: appends, commit
                  ACKed frame + every      records, and the directory
                  committed snapshot       entries naming them are all
                  replay exactly           forced to stable storage
  ``False``       nothing lost (appends    ACKed frames since the last
                  are flushed to the OS    OS writeback may vanish; the
                  before the ACK)          snapshot commit protocol still
                                           fsyncs unconditionally, so
                                           recovery falls back to a
                                           CONSISTENT committed snapshot,
                                           never a torn one
  ==============  =======================  ==============================

The files are the JAX package's, byte for byte where the content is the
same: a WAL segment is the same frames, a snapshot the same npz keys and the
same commit record (dtype names are numpy's, ``"float32"``). So a journal
directory written by either package restores in the other.

``EnginePool(journal_dir=...)`` owns the orchestration; this module owns
bytes-on-disk. It imports only ``fed.wire`` and ``checkpoint``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import threading

import numpy as np

import torch

from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.fed import wire

SNAPSHOT_DIRNAME = "snapshots"
_WAL_RE = re.compile(r"wal_(\d{8})\.log$")
_COMMIT_RE = re.compile(r"commit_(\d{8})\.json$")


def wal_name(seq: int) -> str:
    return f"wal_{seq:08d}.log"


def fsync_dir(path: str | pathlib.Path) -> None:
    """Force a directory's entries (renames, new files) to stable storage.

    ``os.replace`` is atomic for *process* crashes, but the new name only
    survives *power loss* once the parent directory's metadata is synced.
    """
    fd = os.open(str(path), os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One replayable content frame: where it sits and what it binds to."""

    offset: int          # byte offset of the frame record in its segment
    tenant: str          # binding from the preceding Hello marker
    raw: bytes           # the exact admitted frame bytes
    frame: wire.Frame    # decoded once at scan time


@dataclasses.dataclass(frozen=True)
class ScanResult:
    """A segment's valid prefix.

    ``good_bytes`` is the offset after the last fully-valid record;
    ``torn`` is True when trailing bytes past it failed header/CRC/decode
    validation (the crash signature) — they are garbage to be truncated,
    never applied.
    """

    records: tuple[JournalRecord, ...]
    good_bytes: int
    torn: bool
    reason: str = ""


def scan_segment(path: str | pathlib.Path) -> ScanResult:
    """Walk one WAL segment, validating every record with the wire codec.

    Stops at the first record whose header, length, CRC, or payload fails
    validation — everything after a bad record is unreachable anyway
    (records are length-prefixed, so a single torn byte desynchronizes the
    stream exactly like a corrupt TCP header would).
    """
    data = pathlib.Path(path).read_bytes()
    records: list[JournalRecord] = []
    tenant = ""
    off = 0
    while off < len(data):
        if off + wire.HEADER_BYTES > len(data):
            return ScanResult(tuple(records), off, True,
                              f"truncated header at {off}")
        try:
            total = wire.frame_total_length(
                data[off:off + wire.HEADER_BYTES],
                max_payload_bytes=wire.MAX_REASSEMBLED_BYTES)
        except wire.WireError as e:
            return ScanResult(tuple(records), off, True,
                              f"bad header at {off}: {e}")
        if off + total > len(data):
            return ScanResult(tuple(records), off, True,
                              f"truncated record at {off} "
                              f"(needs {total} bytes)")
        raw = data[off:off + total]
        try:
            # Journal records are canonical (reassembled) frames, which may
            # legitimately exceed the per-wire-frame payload cap.
            frame = wire.decode_frame(
                raw, max_payload_bytes=wire.MAX_REASSEMBLED_BYTES)
        except wire.WireError as e:
            return ScanResult(tuple(records), off, True,
                              f"corrupt record at {off}: "
                              f"{type(e).__name__}: {e}")
        if isinstance(frame, wire.Hello):
            tenant = frame.tenant
        else:
            records.append(JournalRecord(off, tenant, raw, frame))
        off += total
    return ScanResult(tuple(records), off, False)


class Journal:
    """Append-only WAL of admitted wire frames (one open segment).

    Thread-safe: appends from many tenant threads interleave under one
    internal lock, and the tenant-marker + content-frame pair is written
    atomically with respect to other appends. ``fsync=True`` (the default)
    makes every append durable before the caller may ACK; ``fsync=False``
    trades the crash window down to OS-flush semantics for throughput.
    """

    def __init__(self, path: str | pathlib.Path, *, fsync: bool = True):
        self.path = pathlib.Path(path)
        self.fsync = fsync
        self._lock = threading.Lock()
        existed = self.path.exists()
        self._f = open(self.path, "ab")
        if self.fsync and not existed:
            # A newly created segment's directory entry must be durable
            # before any record in it can claim to be.
            fsync_dir(self.path.parent)
        self._size = self._f.tell()
        # Re-binding marker state. A reopened segment restarts from an
        # unknown binding, so the first append always writes a fresh marker.
        self._bound: str | None = None
        self.appends = 0
        self.markers = 0

    @property
    def size(self) -> int:
        with self._lock:
            return self._size

    def append(self, tenant: str, raw: bytes) -> int:
        """Durably append one admitted frame; returns its record offset.

        The WAL contract: when this returns, the bytes are on disk (or at
        least handed to the OS with ``fsync=False``) — only then may the
        caller apply the frame and ACK it.
        """
        with self._lock:
            if self._f.closed:
                raise RuntimeError("journal is closed")
            out = b""
            if tenant != self._bound:
                out += wire.encode_frame(wire.Hello(tenant=tenant))
            offset = self._size + len(out)
            out += raw
            self._f.write(out)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._size += len(out)
            if tenant != self._bound:
                self.markers += 1
                self._bound = tenant
            self.appends += 1
            return offset

    def switch(self, path: str | pathlib.Path) -> None:
        """Atomically (w.r.t. appends) start a fresh segment at ``path``."""
        with self._lock:
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._f.close()
            self.path = pathlib.Path(path)
            existed = self.path.exists()
            self._f = open(self.path, "ab")
            if self.fsync and not existed:
                fsync_dir(self.path.parent)
            self._size = self._f.tell()
            self._bound = None

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                if self.fsync:
                    os.fsync(self._f.fileno())
                self._f.close()

    @property
    def closed(self) -> bool:
        return self._f.closed


class DurableStore:
    """Directory layout + atomic commit protocol for one pool's state.

    ::

        <dir>/
          wal_00000000.log          # segment 0 (pre-first-snapshot frames)
          wal_<seq>.log             # segment opened by snapshot <seq>
          snapshots/
            step_<seq>.npz / .json  # checkpoint.save_pytree arrays
            commit_<seq>.json       # tenant metadata; the atomic commit mark

    A snapshot exists iff its commit record exists (written tmp -> fsync ->
    rename). Segments with seq < the latest committed snapshot are garbage
    and pruned best-effort; segments with seq >= it replay in order.
    """

    def __init__(self, directory: str | pathlib.Path, *, fsync: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.snapdir = self.dir / SNAPSHOT_DIRNAME
        self.snapdir.mkdir(exist_ok=True)
        self.fsync = fsync

    # -- discovery -----------------------------------------------------------

    def segment_seqs(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.dir.glob("wal_*.log")
                      if (m := _WAL_RE.match(p.name)))

    def committed_snapshot_seqs(self) -> list[int]:
        out = []
        for p in self.snapdir.glob("commit_*.json"):
            m = _COMMIT_RE.match(p.name)
            if m and (self.snapdir / f"step_{int(m.group(1)):08d}.npz").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_snapshot_seq(self) -> int | None:
        seqs = self.committed_snapshot_seqs()
        return seqs[-1] if seqs else None

    def next_seq(self) -> int:
        segs = self.segment_seqs()
        snaps = self.committed_snapshot_seqs()
        return max(segs + snaps, default=-1) + 1

    def segment_path(self, seq: int) -> pathlib.Path:
        return self.dir / wal_name(seq)

    # -- journal tail --------------------------------------------------------

    def open_journal(self) -> tuple[Journal, list[tuple[int, ScanResult]]]:
        """Open the live journal for appends, returning the replay plan.

        Scans every surviving segment (>= the latest committed snapshot, or
        all of them when no snapshot exists), truncates the LAST segment's
        torn tail in place (a crash can only tear the segment that was open),
        and reopens it for appending. Returns ``(journal, plan)`` where
        ``plan`` is ``[(segment_seq, scan_result), ...]`` in replay order.
        """
        base = self.latest_snapshot_seq()
        seqs = [s for s in self.segment_seqs()
                if base is None or s >= base]
        if not seqs:
            first = 0 if base is None else base
            path = self.segment_path(first)
            path.touch()
            if self.fsync:
                fsync_dir(self.dir)
            seqs = [first]
        plan: list[tuple[int, ScanResult]] = []
        for i, seq in enumerate(seqs):
            res = scan_segment(self.segment_path(seq))
            if res.torn and i == len(seqs) - 1:
                # The crash signature: truncate the garbage tail so the
                # reopened segment appends from the last valid record.
                with open(self.segment_path(seq), "r+b") as f:
                    f.truncate(res.good_bytes)
                    f.flush()
                    if self.fsync:
                        os.fsync(f.fileno())
            plan.append((seq, res))
        journal = Journal(self.segment_path(seqs[-1]), fsync=self.fsync)
        return journal, plan

    # -- snapshots -----------------------------------------------------------

    def commit_snapshot(self, seq: int, tree, meta: dict) -> pathlib.Path:
        """Write arrays + commit record; the rename IS the commit point.

        Ordering (power-loss contract; see module docstring): the npz data
        is fsynced inside ``save_pytree`` BEFORE the commit record is
        renamed into place, and the snapshot directory is fsynced AFTER the
        rename — only once this returns may the caller prune superseded
        segments. All three steps run regardless of ``self.fsync``: a torn
        commit is corruption, not merely lost recency.
        """
        save_pytree(tree, self.snapdir, step=seq)
        commit = self.snapdir / f"commit_{seq:08d}.json"
        tmp = commit.with_suffix(".json.tmp")
        payload = json.dumps(meta, sort_keys=True)
        with open(tmp, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, commit)
        fsync_dir(self.snapdir)
        return commit

    def load_snapshot(self, device="cuda") -> tuple[int, dict, dict] | None:
        """Latest committed snapshot as ``(seq, meta, tree)`` (None if none).

        The tree is restored through ``checkpoint.load_pytree`` against a
        template built from the commit record's shapes/dtypes, so arrays come
        back exactly as saved, as tensors on ``device``.
        """
        seq = self.latest_snapshot_seq()
        if seq is None:
            return None
        meta = json.loads(
            (self.snapdir / f"commit_{seq:08d}.json").read_text())
        template = _snapshot_template(meta)
        tree = load_pytree(template, self.snapdir, seq, device=device)
        return seq, meta, tree

    def prune(self, keep_seq: int) -> None:
        """Best-effort removal of segments/snapshots older than ``keep_seq``."""
        for seq in self.segment_seqs():
            if seq < keep_seq:
                _unlink_quiet(self.segment_path(seq))
        for p in list(self.snapdir.glob("step_*.npz")) \
                + list(self.snapdir.glob("step_*.json")) \
                + list(self.snapdir.glob("commit_*.json")):
            m = re.match(r"(?:step|commit)_(\d{8})\.(?:npz|json)$", p.name)
            if m and int(m.group(1)) < keep_seq:
                _unlink_quiet(p)
        # Tmp files are pre-commit garbage a crash left behind; prune runs
        # only after a durable commit, so any survivor is dead weight.
        for p in self.snapdir.glob("*.tmp"):
            _unlink_quiet(p)


def _unlink_quiet(path: pathlib.Path) -> None:
    try:
        path.unlink()
    except OSError:
        pass


# -- snapshot tree codec -----------------------------------------------------
#
# The npz tree keys tenants and ledger clients by INDEX ("t0", "c3", ...);
# the commit record carries the actual names/ids in the same order, with
# client ids type-tagged ("s"/"i" for str/int — the only id types the wire
# and launch paths produce). This keeps arbitrary tenant/client strings out
# of pytree key paths entirely.

def _tag_id(cid) -> list:
    if isinstance(cid, bool) or not isinstance(cid, (str, int)):
        raise ValueError(
            f"cannot persist client id {cid!r} of type {type(cid).__name__}: "
            f"journaled pools retain str/int client ids only")
    return ["s", cid] if isinstance(cid, str) else ["i", int(cid)]


def _untag_id(tagged):
    kind, val = tagged
    return str(val) if kind == "s" else int(val)


def dtype_name(dtype: torch.dtype) -> str:
    """The commit record's dtype string: numpy's name, as the JAX package
    writes it (``"float32"``, never ``"torch.float32"``)."""
    return str(dtype).removeprefix("torch.")


def stats_entry(gram, moment, count, yty=None) -> dict:
    """Snapshot codec for one SuffStats. ``yty`` (the residual second
    moment) is stored only when carried — a legacy entry omits the key, and
    the commit record's per-entry ``moments`` flags keep the load template
    in sync, so pre-moments snapshots restore unchanged. Tensors stay where
    they are until ``save_pytree`` moves them to the host."""
    out = {"gram": gram, "moment": moment,
           "count": np.asarray(int(count), np.int64)}
    if yty is not None:
        out["yty"] = yty
    return out


def _stats_template(dim: int, dtype: str, moments: bool = False) -> dict:
    """Shapes and dtypes only: tensors on the ``meta`` device hold no data."""
    dt = getattr(torch, dtype)

    def empty(*shape, dt=dt):
        return torch.empty(shape, dtype=dt, device="meta")

    out = {"gram": empty(dim, dim), "moment": empty(dim),
           "count": empty(dt=torch.int64)}
    if moments:
        out["yty"] = empty()
    return out


def _snapshot_template(meta: dict) -> dict:
    tree: dict = {}
    for ti, t in enumerate(meta["tenants"]):
        dim, dtype = t["dim"], t["dtype"]
        # Pre-moments commit records have no "moments" key: every entry is
        # moments-less and the template reduces to the legacy layout.
        mom = t.get("moments") or {}
        mc, md = mom.get("clients", []), mom.get("dropped", [])
        entry = {"fused": _stats_template(dim, dtype,
                                          mom.get("fused", False)),
                 "clients": {f"c{i}": _stats_template(
                     dim, dtype, mc[i] if i < len(mc) else False)
                     for i in range(len(t["clients"]))},
                 "dropped": {f"d{i}": _stats_template(
                     dim, dtype, md[i] if i < len(md) else False)
                     for i in range(len(t["dropped"]))}}
        tree[f"t{ti}"] = entry
    return tree
