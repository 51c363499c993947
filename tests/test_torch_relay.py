"""The port's relay tier (``repro_torch.server.relay``) against the JAX
package's, on the CPU.

Mirrors tests/test_relay.py in process (its subprocess test is in
tests/test_torch_serve_relay.py):

  * Units — ``ForwardPolicy`` triggers, ``wire.relay_client_id`` identity,
    the per-tier pool ledger.
  * Loopback two-tier — 2 relays x 3 clients across dense + sketched + rff
    tenants; telescoping deltas across forward epochs; empty-delta skips;
    the poller's size policy.
  * Crash/resume — a forwarder that dies between its durable pending commit
    and the upstream ACK resumes with the persisted bytes; a re-send whose
    original landed dedups; a warm standby forwards only the remainder.
  * The poller survives its errors, counts them and logs each kind once.
  * Two-tier chaos — ``ChaosProxy`` on both legs, the root still bitwise.

Bitwise references respect float addition's non-associativity, as the
reference's do: dense tenants use small-integer rows, whose statistics are
exact in float32, and are held to a single-tier port pool fed every
client's frame (two-tier == single-tier); feature tenants fold the
reference with the tree's association (per relay in admission order, then
across relays) and ingest it into a single-tier pool. The port's solve is
not ``core.fusion.solve_ridge``'s bits (its float32 solves are refined once
in float64), so every reference solves through a port pool.

Then across packages, where the two meet:

  * a JAX relay forwards into a port root and a port relay into a JAX root
    over TCP: the forwarded frames are equal byte for byte, epoch after
    epoch, and the roots' fused ``(G, h)`` are bitwise equal;
  * the two forwarders' state records are byte-identical member by member
    (file names, npz keys, dtypes and array bytes; the zip's timestamps
    are the clock's);
  * a port forwarder resumes a JAX relay's journal and state directory with
    a pending record, and the reverse: the re-sent bytes are the persisted
    ones and nothing is forwarded twice;
  * a chunked forward (``max_chunk_payload``) reassembles at a port and at
    a JAX root, and the unchunked re-send of the same epoch dedups there.
"""
import io
import shutil
import time
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.features import FeatureMap as JFeatureMap
from repro.fed import transport as jtransport
from repro.server import EnginePool as JEnginePool
from repro.server import relay as jrelay
from repro_torch.core.features import FeatureMap
from repro_torch.core.sufficient_stats import compute_stats
from repro_torch.fed import chaos, transport, wire
from repro_torch.fed.protocol import PackedStats
from repro_torch.server import EnginePool
from repro_torch.server.relay import ForwardPolicy, RelayForwarder

SIGMA = 0.37
D = 6


def _pool(**kw):
    return EnginePool(device="cpu", **kw)


def _int_rows(rng, n=8, d=D):
    A = rng.integers(-3, 4, (n, d)).astype(np.float32)
    b = rng.integers(-3, 4, (n,)).astype(np.float32)
    return A, b


def _stats(A, b):
    return compute_stats(torch.from_numpy(A), torch.from_numpy(b))


def _w(pool, name, sigma=SIGMA):
    return pool.solve_lifted(name, sigma).numpy()


def _w_native(pool, name, sigma=SIGMA):
    """Weights in the tenant's own (feature) space."""
    return pool.solve(name, sigma).numpy()


def _fold(stats_list):
    """Fold-left — the association the relay's admission order produces."""
    acc = stats_list[0]
    for s in stats_list[1:]:
        acc = acc + s
    return acc


def _feature_stats(fm, A, b):
    """What a relay fuses from one client: its packed statistics, unpacked
    (the triangle mirrored)."""
    return PackedStats.pack(fm.stats(torch.from_numpy(A),
                                     torch.from_numpy(b))).unpack()


def _dense_frame(A, b, client_id, moments=False):
    return wire.encode_frame(wire.StatsFrame.from_stats(
        _stats(A, b), client_id=client_id, moments=moments))


def _feature_frame(fm, A, b, client_id):
    p = PackedStats.pack(fm.stats(torch.from_numpy(A), torch.from_numpy(b)))
    common = dict(tri=wire.host_array(p.tri), moment=wire.host_array(p.moment),
                  count=int(p.count), dim=int(p.dim), d_orig=fm.d_orig,
                  seed=fm.seed, client_id=client_id)
    if fm.kind == "sketch":
        return wire.encode_frame(wire.ProjectedFrame(rhash=fm.fhash, **common))
    return wire.encode_frame(wire.RFFFrame(fhash=fm.fhash,
                                           lengthscale=fm.lengthscale,
                                           **common))


def _send_raw(channel, tenant, raw, mod=transport):
    cl = mod.FrameClient(channel)
    cl.hello(tenant)
    ack = cl.upload_raw(raw)
    cl.close()
    assert ack.ok, ack


def _upload_dense(channel, tenant, A, b, client_id):
    _send_raw(channel, tenant, _dense_frame(A, b, client_id))


def _upload_feature(channel, tenant, fm, A, b, client_id):
    _send_raw(channel, tenant, _feature_frame(fm, A, b, client_id))


def _relay(pool, root_disp, relay_id, state_dir, **kw):
    kw.setdefault("policy", ForwardPolicy(max_frames=None))
    return RelayForwarder(pool, lambda: transport.LoopbackChannel(root_disp),
                          relay_id=relay_id, state_dir=state_dir, **kw)


def _crash(pool):
    """SIGKILL-equivalent: the journal's fd gone, no graceful close."""
    if pool._journal is not None:
        pool._journal.close()
    pool._closed = True
    pool.stop_flusher()


def _dense_single_tier(rows, tenant="t"):
    """The single-tier reference: one pool fed every client's frame."""
    ref = _pool()
    disp = transport.WireDispatcher(ref)
    for c, (A, b) in enumerate(rows):
        _upload_dense(transport.LoopbackChannel(disp), tenant, A, b, f"c{c}")
    w = _w(ref, tenant)
    ref.close()
    return w


def _feature_reference(fm, name, stats):
    ref = _pool()
    ref.create_tenant(name, dim=fm.m, features=fm, placement="dense")
    ref.ingest(name, stats, client_id="tree")
    w = _w_native(ref, name)
    ref.close()
    return w


# -- units ---------------------------------------------------------------------

class TestForwardPolicy:
    def test_size_trigger(self):
        p = ForwardPolicy(max_frames=3, max_staleness_s=None)
        assert not p.due(0, 1e9)
        assert not p.due(2, 1e9)       # staleness disabled
        assert p.due(3, 0.0)

    def test_staleness_trigger(self):
        p = ForwardPolicy(max_frames=None, max_staleness_s=0.5)
        assert not p.due(1, 0.4)
        assert p.due(1, 0.5)
        assert not p.due(0, 1e9)       # nothing pending: never due

    def test_both_disabled_only_forward_all(self):
        p = ForwardPolicy(max_frames=None, max_staleness_s=None)
        assert not p.due(10_000, 1e9)

    @pytest.mark.parametrize("frames,age", [(0, 0.0), (1, 0.2), (3, 0.2),
                                            (2, 0.5), (5, 9.0)])
    def test_same_answer_as_reference(self, frames, age):
        for kw in ({}, {"max_frames": 3, "max_staleness_s": 0.5},
                   {"max_frames": None, "max_staleness_s": 0.2}):
            assert (ForwardPolicy(**kw).due(frames, age)
                    == jrelay.ForwardPolicy(**kw).due(frames, age))


class TestRelayIdentity:
    def test_format_and_predicate(self):
        cid = wire.relay_client_id("east-1", 7)
        assert cid == "relay:east-1#00000007"
        assert wire.is_relay_client(cid)
        assert not wire.is_relay_client("client0")
        assert not wire.is_relay_client(3)

    def test_epochs_distinct_ids(self):
        assert wire.relay_client_id("r", 0) != wire.relay_client_id("r", 1)

    def test_bad_relay_id_rejected(self):
        with pytest.raises(wire.PayloadError):
            wire.relay_client_id("", 0)
        with pytest.raises(wire.PayloadError):
            wire.relay_client_id("a#b", 0)

    def test_validated_at_construction(self, tmp_path):
        with _pool() as pool:
            with pytest.raises(wire.PayloadError):
                RelayForwarder(pool, lambda: None, relay_id="",
                               state_dir=tmp_path)

    def test_state_path_is_the_reference_name(self, tmp_path):
        with _pool() as pool:
            fwd = RelayForwarder(pool, lambda: None, relay_id="r",
                                 state_dir=tmp_path / "p")
            jfwd = jrelay.RelayForwarder(JEnginePool(), lambda: None,
                                         relay_id="r",
                                         state_dir=tmp_path / "j")
            for tenant in ("t", "ridge", "ünïcode tenant", "a" * 300):
                assert (fwd._state_path(tenant).name
                        == jfwd._state_path(tenant).name)


class TestPerTierLedger:
    def test_relay_frames_counted_and_persisted(self, tmp_path):
        rng = np.random.default_rng(0)
        pool = _pool(journal_dir=str(tmp_path / "j"), tier="root")
        disp = transport.WireDispatcher(pool)
        _upload_dense(transport.LoopbackChannel(disp), "t",
                      *_int_rows(rng), client_id="plain")
        _upload_dense(transport.LoopbackChannel(disp), "t", *_int_rows(rng),
                      client_id=wire.relay_client_id("r0", 0))
        led = pool.ledger()
        assert led["tier"] == "root"
        assert led["by_tier"] == {"relay_frames": 1, "client_frames": 1}
        assert led["per_tenant"]["t"]["relay_frames"] == 1

        pool.snapshot()
        pool.close()
        restored = _pool(journal_dir=str(tmp_path / "j"))
        assert restored.ledger()["by_tier"]["relay_frames"] == 1
        restored.close()

    def test_default_tier_is_root(self):
        with _pool() as pool:
            assert pool.ledger()["tier"] == "root"
        with _pool(tier="relay") as pool:
            assert pool.ledger()["tier"] == "relay"


# -- loopback two-tier ---------------------------------------------------------

def _build_two_tier(tmp_path, *, num_relays=2):
    root = _pool(tier="root")
    root_disp = transport.WireDispatcher(root)
    relays = []
    for r in range(num_relays):
        pool = _pool(journal_dir=str(tmp_path / f"relay{r}"), tier="relay")
        disp = transport.WireDispatcher(pool)
        fwd = _relay(pool, root_disp, f"r{r}",
                     tmp_path / f"relay{r}" / "relay_state")
        relays.append((pool, disp, fwd))
    return root, root_disp, relays


class TestTwoTierLoopback:
    def test_mixed_kinds_bitwise_exact(self, tmp_path):
        """2 relays x 3 clients x 3 tenant kinds -> the root's solves equal
        the single-tier / tree-associated references bitwise, and the
        root's ledger sees only relay frames (one per relay per tenant)."""
        rng = np.random.default_rng(0)
        root, root_disp, relays = _build_two_tier(tmp_path)
        fm_sk = FeatureMap("sketch", seed=3, d_orig=D, m=4)
        fm_rf = FeatureMap("rff", seed=5, d_orig=D, m=4, lengthscale=1.3)

        rows = []
        for r, (pool, disp, fwd) in enumerate(relays):
            for c in range(3):
                A, b = _int_rows(rng)
                _upload_dense(transport.LoopbackChannel(disp), "dense",
                              A, b, f"r{r}c{c}")
                _upload_feature(transport.LoopbackChannel(disp), "sk",
                                fm_sk, A, b, f"r{r}c{c}")
                _upload_feature(transport.LoopbackChannel(disp), "rf",
                                fm_rf, A, b, f"r{r}c{c}")
                rows.append((A, b))
        for pool, disp, fwd in relays:
            assert fwd.forward_all() == 3

        assert _w(root, "dense").tobytes() == _dense_single_tier(
            rows, "dense").tobytes()
        for name, fm in (("sk", fm_sk), ("rf", fm_rf)):
            per_relay = [_fold([_feature_stats(fm, A, b)
                                for A, b in rows[3 * r:3 * r + 3]])
                         for r in range(2)]
            ref = _feature_reference(fm, name, _fold(per_relay))
            assert _w_native(root, name).tobytes() == ref.tobytes(), name

        led = root.ledger()
        assert led["by_tier"] == {"relay_frames": 6, "client_frames": 0}
        for t in ("dense", "sk", "rf"):
            assert led["per_tenant"][t]["relay_frames"] == 2
        for pool, disp, fwd in relays:
            fwd.close(forward=False)
            pool.close()
        root.close()

    def test_delta_telescopes_across_epochs(self, tmp_path):
        """Multiple forward epochs: each ships now - last, so the root's
        fused view equals the relay's regardless of cadence (and the
        single-tier pool's bitwise on integer rows)."""
        rng = np.random.default_rng(1)
        root, root_disp, relays = _build_two_tier(tmp_path, num_relays=1)
        pool, disp, fwd = relays[0]
        all_rows = []
        for epoch in range(3):
            for c in range(2):
                A, b = _int_rows(rng)
                _upload_dense(transport.LoopbackChannel(disp), "t", A, b,
                              f"e{epoch}c{c}")
                all_rows.append((A, b))
            assert fwd.forward_all() == 1
        assert fwd._state("t").epoch == 3

        assert _w(root, "t").tobytes() == _dense_single_tier(
            all_rows).tobytes()
        assert torch.equal(root.stats("t").gram, pool.stats("t").gram)
        # 3 epochs -> 3 relay frames at the root, each a distinct client id.
        assert root.ledger()["per_tenant"]["t"]["relay_frames"] == 3
        fwd.close(forward=False)
        pool.close()
        root.close()

    def test_empty_delta_skips(self, tmp_path):
        rng = np.random.default_rng(2)
        root, root_disp, relays = _build_two_tier(tmp_path, num_relays=1)
        pool, disp, fwd = relays[0]
        _upload_dense(transport.LoopbackChannel(disp), "t", *_int_rows(rng),
                      client_id="c0")
        assert fwd.forward_all() == 1
        assert fwd.forward_all() == 0          # nothing new: no frame
        assert fwd.empty_skips == 1
        assert fwd._state("t").epoch == 1      # epoch not burned
        assert root.ledger()["per_tenant"]["t"]["relay_frames"] == 1
        fwd.close(forward=False)
        pool.close()
        root.close()

    def test_poll_respects_size_policy(self, tmp_path):
        rng = np.random.default_rng(3)
        root = _pool(tier="root")
        root_disp = transport.WireDispatcher(root)
        pool = _pool(tier="relay")
        disp = transport.WireDispatcher(pool)
        fwd = _relay(pool, root_disp, "r0", tmp_path / "state",
                     policy=ForwardPolicy(max_frames=2))
        _upload_dense(transport.LoopbackChannel(disp), "t", *_int_rows(rng),
                      client_id="c0")
        assert fwd.poll() == 0                 # 1 < max_frames
        _upload_dense(transport.LoopbackChannel(disp), "t", *_int_rows(rng),
                      client_id="c1")
        assert fwd.poll() == 1
        assert fwd.poll() == 0                 # counter reset after forward
        fwd.close(forward=False)
        pool.close()
        root.close()

    def test_forward_copies_the_stats_to_the_host(self, tmp_path):
        """The forwarded ``now`` is a host copy taken under the tenant
        lock: later admissions never move the recorded arrays."""
        rng = np.random.default_rng(12)
        root = _pool()
        pool = _pool(tier="relay")
        disp = transport.WireDispatcher(pool)
        fwd = _relay(pool, transport.WireDispatcher(root), "r0",
                     tmp_path / "state")
        _upload_dense(transport.LoopbackChannel(disp), "t", *_int_rows(rng),
                      client_id="c0")
        assert fwd.forward_all() == 1
        last = {k: v.copy() for k, v in fwd._state("t").last.items()}
        _upload_dense(transport.LoopbackChannel(disp), "t", *_int_rows(rng),
                      client_id="c1")
        pool.stats("t")
        for k, v in last.items():
            assert fwd._state("t").last[k].tobytes() == v.tobytes(), k
        assert isinstance(fwd._state("t").last["gram"], np.ndarray)
        fwd.close(forward=False)
        pool.close()
        root.close()


# -- crash/resume --------------------------------------------------------------

class TestCrashResume:
    def test_crash_before_send_resumes_pending(self, tmp_path):
        """Die between the durable pending commit and the send: a restarted
        forwarder (fresh pool restored from the WAL, same state dir)
        re-sends the EXACT persisted bytes; the root converges with zero
        client re-uploads."""
        rng = np.random.default_rng(4)
        root = _pool(tier="root")
        root_disp = transport.WireDispatcher(root)
        jdir = tmp_path / "relay"
        pool = _pool(journal_dir=str(jdir), tier="relay")
        disp = transport.WireDispatcher(pool)
        fwd = _relay(pool, root_disp, "r0", jdir / "relay_state")

        rows = [_int_rows(rng) for _ in range(3)]
        for c, (A, b) in enumerate(rows):
            _upload_dense(transport.LoopbackChannel(disp), "t", A, b, f"c{c}")

        boom = RuntimeError("power gone")
        fwd._send_pending = lambda st: (_ for _ in ()).throw(boom)
        with pytest.raises(RuntimeError):
            fwd.forward_tenant("t")
        _crash(pool)
        assert root.tenant_names == ()         # nothing arrived upstream
        (state_file,) = (jdir / "relay_state").glob("fwd_*.npz")
        persisted = bytes(np.load(state_file)["pending_raw"])

        pool2 = _pool(journal_dir=str(jdir), tier="relay")
        fwd2 = _relay(pool2, root_disp, "r0", jdir / "relay_state")
        sent = _recording(fwd2)
        assert fwd2.resume() == 1
        assert fwd2.resumed_pending == 1
        assert sent == [("t", persisted)]

        assert _w(root, "t").tobytes() == _dense_single_tier(rows).tobytes()
        # Zero client re-uploads: one relay frame is ALL the root ever saw.
        assert root.ledger()["by_tier"] == {"relay_frames": 1,
                                            "client_frames": 0}
        assert fwd2.forward_all() == 0         # delta already covered
        fwd2.close(forward=False)
        pool2.close()
        root.close()

    def test_lost_ack_reforward_dedups(self, tmp_path):
        """The forward LANDED but the ACK was lost (state dir captured at
        the pending-commit point, as a crash would leave it): the resumed
        re-send is byte-identical, the root answers duplicate=True, and
        nothing is fused twice."""
        rng = np.random.default_rng(5)
        root = _pool(tier="root")
        root_disp = transport.WireDispatcher(root)
        state = tmp_path / "state"
        captured = tmp_path / "state_at_commit"
        pool = _pool(tier="relay")
        disp = transport.WireDispatcher(pool)
        fwd = _relay(pool, root_disp, "r0", state)
        _upload_dense(transport.LoopbackChannel(disp), "t", *_int_rows(rng),
                      client_id="c0")
        _capture_at_commit(fwd, state, captured)
        assert fwd.forward_tenant("t")
        before = _w(root, "t")
        frames_before = root.tenant("t").wire_frames

        fwd2 = _relay(pool, root_disp, "r0", captured)
        assert fwd2.resume() == 1              # re-sends the landed epoch
        assert fwd2.summary()["duplicate_acks"] == 1
        assert root.tenant("t").wire_frames == frames_before
        assert root.tenant("t").duplicates == 1
        assert _w(root, "t").tobytes() == before.tobytes()
        fwd.close(forward=False)
        fwd2.close(forward=False)
        pool.close()
        root.close()

    def test_warm_standby_spinup(self, tmp_path):
        """Ship a relay's journal+state directory to a standby: the
        replacement pool restores from snapshot+WAL, the replacement
        forwarder loads ``last`` from the durable record, and forwards
        exactly the not-yet-forwarded remainder."""
        rng = np.random.default_rng(6)
        root = _pool(tier="root")
        root_disp = transport.WireDispatcher(root)
        jdir = tmp_path / "relay"
        pool = _pool(journal_dir=str(jdir), tier="relay")
        disp = transport.WireDispatcher(pool)
        fwd = _relay(pool, root_disp, "r0", jdir / "relay_state")

        rows = [_int_rows(rng) for _ in range(5)]
        for c, (A, b) in enumerate(rows[:3]):
            _upload_dense(transport.LoopbackChannel(disp), "t", A, b, f"c{c}")
        assert fwd.forward_all() == 1          # epoch 0 shipped
        for c, (A, b) in enumerate(rows[3:], 3):
            _upload_dense(transport.LoopbackChannel(disp), "t", A, b, f"c{c}")
        pool.snapshot()
        _crash(pool)
        standby_dir = tmp_path / "standby"
        shutil.copytree(jdir, standby_dir)

        standby = _pool(journal_dir=str(standby_dir), tier="relay")
        sfwd = _relay(standby, root_disp, "r0", standby_dir / "relay_state")
        assert sfwd.resume() == 0              # no pending was in flight
        assert sfwd.forward_all() == 1         # the un-forwarded remainder
        assert sfwd._state("t").epoch == 2

        assert _w(root, "t").tobytes() == _dense_single_tier(rows).tobytes()
        assert root.ledger()["per_tenant"]["t"]["relay_frames"] == 2
        sfwd.close(forward=False)
        standby.close()
        root.close()


def _recording(fwd):
    """Record (tenant, bytes) of every pending frame ``fwd`` ships."""
    sent = []
    real = fwd._send_pending

    def send(st):
        sent.append((st.tenant, st.pending_raw))
        real(st)

    fwd._send_pending = send
    return sent


def _capture_at_commit(fwd, state, captured):
    """Copy the state directory at the durable pending commit, then send:
    the directory a crash before the ACK would leave."""
    real = fwd._send_pending

    def capture_then_send(st):
        shutil.copytree(state, captured)
        real(st)

    fwd._send_pending = capture_then_send


class TestPollerErrorSurface:
    """The background poller survives failures and surfaces them: every
    failed poll counts in ``summary()['poll_errors']`` and each distinct
    error's traceback is logged once."""

    def test_poisoned_poll_counts_logs_once_and_survives(self, tmp_path,
                                                         caplog):
        rng = np.random.default_rng(9)
        root = _pool(tier="root")
        root_disp = transport.WireDispatcher(root)
        pool = _pool(tier="relay")
        disp = transport.WireDispatcher(pool)
        fwd = _relay(pool, root_disp, "r0", tmp_path / "state",
                     policy=ForwardPolicy(max_frames=1))
        real_poll = fwd.poll
        boom = {"on": True}

        def poisoned_poll():
            if boom["on"]:
                raise RuntimeError("upstream exploded")
            return real_poll()

        fwd.poll = poisoned_poll
        with caplog.at_level("ERROR", logger="repro_torch.server.relay"):
            fwd.start(interval_s=0.01)
            deadline = time.monotonic() + 5.0
            while fwd.poll_errors < 3 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert fwd.poll_errors >= 3
            assert fwd.summary()["poll_errors"] >= 3
            hits = [r for r in caplog.records
                    if "upstream exploded" in r.getMessage()]
            assert len(hits) == 1
            assert "Traceback" in hits[0].getMessage()
            assert fwd._thread.is_alive()

            # The thread survived the poison: heal it and the same loop
            # still drives a real forward to the root.
            boom["on"] = False
            _upload_dense(transport.LoopbackChannel(disp), "t",
                          *_int_rows(rng), client_id="c0")
            deadline = time.monotonic() + 5.0
            while "t" not in root.tenant_names and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            assert "t" in root.tenant_names
        fwd.close(forward=False)
        pool.close()
        root.close()

    def test_distinct_errors_each_logged(self, tmp_path, caplog):
        pool = _pool(tier="relay")
        fwd = _relay(pool, None, "r0", tmp_path / "state")
        errors = iter([RuntimeError("first kind"), RuntimeError("first kind"),
                       ValueError("second kind")])
        done = []

        def poll():
            try:
                raise next(errors)
            except StopIteration:
                done.append(True)
                fwd._stop.set()
                return 0

        fwd.poll = poll
        with caplog.at_level("ERROR", logger="repro_torch.server.relay"):
            fwd.start(interval_s=0.005)
            deadline = time.monotonic() + 5.0
            while not done and time.monotonic() < deadline:
                time.sleep(0.01)
        assert done
        assert fwd.poll_errors == 3
        msgs = [r.getMessage() for r in caplog.records]
        assert sum("first kind" in m for m in msgs) == 1
        assert sum("second kind" in m for m in msgs) == 1
        fwd.stop()
        assert fwd._thread is None
        pool.close()


# -- two-tier chaos ------------------------------------------------------------

class TestTwoTierChaos:
    def test_chaos_both_legs_bitwise_exact(self, tmp_path):
        """2 relays x 3 clients each, mixed dense / sketched / rff tenants,
        seeded faults at 0.15 per fault class on both the client->relay and
        relay->root legs (real TCP chaos proxies). Retries and two tiers of
        dedup still land the root on the bitwise references, with exactly
        one upstream frame per relay per tenant."""
        rng = np.random.default_rng(7)
        fm_sk = FeatureMap("sketch", seed=3, d_orig=D, m=4)
        fm_rf = FeatureMap("rff", seed=5, d_orig=D, m=4, lengthscale=1.3)
        cfg = chaos.ChaosConfig.uniform(0.15, delay_s=0.001)

        def resilient(px, tenant, seed):
            return transport.ResilientClient(
                lambda: transport.TCPChannel(px.host, px.port, timeout_s=30),
                tenant=tenant, retries=50, backoff_s=0.0, jitter=0.0,
                seed=seed, sleep=lambda s: None)

        root = _pool(tier="root")
        rows = []
        with transport.FrameServer(root) as root_srv, \
                chaos.ChaosProxy(root_srv.host, root_srv.port,
                                 chaos.ChaosSchedule(cfg, seed=100)) as up_px:
            relays = []
            for r in range(2):
                pool = _pool(journal_dir=str(tmp_path / f"relay{r}"),
                             tier="relay")
                srv = transport.FrameServer(pool).start()
                px = chaos.ChaosProxy(srv.host, srv.port,
                                      chaos.ChaosSchedule(cfg, seed=200 + r)
                                      ).start()
                fwd = RelayForwarder(
                    pool,
                    lambda: transport.TCPChannel(up_px.host, up_px.port,
                                                 timeout_s=30),
                    relay_id=f"r{r}",
                    state_dir=tmp_path / f"relay{r}" / "relay_state",
                    policy=ForwardPolicy(max_frames=None),
                    retries=50, backoff_s=0.0, jitter=0.0,
                    sleep=lambda s: None)
                relays.append((pool, srv, px, fwd))

            for r, (pool, srv, px, fwd) in enumerate(relays):
                for c in range(3):
                    A, b = _int_rows(rng)
                    client = resilient(px, "dense", 10 * r + c)
                    client.upload_stats(_stats(A, b), client_id=f"r{r}c{c}")
                    client.close()
                    for tenant, fm in (("sk", fm_sk), ("rf", fm_rf)):
                        fc = resilient(px, tenant, 77 + 10 * r + c)
                        packed = PackedStats.pack(
                            fm.stats(torch.from_numpy(A), torch.from_numpy(b)))
                        if fm.kind == "sketch":
                            fc.upload_projected(
                                packed, d_orig=D, seed=fm.seed,
                                rhash=fm.fhash, client_id=f"r{r}c{c}")
                        else:
                            fc.upload_rff(
                                packed, d_orig=D, seed=fm.seed,
                                fhash=fm.fhash, lengthscale=fm.lengthscale,
                                client_id=f"r{r}c{c}")
                        fc.close()
                    rows.append((A, b))

            for pool, srv, px, fwd in relays:
                assert fwd.forward_all() == 3
                fwd.close(forward=False)
                px.stop()
                srv.stop()
                pool.close()

        assert _w(root, "dense").tobytes() == _dense_single_tier(
            rows, "dense").tobytes()
        for name, fm in (("sk", fm_sk), ("rf", fm_rf)):
            per_relay = [_fold([_feature_stats(fm, A, b)
                                for A, b in rows[3 * r:3 * r + 3]])
                         for r in range(2)]
            ref = _feature_reference(fm, name, _fold(per_relay))
            assert _w_native(root, name).tobytes() == ref.tobytes(), name

        led = root.ledger()
        assert led["by_tier"] == {"relay_frames": 6, "client_frames": 0}
        for t in ("dense", "sk", "rf"):
            assert led["per_tenant"][t]["relay_frames"] == 2   # == num relays
        root.close()


# -- across packages -----------------------------------------------------------

def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_stats(a, b):
    for field in ("gram", "moment"):
        x, y = _np(getattr(a, field)), _np(getattr(b, field))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field
    assert int(a.count) == int(b.count)
    assert (a.yty is None) == (b.yty is None)
    if a.yty is not None:
        assert float(a.yty) == float(b.yty)


def _npz_members(path):
    with zipfile.ZipFile(io.BytesIO(path.read_bytes())) as z:
        return [(i.filename, i.compress_type, i.CRC, z.read(i.filename))
                for i in z.infolist()]


def _same_state_dirs(a, b):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and names
    for name in names:
        assert _npz_members(a / name) == _npz_members(b / name), name


class TestAcrossPackages:
    def test_forwarded_frames_and_roots_bitwise_both_ways(self, tmp_path):
        """The same client frames into a JAX relay and a port relay; the
        JAX relay forwards over TCP into a port root, the port relay into a
        JAX root, in two epochs across dense (with moments), sketched and
        rff tenants. Every forwarded frame is the same bytes, the two
        roots' fused (G, h) and the relays' state records are equal."""
        rng = np.random.default_rng(10)
        fm_sk = FeatureMap("sketch", seed=3, d_orig=D, m=4)
        fm_rf = FeatureMap("rff", seed=5, d_orig=D, m=4, lengthscale=1.3)
        proot, jroot = _pool(tier="root"), JEnginePool(tier="root")
        jpool = JEnginePool(journal_dir=str(tmp_path / "jrelay"), tier="relay")
        ppool = _pool(journal_dir=str(tmp_path / "prelay"), tier="relay")
        jdisp, pdisp = jtransport.WireDispatcher(jpool), \
            transport.WireDispatcher(ppool)
        with transport.FrameServer(proot) as psrv, \
                jtransport.FrameServer(jroot) as jsrv:
            jfwd = jrelay.RelayForwarder(
                jpool, lambda: jtransport.TCPChannel(psrv.host, psrv.port),
                relay_id="r0", state_dir=tmp_path / "jrelay" / "relay_state",
                policy=jrelay.ForwardPolicy(max_frames=None))
            pfwd = RelayForwarder(
                ppool, lambda: transport.TCPChannel(jsrv.host, jsrv.port),
                relay_id="r0", state_dir=tmp_path / "prelay" / "relay_state",
                policy=ForwardPolicy(max_frames=None))
            jsent, psent = _recording(jfwd), _recording(pfwd)
            for epoch in range(2):
                for c in range(3):
                    A, b = _int_rows(rng)
                    frames = [("dense", _dense_frame(A, b, f"e{epoch}c{c}",
                                                     moments=True)),
                              ("sk", _feature_frame(fm_sk, A, b,
                                                    f"e{epoch}c{c}")),
                              ("rf", _feature_frame(fm_rf, A, b,
                                                    f"e{epoch}c{c}"))]
                    for tenant, raw in frames:
                        _send_raw(jtransport.LoopbackChannel(jdisp), tenant,
                                  raw, mod=jtransport)
                        _send_raw(transport.LoopbackChannel(pdisp), tenant,
                                  raw)
                assert jfwd.forward_all() == pfwd.forward_all() == 3
                _same_state_dirs(tmp_path / "jrelay" / "relay_state",
                                 tmp_path / "prelay" / "relay_state")
            assert len(psent) == 6 and psent == jsent
            for name in ("dense", "sk", "rf"):
                _same_stats(proot.stats(name), jroot.stats(name))
                assert proot.tenant(name).relay_frames == 2
            assert proot.ledger()["by_tier"] == jroot.ledger()["by_tier"] \
                == {"relay_frames": 6, "client_frames": 0}
            jfwd.close(forward=False)
            pfwd.close(forward=False)
        for p in (proot, jroot, jpool, ppool):
            p.close()

    @pytest.mark.parametrize("crashed", ["jax", "port"])
    def test_resume_the_other_packages_pending_forward(self, tmp_path,
                                                       crashed):
        """A relay of one package dies between its pending commit and the
        send; the other package's pool restores the journal and its
        forwarder resumes the state directory: it re-sends the persisted
        bytes, and the next forward finds nothing left to ship."""
        rng = np.random.default_rng(11)
        jdir = tmp_path / "relay"
        rows = [_int_rows(rng) for _ in range(3)]
        if crashed == "jax":
            pool = JEnginePool(journal_dir=str(jdir), tier="relay")
            disp, mod, Fwd = (jtransport.WireDispatcher(pool), jtransport,
                              jrelay.RelayForwarder)
        else:
            pool = _pool(journal_dir=str(jdir), tier="relay")
            disp, mod, Fwd = (transport.WireDispatcher(pool), transport,
                              RelayForwarder)
        for c, (A, b) in enumerate(rows):
            _send_raw(mod.LoopbackChannel(disp), "t",
                      _dense_frame(A, b, f"c{c}", moments=True), mod=mod)
        fwd = Fwd(pool, lambda: None, relay_id="r0",
                  state_dir=jdir / "relay_state")
        fwd._send_pending = lambda st: (_ for _ in ()).throw(
            RuntimeError("power gone"))
        with pytest.raises(RuntimeError):
            fwd.forward_tenant("t")
        _crash(pool)
        (state_file,) = (jdir / "relay_state").glob("fwd_*.npz")
        persisted = bytes(np.load(state_file)["pending_raw"])

        if crashed == "jax":
            root = _pool(tier="root")
            pool2 = _pool(journal_dir=str(jdir), tier="relay")
            fwd2 = RelayForwarder(
                pool2, lambda: transport.LoopbackChannel(
                    transport.WireDispatcher(root)),
                relay_id="r0", state_dir=jdir / "relay_state")
        else:
            root = JEnginePool(tier="root")
            pool2 = JEnginePool(journal_dir=str(jdir), tier="relay")
            fwd2 = jrelay.RelayForwarder(
                pool2, lambda: jtransport.LoopbackChannel(
                    jtransport.WireDispatcher(root)),
                relay_id="r0", state_dir=jdir / "relay_state")
        sent = _recording(fwd2)
        assert fwd2.resume() == 1
        assert sent == [("t", persisted)]
        assert fwd2.forward_all() == 0         # `last` read across packages
        assert fwd2._state("t").epoch == 1
        assert root.ledger()["by_tier"] == {"relay_frames": 1,
                                            "client_frames": 0}
        _same_stats(root.stats("t"), pool2.stats("t"))
        fwd2.close(forward=False)
        pool2.close()
        root.close()

    @pytest.mark.parametrize("root_pkg", ["port", "jax"])
    def test_chunked_forward_dedups_against_unchunked(self, tmp_path,
                                                      root_pkg):
        """A forward streamed as continuation chunks (``max_chunk_payload``)
        reassembles at the root into the frame's bytes; the same epoch
        re-sent unchunked from the state captured at its commit is answered
        duplicate=True and fuses nothing twice."""
        rng = np.random.default_rng(13)
        if root_pkg == "port":
            root = _pool(tier="root")
            root_disp = transport.WireDispatcher(root)
            channel = lambda: transport.LoopbackChannel(root_disp)  # noqa: E731
        else:
            root = JEnginePool(tier="root")
            root_disp = jtransport.WireDispatcher(root)
            channel = lambda: jtransport.LoopbackChannel(root_disp)  # noqa: E731
        pool = _pool(tier="relay")
        disp = transport.WireDispatcher(pool)
        for c in range(2):
            _upload_dense(transport.LoopbackChannel(disp), "t",
                          *_int_rows(rng), client_id=f"c{c}")
        state, captured = tmp_path / "state", tmp_path / "captured"
        fwd = RelayForwarder(pool, channel, relay_id="r0", state_dir=state,
                             policy=ForwardPolicy(max_frames=None),
                             max_chunk_payload=64)
        sent = _recording(fwd)
        _capture_at_commit(fwd, state, captured)
        assert fwd.forward_all() == 1
        ((_, raw),) = sent
        summ = root_disp.summary()
        assert summ["frames_reassembled"] == 1
        assert summ["chunks_received"] == len(
            wire.split_frame(raw, max_chunk_payload=64)) > 2
        up = fwd.summary()["upstream"]["t"]
        assert up["bytes_uploaded"] > len(raw)    # the chunks' own headers
        stats_before = root.stats("t")

        fwd2 = RelayForwarder(pool, channel, relay_id="r0",
                              state_dir=captured)
        assert fwd2.resume() == 1
        assert fwd2.summary()["duplicate_acks"] == 1
        assert fwd2.summary()["upstream"]["t"]["bytes_uploaded"] == len(raw)
        assert root.tenant("t").duplicates == 1
        _same_stats(root.stats("t"), stats_before)
        _same_stats(root.stats("t"), pool.stats("t"))
        fwd.close(forward=False)
        fwd2.close(forward=False)
        pool.close()
        root.close()


def test_jax_stats_reference_is_exact_on_int_rows():
    """The premise of the dense pins: small-integer rows give float32
    statistics that both packages compute exactly."""
    from repro.core.sufficient_stats import compute_stats as jcompute

    rng = np.random.default_rng(14)
    A, b = _int_rows(rng, n=32)
    js = jcompute(jnp.asarray(A), jnp.asarray(b))
    _same_stats(_stats(A, b), js)
