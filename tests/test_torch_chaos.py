"""The port's chaos harness (``repro_torch.fed.chaos``) against the JAX package's.

Mirrors tests/test_chaos.py on a port pool on the CPU: with every fault
class firing, resilient clients plus the pool's dedup index land the fused
statistics on the bits of a pool that saw no chaos, each duplicate fused
once — through ``ChaosChannel`` over loopback and through ``ChaosProxy``
over real sockets. The schedule is Python ``random`` from a seed, so the
same seed and config draw the same faults, at the same requests and bits,
as the reference's schedule; that is pinned too, as is a mixed federation
of reference clients through the port's proxy.
"""
import numpy as np
import pytest
import torch

from repro.fed import chaos as jchaos
from repro.fed import transport as jtransport
from repro_torch.core import fusion
from repro_torch.core.sufficient_stats import compute_stats
from repro_torch.fed import chaos, transport, wire
from repro_torch.server import EnginePool

SIGMA = 0.1


def _int_rows(rng, n, d):
    """Small-integer rows: f32 sums are exact whatever the fuse order, so a
    chaos run (any retry interleaving) stays bitwise comparable."""
    A = rng.integers(-3, 4, (n, d)).astype(np.float32)
    b = rng.integers(-3, 4, (n,)).astype(np.float32)
    return torch.from_numpy(A), torch.from_numpy(b)


def _pool():
    return EnginePool(device="cpu")


class TestScheduleDeterminism:
    def test_same_seed_same_schedule(self):
        cfg = chaos.ChaosConfig.uniform(0.3)
        a = chaos.ChaosSchedule(cfg, seed=123)
        b = chaos.ChaosSchedule(cfg, seed=123)
        draws_a = [a.draw(200 + i) for i in range(50)]
        assert draws_a == [b.draw(200 + i) for i in range(50)]
        assert a.summary() == b.summary()
        assert sum(a.fired.values()) > 0

    @pytest.mark.parametrize("seed", [0, 7, 42, 2**31 - 1])
    @pytest.mark.parametrize("rates", [
        {"uniform": 0.1}, {"uniform": 0.5},
        {"drop": 0.3, "corrupt": 0.3}, {"kill": 0.4, "drop_reply": 0.4},
        {"corrupt": 1.0}])
    def test_same_seed_same_schedule_as_reference(self, seed, rates):
        """The port's schedule is the reference's: same faults at the same
        requests, same corrupt bits, same summary."""
        if "uniform" in rates:
            cfg = chaos.ChaosConfig.uniform(rates["uniform"])
            jcfg = jchaos.ChaosConfig.uniform(rates["uniform"])
        else:
            cfg, jcfg = chaos.ChaosConfig(**rates), jchaos.ChaosConfig(**rates)
        a = chaos.ChaosSchedule(cfg, seed=seed)
        b = jchaos.ChaosSchedule(jcfg, seed=seed)
        sizes = np.random.default_rng(seed).integers(13, 5000, 300)
        assert [a.draw(int(n)) for n in sizes] == \
            [b.draw(int(n)) for n in sizes]
        assert a.summary() == b.summary()
        assert chaos.FAULTS == jchaos.FAULTS

    def test_different_seed_differs(self):
        cfg = chaos.ChaosConfig.uniform(0.3)
        a = chaos.ChaosSchedule(cfg, seed=1)
        b = chaos.ChaosSchedule(cfg, seed=2)
        assert ([a.draw(300) for _ in range(50)]
                != [b.draw(300) for _ in range(50)])

    def test_earlier_faults_stable_under_later_rate_changes(self):
        lo = chaos.ChaosConfig(drop=0.3, corrupt=0.3)
        hi = chaos.ChaosConfig(drop=0.3, corrupt=0.3, delay=0.9,
                               drop_reply=0.9)
        a = chaos.ChaosSchedule(lo, seed=7)
        b = chaos.ChaosSchedule(hi, seed=7)
        for _ in range(100):
            fa, _ = a.draw(500)
            fb, _ = b.draw(500)
            assert ([f for f in fa if f in ("drop", "corrupt")]
                    == [f for f in fb if f in ("drop", "corrupt")])

    def test_config_validation(self):
        with pytest.raises(ValueError):
            chaos.ChaosConfig(drop=1.5)
        with pytest.raises(ValueError):
            chaos.ChaosConfig(delay_s=-0.1)
        u = chaos.ChaosConfig.uniform(0.25)
        assert all(u.rate(f) == 0.25 for f in chaos.FAULTS)

    @pytest.mark.parametrize("bit", [0, 13 * 8 + 5, 255, 10_000])
    def test_flip_bit_equals_reference(self, bit):
        data = bytes(range(32))
        flipped = chaos.flip_bit(data, bit)
        assert flipped == jchaos.flip_bit(data, bit) != data
        assert chaos.flip_bit(flipped, bit) == data

    def test_corrupt_bit_lands_past_header(self):
        sched = chaos.ChaosSchedule(chaos.ChaosConfig(corrupt=1.0), seed=0)
        for _ in range(50):
            faults, bit = sched.draw(100)
            assert faults == ["corrupt"]
            assert bit >= wire.HEADER_BYTES * 8


def _run_chaos_clients(make_factory, *, num_clients, dim, seed, retries=80):
    rng = np.random.default_rng(seed)
    stats, summaries = [], []
    for i in range(num_clients):
        s = compute_stats(*_int_rows(rng, 15, dim))
        stats.append(s)
        client = transport.ResilientClient(
            make_factory(i), tenant="t", offers=("f32",),
            retries=retries, backoff_s=0.001, jitter=0.5, seed=100 + i,
            sleep=lambda s: None)
        assert client.upload_stats(s, client_id=f"c{i}").ok
        summaries.append(client.summary())
        client.close()
    return summaries, stats


def _assert_exact(pool, stats, *, num_clients, sigma=SIGMA):
    """The chaos pin: the fused statistics and the solve are the bits of a
    pool that saw no chaos (the same uploads in order), each row fused
    once."""
    with _pool() as clean:
        clean.create_tenant("t", dim=stats[0].dim)
        for i, s in enumerate(stats):
            clean.ingest("t", s, client_id=f"c{i}")
        for a, b in ((pool.stats("t").gram, clean.stats("t").gram),
                     (pool.stats("t").moment, clean.stats("t").moment)):
            assert a.numpy().tobytes() == b.numpy().tobytes()
        w = pool.solve("t", sigma)
        assert w.numpy().tobytes() == clean.solve("t", sigma).numpy().tobytes()
    fused = stats[0]
    for s in stats[1:]:
        fused = fused + s
    np.testing.assert_allclose(w.numpy(),
                               fusion.solve_ridge(fused, sigma).numpy(),
                               rtol=1e-5, atol=1e-6)
    eng = pool.get("t")
    assert sorted(eng.client_ids) == [f"c{i}" for i in range(num_clients)]
    assert int(eng.backend.count) == 15 * num_clients


class TestChaosChannelLoopback:
    def test_ten_percent_everything_converges_bit_exact(self):
        cfg = chaos.ChaosConfig.uniform(0.15)
        sched = chaos.ChaosSchedule(cfg, seed=42)
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)

            def make_factory(i):
                return chaos.chaos_channel_factory(
                    lambda: transport.LoopbackChannel(disp), sched,
                    sleep=lambda s: None)

            summaries, stats = _run_chaos_clients(
                make_factory, num_clients=6, dim=6, seed=0)
            _assert_exact(pool, stats, num_clients=6)
            fired = sched.summary()["fired"]
            assert all(fired[f] >= 1 for f in chaos.FAULTS), fired
            assert sum(s["retries"] for s in summaries) > 0
            assert sum(s["reconnects"] for s in summaries) >= 6
            assert pool.tenant("t").duplicates >= 1
            assert disp.duplicates_acked == pool.tenant("t").duplicates

    def test_same_seed_same_run_as_reference(self):
        """The same seeded chaos over loopback: the port's run and the
        reference's fire the same faults and take the same retries."""
        from repro import server as jserver
        from repro.core.sufficient_stats import compute_stats as jstats

        def run(mod_chaos, mod_transport, pool, make_stats):
            sched = mod_chaos.ChaosSchedule(
                mod_chaos.ChaosConfig.uniform(0.15), seed=42)
            disp = mod_transport.WireDispatcher(pool)
            rng = np.random.default_rng(0)
            out = []
            for i in range(6):
                A, b = _int_rows(rng, 15, 6)
                client = mod_transport.ResilientClient(
                    mod_chaos.chaos_channel_factory(
                        lambda: mod_transport.LoopbackChannel(disp), sched,
                        sleep=lambda s: None),
                    tenant="t", retries=80, backoff_s=0.0, seed=100 + i,
                    sleep=lambda s: None)
                client.upload_stats(make_stats(A, b), client_id=f"c{i}")
                out.append(client.summary())
                client.close()
            return sched.summary(), out, disp.frames_rejected

        jpool = jserver.EnginePool()
        with _pool() as pool:
            got = run(chaos, transport, pool, compute_stats)
            want = run(jchaos, jtransport, jpool,
                       lambda A, b: jstats(A.numpy(), b.numpy()))
            assert got == want
            assert pool.stats("t").gram.numpy().tobytes() == \
                np.asarray(jpool.stats("t").gram).tobytes()
        jpool.close()

    def test_lost_ack_heavy_schedule(self):
        cfg = chaos.ChaosConfig(kill=0.4, drop_reply=0.4)
        sched = chaos.ChaosSchedule(cfg, seed=9)
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)

            def make_factory(i):
                return chaos.chaos_channel_factory(
                    lambda: transport.LoopbackChannel(disp), sched,
                    sleep=lambda s: None)

            summaries, stats = _run_chaos_clients(
                make_factory, num_clients=4, dim=5, seed=1)
            _assert_exact(pool, stats, num_clients=4)
            assert pool.tenant("t").duplicates >= 1
            assert sum(s["duplicate_acks"] for s in summaries) >= 1
            assert sum(s["reconnects"] for s in summaries) > 4

    def test_corruption_answered_retryable_and_absorbed(self):
        sched = chaos.ChaosSchedule(chaos.ChaosConfig(corrupt=0.5), seed=3)
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            factory = chaos.chaos_channel_factory(
                lambda: transport.LoopbackChannel(disp), sched,
                sleep=lambda s: None)
            client = transport.ResilientClient(
                factory, tenant="t", retries=50, backoff_s=0.0, jitter=0.0)
            rng = np.random.default_rng(2)
            for i in range(4):
                s = compute_stats(*_int_rows(rng, 6, 4))
                assert client.upload_stats(s, client_id=f"c{i}").ok
            client.close()
            assert sched.fired["corrupt"] >= 1
            assert disp.frames_rejected >= sched.fired["corrupt"]
            assert len(pool.get("t").client_ids) == 4

    def test_terminal_rejection_is_not_retried(self):
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            client = transport.ResilientClient(
                lambda: transport.LoopbackChannel(disp), tenant="t",
                retries=5, backoff_s=0.0, jitter=0.0)
            rng = np.random.default_rng(4)
            client.upload_stats(compute_stats(*_int_rows(rng, 4, 6)))
            with pytest.raises(transport.RejectedError) as ei:
                client.upload_stats(compute_stats(*_int_rows(rng, 4, 3)))
            assert not ei.value.ack.retryable
            assert client.retries_used == 0
            client.close()

    def test_backoff_schedule_is_seeded(self):
        """Backoff delays come from the client's own seeded generator, as
        the reference's do."""
        def delays(mod):
            slept = []
            c = mod.ResilientClient(lambda: None, retries=6, backoff_s=0.01,
                                    jitter=0.5, max_backoff_s=0.2, seed=9,
                                    sleep=slept.append)
            for attempt in range(6):
                c._backoff(attempt)
            return slept

        assert delays(transport) == delays(jtransport)
        assert delays(transport)[-1] <= 0.2 * 1.5


class TestChaosProxyTCP:
    def test_tcp_proxy_ten_percent_converges_bit_exact(self):
        cfg = chaos.ChaosConfig.uniform(0.12, delay_s=0.001)
        sched = chaos.ChaosSchedule(cfg, seed=11)
        with _pool() as pool, transport.FrameServer(pool) as srv, \
                chaos.ChaosProxy(srv.host, srv.port, sched,
                                 timeout_s=10.0) as proxy:

            def make_factory(i):
                return lambda: transport.TCPChannel(
                    proxy.host, proxy.port, timeout_s=10.0)

            summaries, stats = _run_chaos_clients(
                make_factory, num_clients=4, dim=6, seed=5)
            chan = transport.TCPChannel(srv.host, srv.port)
            client = transport.FrameClient(chan)
            client.hello("t", ("f32",))
            w = client.solve(SIGMA)
            client.close()
            assert w.tobytes() == pool.solve_lifted("t", SIGMA).numpy().tobytes()
            _assert_exact(pool, stats, num_clients=4)
            assert sched.requests > 4
            assert sum(sched.fired.values()) >= 1
            assert sum(s["reconnects"] for s in summaries) >= 4

    def test_reference_clients_through_the_port_proxy(self):
        """Reference ``ResilientClient``s through the port's ``ChaosProxy``
        into a port server: the same exactness, nothing shared but bytes."""
        from repro.core.sufficient_stats import compute_stats as jstats

        cfg = chaos.ChaosConfig.uniform(0.1, delay_s=0.001)
        sched = chaos.ChaosSchedule(cfg, seed=7)
        rng = np.random.default_rng(8)
        stats = []
        with _pool() as pool, transport.FrameServer(pool) as srv, \
                chaos.ChaosProxy(srv.host, srv.port, sched,
                                 timeout_s=10.0) as proxy:
            for i in range(4):
                A, b = _int_rows(rng, 15, 5)
                stats.append(compute_stats(A, b))
                client = jtransport.ResilientClient(
                    lambda: jtransport.TCPChannel(proxy.host, proxy.port,
                                                  timeout_s=10.0),
                    tenant="t", retries=80, backoff_s=0.001, seed=i)
                assert client.upload_stats(jstats(A.numpy(), b.numpy()),
                                           client_id=f"c{i}").ok
                client.close()
            _assert_exact(pool, stats, num_clients=4)

    def test_mid_frame_kill_leaves_server_consistent(self):
        sched = chaos.ChaosSchedule(chaos.ChaosConfig(kill=1.0), seed=13)
        rng = np.random.default_rng(6)
        s = compute_stats(*_int_rows(rng, 8, 5))
        with _pool() as pool, transport.FrameServer(pool) as srv, \
                chaos.ChaosProxy(srv.host, srv.port, sched,
                                 timeout_s=5.0) as proxy:
            client = transport.ResilientClient(
                lambda: transport.TCPChannel(proxy.host, proxy.port,
                                             timeout_s=5.0),
                tenant="t", retries=2, backoff_s=0.001, jitter=0.0)
            with pytest.raises(transport.TransportError):
                client.upload_stats(s, client_id="c0")
            client.close()
            assert "t" not in pool

            direct = transport.FrameClient(
                transport.TCPChannel(srv.host, srv.port))
            direct.hello("t", ("f32",))
            assert direct.upload_stats(s, client_id="c0").ok
            direct.close()
            assert list(pool.get("t").client_ids) == ["c0"]
