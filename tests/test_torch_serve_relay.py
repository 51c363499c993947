"""``repro_torch.launch.serve --mode relay``: the relay tier as a process,
its in-process ``serve_wire(upstream=...)`` and its flags, on the CPU.

Mirrors ``TestServeRelaySubprocess`` of tests/test_relay.py with the
port's ``serve`` processes (``--device cpu``): a relay SIGKILLed after
acking its clients and before any forward restarts on its journal, replays
it and forwards one fused frame upstream with no client connection; the
root's served weights equal those of a single-tier port pool fed the same
client frames, bitwise (small-integer rows: order-free exact sums).

In process: ``serve_wire`` as a relay against the JAX package's (the same
report keys and relay summary keys), the resume-before-listen path that
re-sends a pending forward, the relay's state-directory rule, and the
parser: the relay flags with the reference's defaults, ``--mode relay``
without ``--upstream`` refused, a relay listening without ``--listen``,
and the sharded stubs still naming their ROADMAP item. Every wait has a
timeout.
"""
import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.fed import transport as jtransport
from repro.launch import serve as jserve
from repro.server import EnginePool as JEnginePool
from repro_torch.core.sufficient_stats import compute_stats
from repro_torch.fed import transport, wire
from repro_torch.launch import serve
from repro_torch.server import EnginePool
from repro_torch.server.relay import ForwardPolicy, RelayForwarder

REPO = pathlib.Path(__file__).resolve().parents[1]
SIGMA = 0.37
D = 6
TIMEOUT = 120


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(REPO / "src")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _int_rows(rng, n=8, d=D):
    A = rng.integers(-3, 4, (n, d)).astype(np.float32)
    b = rng.integers(-3, 4, (n,)).astype(np.float32)
    return A, b


def _frame(A, b, client_id):
    return wire.encode_frame(wire.StatsFrame.from_stats(
        compute_stats(torch.from_numpy(A), torch.from_numpy(b)),
        client_id=client_id))


def _send(channel, tenant, raw, mod=transport):
    cl = mod.FrameClient(channel)
    cl.hello(tenant)
    ack = cl.upload_raw(raw)
    cl.close()
    assert ack.ok, ack


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_serve(*args):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=str(REPO))
    port, head = None, []
    for _ in range(20):                   # a bounded readline loop
        line = proc.stdout.readline()
        if not line:
            break
        head.append(line)
        m = re.search(r"listening on 127\.0\.0\.1:(\d+)", line)
        if m:
            port = int(m.group(1))
            break
    if port is None:
        proc.kill()
        _, err = proc.communicate(timeout=30)
        pytest.fail(f"no listening line: {''.join(head)}{err}")
    return proc, port, "".join(head)


def _serve_report(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    m = re.search(r"\[serve_wire\] report (.*)", out)
    assert m, out + err
    launches = re.search(r"\[serve_wire\] launches (.*)", out)
    assert launches and all(v == 0 for v in json.loads(
        launches.group(1)).values())      # no kernel runs on the CPU
    return json.loads(m.group(1)), out


def _single_tier(frames, sigma=SIGMA):
    """The served weights of one pool fed every client frame directly."""
    with EnginePool(device="cpu") as ref:
        disp = transport.WireDispatcher(ref)
        for tenant, raw in frames:
            _send(transport.LoopbackChannel(disp), tenant, raw)
        return {t: ref.solve_lifted(t, sigma).numpy().astype(
            np.float64).tolist() for t in ref.tenant_names}


class TestServeRelaySubprocess:
    def test_sigkill_relay_restart_flush_bit_identical(self, tmp_path):
        """``serve --mode relay``, killed AFTER acking its clients but
        BEFORE any forward: a restart on the same --journal-dir replays the
        WAL and its shutdown flush ships one fused frame per tenant
        upstream. The root's served weights equal the single-tier pool's
        bit for bit, its ledger shows only relay-tier frames, and no
        client re-uploaded a byte."""
        rng = np.random.default_rng(8)
        frames = [("t", _frame(*_int_rows(rng), f"c{c}")) for c in range(3)]

        root_proc, root_port, _ = _spawn_serve(
            "--mode", "fusion", "--listen", "0", "--serve-timeout", TIMEOUT,
            "--sigma", SIGMA)
        relay_jdir = tmp_path / "relay_journal"
        relay_proc = relay2 = None
        try:
            relay_proc, relay_port, _ = _spawn_serve(
                "--mode", "relay", "--upstream", f"127.0.0.1:{root_port}",
                "--listen", "0", "--serve-timeout", TIMEOUT,
                "--journal-dir", relay_jdir,
                "--forward-every", 999)        # no mid-run forwards
            for tenant, raw in frames:
                _send(transport.TCPChannel("127.0.0.1", relay_port,
                                           timeout_s=60), tenant, raw)
            relay_proc.kill()                  # SIGKILL: no flush, no ACKs
            relay_proc.communicate(timeout=30)

            # Restart on the same journal dir; a short serve-timeout makes
            # it flush upstream and exit with no client contact at all.
            relay2, _, head = _spawn_serve(
                "--mode", "relay", "--upstream", f"127.0.0.1:{root_port}",
                "--serve-timeout", "1", "--journal-dir", relay_jdir)
            relay_report, _ = _serve_report(relay2)
            assert "recovered" in head
            assert relay_report["relay"]["forwards"] == 1
            assert relay_report["relay"]["relay_id"] == "relay0"
            assert relay_report["connections_total"] == 0   # zero re-uploads
            assert relay_report["ledger"]["tier"] == "relay"

            root_proc.send_signal(signal.SIGTERM)
            root_report, _ = _serve_report(root_proc)
        finally:
            for p in (root_proc, relay_proc, relay2):
                if p is not None and p.poll() is None:
                    p.kill()
                    p.communicate(timeout=30)

        assert root_report["weights"] == _single_tier(frames)
        assert root_report["ledger"]["by_tier"] == {"relay_frames": 1,
                                                    "client_frames": 0}
        assert root_report["ledger"]["wire_upload_bytes"] == \
            relay_report["relay"]["forwarded_bytes"]


def _run_in_thread(fn, **kw):
    out = {}

    def target():
        out["report"] = fn(**kw)

    t = threading.Thread(target=target)
    t.start()
    return t, out


def _upload_when_listening(port, frames, mod):
    for _ in range(400):
        try:
            for tenant, raw in frames:
                _send(mod.TCPChannel("127.0.0.1", port, timeout_s=60),
                      tenant, raw, mod=mod)
            return
        except ConnectionRefusedError:
            threading.Event().wait(0.05)
    pytest.fail("the relay never listened")


class TestServeWireRelayInProcess:
    def test_relay_report_matches_the_reference(self, tmp_path, capsys):
        """The same frames into both packages' ``serve_wire`` as a relay
        (threads, each forwarding into its own package's root): the same
        report keys, relay summary keys and forward counts, and the roots'
        fused statistics bitwise equal."""
        rng = np.random.default_rng(0)
        frames = [(t, _frame(*_int_rows(rng), f"c{c}"))
                  for c in range(2) for t in ("a", "b")]
        reports, roots = [], []
        for pkg in ("jax", "port"):
            mod = jtransport if pkg == "jax" else transport
            root = (JEnginePool() if pkg == "jax"
                    else EnginePool(device="cpu"))
            kw = {} if pkg == "jax" else {"device": "cpu"}
            fn = jserve.serve_wire if pkg == "jax" else serve.serve_wire
            with mod.FrameServer(root) as srv:
                port = _free_port()
                t, out = _run_in_thread(
                    fn, port=port, expect_uploads=len(frames), timeout_s=60,
                    sigma=SIGMA, journal_dir=str(tmp_path / pkg),
                    upstream=f"{srv.host}:{srv.port}", relay_id="r7",
                    forward_every=None, **kw)
                _upload_when_listening(port, frames, mod)
                t.join(timeout=90)
                assert not t.is_alive()
            reports.append(out["report"])
            roots.append(root)
        ref, got = reports
        assert got.keys() == ref.keys()
        assert got["relay"].keys() == ref["relay"].keys()
        for key in ("relay_id", "tier", "forwards", "forwarded_bytes",
                    "resumed_pending", "empty_skips", "poll_errors",
                    "duplicate_acks", "per_tenant"):
            assert got["relay"][key] == ref["relay"][key], key
        assert got["relay"]["forwards"] == 2
        assert got["ledger"]["tier"] == "relay"
        assert (tmp_path / "port" / "relay_state").is_dir()
        jroot, proot = roots
        for name in ("a", "b"):
            js, ps = jroot.stats(name), proot.stats(name)
            assert np.asarray(js.gram).tobytes() == ps.gram.numpy().tobytes()
            assert np.asarray(js.moment).tobytes() == \
                ps.moment.numpy().tobytes()
        assert proot.ledger()["by_tier"] == {"relay_frames": 2,
                                             "client_frames": 0}
        assert "[serve_wire] relay r7: 2 upstream frames" in \
            capsys.readouterr().out
        jroot.close()
        proot.close()

    def test_resume_resends_pending_before_listening(self, tmp_path, capsys):
        """A state directory holding a pending forward (a relay that died
        before its ACK): ``serve_wire`` re-sends it before it listens,
        prints the reference's line, and forwards nothing more."""
        rng = np.random.default_rng(1)
        jdir = tmp_path / "relay"
        pool = EnginePool(journal_dir=str(jdir), tier="relay", device="cpu")
        disp = transport.WireDispatcher(pool)
        for c in range(2):
            _send(transport.LoopbackChannel(disp), "t",
                  _frame(*_int_rows(rng), f"c{c}"))
        fwd = RelayForwarder(pool, lambda: None, relay_id="r0",
                             state_dir=jdir / "relay_state",
                             policy=ForwardPolicy(max_frames=None))
        fwd._send_pending = lambda st: (_ for _ in ()).throw(
            RuntimeError("power gone"))
        with pytest.raises(RuntimeError):
            fwd.forward_tenant("t")
        pool._journal.close()
        pool._closed = True
        with EnginePool(device="cpu") as root, \
                transport.FrameServer(root) as srv:
            rep = serve.serve_wire(port=0, timeout_s=0.2, sigma=SIGMA,
                                   journal_dir=str(jdir),
                                   upstream=f"{srv.host}:{srv.port}",
                                   relay_id="r0", device="cpu")
            out = capsys.readouterr().out
            assert "relay r0: re-sent 1 pending forward frame(s)" in out
            assert out.index("re-sent 1 pending") < out.index("listening on")
            assert rep["relay"]["resumed_pending"] == 1
            assert rep["relay"]["forwards"] == 1
            assert rep["relay"]["empty_skips"] == 1    # the shutdown flush
            assert root.ledger()["by_tier"] == {"relay_frames": 1,
                                                "client_frames": 0}
            assert rep["weights"]["t"] == root.solve_lifted(
                "t", SIGMA).numpy().astype(np.float64).tolist()

    def test_relay_needs_a_state_directory(self):
        with pytest.raises(ValueError, match="relay_state_dir"):
            serve.serve_wire(port=0, timeout_s=0.1, upstream="127.0.0.1:1",
                             device="cpu")


class TestRelayFlags:
    @pytest.mark.parametrize("flag,dest,default", [
        ("--upstream", "upstream", None), ("--relay-id", "relay_id", "relay0"),
        ("--forward-every", "forward_every", 32),
        ("--forward-staleness", "forward_staleness", None),
        ("--forward-interval", "forward_interval", 0.25),
        ("--relay-state-dir", "relay_state_dir", None),
        ("--max-chunk-payload", "max_chunk_payload", None)])
    def test_flags_have_the_reference_defaults(self, flag, dest, default):
        assert getattr(serve.make_parser().parse_args(["--mode", "relay"]),
                       dest) == default

    @pytest.mark.parametrize("flags,dest,value", [
        (["--upstream", "h:9"], "upstream", "h:9"),
        (["--relay-id", "east-1"], "relay_id", "east-1"),
        (["--forward-every", "4"], "forward_every", 4),
        (["--forward-staleness", "0.5"], "forward_staleness", 0.5),
        (["--forward-interval", "0.1"], "forward_interval", 0.1),
        (["--relay-state-dir", "d"], "relay_state_dir", "d"),
        (["--max-chunk-payload", "4096"], "max_chunk_payload", 4096)])
    def test_relay_flags_are_accepted(self, flags, dest, value):
        args = serve.make_parser().parse_args(["--mode", "relay"] + flags)
        assert getattr(args, dest) == value

    def test_relay_without_upstream_is_a_parser_error(self, monkeypatch,
                                                      capsys):
        monkeypatch.setattr(sys, "argv", ["serve.py", "--mode", "relay",
                                          "--device", "cpu"])
        with pytest.raises(SystemExit) as e:
            serve.main()
        assert e.value.code == 2
        assert "--mode relay requires --upstream HOST:PORT" in \
            capsys.readouterr().err

    @pytest.mark.parametrize("argv,want", [
        (["--mode", "relay", "--upstream", "h:9", "--journal-dir", "j"],
         {"port": 0, "upstream": "h:9", "relay_id": "relay0",
          "forward_every": 32, "forward_interval_s": 0.25,
          "max_chunk_payload": None}),
        (["--mode", "relay", "--upstream", "h:9", "--listen", "7", "--relay-id",
          "r1", "--forward-every", "5", "--forward-staleness", "2",
          "--forward-interval", "0.5", "--relay-state-dir", "s",
          "--max-chunk-payload", "64"],
         {"port": 7, "upstream": "h:9", "relay_id": "r1", "forward_every": 5,
          "forward_staleness_s": 2.0, "forward_interval_s": 0.5,
          "relay_state_dir": "s", "max_chunk_payload": 64}),
        (["--mode", "fusion", "--listen", "3", "--upstream", "h:9"],
         {"port": 3, "upstream": None})])
    def test_main_passes_the_relay_arguments(self, monkeypatch, argv, want):
        """A relay listens even without --listen (an ephemeral port); the
        fusion mode never forwards, whatever --upstream says."""
        seen = {}
        monkeypatch.setattr(serve, "serve_wire", lambda **kw: seen.update(kw))
        monkeypatch.setattr(sys, "argv", ["serve.py", "--device", "cpu"] + argv)
        serve.main()
        for key, value in want.items():
            assert seen[key] == value, key
        assert seen["device"] == "cpu"

    @pytest.mark.parametrize("flag", ["--sharded-tenants", "--auto-tenants"])
    def test_sharded_stubs_still_name_their_item(self, monkeypatch, capsys,
                                                 flag):
        """The placement flags are the in-process loop's, as in the
        reference: a relay accepts them and its server ignores them."""
        seen = {}
        monkeypatch.setattr(serve, "serve_wire", lambda **kw: seen.update(kw))
        monkeypatch.setattr(sys, "argv", ["serve.py", "--mode", "relay",
                                          "--upstream", "h:9", "--device",
                                          "cpu", flag, "1"])
        serve.main()
        assert seen["upstream"] == "h:9"
        assert "sharded_tenants" not in seen and "auto_tenants" not in seen
        assert "not ported" not in capsys.readouterr().err
