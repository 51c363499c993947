"""The port's federation server and client as processes:
``repro_torch.launch.serve --mode fusion --listen`` and
``repro_torch.launch.client``, on the CPU (``--device cpu``).

Mirrors the subprocess half of tests/test_wire_e2e.py: client processes
against a port ``FrameServer`` (a mixed federation: f64-offering, f32 and
bf16 clients, a sketched upload, a delta-row client that solves), and the
serve / client CLI pair, where the server's printed report pins the ledger
and the weights. Nothing is shared between the sides but the TCP bytes and
the dataset seed. Then across packages over TCP: the JAX package's
``launch/client.py`` against a port server, and a port client against the
JAX package's ``serve.py``. Each client draws its shard with its own
package's generator (the port's ``synthetic.generate`` draws other
numbers), so each expected union is built from the clients' own package;
the ledger must equal the bytes the clients sent, and the weights a float64
solve of the union within the main path's tolerance.

Also: ``serve_wire`` in process (report keys against the reference's, the
chaos proxy), and the client's flags. Every subprocess has a timeout.
"""
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsynthetic
from repro.launch import serve as jserve
from repro_torch.core import fusion
from repro_torch.core.features import FeatureMap
from repro_torch.core.sufficient_stats import compute_stats, fuse_stats
from repro_torch.data import synthetic
from repro_torch.fed import transport, wire
from repro_torch.fed.protocol import PackedStats
from repro_torch.launch import client as client_cli
from repro_torch.launch import serve
from repro_torch.server import EnginePool

REPO = pathlib.Path(__file__).resolve().parents[1]
SIGMA = 0.1
D = 16
TOL = 1e-4          # the main path's: relative to max |w|, against float64
TIMEOUT = 120


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(REPO / "src")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _dataset(num_clients=3, samples=64, dim=D, seed=0):
    return synthetic.generate(seed, num_clients=num_clients,
                              samples_per_client=samples, dim=dim,
                              device="cpu")


def _f64_solve(rows, sigma=SIGMA):
    stats = fuse_stats([compute_stats(torch.as_tensor(A).double(),
                                      torch.as_tensor(b).double())
                        for A, b in rows])
    return fusion.solve_ridge(stats, sigma).numpy()


def _close(w, ref, tol=TOL):
    w, ref = np.asarray(w, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(w - ref).max() / np.abs(ref).max()) <= tol


def _bf16_quantized(stats):
    p = PackedStats.pack(stats)
    return PackedStats(p.tri.to(torch.bfloat16).float(),
                       p.moment.to(torch.bfloat16).float(), p.count,
                       p.dim).unpack()


def _spawn_client(port, *extra, pkg="port"):
    cmd = ([sys.executable, "-m", "repro_torch.launch.client", "--device",
            "cpu"] if pkg == "port"
           else [sys.executable, str(REPO / "src" / "repro" / "launch"
                                     / "client.py")])
    return subprocess.Popen(
        cmd + ["--connect", f"127.0.0.1:{port}", "--seed", "0",
               "--num-clients", "3", "--samples", "64", "--dim", str(D)]
        + [str(e) for e in extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=str(REPO))


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, f"client failed:\n{err}"
    return json.loads(out.strip().splitlines()[-1])


def _spawn_server(*extra, pkg="port"):
    cmd = ([sys.executable, "-m", "repro_torch.launch.serve", "--device",
            "cpu"] if pkg == "port"
           else [sys.executable, str(REPO / "src" / "repro" / "launch"
                                     / "serve.py")])
    proc = subprocess.Popen(
        cmd + ["--mode", "fusion", "--listen", "0", "--serve-timeout", "100",
               "--sigma", str(SIGMA)] + [str(e) for e in extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=str(REPO))
    ports, head = {}, []
    for _ in range(20):                   # a bounded readline loop
        line = proc.stdout.readline()
        if not line:
            break
        head.append(line)
        m = re.search(r"(listening|chaos proxy) on 127\.0\.0\.1:(\d+)", line)
        if m:
            ports[m.group(1)] = int(m.group(2))
        if "listening" in ports:
            break
    if "listening" not in ports:
        proc.kill()
        _, err = proc.communicate(timeout=30)
        pytest.fail(f"no listening line: {''.join(head)}{err}")
    return proc, ports


def _server_report(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    return json.loads(re.search(r"\[serve_wire\] report (.*)", out).group(1))


class TestSubprocessFederation:
    """Port client processes against an in-process port FrameServer."""

    def test_three_process_mixed_federation(self):
        ds = _dataset()
        m, proj_seed = 6, 41
        with EnginePool(device="cpu") as pool, \
                transport.FrameServer(pool) as srv:
            first_wave = [
                _spawn_client(srv.port, "--tenant", "ridge",
                              "--client-index", 0, "--offer", "f64,f32"),
                _spawn_client(srv.port, "--tenant", "ridge",
                              "--client-index", 1, "--offer", "f32"),
                _spawn_client(srv.port, "--tenant", "lowp",
                              "--client-index", 0, "--offer", "bf16"),
                _spawn_client(srv.port, "--tenant", "sketch",
                              "--client-index", 1, "--projected", m,
                              "--proj-seed", proj_seed),
            ]
            wave = [_finish(p) for p in first_wave]
            # the solving client starts after the other ridge uploads
            # landed, so its SOLVE sees the tenant's final state
            solver = _finish(_spawn_client(
                srv.port, "--tenant", "ridge", "--client-index", 2,
                "--delta-batches", 2, "--solve", SIGMA))
            reports = [wave[0], wave[1], solver, wave[2], wave[3]]
            assert [r["negotiated_dtype"] for r in reports] == \
                ["f32", "f32", "f32", "bf16", "f32"]
            assert all(set(r["seconds"]) == {"generate", "phase1", "upload"}
                       and not any(r["launches"].values()) for r in reports)

            # ridge: the union of the three shards against float64
            w_wire = pool.solve("ridge", SIGMA).numpy()
            assert _close(w_wire, _f64_solve(ds.clients))
            # the WEIGHTS frame carried the served weights bitwise
            np.testing.assert_array_equal(
                np.asarray(solver["solve"]["weights"], np.float32), w_wire)

            # lowp: the bf16-rounded statistics of its one client
            ref = fusion.solve_ridge(
                _bf16_quantized(compute_stats(*ds.clients[0])), SIGMA)
            np.testing.assert_allclose(pool.solve("lowp", SIGMA).numpy(),
                                       ref.numpy(), rtol=1e-5, atol=1e-5)

            # sketch: lifted through the shared map
            fm = FeatureMap("sketch", seed=proj_seed, d_orig=D, m=m)
            assert pool.tenant("sketch").projection == {
                "seed": proj_seed, "d_orig": D, "m": m, "rhash": fm.fhash}
            ref = fm.lift(fusion.solve_ridge(fm.stats(*ds.clients[1]), SIGMA))
            np.testing.assert_allclose(
                pool.solve_lifted("sketch", SIGMA).numpy(), ref.numpy(),
                rtol=1e-4, atol=1e-5)

            # the ledger: the bytes the clients sent, frame by frame
            led = pool.ledger()
            assert led["wire_upload_bytes"] == \
                sum(r["bytes_uploaded"] for r in reports)
            assert led["per_tenant"]["ridge"]["wire_upload_bytes"] == \
                sum(r["bytes_uploaded"] for r in reports[:3])
            assert reports[0]["bytes_uploaded"] == wire.stats_frame_nbytes(
                D, "f32", client_id="client0")
            assert reports[3]["bytes_uploaded"] == wire.stats_frame_nbytes(
                D, "bf16", client_id="client0")
            assert reports[4]["bytes_uploaded"] == \
                wire.projected_frame_nbytes(m, "f32", client_id="client1")

    def test_serve_cli_subprocess_end_to_end(self):
        """The CLI pair: the server's printed report pins the ledger and
        the solve, and the client received the report's weights bitwise."""
        srv, ports = _spawn_server("--expect-uploads", 2, "--inference")
        try:
            first = _finish(_spawn_client(
                ports["listening"], "--tenant", "solo", "--client-index", 0,
                "--offer", "f64,f32", "--moments"))
            rep = _finish(_spawn_client(
                ports["listening"], "--tenant", "solo", "--client-index", 1,
                "--moments", "--solve", SIGMA))
        finally:
            report = _server_report(srv)
        assert set(report) == {
            "port", "proxy_port", "sigterm", "transport", "connections_total",
            "tenants", "sigma", "weights", "tenant_reports", "ledger", "pool"}
        assert report["transport"]["uploads_admitted"] == 2
        assert report["ledger"]["wire_upload_bytes"] == \
            first["bytes_uploaded"] + rep["bytes_uploaded"]
        ds = _dataset()
        assert _close(report["weights"]["solo"], _f64_solve(ds.clients[:2]))
        np.testing.assert_array_equal(np.asarray(rep["solve"]["weights"]),
                                      np.asarray(report["weights"]["solo"]))
        inf = report["tenant_reports"]["solo"]["inference"]
        assert inf["n"] == 128 and len(report["tenant_reports"]["solo"]
                                       ["stderr"]) == D
        assert report["pool"]["journaled"] is False

    def test_chaos_proxy_subprocess(self, tmp_path):
        """``--chaos-rate`` puts the seeded proxy in front; a retrying
        client process still fuses exactly once."""
        srv, ports = _spawn_server("--expect-uploads", 1, "--chaos-rate",
                                   0.1, "--chaos-seed", 3, "--journal-dir",
                                   tmp_path / "j")
        try:
            assert "chaos proxy" in ports
            rep = _finish(_spawn_client(
                ports["chaos proxy"], "--tenant", "c", "--client-index", 0,
                "--retries", 30, "--backoff", 0.01))
        finally:
            report = _server_report(srv)
        assert report["proxy_port"] == ports["chaos proxy"]
        assert report["chaos"]["requests"] >= 2
        assert report["pool"]["per_tenant"]["c"]["engine"]["rows"] == 64
        ref = fusion.solve_ridge(compute_stats(*_dataset().clients[0]), SIGMA)
        np.testing.assert_allclose(report["weights"]["c"], ref.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert rep["ok"]


class TestAcrossPackages:
    def test_jax_client_against_a_port_server(self):
        """One JAX client process streams its shard as DELTA frames to a
        port server and solves: the server's ledger is its bytes, and the
        weights it received are the server's report bitwise."""
        srv, ports = _spawn_server("--expect-uploads", 2)
        try:
            rep = _finish(_spawn_client(
                ports["listening"], "--tenant", "x", "--client-index", 1,
                "--offer", "f64,f32", "--delta-batches", 2, "--solve", SIGMA,
                pkg="jax"))
        finally:
            report = _server_report(srv)
        assert rep["negotiated_dtype"] == "f32"
        assert report["ledger"]["wire_upload_bytes"] == rep["bytes_uploaded"]
        assert rep["bytes_uploaded"] == 2 * wire.delta_frame_nbytes(
            32, D, "f32", client_id="client1")
        jds = jsynthetic.generate(jax.random.PRNGKey(0), num_clients=3,
                                  samples_per_client=64, dim=D)
        A, b = jds.clients[1]
        assert _close(report["weights"]["x"],
                      _f64_solve([(np.array(A), np.array(b))]))
        np.testing.assert_array_equal(np.asarray(rep["solve"]["weights"]),
                                      np.asarray(report["weights"]["x"]))

    def test_port_client_against_the_jax_server(self):
        srv, ports = _spawn_server("--expect-uploads", 2, pkg="jax")
        try:
            first = _finish(_spawn_client(
                ports["listening"], "--tenant", "x", "--client-index", 0,
                "--offer", "f64,f32", "--moments"))
            second = _finish(_spawn_client(
                ports["listening"], "--tenant", "x", "--client-index", 1,
                "--solve", SIGMA))
        finally:
            report = _server_report(srv)
        sent = first["bytes_uploaded"] + second["bytes_uploaded"]
        assert report["ledger"]["wire_upload_bytes"] == sent
        assert first["bytes_uploaded"] == wire.stats_frame_nbytes(
            D, "f32", client_id="client0", moments=True)
        assert _close(report["weights"]["x"], _f64_solve(_dataset().clients[:2]))
        np.testing.assert_array_equal(np.asarray(second["solve"]["weights"]),
                                      np.asarray(report["weights"]["x"]))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _upload_all(port, frames):
    for tenant, raw in frames:
        with transport.TCPChannel("127.0.0.1", port) as ch:
            c = transport.FrameClient(ch)
            c.hello(tenant, ("f32",))
            assert wire.decode_frame(ch.request(raw)).ok


def _run_in_thread(fn, **kw):
    out = {}

    def target():
        out["report"] = fn(**kw)

    t = threading.Thread(target=target)
    t.start()
    return t, out


class TestServeWireInProcess:
    def test_report_matches_the_reference(self, capsys):
        """The same frames over TCP into both packages' ``serve_wire`` (run
        on threads, where no SIGTERM handler is installed): the same report
        keys, the same ledger and dispatcher counts, and weights within
        tolerance."""
        rng = np.random.default_rng(0)
        frames = []
        for i in range(2):
            A = rng.standard_normal((32, 8)).astype(np.float32)
            b = rng.standard_normal(32).astype(np.float32)
            frames.append(("t", wire.encode_frame(wire.StatsFrame.from_stats(
                compute_stats(torch.from_numpy(A), torch.from_numpy(b)),
                client_id=f"c{i}", moments=True))))
        reports = []
        for fn, kw in ((jserve.serve_wire, {}),
                       (serve.serve_wire, {"device": "cpu"})):
            port = _free_port()
            t, out = _run_in_thread(fn, port=port, expect_uploads=2,
                                    timeout_s=60, sigma=SIGMA, **kw)
            for _ in range(200):
                try:
                    _upload_all(port, frames)
                    break
                except ConnectionRefusedError:
                    threading.Event().wait(0.05)
            t.join(timeout=90)
            assert not t.is_alive()
            reports.append(out["report"])
        ref, got = reports
        assert got.keys() == ref.keys()
        assert got["sigterm"] is False
        assert got["ledger"] == ref["ledger"]
        assert got["transport"] == {**ref["transport"], "internal_errors": 0}
        assert got["pool"].keys() == ref["pool"].keys()
        assert got["tenant_reports"]["t"].keys() == \
            ref["tenant_reports"]["t"].keys()
        np.testing.assert_allclose(got["weights"]["t"], ref["weights"]["t"],
                                   rtol=1e-4, atol=1e-5)
        assert "[serve_wire] report" in capsys.readouterr().out

    def test_journaled_serve_wire_restores(self, tmp_path):
        rng = np.random.default_rng(1)
        A = torch.from_numpy(rng.integers(-3, 4, (16, 6)).astype(np.float32))
        b = torch.from_numpy(rng.integers(-3, 4, 16).astype(np.float32))
        raw = wire.encode_frame(wire.StatsFrame.from_stats(
            compute_stats(A, b), client_id="c0"))
        port = _free_port()
        t, out = _run_in_thread(serve.serve_wire, port=port, expect_uploads=1,
                                timeout_s=60, journal_dir=str(tmp_path),
                                device="cpu")
        for _ in range(200):
            try:
                _upload_all(port, [("t", raw)])
                break
            except ConnectionRefusedError:
                threading.Event().wait(0.05)
        t.join(timeout=90)
        assert not t.is_alive()
        second = serve.serve_wire(port=0, timeout_s=0.1,
                                  journal_dir=str(tmp_path), device="cpu")
        assert second["pool"]["restored_tenants"] == 1
        assert second["pool"]["replayed_frames"] == 0
        assert second["weights"] == out["report"]["weights"]


    def test_solve_window_routes_solves_through_the_batcher(self):
        rng = np.random.default_rng(2)
        A = torch.from_numpy(rng.standard_normal((32, 6)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
        port = _free_port()
        t, out = _run_in_thread(serve.serve_wire, port=port, expect_uploads=1,
                                timeout_s=60, solve_window_s=0.002,
                                device="cpu")
        for _ in range(200):
            try:
                ch = transport.TCPChannel("127.0.0.1", port)
                break
            except ConnectionRefusedError:
                threading.Event().wait(0.05)
        with ch:
            c = transport.FrameClient(ch)
            c.hello("t")
            c.upload_stats(compute_stats(A, b), client_id="c0")
            w = c.solve(SIGMA)
        t.join(timeout=90)
        assert not t.is_alive()
        report = out["report"]
        assert report["transport"]["solve_batcher"]["requests"] >= 1
        np.testing.assert_array_equal(np.asarray(report["weights"]["t"],
                                                 np.float32), w)


class TestClientCLI:
    def test_parser_defaults(self):
        args = client_cli.make_parser().parse_args(["--connect", "h:1"])
        assert args.device == "cuda" and args.offer == "f32"
        assert args.max_chunk_payload is None and args.retries == 0
        ref = {a.dest for a in client_cli.make_parser()._actions}
        jref = {a.dest for a in _jax_client_parser()._actions}
        # every reference flag but the XLA-only --unfused-ingest, + --device
        assert ref == (jref - {"unfused_ingest"}) | {"device"}

    def test_report_in_process_over_loopback_tcp(self, capsys):
        with EnginePool(device="cpu") as pool, \
                transport.FrameServer(pool) as srv:
            client_cli.main(["--connect", f"127.0.0.1:{srv.port}",
                             "--device", "cpu", "--features", "rff",
                             "--feature-dim", "12", "--moments",
                             "--max-chunk-payload", "256",
                             "--solve", str(SIGMA)])
            rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert rep["uploaded"] == {"frame": "rff", "m": 12, "proj_seed": 0,
                                       "fused_ingest": True, "moments": True}
            assert srv.dispatcher.summary()["frames_reassembled"] == 1
            assert pool.tenant("default").kind == "rff"
            assert rep["bytes_uploaded"] == \
                pool.ledger()["wire_upload_bytes"]
            np.testing.assert_array_equal(
                np.asarray(rep["solve"]["weights"], np.float32),
                pool.solve_lifted("default", SIGMA).numpy())


def _jax_client_parser():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_jax_client", REPO / "src" / "repro" / "launch" / "client.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_parser()
