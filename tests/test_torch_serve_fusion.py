"""The port's in-process fusion serving CLI (``launch/serve.py --mode fusion``).

The CLI runs at a tiny size on the CPU (argv patched, no subprocess): it
must complete AND report every tenant's served weights within 1e-4 of a
float64 ``core.fusion`` solve over that tenant's own rows, with the
streamed deltas drained by the background flusher alone. Its result dict
carries the reference's keys, and for the same sizes the same byte ledger.
``--sharded-tenants`` and ``--auto-tenants`` default to the reference's 2
and 2: the first tenants go to the pool's one mesh (8 CPU shards here) and
are held to float64 like the rest. The wire server's flags are accepted
(the server itself: tests/test_torch_serve_wire.py).
"""
import re
import sys

import pytest

from repro.launch import serve as jserve
from repro_torch.launch import serve

ARGV = ["serve.py", "--mode", "fusion", "--dim", "32", "--tenants", "4",
        "--sketched-tenants", "1", "--rff-tenants", "1",
        "--stream-deltas", "16", "--device", "cpu"]
SMALL = dict(num_clients=2, samples_per_client=16, dim=8, tenants=3,
             queries=4, sketched_tenants=1, rff_tenants=1, feature_dim=4,
             stream_deltas=3, coalesce_rank=2, flush_staleness_s=0.02)


def test_fusion_cli_is_exact_and_drains(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ARGV)
    serve.main()
    out = capsys.readouterr().out
    errs = [float(v) for v in re.findall(r"max\|dw\|=([0-9.eE+-]+)", out)]
    assert len(errs) == 2, out                 # after admission, after stream
    assert all(e < 1e-4 for e in errs), out
    assert "0 left pending" in out, out
    # the reference's defaults: 2 pinned sharded, 2 auto (dense: no table;
    # the last two are the feature tenants, always dense)
    assert "placements {'sharded': 2, 'dense': 2} (2 pinned sharded, 2 auto)" \
        in out, out
    assert "pool: meshes_built=1 " in out, out
    assert "kind=sketched" in out and "kind=rff" in out, out
    # 4 tenants x 4 clients, each upload at its encoded Thm-4 frame length
    # for its solve space (d 32; m 16 for the feature tenants) plus a
    # download of that many float32s; 16 single rows streamed round-robin,
    # 8 of 33 floats into the dense tenants and 8 of 17 into the others.
    m = re.search(r"ledger: (\d+) upload bytes \+ (\d+) streamed", out)
    def frame(k):
        return 16 + 14 + 4 * (k * (k + 1) // 2 + k) + 4 * k
    assert int(m.group(1)) == 4 * (2 * frame(32) + 2 * frame(16)), out
    assert int(m.group(2)) == 4 * (8 * 33 + 8 * 17), out


@pytest.fixture(scope="module")
def results():
    ref = jserve.serve_fusion(sharded_tenants=0, auto_tenants=0, **SMALL)
    port = serve.serve_fusion(device="cpu", **SMALL)
    return ref, port


def test_result_keys_and_ledger_match_reference(results):
    ref, port = results
    assert set(port) - set(ref) == {"exact_max_rel_err"}
    assert set(ref) <= set(port)
    assert set(port["streaming"]) - set(ref["streaming"]) == \
        {"flush_ranks", "exact_max_rel_err"}
    assert set(ref["streaming"]) <= set(port["streaming"])
    assert port["feature_reports"].keys() == ref["feature_reports"].keys()
    for name, rep in port["feature_reports"].items():
        assert rep.keys() == ref["feature_reports"][name].keys()
        for key in ("kind", "solve_dim", "d_orig", "m", "upload_floats"):
            assert rep[key] == ref["feature_reports"][name][key]
    assert port["pool"].keys() == ref["pool"].keys()
    assert port["ledger"] == ref["ledger"]
    for key in ("tenants", "placements", "sharded_tenants", "auto_tenants",
                "sketched_tenants", "rff_tenants", "queries"):
        assert port[key] == ref[key], key


def test_small_run_is_exact(results):
    _, port = results
    s = port["streaming"]
    assert port["exact_max_abs_err"] < 1e-4 and port["exact_max_rel_err"] < 1e-4
    assert s["exact_max_abs_err"] < 1e-4 and s["exact_max_rel_err"] < 1e-4
    assert s["pending_after"] == 0
    assert sum(s["flush_ranks"].values()) >= 1
    assert sum(r * n for r, n in s["flush_ranks"].items()) == SMALL["stream_deltas"]
    assert port["pool"]["flusher_alive"] is False


@pytest.mark.parametrize("flags,item", [
    (["--sharded-tenants", "1"], "item 15"), (["--auto-tenants", "1"], "item 15")])
def test_unported_flags_are_rejected(monkeypatch, capsys, flags, item):
    """The flags that waited for the sharded backend (ROADMAP ``item``) now
    reach serve_fusion, and the run stays exact."""
    seen = {}
    real = serve.serve_fusion
    monkeypatch.setattr(serve, "serve_fusion",
                        lambda **kw: seen.update(kw) or real(**kw))
    monkeypatch.setattr(sys, "argv", ARGV + flags)
    serve.main()
    out = capsys.readouterr().out
    sharded, auto = (1, 2) if flags[0] == "--sharded-tenants" else (2, 1)
    assert (seen["sharded_tenants"], seen["auto_tenants"]) == (sharded, auto)
    assert "threshold" not in seen
    # no crossover table: the auto tenants place dense, as the reference's
    assert f"placements {{'sharded': {sharded}, 'dense': {4 - sharded}}}" in out, out
    errs = [float(v) for v in re.findall(r"max\|dw\|=([0-9.eE+-]+)", out)]
    assert errs and all(e < 1e-4 for e in errs), out


def test_sharded_and_auto_tenants_match_reference():
    """The reference's serve_fusion with 2 sharded and 1 auto tenant (its
    mesh is 1 x 1 in this process) against the port's on 8 CPU shards: the
    same placements, one mesh each, the same upload ledger; the port's
    cross-shard bytes are the reference's record for the 4-way data axis."""
    from repro.fed import comm as jcomm

    kw = dict(num_clients=2, samples_per_client=16, dim=8, tenants=4,
              queries=4, stream_deltas=4, coalesce_rank=2,
              flush_staleness_s=0.02)
    ref = jserve.serve_fusion(sharded_tenants=2, auto_tenants=1, **kw)
    port = serve.serve_fusion(sharded_tenants=2, auto_tenants=1, device="cpu", **kw)
    assert port["placements"] == ref["placements"] == {"sharded": 2, "dense": 2}
    assert port["pool"]["meshes_built"] == ref["pool"]["meshes_built"] == 1
    assert (port["sharded_tenants"], port["auto_tenants"]) == (2, 1)
    assert port["exact_max_rel_err"] < 1e-4
    assert port["streaming"]["exact_max_rel_err"] < 1e-4
    led, jled = dict(port["ledger"]), dict(ref["ledger"])
    cross = led.pop("cross_shard_bytes")
    jled.pop("cross_shard_bytes")
    for d in (led, jled):
        for t in d.get("per_tenant", {}).values():
            t.pop("cross_shard_bytes", None)
    assert led == jled
    assert cross == 2 * jcomm.sharded_oneshot_record(8, 2, {"data": 4}).cross_shard_bytes
    port_t = serve.serve_fusion(sharded_tenants=1, auto_tenants=2, threshold=8,
                                device="cpu", **kw)
    assert port_t["placements"] == {"sharded": 3, "dense": 1}
    assert port_t["pool"]["meshes_built"] == 1


@pytest.mark.parametrize("flags,dest,value", [
    (["--listen", "0"], "listen", 0), (["--expect-uploads", "2"], "expect_uploads", 2),
    (["--solve-window", "0.01"], "solve_window", 0.01),
    (["--journal-dir", "j"], "journal_dir", "j"),
    (["--chaos-rate", "0.1"], "chaos_rate", 0.1)])
def test_wire_flags_are_accepted(flags, dest, value):
    args = serve.make_parser().parse_args(ARGV[1:] + flags)
    assert getattr(args, dest) == value


def test_compilation_cache_is_not_defined(capsys):
    with pytest.raises(SystemExit):
        serve.make_parser().parse_args(ARGV[1:] + ["--compilation-cache", "c"])
    assert "unrecognized arguments" in capsys.readouterr().err


def test_relay_mode_is_rejected(monkeypatch, capsys):
    """Without ``--upstream`` a relay has nowhere to forward to."""
    monkeypatch.setattr(sys, "argv", ["serve.py", "--mode", "relay"])
    with pytest.raises(SystemExit):
        serve.main()
    assert "--mode relay requires --upstream" in capsys.readouterr().err


def test_model_mode_still_requires_arch(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve.py", "--mode", "model"])
    with pytest.raises(SystemExit):
        serve.main()
