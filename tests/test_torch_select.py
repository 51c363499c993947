"""Port parity for backend selection (``server/select.py``).

The same thresholds and tables go through both packages: an explicit
threshold wins, a table's ``crossover_d`` comes next, and a missing table,
an unreadable one or a null crossover reads as +inf (dense everywhere).
The port has no default table (the reference's is a CPU measurement of its
JAX sharded backend), so with neither argument it resolves +inf. A
dimension that clears the threshold on a mesh gets a ``ShardedBackend``
there, as in the reference (tests/test_mutation_path.py's auto tests).
"""
import json
import math

import pytest
import torch

from repro.server import select as jselect
from repro_torch.server import DenseBackend, EnginePool
from repro_torch.server import select as tselect


def _table(tmp_path, crossover):
    path = tmp_path / "crossover.json"
    path.write_text(json.dumps({"crossover_d": crossover}))
    return path


@pytest.mark.parametrize("threshold", [0, 7, 96.5, 4096])
def test_explicit_threshold_wins(tmp_path, threshold):
    table = _table(tmp_path, 3)
    for mod in (jselect, tselect):
        assert mod.backend_threshold(threshold, table) == float(threshold)
        assert mod.prefer_sharded(100, threshold=threshold, table=table) == \
            (100 >= threshold)


@pytest.mark.parametrize("crossover", [64, 1024])
def test_table_crossover(tmp_path, crossover):
    table = _table(tmp_path, crossover)
    for dim in (crossover - 1, crossover, crossover + 1):
        assert tselect.prefer_sharded(dim, table=table) == \
            jselect.prefer_sharded(dim, table=table) == (dim >= crossover)
    assert tselect.backend_threshold(table=table) == \
        jselect.backend_threshold(table=table) == float(crossover)


@pytest.mark.parametrize("case", ["null", "missing", "garbage"])
def test_unusable_table_reads_inf(tmp_path, case):
    path = tmp_path / "t.json"
    if case == "null":
        path = _table(tmp_path, None)
    elif case == "garbage":
        path.write_text("{not json")
    assert tselect.backend_threshold(table=path) == math.inf
    assert jselect.backend_threshold(table=path) == math.inf
    assert not tselect.prefer_sharded(10**6, table=path)


def test_port_has_no_default_table():
    assert tselect.backend_threshold() == math.inf
    assert not tselect.prefer_sharded(10**9)


def test_auto_backend_dense():
    be = tselect.auto_backend(12, dtype=torch.float64, device="cpu")
    assert isinstance(be, DenseBackend)
    assert be.dim == 12 and be.dtype == torch.float64
    assert be.device == torch.device("cpu")
    # A threshold without a mesh stays dense, as in the reference.
    assert isinstance(tselect.auto_backend(12, threshold=4, device="cpu"),
                      DenseBackend)
    assert isinstance(tselect.auto_backend(12, mesh=object(), threshold=64,
                                           device="cpu"), DenseBackend)


def test_sharded_choice_raises_naming_item_15():
    """The choice that raised before the sharded backend was ported now
    places: sharded past the threshold on a mesh, dense below it."""
    from repro_torch.launch.mesh import make_cpu_mesh

    be = tselect.auto_backend(12, mesh=make_cpu_mesh(8), threshold=4,
                              dtype=torch.float64, block_size=4)
    assert be.name == "sharded" and be.dtype == torch.float64
    assert be.block_size == 4
    pool = EnginePool(threshold=4, device="cpu")
    pool.create_tenant("a", dim=12, placement="auto")
    pool.create_tenant("s", dim=12, placement="sharded")
    pool.create_tenant("d", dim=3, placement="auto")   # below the threshold
    assert pool.tenant("d").backend_name == "dense"
    assert [pool.tenant(n).backend_name for n in "as"] == ["sharded"] * 2
    assert pool.meshes_built == 1


def test_auto_backend_picks_by_dim(tmp_path):
    from repro_torch.launch.mesh import make_cpu_mesh

    table = tmp_path / "crossover.json"
    table.write_text('{"crossover_d": 32}')
    mesh = make_cpu_mesh(8)
    for dim, m, want in ((16, mesh, "dense"), (64, mesh, "sharded"),
                         (64, None, "dense")):
        assert tselect.auto_backend(dim, m, table=table, device="cpu").name == want
        jmesh = None
        if m is not None:
            import warnings

            from repro.launch import mesh as jmesh_lib
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                jmesh = jmesh_lib.make_cpu_mesh(8)
        assert jselect.auto_backend(dim, jmesh, table=table).name == want


def test_from_clients_auto(tmp_path):
    from repro_torch import core as tcore
    from repro_torch.server import FusionEngine

    table = tmp_path / "crossover.json"
    table.write_text('{"crossover_d": null}')
    s = tcore.compute_stats(torch.ones((4, 6)), torch.ones((4,)))
    eng = FusionEngine.from_clients({0: s}, backend="auto",
                                    threshold=tselect.backend_threshold(table=table))
    assert eng.summary()["backend"] == "dense"
