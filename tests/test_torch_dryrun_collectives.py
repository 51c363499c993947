"""The dry-run's collective bytes (``launch/dryrun.py``) against XLA's.

- Four hand-reckoned programs on a (4, 2) ``data, model`` mesh: the port's
  ``count_collectives`` over DTensor's program on a fake process group
  against the reference's ``parse_collectives`` over the same program
  compiled by ``jax.jit`` with in / out shardings on 8 host devices (a child
  process, as tests/test_distributed.py runs it): a column-parallel product
  (nothing moves), a row-parallel product reduced into rows (one all-reduce
  of the (rows / 4, d) block), an FSDP-sharded weight gathered for a
  product (an all-gather of the weight), the gradient of a data-parallel
  weight (an all-reduce). Bytes equal as integers, by kind.
- Reduced yi-9b's train and prefill steps (2 stages, B 2, S 256) on that
  mesh, through ``tools/dryrun_vs_xla.py`` (which shows every config's):
  both totals nonzero and within a factor of 2 of XLA's (the ratios are
  in PERF.md §6).
- The counter's hygiene: a collective's carriers (``wait_tensor``,
  ``_wrap_tensor_autograd``) are not counted, an unknown collective raises,
  an op DTensor cannot run sharded runs replicated and is listed, a select
  along a sharded dim moves only its slice, and the fake process group is
  gone after a success and after an error.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.sharding import P

ROOT = Path(__file__).resolve().parents[1]
MESH = mesh_lib.make_mesh((4, 2), ("data", "model"), device="meta")
ROWS, D, N = 1024, 64, 128

# (argument shapes and specs, output specs) of each hand-reckoned program
PROGRAMS = {
    "column_parallel": ([((ROWS, D), P()), ((D, N), P(None, "model"))],
                        [P(None, "model")]),
    "row_parallel": ([((ROWS, D), P("data", "model")), ((D, N), P("model", None))],
                     [P("data", None)]),
    "fsdp_gather": ([((ROWS, D), P("data", None)), ((D, N), P("model", None))],
                    [P("data", None)]),
    "data_parallel_grad": ([((ROWS, D), P("data", None)), ((D, N), P())], [P()]),
}

_CHILD = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
jax.devices()                      # 8 devices, before the dry-run sets its flag
from repro.launch import dryrun

mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
ROWS, D, N = %d, %d, %d

def coll(fn, args, outs):
    f = jax.jit(fn, in_shardings=tuple(NamedSharding(mesh, s) for _, s in args),
                out_shardings=tuple(NamedSharding(mesh, s) for s in outs))
    lowered = f.lower(*[jax.ShapeDtypeStruct(shape, jnp.float32) for shape, _ in args])
    return dryrun.parse_collectives(lowered.compile().as_text())

def grad(x, w):
    return (jax.grad(lambda w: jnp.sum(x @ w))(w),)

out = {
    "column_parallel": coll(lambda x, w: (x @ w,), [((ROWS, D), P()), ((D, N), P(None, "model"))],
                            [P(None, "model")]),
    "row_parallel": coll(lambda x, w: (x @ w,), [((ROWS, D), P("data", "model")),
                                                 ((D, N), P("model", None))], [P("data", None)]),
    "fsdp_gather": coll(lambda x, w: (x @ w,), [((ROWS, D), P("data", None)),
                                                ((D, N), P("model", None))], [P("data", None)]),
    "data_parallel_grad": coll(grad, [((ROWS, D), P("data", None)), ((D, N), P())], [P()]),
}
print("XLA-COLLECTIVES " + json.dumps(out))
""" % (ROWS, D, N)


@pytest.fixture(scope="module")
def xla():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _CHILD], env=env, capture_output=True,
                         text=True, timeout=600)
    line = [l for l in run.stdout.splitlines() if l.startswith("XLA-COLLECTIVES ")]
    assert run.returncode == 0 and line, run.stdout[-2000:] + run.stderr[-4000:]
    return json.loads(line[0][len("XLA-COLLECTIVES "):])


def port_program(name: str) -> dict:
    """The port's collective bytes of ``PROGRAMS[name]``: DTensor's program
    on the fake (4, 2) mesh, its outputs laid out by the output specs."""
    args, outs = PROGRAMS[name]
    with dryrun.fake_mesh(MESH) as dm:
        x, w = (dryrun.meta_dtensor(torch.empty(shape, device="meta"), dm,
                                    dryrun.placements_of(spec, MESH)) for shape, spec in args)
        counter = dryrun.count_collectives()
        with counter:
            if name == "data_parallel_grad":
                w.requires_grad_(True)
                y = (torch.autograd.grad((x @ w).sum(), w)[0],)
            else:
                y = (x @ w,)
            for t, spec in zip(y, outs):
                t.redistribute(dm, dryrun.placements_of(spec, MESH))
    return counter.result()


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_hand_reckoned_programs_match_xla(name, xla):
    """Equal bytes by kind, as integers; the reckoning: a column-parallel
    product moves nothing; a row-parallel one all-reduces each (rows / 4,
    N) block over the model axis; an FSDP weight sharded over the model
    axis is all-gathered whole (D x N) rather than the product reduced; a
    data-parallel weight's gradient is all-reduced whole (D x N)."""
    port = port_program(name)
    want = {"column_parallel": {"total": 0},
            "row_parallel": {"all-reduce": ROWS // 4 * N * 4},
            "fsdp_gather": {"all-gather": D * N * 4},
            "data_parallel_grad": {"all-reduce": D * N * 4}}[name]
    want = {**want, "total": sum(v for k, v in want.items() if k != "total")}
    assert port == want
    assert xla[name] == want


def _vs_xla():
    """``tools/dryrun_vs_xla.py``, the one place the reduced configs are
    compiled by the reference and counted by the port."""
    spec = importlib.util.spec_from_file_location("dryrun_vs_xla",
                                                  ROOT / "tools" / "dryrun_vs_xla.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def xla_yi():
    return _vs_xla().xla_collectives(["yi-9b:train", "yi-9b:prefill"])


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_reduced_yi_within_a_factor_of_two(kind, xla_yi):
    """Reduced yi-9b (2 stages, B 2, S 256) on the (4, 2) mesh: the port's
    total within a factor of 2 of XLA's, both nonzero."""
    port, replicated = _vs_xla().port_collectives(f"yi-9b:{kind}")
    ref = xla_yi[f"yi-9b:{kind}"]
    print(f"\nyi-9b {kind}: port {port}, XLA {ref}, ratio {port['total'] / ref['total']:.3f}, "
          f"replicated {replicated}")
    assert port["total"] > 0 and ref["total"] > 0
    assert 0.5 <= port["total"] / ref["total"] <= 2.0
    assert set(port) <= {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                         "collective-permute", "total"}
    assert not dist.is_initialized()


def test_carriers_are_not_counted():
    """A partial sum redistributed to replicated is one all-reduce of its
    local block, counted once: its ``wait_tensor`` and
    ``_wrap_tensor_autograd`` pass through the counter uncounted."""
    seen = []
    local = dryrun.count_collectives._local

    def spy(self, func, args, kwargs):
        seen.append(str(func))
        return local(self, func, args, kwargs)

    with dryrun.fake_mesh(MESH) as dm:
        x = DTensor.from_local(torch.empty(4, 256, device="meta"), dm,
                               [Replicate(), Partial()], run_check=False)
        counter = dryrun.count_collectives()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dryrun.count_collectives, "_local", spy)
            with counter:
                x.redistribute(dm, [Replicate(), Replicate()])
    assert counter.result() == {"all-reduce": 4096, "total": 4096}
    assert "_c10d_functional.all_reduce.default" in seen
    assert {"_c10d_functional.wait_tensor.default",
            "_c10d_functional._wrap_tensor_autograd.default"} & set(seen)
    assert not dist.is_initialized()


def test_unknown_collective_raises():
    with dryrun.fake_mesh(MESH) as dm:
        group = dm.get_group("data").group_name
        with dryrun.count_collectives(), pytest.raises(NotImplementedError, match="no kind"):
            torch.ops._c10d_functional.broadcast(torch.empty(8, device="meta"), 0, group)
    assert not dist.is_initialized()


def test_op_without_a_sharding_rule_runs_replicated():
    """``aten.renorm`` on a row-sharded DTensor: DTensor has no sharding
    strategy for it, so the counter replicates the operand (an all-gather
    of its rows, counted) and lists the op."""
    with dryrun.fake_mesh(MESH) as dm:
        a = dryrun.meta_dtensor(torch.empty(64, 64, device="meta"), dm,
                                [Shard(0), Replicate()])
        counter = dryrun.count_collectives()
        with counter:
            out = torch.renorm(a, 2, 0, 1.0)
    assert isinstance(out, DTensor) and out.shape == (64, 64)
    assert counter.replicated_ops == {"aten.renorm.default": 1}
    assert counter.result() == {"all-gather": 64 * 64 * 4, "total": 64 * 64 * 4}


def test_fake_group_destroyed_after_success_and_error():
    with dryrun.fake_mesh(MESH) as dm:
        assert dist.is_initialized() and dist.get_world_size() == 8
        assert dm.mesh_dim_names == ("data", "model") and tuple(dm.shape) == (4, 2)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="inside"):
        with dryrun.fake_mesh(MESH):
            raise ValueError("inside")
    assert not dist.is_initialized()
    pod2 = dryrun.make_named_mesh("pod2")
    with dryrun.fake_mesh(pod2) as dm:
        assert dm.mesh_dim_names == ("pod", "data", "model") and dist.get_world_size() == 512
    assert not dist.is_initialized()


def test_an_initialised_group_is_refused():
    with dryrun.fake_mesh(MESH):
        with pytest.raises(RuntimeError, match="initialised already"):
            with dryrun.fake_mesh(MESH):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()


def test_select_along_a_sharded_dim_moves_the_slice():
    """``t[j]`` along a dim sharded over ``data``: the slice goes from its
    shard to the others (an all-gather of the slice's bytes), the other
    dims keep their layout; DTensor alone would gather the whole tensor."""
    with dryrun.fake_mesh(MESH) as dm:
        t = dryrun.meta_dtensor(torch.empty(64, 8, 32, device="meta"), dm,
                                [Shard(0), Shard(2)])
        counter = dryrun.count_collectives()
        with counter:
            out = t[5]
    assert isinstance(out, DTensor) and out.shape == (8, 32)
    assert tuple(out.placements) == (Replicate(), Shard(1))
    assert counter.result() == {"all-gather": 8 * 16 * 4, "total": 8 * 16 * 4}
