"""The port's public surface against the reference's.

Every module of ``src/repro/`` (read by AST, no JAX import) has a module of
the same path in ``src/repro_torch/``, and every public top-level function,
class and upper-case constant of it exists there, unless ``DEVIATIONS``
below names it with the reason it has no counterpart. ``DEVIATIONS`` is the
one list of such names; each entry is also recorded under ROADMAP.md's
"Deviations from the reference, kept on purpose", and an entry whose name
the port has, or the reference lacks, fails as stale. Every example
``examples/<name>.py`` has its port ``examples/<name>_torch.py``; each
package's ``__all__`` covers the reference's; ``data.as_sharded_rows``
cuts the reference's rows bitwise.
"""
import ast
import importlib
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import data as jdata
from repro_torch import convert, data

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

# "module path" (a whole module) or "module path::name" -> why the port has
# no counterpart.
_CONSTRUCTOR = "initialisation is the port module's constructor and reset_parameters"
DEVIATIONS = {
    "kernels/swa_flash.py": "the Pallas kernel K5 and its mask constant; its hand-written "
                            "counterpart is kernels/gram.py::swa_flash_cuda "
                            "(csrc/swa_flash.cu)",
    "kernels/gram.py::gram_moment_pallas": "the Pallas kernel K1; kernels/gram.py::"
                                           "gram_moment_cuda (csrc/gram_moment.cu)",
    "kernels/gram.py::gemm_nt_pallas": "the Pallas kernel K2; kernels/gram.py::gemm_nt_cuda "
                                       "(csrc/gemm_nt.cu)",
    "kernels/gram.py::sketch_gram_pallas": "the Pallas kernel K3; kernels/gram.py::"
                                           "sketch_gram_cuda (csrc/feature_gram.cu)",
    "kernels/gram.py::rff_gram_pallas": "the Pallas kernel K4; kernels/gram.py::rff_gram_cuda "
                                        "(csrc/feature_gram.cu)",
    "launch/dryrun.py::MEM_CHUNK": "the chunk XLA's memory-mode lowering runs at; the port's "
                                   "dry-run never compiles",
    "launch/dryrun.py::build_lowered": "lowers a program with jax.jit; the port's dry-run "
                                       "builds meta tensors",
    "launch/dryrun.py::parse_collectives": "reads collectives from compiled HLO text; the "
                                           "port has no compiler output and counts the "
                                           "same bytes by count_collectives from "
                                           "DTensor's collectives",
    "launch/mesh.py::ICI_LINK_BANDWIDTH": "the TPU v5e's ICI link rate; one H100 has no "
                                          "interconnect in the roofline",
    "launch/roofline.py::CHIPS": "the TPU pod's 256 chips; the port's chip count is the "
                                 "record's mesh",
    "launch/serve.py::enable_compilation_cache": "JAX's persistent compilation cache; the "
                                                 "port compiles no programs",
    "models/attention.py::set_tp_constraints": "JAX sharding-constraint hints for the "
                                               "dry-run's lowering; the port never lowers",
    "models/attention.py::init_attention": _CONSTRUCTOR + " (attention.Attention)",
    "models/blocks.py::init_layer": _CONSTRUCTOR + " (blocks.Layer)",
    "models/blocks.py::init_stage": _CONSTRUCTOR + " (the layers of model.BackboneLM)",
    "models/blocks.py::init_stacked_stages": _CONSTRUCTOR + " (model.BackboneLM; "
                                             "model.stacked_tree rebuilds the stacked layout)",
    "models/layers.py::init_rmsnorm": _CONSTRUCTOR + " (layers.RMSNorm)",
    "models/layers.py::init_mlp": _CONSTRUCTOR + " (layers.MLP)",
    "models/layers.py::init_embedding": _CONSTRUCTOR + " (layers.Embedding)",
    "models/layers.py::init_lm_head": _CONSTRUCTOR + " (layers.LMHead)",
    "models/layers.py::dense_init": "the in-place layers.dense_init_ on a module's weight",
    "models/layers.py::rmsnorm": "the module's forward, layers.RMSNorm",
    "models/layers.py::mlp": "the module's forward, layers.MLP",
    "models/layers.py::embed": "the module's forward, layers.Embedding",
    "models/mamba.py::init_mamba": _CONSTRUCTOR + " (mamba.Mamba)",
    "models/moe.py::init_moe": _CONSTRUCTOR + " (moe.MoE)",
    "models/rwkv6.py::init_rwkv": _CONSTRUCTOR + " (rwkv6.RWKVTimeMix)",
    "models/rwkv6.py::init_channel_mix": _CONSTRUCTOR + " (rwkv6.RWKVChannelMix)",
}

MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))
EXAMPLES = sorted(p.name for p in (ROOT / "examples").glob("*.py")
                  if not p.stem.endswith("_torch"))
PACKAGES = sorted(p.parent.name for p in REF.glob("*/__init__.py") if "__all__" in p.read_text())


def _public(path: Path) -> list[str]:
    """Public top-level functions, classes and upper-case constants."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names += [n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name) and n.id.isupper()]
    return sorted({n for n in names if not n.startswith("_")})


def _all(path: Path) -> list[str]:
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    raise AssertionError(f"{path} has no __all__")


def _port_module(rel: str):
    parts = rel[:-len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join(["repro_torch", *parts]))


def _roadmap_deviations() -> str:
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("**Deviations from the reference, kept on purpose**")
    return text[start:text.index("\n### ", start)]


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_is_ported_or_a_deviation(rel):
    if rel in DEVIATIONS:
        assert not (PORT / rel).exists(), f"{rel} is ported: drop its deviation"
        return
    assert (PORT / rel).exists(), f"src/repro_torch/{rel} is missing"
    module = _port_module(rel)
    missing = [n for n in _public(REF / rel)
               if not hasattr(module, n) and f"{rel}::{n}" not in DEVIATIONS]
    assert not missing, f"{rel}: no counterpart and no deviation for {missing}"


@pytest.mark.parametrize("entry", sorted(DEVIATIONS))
def test_deviation_is_current_and_recorded(entry):
    rel, _, name = entry.partition("::")
    assert (REF / rel).exists(), entry
    if name:
        assert name in _public(REF / rel), f"the reference has no public {entry}"
        assert not hasattr(_port_module(rel), name), f"{entry} is ported: drop it"
    assert DEVIATIONS[entry].strip()
    assert f"`{entry}`" in _roadmap_deviations(), f"ROADMAP.md does not record {entry}"


@pytest.mark.parametrize("name", EXAMPLES)
def test_every_example_has_a_port(name):
    port = ROOT / "examples" / (name[:-len(".py")] + "_torch.py")
    assert port.exists(), f"examples/{name} has no examples/{port.name}"
    text = port.read_text()
    assert "def main(argv=None)" in text and '"--device", default="cuda"' in text


@pytest.mark.parametrize("package", PACKAGES)
def test_package_all_covers_the_reference(package):
    want = _all(REF / package / "__init__.py")
    module = importlib.import_module(f"repro_torch.{package}")
    assert set(want) <= set(getattr(module, "__all__", ())), package
    assert all(hasattr(module, n) for n in want), package


@pytest.mark.parametrize("num_shards", [1, 3, 7, 8, 20])
def test_as_sharded_rows_bitwise(num_shards):
    jds = jdata.generate(jax.random.PRNGKey(2), num_clients=5, samples_per_client=13,
                         dim=6, gamma=0.5)
    ds = convert.dataset_from_numpy(
        [(np.asarray(A), np.asarray(b)) for A, b in jds.clients], np.asarray(jds.test_A),
        np.asarray(jds.test_b), np.asarray(jds.w_star), jds.gamma, device="cpu")
    jA, jb = jdata.as_sharded_rows(jds, num_shards)
    A, b = data.as_sharded_rows(ds, num_shards)
    assert A.shape[0] == (65 // num_shards) * num_shards
    np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
