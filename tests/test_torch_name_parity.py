"""Name-level parity of the PyTorch port with the JAX package.

Every public name of ``tf2_gnn_tpu`` has a counterpart in
``tf2_gnn_tpu_torch`` at the same module path, or stands in
``COUNTERPARTS`` (ported under another name or module) or in
``NOT_PORTED`` (with the reason it has none). Both sides are read with
``ast``; nothing of either package is imported.

The public names of a module are its module-level functions and classes
whose names do not start with ``_``, its UPPER-case module-level
constants, and each class's public methods (properties included) and
plain class-level assignments. A class's annotated fields are left out:
they are its constructor's parameters (flax module fields, a
``TrainState``'s leaves), which the port takes as a hyperparameter dict
or holds in its own state. In the port a name counts when its module
defines it or imports it, a member when its class defines it.

Neither map may go stale: each entry names a public name of the JAX
package that has no counterpart at the same path, and each counterpart
exists in the port.
"""
import ast
import re
from pathlib import Path
from typing import Dict, Set

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "tf2_gnn_tpu"
PORT_ROOT = REPO / "tf2_gnn_tpu_torch"

# JAX name -> the port's name for it. A key without "::" is a module.
COUNTERPARTS = {
    "ops/spmm_pallas.py": "ops/sorted_spmm.py",
    "ops/pair_spmm.py::pair_stream_from_typed":
        "ops/pair_spmm.py::stream_typed_plan",
    "ops/pair_spmm.py::pair_stream_gather_scatter":
        "ops/pair_spmm.py::PairStreamTyped",
    "ops/spmm_pallas.py::PlanView": "ops/sorted_spmm.py::ScatterPlan",
}

_VMEM_GATE = ("a TPU VMEM gate of the pair kernels; the port routes by "
              "plan form (ROADMAP queue C, routing by decision)")
NOT_PORTED = {
    "harness/training.py::init_model":
        "flax's init; the port's reset_parameters(generator) does its job",
    "ops/pair_spmm.py::pair_kernel_applicable": _VMEM_GATE,
    "ops/pair_spmm.py::pair_stream_joint_applicable": _VMEM_GATE,
    "ops/pair_spmm.py::pair_kernel_table_bytes": _VMEM_GATE,
    "ops/pair_spmm.py::JOINT_WINDOW_BUDGET_BYTES": _VMEM_GATE,
    "ops/pair_spmm.py::VMEM_TABLE_BUDGET_BYTES": _VMEM_GATE,
    "ops/pair_attention.py::SCORE_BUDGET_BYTES": _VMEM_GATE,
    "ops/pair_attention.py::TABLE_BUDGET_BYTES": _VMEM_GATE,
    "ops/pair_attention.py::RESIDENT_BUDGET_BYTES": _VMEM_GATE,
    "ops/pair_attention.py::EXACT":
        "jax.lax.Precision.HIGHEST, a TPU matmul precision",
}

MODULES = {k: v for k, v in COUNTERPARTS.items() if "::" not in k}
UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")


def _assigned(node) -> Set[str]:
    """Names bound by a plain assignment statement."""
    if not isinstance(node, ast.Assign):
        return set()
    return {t.id for t in node.targets if isinstance(t, ast.Name)}


def public_names(source: str) -> Set[str]:
    """The public names of a JAX module (see the module docstring), a
    class's members as ``Class.member``."""
    names = set()
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    members = _assigned(item)
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        members = {item.name}
                    names.update(f"{node.name}.{m}" for m in members
                                 if not m.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (_assigned(node) if isinstance(node, ast.Assign)
                       else {getattr(node.target, "id", "")})
            names.update(n for n in targets if UPPER.match(n))
    return names


def defined_names(source: str) -> Set[str]:
    """Every name a port module binds at module level (definitions,
    assignments, imports) and every member its classes define, the latter
    as ``Class.member``."""
    names = set()
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    names.add(f"{node.name}.{item.name}")
                elif isinstance(item, ast.AnnAssign) and isinstance(
                        item.target, ast.Name):
                    names.add(f"{node.name}.{item.target.id}")
                names.update(f"{node.name}.{m}" for m in _assigned(item))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        names.update(_assigned(node))
    return names


def missing_names(jax_root: Path, port_root: Path,
                  modules: Dict[str, str]) -> Dict[str, str]:
    """``{"module::name": port module}`` for each public name of the JAX
    tree without a counterpart at its path in the port tree (``modules``
    maps renamed modules); ``"module"`` alone for a JAX module with public
    names and no port module."""
    missing = {}
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        wanted = public_names(path.read_text())
        port_rel = modules.get(rel, rel)
        port_path = port_root / port_rel
        if not port_path.is_file():
            if wanted:
                missing[rel] = port_rel
            continue
        have = defined_names(port_path.read_text())
        missing.update({f"{rel}::{name}": port_rel
                        for name in sorted(wanted - have)})
    return missing


JAX_MODULES = sorted(p.relative_to(JAX_ROOT).as_posix()
                     for p in JAX_ROOT.rglob("*.py"))


@pytest.fixture(scope="module")
def missing():
    return missing_names(JAX_ROOT, PORT_ROOT, MODULES)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module, missing):
    unaccounted = sorted(
        key for key in missing
        if key.split("::")[0] == module
        and key not in COUNTERPARTS and key not in NOT_PORTED)
    assert not unaccounted, (
        f"public names of tf2_gnn_tpu/{module} without a counterpart in "
        f"tf2_gnn_tpu_torch (port them, or list them in COUNTERPARTS or "
        f"NOT_PORTED): {unaccounted}")


@pytest.mark.parametrize("key", sorted(COUNTERPARTS) + sorted(NOT_PORTED))
def test_no_stale_entry_on_the_jax_side(key, missing):
    """Each entry names a JAX module or public name that exists and that
    has no counterpart under its own path and name in the port."""
    module, _, name = key.partition("::")
    source = JAX_ROOT / module
    assert source.is_file(), f"{key}: no such JAX module"
    if name:
        assert name in public_names(source.read_text()), (
            f"{key}: no such public name in the JAX package")
        assert key in missing, (
            f"{key}: the port has it under its own name; drop the entry")
    else:
        assert not (PORT_ROOT / module).is_file(), (
            f"{key}: the port has this module; drop the entry")


@pytest.mark.parametrize("key", sorted(COUNTERPARTS))
def test_no_stale_entry_on_the_port_side(key):
    """Each counterpart exists in the port."""
    module, _, name = COUNTERPARTS[key].partition("::")
    target = PORT_ROOT / module
    assert target.is_file(), f"{key}: no port module {module}"
    if name:
        assert name in defined_names(target.read_text()), (
            f"{key}: tf2_gnn_tpu_torch/{module} has no {name}")


def test_not_ported_entries_give_a_reason():
    assert all(reason.strip() for reason in NOT_PORTED.values())
    assert not set(COUNTERPARTS) & set(NOT_PORTED)


def test_checker_reports_what_is_missing(tmp_path):
    """The checker itself on two small trees: a missing function,
    method, property, class-level name and UPPER constant are reported; a
    private name, a lower-case module variable and an annotated field are
    not; an import or a renamed module counts as a counterpart."""
    (tmp_path / "jax" / "sub").mkdir(parents=True)
    (tmp_path / "port" / "sub").mkdir(parents=True)
    (tmp_path / "jax" / "sub" / "a.py").write_text(
        "import numpy as np\n"
        "LIMIT = 4\n"
        "cache = {}\n"
        "def helper(): pass\n"
        "def gone(): pass\n"
        "def _private(): pass\n"
        "class Box:\n"
        "    size: int\n"
        "    KIND = 'box'\n"
        "    def __init__(self): pass\n"
        "    def open(self): pass\n"
        "    @property\n"
        "    def width(self): return 1\n")
    (tmp_path / "port" / "sub" / "a.py").write_text(
        "from .b import helper\n"
        "class Box:\n"
        "    def open(self): pass\n")
    (tmp_path / "jax" / "old.py").write_text("def kept(): pass\n")
    (tmp_path / "port" / "new.py").write_text("def kept(): pass\n")
    (tmp_path / "jax" / "lost.py").write_text("def lost(): pass\n")
    (tmp_path / "jax" / "empty.py").write_text("import os\n")
    got = missing_names(tmp_path / "jax", tmp_path / "port",
                        {"old.py": "new.py"})
    assert got == {
        "sub/a.py::LIMIT": "sub/a.py", "sub/a.py::gone": "sub/a.py",
        "sub/a.py::Box.KIND": "sub/a.py", "sub/a.py::Box.width": "sub/a.py",
        "lost.py": "lost.py"}


def test_the_ported_helpers_are_seen():
    """The names this guard was written to close are collected on the JAX
    side and resolve in the port."""
    for module, name in [
            ("data/io.py", "make_staging_resolver"),
            ("data/graph_batch.py", "GraphBatch.pad_node_index"),
            ("data/graph_batch.py", "GraphBatch.edge_mask"),
            ("data/graph_dataset.py", "GraphDataset.num_batches"),
            ("harness/run.py", "set_seeds"),
            ("models/graph_task_model.py",
             "GraphTaskModel.compute_initial_node_features"),
            ("ops/pair_spmm.py", "pair_chunk_budget"),
            ("ops/pair_spmm.py", "pair_slot_abs_ids"),
            ("ops/pair_spmm.py", "pair_normalisation_scales")]:
        assert name in public_names((JAX_ROOT / module).read_text())
        assert name in defined_names((PORT_ROOT / module).read_text())
