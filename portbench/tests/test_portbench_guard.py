"""The import guard compares whole top-level names; the reference loads
nothing of the program, and the harness nothing of JAX."""
import subprocess
import sys
from pathlib import Path

from portbench.harness import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_by_whole_top_level_name():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "tf2_gnn_tpu", "tf2_gnn_tpu.ops.pair_spmm", "tf2_gnn_tpu_torch",
             "tf2_gnn_tpu_torch.ops", "jaxtyping", "flaxen", "numpy"]
    assert forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "tf2_gnn_tpu", "tf2_gnn_tpu.ops.pair_spmm"]


def loaded_after(statement: str):
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {statement}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program_or_jax():
    loaded = loaded_after("import portbench.reference.rgcn, "
                          "portbench.check, portbench.generator")
    assert not loaded & {"tf2_gnn_tpu_torch", "tf2_gnn_tpu", "jax",
                         "jaxlib", "flax"}


def test_harness_and_program_load_no_jax():
    loaded = loaded_after("import portbench.harness, portbench.system, "
                          "portbench.trace")
    assert "tf2_gnn_tpu_torch" in loaded
    assert not loaded & {"tf2_gnn_tpu", "jax", "jaxlib", "flax"}
