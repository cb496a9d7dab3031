"""The port's reference-checkpoint import against the TF reference's
recorded runs, on the CPU.

For each of the eight dumps under ``tests/fixtures/reference_dumps`` (real
runs of the original tf2-gnn, see ``tests/test_reference_parity.py``):

* the port's ``map_reference_variables`` gives the JAX importer's paths,
  array-equal, and the same unmatched names (none);
* the port's model, with the dump's weights imported (no variable left
  unmatched either way), meets the parity test's tolerances on its layer
  representations, final representations, task output, loss and every
  gradient (``harness/reference_parity.py``), on the batch without plans
  (the unfused route) and on the plan kind of the flavour's fused route
  (the kernels' plain versions on the CPU), whose route is checked;
* ``read_reference_checkpoint`` reads ``rgcn/ckpt.hdf5`` back to the dumped
  variables, and importing from the file equals importing from the dump.

Also: an unmatched variable and a model parameter the checkpoint leaves
unset are logged, and make ``reference_parity.import_weights`` raise; a
missing h5py raises naming it.
"""
import sys

import numpy as np
import pytest
import torch

from tf2_gnn_tpu.harness import import_reference as jimport
from tf2_gnn_tpu_torch.harness import import_reference as timport
from tf2_gnn_tpu_torch.harness import reference_parity as rp

NAMES = [c[0] for c in rp.CASES]
# The route of layer 0 on each plan kind (RGCN, GGNN and RGIN are forms of
# the edge-MLP family and name its routes).
ROUTES = {"none": "unfused", "per_type": ("pair_joint", "factorised"),
          "merged": "pair_attention"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return tmp_path_factory.mktemp("reference_data")


@pytest.mark.parametrize("name", NAMES)
def test_mapping_matches_jax(name):
    dump = rp.load_dump(name)
    for source in (dump.variables, dump.gradients):
        got, got_unmatched = timport.map_reference_variables(
            source, use_target_state_as_input=dump.use_target_state_as_input,
            log=lambda *_: None)
        want, want_unmatched = jimport.map_reference_variables(
            source, use_target_state_as_input=dump.use_target_state_as_input,
            log=lambda *_: None)
        assert got_unmatched == want_unmatched == []
        assert sorted(got) == sorted(want)
        for path in want:
            assert got[path].dtype == want[path].dtype
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg="/".join(path))


@pytest.mark.parametrize("plans", ["none", "fused"])
@pytest.mark.parametrize("name", NAMES)
def test_port_matches_reference(name, plans, data_root):
    dump = rp.load_dump(name)
    kind = rp.FUSED_PLANS[dump.model] if plans == "fused" else "none"
    model, dataset = rp.build(dump, rp.write_data(dump.task, data_root),
                              kind, "cpu")
    batch, labels = rp.first_batch(dataset)
    rp.check_batch(batch, labels, dump)
    log = rp.import_weights(model, dump)
    assert any(line.startswith("Imported ") for line in log), log
    layer = model.gnn.mp_layer_0
    route = layer._route(batch.to("cpu"))
    expected = ROUTES[kind]
    assert route in (expected if isinstance(expected, tuple)
                     else (expected,)), route
    report = rp.compare(rp.run(model, batch, labels), dump)
    assert all(share <= 1.0 for share, _ in report.values()), report


def test_hdf5_checkpoint_reads_back(tmp_path):
    pytest.importorskip("h5py")
    dump = rp.load_dump("rgcn")
    h5_vars = timport.read_reference_checkpoint(
        rp.DUMPS_DIR / "rgcn" / "ckpt.hdf5")
    h5_vars.pop("training_step:0", None)
    ref_vars = dump.variables
    ref_vars.pop("training_step:0", None)
    assert set(h5_vars) == set(ref_vars)
    for name, value in ref_vars.items():
        np.testing.assert_array_equal(h5_vars[name], value)
    # Importing from the file loads the same weights as from the dump.
    models = []
    for source in (rp.DUMPS_DIR / "rgcn" / "ckpt.hdf5", dump.variables):
        model, _ = rp.build(dump, rp.MOLECULES_DIR, "none", "cpu")
        timport.import_reference_weights(model, source, log=lambda *_: None)
        models.append(model.state_dict())
    assert sorted(models[0]) == sorted(models[1])
    for key in models[0]:
        assert torch.equal(models[0][key], models[1][key]), key


def test_missing_h5py_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="h5py"):
        timport.read_reference_checkpoint(rp.DUMPS_DIR / "rgcn" / "ckpt.hdf5")


def test_unmatched_names_are_logged_and_refused():
    dump = rp.load_dump("rgcn")
    model, _ = rp.build(dump, rp.MOLECULES_DIR, "none", "cpu")
    variables = dict(dump.variables)
    variables["RGCN_GNN/Layer_0/NoSuchThing/kernel:0"] = np.zeros((2, 2))
    dropped = "RGCN_GNN/Layer_0/Dense/kernel:0"
    kept = variables.pop(dropped)
    log = []
    timport.import_reference_weights(model, variables, log=log.append)
    assert ("W: reference variable not mapped: "
            "RGCN_GNN/Layer_0/NoSuchThing/kernel:0") in log
    assert any(line.startswith("W: gnn/dense_0/kernel not in the reference")
               for line in log), log
    # The parameter left unset keeps its initialisation; the rest load.
    assert not torch.equal(model.gnn.dense_0.weight,
                           torch.from_numpy(kept.T.copy()))
    with pytest.raises(AssertionError, match="unmatched"):
        rp.import_weights(model, dump._replace(arrays={
            **{k: v for k, v in dump.arrays.items() if k != "var::" + dropped}
        }))


def test_shape_mismatch_keeps_fresh_weights():
    dump = rp.load_dump("rgcn")
    model, _ = rp.build(dump, rp.MOLECULES_DIR, "none", "cpu")
    before = model.gnn.initial_node_projection.weight.detach().clone()
    variables = dict(dump.variables)
    name = "RGCN_GNN/gnn_initial_node_projection/kernel:0"
    variables[name] = np.zeros((3, 3), np.float32)
    log = []
    timport.import_reference_weights(model, variables, log=log.append)
    assert any("shape mismatch for gnn/initial_node_projection/kernel" in line
               for line in log), log
    assert torch.equal(model.gnn.initial_node_projection.weight, before)
