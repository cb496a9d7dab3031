"""The model options ``gnn_dense_dtype="bfloat16"`` and ``gnn_use_remat``
against the JAX package on the CPU.

* ``TypedLinear(compute_dtype="bfloat16")`` in its three call modes: the
  output against the JAX module's (bf16 operands, f32 accumulation, an f32
  output that is not rounded to bf16), and the input and kernel gradients
  (rounded to bf16 by the casts' transposes in both).
* The flavours that take ``dense_dtype`` (RGCN, GNN_Edge_MLP's target-state
  form, GNN-FiLM on per-type plans, RGAT on a merged plan) with
  ``gnn_dense_dtype="bfloat16"``: logits, loss and every gradient.
* ``use_remat``: at dropout 0 the loss and gradients match the JAX model
  with remat; at input and exchange dropout 0.3 they equal the port's own
  without remat under the same generator seed, bit for bit, and the
  forward kernel wrapper (K2's) runs twice a layer in a train step and
  once in an eval forward.

Tolerances. One ``TypedLinear``: the output rtol 1e-6 / atol 1e-6 (exact
products of bf16 values, f32 sums in other orders); gradients rtol 2**-7
(each rounded to bf16 from f32 sums in other orders, so one may land on
the neighbouring bf16 value, 2**-8 relative). Whole models: an activation
that differs from JAX's in its last f32 bits may round to the neighbouring
bf16 operand in the next layer's product and carry that downstream, so
logits and each gradient are held to ``BF16_SHARE`` = 2**-7 of their
largest |entry| and the loss to rtol 1e-3 (observed: gradients at most
1.1e-3 of their largest |entry|, logits 5.5e-5, the loss 2.0e-7
relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.layers.message_passing.typed_linear import (
    TypedLinear as JaxTypedLinear,
)
from tf2_gnn_tpu.models.node_multiclass_task import (
    NodeMulticlassTask as JaxNodeMulticlassTask,
)
from tf2_gnn_tpu_torch.harness.import_jax import flax_params_to_state_dict
from tf2_gnn_tpu_torch.layers.message_passing.typed_linear import TypedLinear
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.ops import pair_spmm as tps

from .test_torch_flavours import build_pair, case_params
from .test_torch_rgcn_model import (
    FEATURES,
    NUM_LABELS,
    check_matches_jax,
    make_params,
    small_workload,
)

BF16_SHARE = 2.0 ** -7
LOSS_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and these small ops then run
    many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", ["all_types", "per_type", "one_type"])
def test_bf16_typed_linear_matches_jax(mode):
    rng = np.random.RandomState(0)
    num_types, d, h = 3, 40, 24
    shape = {"all_types": (50, d), "per_type": (num_types, 50, d),
             "one_type": (50, d)}[mode]
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*((num_types, 50, h) if mode != "one_type"
                    else (50, h))).astype(np.float32)
    edge_type = 1 if mode == "one_type" else None
    jmod = JaxTypedLinear(num_types, d, h, compute_dtype="bfloat16")
    jparams = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), edge_type)

    def jout(p, xx):
        return jmod.apply(p, xx, edge_type)

    jy, vjp = jax.vjp(jout, jparams, jnp.asarray(x))
    jgrad_params, jgrad_x = vjp(jnp.asarray(g))

    mod = TypedLinear(num_types, d, h, compute_dtype="bfloat16")
    with torch.no_grad():
        mod.kernel.copy_(torch.tensor(
            np.asarray(jparams["params"]["kernel"])))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = mod(xt, edge_type=edge_type)
    y.backward(torch.from_numpy(g))

    assert y.dtype == torch.float32 and np.asarray(jy).dtype == np.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-6, atol=1e-6)
    # The output keeps its f32 bits: it is not the bf16-rounded product.
    assert not torch.equal(y, y.to(torch.bfloat16).to(torch.float32))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad_x),
                               rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(mod.kernel.grad.numpy(),
                               np.asarray(jgrad_params["params"]["kernel"]),
                               rtol=2.0 ** -7, atol=1e-6)


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        TypedLinear(2, 3, 4, compute_dtype="int8")


# The flavours whose TypedLinear products take dense_dtype (RGCN, RGAT, or
# a case of test_torch_flavours.py), each with its batch's plan kind.
DENSE_CASES = {
    "rgcn": {},
    "edge_mlp_target_0": {},
    "film_target": {},
    "rgat": dict(merged=True),
}


def dense_params(name: str):
    if name == "rgcn":
        params = make_params("ppi", "float32")
    elif name == "rgat":
        params = JaxNodeMulticlassTask.get_default_hyperparameters("rgat")
        params.update({"gnn_hidden_dim": 24, "gnn_num_heads": 4,
                       "gnn_num_layers": 2,
                       "gnn_layer_input_dropout_rate": 0.0,
                       "gnn_global_exchange_every_num_layers": 10000})
    else:
        params = case_params(name)
    params.update({"gnn_dense_dtype": "bfloat16",
                   "gnn_edge_dtype": "float32"})
    return params


def assert_share_close(got, want, what: str):
    err, largest = np.abs(got - want).max(), np.abs(want).max()
    assert err <= BF16_SHARE * largest, (what, err, largest)


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_bf16_dense_flavours_match_jax(case):
    params = dense_params(case)
    jbatch, tbatch, labels = small_workload(seed=8, **DENSE_CASES[case])
    jmodel, jparams, tmodel = build_pair(params, jbatch)
    assert all(m.operand_dtype == torch.bfloat16 for m in tmodel.modules()
               if isinstance(m, TypedLinear))

    def jloss(p):
        out = jmodel.apply({"params": p}, jbatch, False)
        metrics = jmodel.compute_task_metrics(
            jbatch, out, {"node_labels": jnp.asarray(labels)})
        return metrics["loss"], out[0]

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    out = tmodel(tbatch, False)
    loss = tmodel.compute_task_metrics(
        tbatch, out, {"node_labels": torch.from_numpy(labels)})["loss"]
    loss.backward()
    assert_share_close(out[0].detach().numpy(), np.asarray(jlogits), "logits")
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, grad in want.items():
        assert_share_close(got[name].grad.numpy(), grad.numpy(), name)


def test_remat_matches_jax():
    """Dropout 0: the port with remat against the JAX model with remat,
    at the f32 tolerances of ``test_torch_rgcn_model.py``."""
    jbatch, tbatch, labels = small_workload(seed=9)
    params = make_params("residual_dense_layernorm", "float32")
    params["gnn_use_remat"] = True
    tmodel = check_matches_jax(params, jbatch, tbatch, labels)
    assert tmodel.gnn.use_remat


def _counting(monkeypatch, name: str):
    calls = []
    original = getattr(tps, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return original(*args, **kwargs)

    monkeypatch.setattr(tps, name, counted)
    return calls


def test_remat_with_dropout_matches_the_port_without_remat(monkeypatch):
    """Input and exchange dropout 0.3: a train-mode loss and its gradients
    with remat equal those without under the same generator seed (the
    recompute draws no masks); K2's wrapper runs twice a layer, K1's once."""
    _, tbatch, labels = small_workload(seed=10)
    params = make_params("residual_dense_layernorm", "bfloat16")
    params.update({"gnn_layer_input_dropout_rate": 0.3,
                   "gnn_global_exchange_every_num_layers": 2,
                   "gnn_global_exchange_dropout_rate": 0.3})
    forward = _counting(monkeypatch, "pair_spmm_stream_joint")
    backward = _counting(monkeypatch, "pair_spmm_stream")
    results = []
    for remat in (False, True):
        model = NodeMulticlassTask.from_params(
            dict(params, gnn_use_remat=remat), input_dim=FEATURES,
            num_edge_types=3, device="cpu", seed=4, num_labels=NUM_LABELS)
        forward.clear()
        backward.clear()
        generator = torch.Generator().manual_seed(7)
        out = model(tbatch, True, generator)
        loss = model.compute_task_metrics(
            tbatch, out, {"node_labels": torch.from_numpy(labels)})["loss"]
        loss.backward()
        layers = params["gnn_num_layers"]
        assert (len(forward), len(backward)) == (
            (2 if remat else 1) * layers, layers)
        results.append((float(loss.detach()), {n: p.grad.clone()
                                      for n, p in model.named_parameters()}))
        forward.clear()
        with torch.no_grad():
            model(tbatch, False)
        assert len(forward) == layers
    (loss_plain, grads_plain), (loss_remat, grads_remat) = results
    assert loss_remat == loss_plain
    for name, grad in grads_plain.items():
        assert torch.equal(grads_remat[name], grad), name
