"""The port's global-exchange stack against the JAX package's on the CPU:
the segment ops it uses (``ops/segment.py``), the MLP, the Keras-layout GRU
cell, the WeightedSum readout in its four weightings and the three exchange
modes, each from weights bridged out of the flax params (which also holds
the bridge's GRU and readout leaves). Outputs and gradients, in f32, at
rtol 1e-5 / atol 1e-6: the same f32 arithmetic in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_gnn_tpu.layers import global_exchange as jge
from tf2_gnn_tpu.layers.mlp import MLP as JaxMLP
from tf2_gnn_tpu.layers.readout import (
    WeightedSumGraphRepresentation as JaxWeightedSum,
)
from tf2_gnn_tpu.ops import gru as jgru
from tf2_gnn_tpu.ops import segment as jseg
from tf2_gnn_tpu_torch.harness.import_jax import flax_params_to_state_dict
from tf2_gnn_tpu_torch.layers import global_exchange as tge
from tf2_gnn_tpu_torch.layers.mlp import MLP
from tf2_gnn_tpu_torch.layers.readout import WeightedSumGraphRepresentation
from tf2_gnn_tpu_torch.ops import gru as tgru
from tf2_gnn_tpu_torch.ops import segment as tseg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and small ops then run many
    times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=1e-5, atol=1e-6)


def graph_ids(rng, num_nodes: int, num_graphs: int):
    """Sorted node-to-graph ids; the last graph slot stays empty."""
    return np.sort(rng.randint(0, num_graphs - 1, num_nodes)).astype(np.int32)


def bridged(jmodule, tmodule, *args):
    """Init the flax module on ``args`` (numpy) and copy its params into
    the port's module; returns the flax params."""
    params = jmodule.init(jax.random.PRNGKey(0),
                          *(jnp.asarray(a) if isinstance(a, np.ndarray)
                            else a for a in args))["params"]
    tmodule.load_state_dict(flax_params_to_state_dict(
        jax.device_get(params)), strict=True)
    return params


def assert_grads_match(tmodule, jgrads):
    want = flax_params_to_state_dict(jax.device_get(jgrads))
    got = dict(tmodule.named_parameters())
    assert set(got) == set(want)
    for name, param in got.items():
        np.testing.assert_allclose(param.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("heads", [None, 3])
def test_segment_softmax_and_max_match_jax(heads):
    rng = np.random.RandomState(0)
    shape = (50,) if heads is None else (50, heads)
    logits = (3.0 * rng.randn(*shape)).astype(np.float32)
    ids = graph_ids(rng, 50, 6)
    cot = rng.randn(*shape).astype(np.float32)

    def jfn(x):
        out = jseg.segment_softmax(x, jnp.asarray(ids), 6)
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, want), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tseg.segment_softmax(x, torch.from_numpy(ids), 6)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **TOL)
    np.testing.assert_allclose(
        tseg.segment_logits_max(torch.from_numpy(logits),
                                torch.from_numpy(ids), 6).numpy(),
        np.asarray(jseg.segment_logits_max(jnp.asarray(logits),
                                           jnp.asarray(ids), 6)), **TOL)


def test_segment_sum_and_mean_match_jax():
    rng = np.random.RandomState(1)
    data = rng.randn(40, 5).astype(np.float32)
    ids = graph_ids(rng, 40, 7)
    ids[3] = 9  # out of range: dropped
    for tfn, jfn in ((tseg.segment_sum, jseg.segment_sum),
                     (tseg.segment_mean, jseg.segment_mean)):
        np.testing.assert_allclose(
            tfn(torch.from_numpy(data), torch.from_numpy(ids), 7).numpy(),
            np.asarray(jfn(jnp.asarray(data), jnp.asarray(ids), 7)), **TOL)


def test_gather_rows_clips_and_drops_out_of_range_gradients():
    rng = np.random.RandomState(2)
    params = rng.randn(6, 4).astype(np.float32)
    idx = np.array([0, 5, 2, 6, 7, 2, 1], np.int32)  # 6 and 7 clip to 5
    cot = rng.randn(7, 4).astype(np.float32)

    def jfn(p):
        out = jseg.gather_rows(p, jnp.asarray(idx))
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, want), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(params))
    p = torch.from_numpy(params).requires_grad_(True)
    got = tseg.gather_rows(p, torch.from_numpy(idx))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("hidden_layers,use_biases,activation", [
    (1, False, "relu"), ((7, 5), True, "elu"), (0, True, "tanh")])
def test_mlp_matches_jax(hidden_layers, use_biases, activation):
    rng = np.random.RandomState(3)
    x = rng.randn(20, 6).astype(np.float32)
    cot = rng.randn(20, 4).astype(np.float32)
    jmlp = JaxMLP(out_size=4, hidden_layers=hidden_layers,
                  use_biases=use_biases, activation=activation)
    mlp = MLP(6, 4, hidden_layers=hidden_layers, use_biases=use_biases,
              activation=activation)
    params = bridged(jmlp, mlp, x)

    def jfn(p):
        out = jmlp.apply({"params": p}, jnp.asarray(x))
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, want), jgrads = jax.value_and_grad(jfn, has_aux=True)(params)
    got = mlp(torch.from_numpy(x))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert_grads_match(mlp, jgrads)


def test_mlp_dropout_needs_a_generator_and_scales_kept_entries():
    mlp = MLP(6, 6, hidden_layers=1, dropout_rate=0.5)
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(50, 6)
    with pytest.raises(ValueError, match="torch.Generator"):
        mlp(x, True)
    gen = torch.Generator().manual_seed(1)
    hidden = torch.relu(mlp.hidden_0(x))
    out = mlp(x, True, gen)
    keep = torch.rand(hidden.shape,
                      generator=torch.Generator().manual_seed(1)) < 0.5
    want = mlp.out(torch.where(keep, hidden / 0.5, torch.zeros_like(hidden)))
    torch.testing.assert_close(out, want)
    torch.testing.assert_close(mlp(x, False), mlp.out(hidden))


def test_gru_cell_matches_jax_and_keeps_the_flax_layout():
    rng = np.random.RandomState(4)
    inputs = rng.randn(30, 6).astype(np.float32)
    state = rng.randn(30, 8).astype(np.float32)
    cot = rng.randn(30, 8).astype(np.float32)
    jcell = jgru.GRUCell(hidden_dim=8)
    cell = tgru.GRUCell(6, 8)
    params = jcell.init(jax.random.PRNGKey(0), jnp.asarray(inputs),
                        jnp.asarray(state))["params"]
    # Non-zero biases, so the test sees where each one enters.
    params = {**params,
              "input_bias": jnp.asarray(rng.randn(24).astype(np.float32)),
              "recurrent_bias": jnp.asarray(rng.randn(24).astype(np.float32))}
    state_dict = flax_params_to_state_dict({"gru_cell": params})
    assert tuple(state_dict["gru_cell.kernel"].shape) == (6, 24)
    np.testing.assert_array_equal(state_dict["gru_cell.kernel"].numpy(),
                                  np.asarray(params["kernel"]))
    cell.load_state_dict({k.split(".", 1)[1]: v
                          for k, v in state_dict.items()})

    def jfn(p, x, h):
        out = jcell.apply({"params": p}, x, h)
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, want), (jgrads, jdx, jdh) = jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True)(
            params, jnp.asarray(inputs), jnp.asarray(state))
    x = torch.from_numpy(inputs).requires_grad_(True)
    h = torch.from_numpy(state).requires_grad_(True)
    got = cell(x, h)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jdh), **TOL)
    for name, param in cell.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(),
                                   np.asarray(jgrads[name]), err_msg=name,
                                   **TOL)


def test_gru_cell_init_is_orthogonal_recurrent_and_zero_biases():
    cell = tgru.GRUCell(6, 8)
    cell.reset_parameters(torch.Generator().manual_seed(0))
    rec = cell.recurrent_kernel.detach()
    torch.testing.assert_close(rec @ rec.T, torch.eye(8), rtol=1e-5,
                               atol=1e-5)
    assert not cell.input_bias.detach().any()
    assert not cell.recurrent_bias.detach().any()
    assert float(cell.kernel.detach().abs().max()) <= (6.0 / (6 + 24)) ** 0.5


@pytest.mark.parametrize("weighting", ["none", "average", "softmax",
                                       "sigmoid"])
def test_weighted_sum_readout_matches_jax(weighting):
    rng = np.random.RandomState(5)
    nodes = rng.randn(60, 12).astype(np.float32)
    ids = graph_ids(rng, 60, 5)
    cot = rng.randn(5, 8).astype(np.float32)
    kwargs = dict(num_heads=4, weighting_fun=weighting,
                  scoring_mlp_layers=(10,), transformation_mlp_layers=(9,),
                  transformation_mlp_result_lower_bound=-0.5,
                  transformation_mlp_result_upper_bound=0.9)
    jread = JaxWeightedSum(graph_representation_size=8, **kwargs)
    read = WeightedSumGraphRepresentation(12, 8, **kwargs)
    params = bridged(jread, read, nodes, ids, 5)

    def jfn(p):
        out = jread.apply({"params": p}, jnp.asarray(nodes), jnp.asarray(ids),
                          5)
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, want), jgrads = jax.value_and_grad(jfn, has_aux=True)(params)
    got = read(torch.from_numpy(nodes), torch.from_numpy(ids), 5)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert_grads_match(read, jgrads)


def test_weighted_sum_readout_rejects_bad_settings():
    with pytest.raises(ValueError, match="weighting"):
        WeightedSumGraphRepresentation(4, 8, 4, weighting_fun="max")
    with pytest.raises(ValueError, match="divide"):
        WeightedSumGraphRepresentation(4, 10, 4)


@pytest.mark.parametrize("mode", ["mean", "gru", "mlp"])
def test_global_exchange_matches_jax(mode):
    rng = np.random.RandomState(6)
    hidden = 12
    nodes = rng.randn(70, hidden).astype(np.float32)
    ids = graph_ids(rng, 70, 4)
    cot = rng.randn(70, hidden).astype(np.float32)
    jex = jge.get_global_exchange_class(mode)(hidden_dim=hidden,
                                              num_heads=4, dropout_rate=0.2)
    ex = tge.get_global_exchange_class(mode)(hidden, num_heads=4,
                                             dropout_rate=0.2)
    params = bridged(jex, ex, nodes, ids, 4)

    def jfn(p, x):
        out = jex.apply({"params": p}, x, jnp.asarray(ids), 4)
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, want), (jgrads, jdx) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(nodes))
    x = torch.from_numpy(nodes).requires_grad_(True)
    got = ex(x, torch.from_numpy(ids), 4)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jdx), **TOL)
    assert_grads_match(ex, jgrads)


def test_global_exchange_dropout_draws_from_the_generator():
    ex = tge.get_global_exchange_class("mean")(8, num_heads=2,
                                               dropout_rate=0.5)
    ex.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(20, 8)
    ids = torch.zeros(20, dtype=torch.int32)
    with pytest.raises(ValueError, match="torch.Generator"):
        ex(x, ids, 2, True)
    a = ex(x, ids, 2, True, torch.Generator().manual_seed(3))
    b = ex(x, ids, 2, True, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b)
    assert not torch.allclose(a, ex(x, ids, 2, False))
    with pytest.raises(ValueError, match="global_exchange_mode"):
        tge.get_global_exchange_class("max")
