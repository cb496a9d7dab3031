"""Training parity with the JAX package on the CPU: three train steps from
bridged weights at dropout 0 follow the reference's loss trajectory, and
the optimizer (Adam, eps 1e-7), learning-rate schedule and the three
gradient-clipping modes reproduce optax's updates.

Tolerances: losses rtol 1e-4 (f32 edge stream; the parameter gradients
agree to ~1e-7, tests/test_torch_rgcn_model.py); parameters after the
steps atol 1e-5 (Adam divides by sqrt(v) + 1e-7, so a gradient entry
within ~1e-8 of zero may move its parameter by a small fraction of lr in
either framework). Single optimizer updates rtol 1e-5 / atol 1e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf2_gnn_tpu.harness import optimizers as joptimizers
from tf2_gnn_tpu.harness.training import create_train_state as jcreate
from tf2_gnn_tpu.harness.training import make_train_step as jmake_step
from tf2_gnn_tpu.utils.schedules import make_learning_rate as jmake_lr
from tf2_gnn_tpu_torch.harness.import_jax import flax_params_to_state_dict
from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
from tf2_gnn_tpu_torch.harness.training import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from tf2_gnn_tpu_torch.utils.schedules import make_learning_rate

from .test_torch_rgcn_model import build_pair, make_params, small_workload


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under parallel test workers torch's
    CPU thread pool oversubscribes the cores, and small ops then run many
    times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


STEPS = 3


@pytest.mark.parametrize("extra", [
    {},
    {"learning_rate_warmup_steps": 2, "learning_rate_decay_steps": 4,
     "gradient_clip_global_norm": 0.5},
])
def test_three_adam_steps_follow_jax(extra):
    jbatch, tbatch, labels = small_workload(seed=6)
    params = make_params("ppi", "float32")
    params.update(extra)
    jmodel, jparams, tmodel = build_pair(params, jbatch)

    joptimizer = joptimizers.make_optimizer(params)
    jstate = jcreate(jmodel, jbatch, joptimizer, seed=0)
    jstate = jstate.replace(params=jparams,
                            opt_state=joptimizer.init(jparams))
    jstep = jmake_step(jmodel, joptimizer)
    jlabels = {"node_labels": jnp.asarray(labels)}

    optimizer = make_optimizer(params, tmodel.parameters())
    state = create_train_state(tmodel, optimizer, seed=0)
    step = make_train_step(tmodel, optimizer)
    tlabels = {"node_labels": torch.from_numpy(labels)}

    jlosses, losses = [], []
    for _ in range(STEPS):
        jstate, jmetrics = jstep(jstate, jbatch, jlabels)
        jlosses.append(float(jmetrics["loss"]))
        state, metrics = step(state, tbatch, tlabels)
        losses.append(float(metrics["loss"]))
    assert state.step == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]

    want = flax_params_to_state_dict(jax.device_get(jstate.params))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
    evaluated = make_eval_step(tmodel)(tbatch, tlabels)
    assert np.isfinite(float(evaluated["loss"]))


@pytest.mark.parametrize("extra", [
    {},
    {"gradient_clip_value": 0.05},
    {"gradient_clip_norm": 0.1},
    {"gradient_clip_global_norm": 0.1},
    {"learning_rate_warmup_steps": 3},
    {"learning_rate_decay_steps": 3},
])
def test_optimizer_updates_match_optax(extra):
    rng = np.random.RandomState(2)
    hypers = {"optimizer": "Adam", "learning_rate": 0.01, **extra}
    shapes = {"a": (4, 3), "b": (5,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}

    jopt = joptimizers.make_optimizer(hypers)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in init.items()}
    topt = make_optimizer(hypers, tparams.values())
    for step in range(4):
        grads = {k: (rng.randn(*s) * (1 + step)).astype(np.float32)
                 for k, s in shapes.items()}
        updates, jstate = jopt.update({k: jnp.asarray(g)
                                       for k, g in grads.items()},
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.tensor(grads[k])
        topt.step(step)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-8, err_msg=f"{k} step {step}")


@pytest.mark.parametrize("extra", [
    {"learning_rate_warmup_steps": 4},
    {"learning_rate_decay_steps": 5},
    {"learning_rate_warmup_steps": 3, "learning_rate_decay_steps": 6},
])
def test_learning_rate_schedules_match(extra):
    hypers = {"learning_rate": 0.002, **extra}
    jfn, tfn = jmake_lr(hypers), make_learning_rate(hypers)
    for step in range(12):
        np.testing.assert_allclose(tfn(step), float(jfn(step)), rtol=1e-6)
    assert make_learning_rate({"learning_rate": 0.3}) == 0.3


def test_unported_optimizers_and_double_clip_raise():
    """Every optimizer of the reference is ported (SGD and RMSProp with
    optax's semantics: tests/test_torch_graph_tasks.py); an unknown name
    and two clipping modes at once raise."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    for name in ("SGD", "RMSProp", "Adam"):
        make_optimizer({"optimizer": name}, p)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        make_optimizer({"optimizer": "Lion"}, p)
    with pytest.raises(ValueError, match="one gradient clipping"):
        make_optimizer({"gradient_clip_value": 1.0,
                        "gradient_clip_norm": 1.0}, p)
