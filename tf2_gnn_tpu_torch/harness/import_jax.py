"""Bridge a flax ``params`` tree of the JAX package to the port's
``state_dict``.

The tree is given as nested dicts of numpy arrays (``jax.device_get`` of
the reference's params), so this module needs no JAX. Flax leaf names map
as follows:

* ``<path>/kernel`` of rank 2 (``nn.Dense``, [in, out]) ->
  ``<path>.weight``, transposed to ``nn.Linear``'s [out, in];
* ``<path>/kernel`` of rank 3 (``TypedLinear``, [L, D, H]) ->
  ``<path>.kernel`` as is;
* ``<path>/bias`` -> ``<path>.bias``;
* ``<path>/scale`` (``nn.LayerNorm``) -> ``<path>.weight``;
* ``<path>/edge_attention_parameters`` (RGAT's raw [L, K, 2 * head_dim]
  parameter) -> ``<path>.edge_attention_parameters`` as is;
* ``<path>/gru_cell/{kernel, recurrent_kernel, input_bias,
  recurrent_bias}`` (the GRU cell of the global exchange and of each GGNN
  layer, ``ops/gru.py``, which keeps flax's packed ``[in, 3H]`` layout)
  -> the same names as is.

RGIN's ``aggregation_mlp/{hidden_i, out}`` are Dense kernels and GNN-FiLM's
``film_mlp_layer_i`` TypedLinear ones, so the rules above cover them.

A leaf of another name, or one the model does not hold, raises; so does a
model parameter that the tree leaves unset. ``state_dict_to_flax_params``
is the inverse: the flax tree of a port ``state_dict`` (or of any
``{name: tensor}`` under the same names, such as the parameters'
gradients), the template the reference-checkpoint import fills.
"""
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_GRU_LEAVES = ("kernel", "recurrent_kernel", "input_bias", "recurrent_bias")


def flatten_params(tree: Mapping[str, Any], prefix=()
                   ) -> Dict[tuple, np.ndarray]:
    """A nested params tree as ``{path tuple: array}``."""
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def flax_params_to_state_dict(params: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The port's parameter names and tensors for a flax ``params`` tree."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    state = {}
    for path, value in flatten_params(params).items():
        leaf, module = path[-1], ".".join(path[:-1])
        if path[-2:-1] == ("gru_cell",) and leaf in _GRU_LEAVES:
            name = f"{module}.{leaf}"
        elif leaf == "kernel" and value.ndim == 2:
            name, value = f"{module}.weight", value.T
        elif leaf == "kernel" and value.ndim == 3:
            name = f"{module}.kernel"
        elif leaf == "bias":
            name = f"{module}.bias"
        elif leaf == "scale":
            name = f"{module}.weight"
        elif leaf == "edge_attention_parameters":
            name = f"{module}.{leaf}"
        else:
            raise ValueError(f"flax leaf {'/'.join(path)} (shape "
                             f"{value.shape}) has no counterpart in the port")
        state[name] = torch.tensor(np.asarray(value, np.float32))
    return state


def state_dict_to_flax_params(state: Mapping[str, torch.Tensor]
                              ) -> Dict[str, Any]:
    """The flax ``params`` tree (nested dicts of f32 numpy arrays) of the
    port's parameter names and tensors; ``flax_params_to_state_dict``
    inverts it."""
    tree: Dict[str, Any] = {}
    for name, tensor in state.items():
        value = tensor.detach().float().cpu().numpy()
        *path, leaf = name.split(".")
        if path[-1:] == ["gru_cell"] and leaf in _GRU_LEAVES:
            pass
        elif leaf == "weight" and value.ndim == 2:
            leaf, value = "kernel", value.T
        elif leaf == "weight" and value.ndim == 1:
            leaf = "scale"
        elif not ((leaf == "kernel" and value.ndim == 3) or leaf == "bias"
                  or leaf == "edge_attention_parameters"):
            raise ValueError(f"parameter {name} (shape {value.shape}) has no "
                             "flax counterpart")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(value)
    return tree


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> None:
    """Copy a flax ``params`` tree into ``model`` (strict: every leaf must
    map to a parameter of the model and every parameter must be set)."""
    state = flax_params_to_state_dict(params)
    own = model.state_dict()
    unknown = sorted(set(state) - set(own))
    if unknown:
        raise ValueError(f"flax leaves without a model parameter: {unknown}")
    for name, value in state.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: flax shape {tuple(value.shape)} vs "
                             f"model shape {tuple(own[name].shape)}")
    model.load_state_dict(state, strict=True)
