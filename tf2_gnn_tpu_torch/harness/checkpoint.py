"""Model checkpointing (port of ``tf2_gnn_tpu/harness/checkpoint.py``).

``save_model`` persists everything needed to rebuild model and dataset
under the JAX checkpoint's keys: the port's model and dataset classes,
``model_params``, ``dataset_params``, ``dataset_metadata``,
``num_edge_types``, ``node_feature_shape`` and ``padding_config`` (every
field of the port's ``PaddingConfig``, the pair budgets included, so a
restored dataset plans its batches as the trained one did); the weights as
the model's ``state_dict`` in numpy; and, for an exact resume, the
optimizer's state (its ``state_dict`` in numpy) and ``step``.

The file is a pickle, as the JAX package's is, so load only checkpoints
this program wrote. A JAX checkpoint (flax msgpack and the JAX package's
classes) does not load here; a JAX-trained model reaches the port through
``harness/import_jax.py``. Weights load on either device:
``load_weights_verbosely`` copies them into the model where it lives.
"""
import dataclasses
import pickle
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data.graph_batch import PaddingConfig
from ..data.graph_dataset import GraphDataset


def _to_numpy(tree):
    """A state dict (nested dicts, lists and tensors) with every tensor as
    a numpy array."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_tensors(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensors(v) for v in tree)
    return tree


def save_model(
    path,
    model,
    model_params: Dict[str, Any],
    dataset: GraphDataset,
    optimizer=None,
    step: Optional[int] = None,
) -> None:
    """Persist the model's weights and everything needed to rebuild model
    and dataset; with ``optimizer`` (a ``harness/optimizers.py::
    Optimizer``) and ``step`` also the optimizer state for an exact
    resume."""
    data = {
        "model_class": type(model),
        "model_params": model_params,
        "dataset_class": type(dataset),
        "dataset_params": dataset.params,
        "dataset_metadata": dataset.metadata,
        "num_edge_types": dataset.num_edge_types,
        "node_feature_shape": tuple(dataset.node_feature_shape),
        "padding_config": dataclasses.asdict(dataset.padding_config),
        "weights": _to_numpy(model.state_dict()),
    }
    if optimizer is not None:
        data["opt_state"] = _to_numpy(
            optimizer.torch_optimizer.state_dict())
    if step is not None:
        data["step"] = int(step)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)


def load_checkpoint_metadata(path) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return pickle.load(f)


def load_weights_verbosely(checkpoint: Dict[str, Any], model,
                           log: Callable[[str], None] = print) -> None:
    """Name-matched partial restore into ``model``, on its device:
    weights present in both with the same shape are copied; everything
    else keeps its fresh initialisation, with a warning (the reference's
    tolerant loader, model_utils.py:111-148)."""
    saved = checkpoint["weights"]
    own = model.state_dict()
    restored = {}
    for name, value in own.items():
        if name not in saved:
            log(f"W: {name} not found in checkpoint; keeping fresh "
                "initialisation.")
        elif tuple(saved[name].shape) != tuple(value.shape):
            log(f"W: checkpoint var {name} has shape {saved[name].shape}, "
                f"model expects {tuple(value.shape)}; keeping fresh "
                "initialisation.")
        else:
            restored[name] = torch.from_numpy(np.asarray(saved[name]))
    for name in saved:
        if name not in own:
            log(f"W: checkpoint var {name} not used by the model; ignored.")
    model.load_state_dict(restored, strict=False)


def restore_dataset(checkpoint: Dict[str, Any],
                    dataset_params_override: Optional[Dict[str, Any]] = None,
                    **dataset_kwargs) -> GraphDataset:
    """Rebuild the dataset object (without data) from checkpoint metadata,
    with its padding config pinned."""
    dataset_params = dict(checkpoint["dataset_params"])
    if dataset_params_override:
        dataset_params.update(dataset_params_override)
    dataset = checkpoint["dataset_class"](
        dataset_params, metadata=checkpoint.get("dataset_metadata"),
        **dataset_kwargs)
    pc = checkpoint.get("padding_config")
    if pc:
        pc = dict(pc)
        pc["edge_budgets"] = tuple(pc["edge_budgets"])
        if pc.get("pair_chunks_typed") is not None:
            pc["pair_chunks_typed"] = tuple(
                tuple(c) for c in pc["pair_chunks_typed"])
        dataset.set_padding_config(PaddingConfig(**pc))
    return dataset


def restore_opt_state(checkpoint: Dict[str, Any], optimizer) -> bool:
    """Load the saved optimizer state into ``optimizer`` (its tensors move
    to the parameters' device); False when none was saved."""
    saved = checkpoint.get("opt_state")
    if saved is None:
        return False
    optimizer.torch_optimizer.load_state_dict(_to_tensors(saved))
    return True


def restore_model_and_params(
    checkpoint: Dict[str, Any],
    dataset: GraphDataset,
    params_override: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> Tuple[Any, Dict[str, Any]]:
    """Rebuild the model (fresh weights, on ``device``) from checkpoint
    metadata; ``load_weights_verbosely`` then restores its weights."""
    model_params = dict(checkpoint["model_params"])
    if params_override:
        model_params.update(params_override)
    model = checkpoint["model_class"].from_dataset(model_params, dataset,
                                                   device=device)
    return model, model_params
