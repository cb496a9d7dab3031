"""Import reference tf2-gnn Keras checkpoints into the port's models (port
of ``tf2_gnn_tpu/harness/import_reference.py``; numpy only, the port's own
copy).

The reference stores weights as HDF5 keyed by name-scoped variable paths
(reference cli_utils/model_utils.py:62-93). ``map_reference_variables``
maps every variable family the reference produces onto the flax-path
layout of the JAX package's parameter tree, exactly as the JAX importer
does:

* GNN core (reference gnn.py:133-200): initial projection, per-layer Dense /
  LayerNorm, global exchange (readout MLPs + GRU/MLP combine).
* All 6 message-passing flavours:
  - edge MLPs (gnn_edge_mlp.py:74-80): per-type kernels stacked to [L, D, H];
    concat-input first layers split into source/target halves.
  - GGNN GRU (ggnn.py:62-66): kernel/recurrent_kernel direct; the Keras
    reset_after bias [2, 3H] splits into input/recurrent rows, which the
    port's ``ops/gru.py`` keeps as ``input_bias`` / ``recurrent_bias``
    beside the packed [in, 3H] kernels.
  - RGAT (rgat.py:80-87): per-type kernels + Edge_attention_parameters_<l>
    [K, 2H/K] stacked to [L, K, 2H/K].
  - FiLM (gnn_film.py:74-77): per-type FiLM MLPs stacked like edge MLPs.
* Task heads: GraphRegression dual readouts + regression MLP
  (graph_regression_task.py:38-71), NodeMulticlassTask dense
  (node_multiclass_task.py:40-50), QM9 gate/transform
  (qm9_regression.py:49-62).

``import_reference_weights(model, source)`` builds the flax-layout template
from the model's own state (``import_jax.state_dict_to_flax_params``, so
the edge and FiLM MLPs' out layers resolve against the model's depth),
merges the mapped arrays into it shape-checked, and loads the result
through the flax bridge (``import_jax.load_flax_params``) on the model's
device. Anything unmatched is logged, as the reference's tolerant
``load_weights_verbosely`` does (model_utils.py:111-148): reference
variables without a counterpart, and model parameters the checkpoint does
not set (which keep their initialisation).

Reading an ``.hdf5`` file needs ``h5py``, imported when one is read; the
``{name: array}`` form needs numpy only.
"""
import os
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

from .import_jax import (
    flatten_params,
    load_flax_params,
    state_dict_to_flax_params,
)

Path = Tuple[str, ...]


def read_reference_checkpoint(path) -> Dict[str, np.ndarray]:
    """Read a reference ``save_model`` .hdf5 into {var_name: array}.

    Mirrors the reference's own reader (model_utils.py:74-93): the FIRST hdf5
    level is Keras' auto-generated sublayer grouping and is skipped; the inner
    dataset paths are the true name-scoped variable names.
    """
    try:
        import h5py
    except ImportError as err:
        raise RuntimeError(
            "h5py is required to read a reference .hdf5 checkpoint; pass the "
            "variables as a {name: array} mapping instead.") from err
    out: Dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            if name in out:
                raise ValueError(f"Duplicate variable name in hdf5: {name}")
            out[name] = np.asarray(obj)

    with h5py.File(path, "r") as f:
        for sublayer in f.values():
            sublayer.visititems(visit)
    return out


_SUFFIX_MAP = {
    "kernel": "kernel",
    "bias": "bias",
    "gamma": "scale",
    "beta": "bias",
    "recurrent_kernel": "recurrent_kernel",
}

_EXCHANGE_CLASSES = (
    "GraphGlobalGRUExchange",
    "GraphGlobalMeanExchange",
    "GraphGlobalMLPExchange",
    # Pre-rename variants (model_utils.py:98-108 backward-compat map).
    "graph_global_gru_exchange",
    "graph_global_mean_exchange",
    "graph_global_mlp_exchange",
)


def _mlp_path(parts: List[str]) -> Optional[List[str]]:
    """Map a shim-MLP sub-path [dense_hidden_<j>|dense_out, var] -> ours."""
    if len(parts) != 2:
        return None
    layer, var = parts
    if layer == "dense_out":
        return ["out", var]
    m = re.fullmatch(r"dense_hidden_(\d+)", layer)
    if m:
        return [f"hidden_{m.group(1)}", var]
    return None


class _Mapper:
    """Accumulates mapped variables, stacking per-edge-type families."""

    def __init__(self, log: Callable[[str], None]):
        self.direct: Dict[Path, np.ndarray] = {}
        # target path -> {edge_type: array}
        self.stacked: Dict[Path, Dict[int, np.ndarray]] = {}
        # target path prefix -> first-layer concat kernels to split src/tgt
        self.split_concat: Dict[Path, Dict[int, np.ndarray]] = {}
        self.unmatched: List[str] = []
        self.log = log

    def put(self, path: List[str], value: np.ndarray) -> None:
        self.direct[tuple(path)] = value

    def put_gru(self, prefix: List[str], var: str, value: np.ndarray) -> None:
        """Keras GRU(reset_after=True): bias is [2, 3H] = input/recurrent."""
        if var == "bias":
            self.direct[tuple(prefix + ["input_bias"])] = value[0]
            self.direct[tuple(prefix + ["recurrent_bias"])] = value[1]
        else:
            self.direct[tuple(prefix + [var])] = value

    def put_stacked(self, path: List[str], edge_type: int, value: np.ndarray) -> None:
        self.stacked.setdefault(tuple(path), {})[edge_type] = value

    def put_split(self, path: List[str], edge_type: int, value: np.ndarray) -> None:
        self.split_concat.setdefault(tuple(path), {})[edge_type] = value

    def finalise(self) -> Dict[Path, np.ndarray]:
        out = dict(self.direct)
        for path, by_type in self.stacked.items():
            types = sorted(by_type)
            if types != list(range(len(types))):
                self.log(f"W: non-contiguous edge types for {'/'.join(path)}; skipped.")
                continue
            out[path] = np.stack([by_type[t] for t in types], axis=0)
        for path, by_type in self.split_concat.items():
            types = sorted(by_type)
            if types != list(range(len(types))):
                self.log(f"W: non-contiguous edge types for {'/'.join(path)}; skipped.")
                continue
            stacked = np.stack([by_type[t] for t in types], axis=0)
            d = stacked.shape[1] // 2
            # Reference Dense on concat(src, tgt) with kernel [2D, H]; our
            # layout splits into source/target halves [L, D, H] each — an
            # exactly equivalent computation (gnn_edge_mlp.py:92-97).
            prefix = list(path[:-2])
            out[tuple(prefix + ["edge_mlp_src_0", "kernel"])] = stacked[:, :d, :]
            out[tuple(prefix + ["edge_mlp_tgt_0", "kernel"])] = stacked[:, d:, :]
        return out


def _map_exchange(mapper: _Mapper, layer_idx: int, parts: List[str], var: str,
                  value: np.ndarray) -> bool:
    """Variables under Layer_<i>/Global_Exchange/<ExchangeClass>/..."""
    prefix = ["gnn", f"global_exchange_{layer_idx}"]
    if not parts:
        # The exchange's own GRU cell (graph_global_exchange.py:140-155).
        if var in ("kernel", "recurrent_kernel", "bias"):
            mapper.put_gru(prefix + ["gru_cell"], var, value)
            return True
        return False
    head = parts[0]
    if head == "WeightedSumGraphRepresentation":
        inner = parts[1:]
        if inner and inner[0] in ("ScoringMLP", "TransformationMLP"):
            target = (
                "scoring_mlp" if inner[0] == "ScoringMLP" else "transformation_mlp"
            )
            sub = _mlp_path(inner[1:] + [var])
            if sub is not None:
                mapper.put(
                    prefix + ["node_to_graph_representation", target] + sub, value
                )
                return True
        return False
    if head == "MLP":
        sub = _mlp_path(parts[1:] + [var])
        if sub is not None:
            mapper.put(prefix + ["combine_mlp"] + sub, value)
            return True
    return False


def _map_mp(mapper: _Mapper, layer_idx: int, parts: List[str], var: str,
            value: np.ndarray) -> bool:
    """Variables under Layer_<i>/MessagePassing/..."""
    mp_prefix = ["gnn", f"mp_layer_{layer_idx}"]
    if not parts:
        # GGNN's shared GRU cell (ggnn.py:62-66).
        if var in ("kernel", "recurrent_kernel", "bias"):
            mapper.put_gru(mp_prefix + ["gru_cell"], var, value)
            return True
        return False

    m = re.fullmatch(r"edge_type_(\d+)(-FiLM)?", parts[0])
    if not m:
        return False
    edge_type = int(m.group(1))
    is_film = m.group(2) is not None
    rest = parts[1:]

    if not rest:
        if var == "kernel":
            # RGAT per-type dense W_l (rgat.py:74-79).
            mapper.put_stacked(mp_prefix + ["edge_weights", "kernel"], edge_type, value)
            return True
        if re.fullmatch(r"Edge_attention_parameters_\d+", var):
            mapper.put_stacked(
                mp_prefix + ["edge_attention_parameters"], edge_type, value
            )
            return True
        return False

    if rest[0] == "MLP" and var == "kernel":
        sub = rest[1:]
        if len(sub) != 1:
            return False
        family = "film_mlp_layer" if is_film else "edge_mlp_layer"
        if sub[0] == "dense_out":
            depth = None  # resolved below: out layer index = num hidden
        else:
            hm = re.fullmatch(r"dense_hidden_(\d+)", sub[0])
            if not hm:
                return False
            depth = int(hm.group(1))
        # Collect now; the out-layer's final index is resolved in a second
        # pass once all depths for this (layer, family) are known.
        mapper.put_stacked(
            mp_prefix + [family, "OUT" if depth is None else str(depth)],
            edge_type,
            value,
        )
        return True
    return False


def map_reference_variables(
    ref_vars: Mapping[str, np.ndarray],
    use_target_state_as_input: bool = False,
    log: Callable[[str], None] = print,
) -> Tuple[Dict[Path, np.ndarray], List[str]]:
    """Map reference variable names to flax parameter paths.

    Returns ``(mapped, unmatched_names)`` where ``mapped`` keys are tuple
    paths into the model's ``params`` tree.
    """
    mapper = _Mapper(log)
    for name, value in ref_vars.items():
        base = name[:-2] if name.endswith(":0") else name
        parts = base.split("/")
        var = parts[-1]
        body = parts[:-1]
        matched = False

        if base == "training_step" or var == "training_step":
            continue

        if len(body) >= 1 and body[0].endswith("_GNN"):
            inner = body[1:]
            if var == "kernel" and inner == ["gnn_initial_node_projection"]:
                mapper.put(["gnn", "initial_node_projection", "kernel"], value)
                matched = True
            elif inner and (m := re.fullmatch(r"Layer_(\d+)", inner[0])):
                layer_idx = int(m.group(1))
                section = inner[1:]
                if section == ["Dense"] and var == "kernel":
                    mapper.put(["gnn", f"dense_{layer_idx}", "kernel"], value)
                    matched = True
                elif section == ["LayerNorm"] and var in ("gamma", "beta"):
                    mapper.put(
                        ["gnn", f"layernorm_{layer_idx}", _SUFFIX_MAP[var]], value
                    )
                    matched = True
                elif (
                    len(section) >= 2
                    and section[0] == "Global_Exchange"
                    and section[1] in _EXCHANGE_CLASSES
                ):
                    matched = _map_exchange(
                        mapper, layer_idx, section[2:], var, value
                    )
                elif section and section[0] == "MessagePassing":
                    matched = _map_mp(mapper, layer_idx, section[1:], var, value)
        elif body[:1] == ["GraphRegressionTask"] or body[:1] == [
            "GraphBinaryClassificationTask"
        ]:
            inner = body[1:]
            if inner[:1] == ["MLP"]:
                sub = _mlp_path(inner[1:] + [var])
                if sub is not None:
                    mapper.put(["regression_mlp"] + sub, value)
                    matched = True
            elif inner[:1] == ["graph_representation_computation"] and len(inner) >= 3:
                mode = inner[1]  # weighted_avg | weighted_sum
                if inner[2] == "WeightedSumGraphRepresentation" and len(inner) >= 4:
                    which = inner[3]
                    if which in ("ScoringMLP", "TransformationMLP"):
                        target = (
                            "scoring_mlp"
                            if which == "ScoringMLP"
                            else "transformation_mlp"
                        )
                        sub = _mlp_path(inner[4:] + [var])
                        if sub is not None:
                            mapper.put([f"{mode}_readout", target] + sub, value)
                            matched = True
        elif body[:1] == ["NodeMulticlassTask"] and var in ("kernel", "bias"):
            mapper.put(["node_to_labels", var], value)
            matched = True
        elif body[:1] == ["QM9RegressionTask"] and len(body) >= 3:
            which = body[1]  # node_gate | node_transform
            target = {
                "node_gate": "regression_gate",
                "node_transform": "regression_transform",
            }.get(which)
            # body[2] is the MLP's given name ("gate"/"transform").
            if target is not None:
                sub = _mlp_path(body[3:] + [var])
                if sub is not None:
                    mapper.put([target] + sub, value)
                    matched = True

        if not matched:
            mapper.unmatched.append(name)

    mapped = mapper.finalise()
    mapped = _resolve_mlp_out_layers(mapped, use_target_state_as_input)
    return mapped, mapper.unmatched


def _resolve_mlp_out_layers(
    mapped: Dict[Path, np.ndarray], use_target_state_as_input: bool
) -> Dict[Path, np.ndarray]:
    """Rewrite edge/film MLP placeholder depths into final layer names.

    Collected paths look like (gnn, mp_layer_i, edge_mlp_layer, '0'|'OUT');
    the out layer's index is the hidden-layer count. The concat-input FIRST
    layer additionally splits into src/tgt halves when the reference fed
    target states (gnn_edge_mlp.py:92-97).
    """
    out: Dict[Path, np.ndarray] = {}
    # (prefix, family) -> {depth_key: value}
    groups: Dict[Tuple[Path, str], Dict[str, np.ndarray]] = {}
    for path, value in mapped.items():
        if len(path) >= 2 and path[-2] in ("edge_mlp_layer", "film_mlp_layer"):
            groups.setdefault((path[:-2], path[-2]), {})[path[-1]] = value
        else:
            out[path] = value

    for (prefix, family), by_depth in groups.items():
        num_hidden = len(by_depth) - 1 if "OUT" in by_depth else len(by_depth)
        resolved: Dict[int, np.ndarray] = {}
        for key, value in by_depth.items():
            depth = num_hidden if key == "OUT" else int(key)
            resolved[depth] = value
        for depth, value in sorted(resolved.items()):
            split_first = (
                use_target_state_as_input
                and family == "edge_mlp_layer"
                and depth == 0
            )
            if split_first:
                d = value.shape[1] // 2
                out[prefix + ("edge_mlp_src_0", "kernel")] = value[:, :d, :]
                out[prefix + ("edge_mlp_tgt_0", "kernel")] = value[:, d:, :]
            else:
                out[prefix + (f"{family}_{depth}", "kernel")] = value
    return out


def merge_mapped_into_params(
    params: Dict[str, Any],
    mapped: Dict[Path, np.ndarray],
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Copy mapped arrays into a (copied) params tree, shape-checked."""

    def copy_tree(t):
        if isinstance(t, dict):
            return {k: copy_tree(v) for k, v in t.items()}
        return t

    new_params = copy_tree(params)
    applied = 0
    for path, value in sorted(mapped.items()):
        node = new_params
        ok = True
        for key in path[:-1]:
            if not isinstance(node, dict) or key not in node:
                log(f"W: imported {'/'.join(path)} has no counterpart; ignored.")
                ok = False
                break
            node = node[key]
        if not ok:
            continue
        leaf_key = path[-1]
        if not isinstance(node, dict) or leaf_key not in node:
            log(f"W: imported {'/'.join(path)} has no counterpart; ignored.")
            continue
        if tuple(np.shape(node[leaf_key])) != tuple(np.shape(value)):
            log(
                f"W: shape mismatch for {'/'.join(path)}: model "
                f"{np.shape(node[leaf_key])} vs import {np.shape(value)}; kept fresh."
            )
            continue
        node[leaf_key] = np.asarray(value, dtype=np.float32)
        applied += 1
    log(f"Imported {applied}/{len(mapped)} reference variables.")
    return new_params


def import_reference_weights(
    model,
    source: Union[str, os.PathLike, Mapping[str, np.ndarray]],
    use_target_state_as_input: bool = False,
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Import a reference checkpoint (.hdf5 path or {name: array} mapping)
    into ``model`` (a port ``GraphTaskModel`` or any module whose parameter
    names follow the flax tree), in place, on its device. Returns the
    flax-layout tree that was loaded."""
    ref_vars = (source if isinstance(source, Mapping)
                else read_reference_checkpoint(str(source)))
    mapped, unmatched = map_reference_variables(
        ref_vars, use_target_state_as_input=use_target_state_as_input, log=log
    )
    for name in unmatched:
        log(f"W: reference variable not mapped: {name}")
    template = state_dict_to_flax_params(model.state_dict())
    merged = merge_mapped_into_params(template, mapped, log=log)
    for path in sorted(set(flatten_params(template)) - set(mapped)):
        log(f"W: {'/'.join(path)} not in the reference checkpoint; keeping "
            "fresh initialisation.")
    load_flax_params(model, merged)
    return merged


# Backwards-compatible alias for the round-1 API.
def import_into_params(
    model,
    h5_path,
    num_edge_types: int = 0,
    use_target_state_as_input: bool = False,
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    return import_reference_weights(
        model, str(h5_path), use_target_state_as_input=use_target_state_as_input,
        log=log,
    )
