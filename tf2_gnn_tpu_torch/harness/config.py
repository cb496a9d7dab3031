"""Layered hyperparameter configuration (port of
``tf2_gnn_tpu/harness/config.py``, the same code over the port's copies of
the shipped JSONs in ``default_hypers/``).

Override precedence (lowest -> highest), mirroring the reference
(SURVEY.md §5.6; tf2_gnn/cli_utils/model_utils.py:187-279,
dataset_utils.py:32-66, param_helpers.py:26-49):

1. class defaults (``get_default_hyperparameters``, composed up the
   inheritance chain),
2. task-registry defaults,
3. shipped ``default_hypers/{TASK}_{MODEL}.json``,
4. explicit JSON override dicts (``--model-params-override`` etc.),
5. hyperdrive-style ``key value`` string pairs, coerced to the type of the
   existing value.
"""
import json
from pathlib import Path
from typing import Any, Dict, Optional

DEFAULT_HYPERS_DIR = Path(__file__).parent / "default_hypers"


def load_default_hypers(task_name: str, model_name: str) -> Dict[str, Dict[str, Any]]:
    """Shipped tuned config for a (task, model) pair, or empty dicts."""
    path = DEFAULT_HYPERS_DIR / f"{task_name}_{model_name}.json"
    if not path.exists():
        return {"task_params": {}, "model_params": {}}
    with open(path) as f:
        data = json.load(f)
    return {
        "task_params": data.get("task_params", {}),
        "model_params": data.get("model_params", {}),
    }


def merge_params(*layers: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge dicts left-to-right (later wins); None layers are skipped."""
    merged: Dict[str, Any] = {}
    for layer in layers:
        if layer:
            merged.update(layer)
    return merged


def coerce_hyperdrive_value(current_value: Any, string_value: str) -> Any:
    """Parse a string override using the existing value's type
    (reference cli_utils/param_helpers.py:26-49)."""
    if isinstance(current_value, bool):
        lowered = string_value.lower()
        if lowered in ("true", "1", "yes"):
            return True
        if lowered in ("false", "0", "no"):
            return False
        raise ValueError(f"Cannot parse '{string_value}' as bool.")
    if isinstance(current_value, int):
        return int(float(string_value))
    if isinstance(current_value, float):
        return float(string_value)
    if isinstance(current_value, (list, tuple)):
        parsed = json.loads(string_value)
        if not isinstance(parsed, list):
            raise ValueError(f"Cannot parse '{string_value}' as list.")
        return type(current_value)(parsed) if isinstance(current_value, tuple) else parsed
    return string_value


def apply_hyperdrive_overrides(
    params: Dict[str, Any], overrides: Dict[str, str]
) -> Dict[str, Any]:
    """Apply string-typed overrides in place of matching existing params."""
    out = dict(params)
    for key, string_value in overrides.items():
        if key not in out:
            continue
        current = out[key]
        out[key] = (
            string_value if current is None
            else coerce_hyperdrive_value(current, string_value)
        )
    return out


def parse_params_override(spec: Optional[str]) -> Optional[Dict[str, Any]]:
    """Parse a ``--*-params-override`` JSON string (or file path)."""
    if not spec:
        return None
    # Inline JSON starts with '{'; anything else may be a file path. (Long
    # JSON strings must not reach Path.stat — os.stat errors on >255 chars.)
    if not spec.lstrip().startswith("{"):
        path = Path(spec)
        if path.exists():
            with open(path) as f:
                return json.load(f)
    return json.loads(spec)
