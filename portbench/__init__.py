"""The benchmark of ``tf2_gnn_tpu_torch``: see ``portbench/README.md``."""
import importlib.util
from pathlib import Path


def load_module(path: Path, name: str):
    """The module in the file ``path``, loaded under the name ``name``: a
    traffic layout or a metric reader, found by its name in a data file."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
