"""Small file-format helpers, a local-filesystem RichPath equivalent (port
of ``tf2_gnn_tpu/data/io.py`` without its staging resolver).

The reference reads data through dpu-utils' RichPath
(``read_by_file_suffix`` over .json / .jsonl.gz / .npy / .pkl.gz). We support
the same suffixes with plain stdlib/numpy so datasets stay drop-in loadable.

Remote URI schemes (the reference's azure:// via dpu-utils' AzurePath,
tf2_gnn/data/graph_dataset.py:7) go through a pluggable RESOLVER registry:
``register_path_resolver("azure", fn)`` installs ``fn(uri) -> local path``
(download/cache however the deployment likes — azure-storage-blob, azcopy,
gcsfuse, a read-through cache). This keeps the storage SDK out of the
framework while keeping azure:// URIs
in configs working once a deployment registers its resolver.
"""
import gzip
import json
import pickle
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Union

import numpy as np

PathLike = Union[str, Path]

# scheme (no "://") -> fn(uri) -> local filesystem path to read instead.
_PATH_RESOLVERS: Dict[str, Callable[[str], PathLike]] = {}


def register_path_resolver(scheme: str,
                           resolver: Callable[[str], PathLike]) -> None:
    """Install a handler for ``<scheme>://...`` URIs (e.g. "azure").

    The resolver receives the full URI and returns a local path whose
    contents are the staged/downloaded object. Registered once per process
    (e.g. in a deployment's sitecustomize or run script)."""
    _PATH_RESOLVERS[scheme] = resolver


def _resolve(path: PathLike) -> PathLike:
    if isinstance(path, str) and "://" in path:
        scheme = path.split("://", 1)[0]
        resolver = _PATH_RESOLVERS.get(scheme)
        if resolver is None:
            raise NotImplementedError(
                f"No path resolver registered for {scheme}:// ({path}). "
                "Either register one with tf2_gnn_tpu_torch.data.io."
                "register_path_resolver(...) (e.g. an azure-storage-blob "
                "download-and-cache hook), or stage the container locally "
                "(azcopy) and pass that path."
            )
        return resolver(path)
    return path


def read_by_file_suffix(path: PathLike) -> Any:
    path = Path(_resolve(path))
    name = path.name
    if name.endswith(".jsonl.gz"):
        return list(iter_jsonl_gz(path))
    if name.endswith(".json.gz"):
        with gzip.open(path, "rt") as f:
            return json.load(f)
    if name.endswith(".json"):
        with open(path, "rt") as f:
            return json.load(f)
    if name.endswith(".jsonl"):
        with open(path, "rt") as f:
            return [json.loads(line) for line in f if line.strip()]
    if name.endswith(".npy"):
        return np.load(path, allow_pickle=True)
    if name.endswith(".pkl.gz"):
        with gzip.open(path, "rb") as f:
            return pickle.load(f)
    if name.endswith(".pkl"):
        with open(path, "rb") as f:
            return pickle.load(f)
    raise ValueError(f"Unsupported file suffix for {path}")


def iter_jsonl_gz(path: PathLike) -> Iterator[Any]:
    with gzip.open(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def write_jsonl_gz(path: PathLike, records) -> None:
    with gzip.open(path, "wt") as f:
        for record in records:
            f.write(json.dumps(record) + "\n")
