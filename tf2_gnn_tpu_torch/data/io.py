"""Small file-format helpers, a local-filesystem RichPath equivalent (port
of ``tf2_gnn_tpu/data/io.py``, its staging resolver included).

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
import os
import pickle
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional, Union

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


def make_staging_resolver(remote_root: PathLike,
                          cache_dir: Optional[PathLike] = None
                          ) -> Callable[[str], Path]:
    """A read-through staging cache for remote URIs.

    Maps ``<scheme>://bucket/key...`` to ``remote_root/bucket/key...`` and
    copies the object into ``cache_dir`` on first access (re-staged when
    the source's size or mtime changes). ``remote_root`` is whatever makes
    the store look like a filesystem — a blobfuse/gcsfuse/NFS mount point,
    an azcopy-synced directory, a fixture tree in tests. This is the same
    topology dpu-utils' AzurePath gives the reference
    (tf2_gnn/data/graph_dataset.py:7): URIs in configs, local files at
    read time.

        register_path_resolver("azure", make_staging_resolver("/mnt/blob"))

    With ``cache_dir=None`` objects are read in place from the mount (no
    copy) — right when ``remote_root`` is already local-fast.
    """
    remote_root = Path(remote_root)

    def resolver(uri: str) -> Path:
        rel = uri.split("://", 1)[1]
        source = remote_root / rel
        if not source.exists():
            raise FileNotFoundError(f"{uri} -> {source} does not exist")
        if cache_dir is None:
            return source
        staged = Path(cache_dir) / rel
        src_stat = source.stat()
        if (not staged.exists()
                or staged.stat().st_size != src_stat.st_size
                or staged.stat().st_mtime < src_stat.st_mtime):
            staged.parent.mkdir(parents=True, exist_ok=True)
            # Unique temp per stager: concurrent processes each copy into
            # their own file, so the atomic replace below always publishes a
            # COMPLETE copy (a shared fixed tmp name would interleave writes).
            fd, tmp_name = tempfile.mkstemp(
                prefix=staged.name + ".", suffix=".staging",
                dir=staged.parent)
            os.close(fd)
            tmp = Path(tmp_name)
            try:
                shutil.copy2(source, tmp)
                tmp.replace(staged)  # atomic publish: never a partial
            finally:
                tmp.unlink(missing_ok=True)
        return staged

    return resolver


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
