"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` at first use. Nothing here
runs at import time, so the CPU test suite imports every module without a
CUDA toolkit. Libraries go under ``build/tf2_gnn_tpu_torch/`` beside the
package (the checkout's git-ignored ``build/``), named by a hash of the
source, the shared headers and the flags, so an edited source rebuilds. ``build_all`` starts one
``nvcc`` per source, all at once.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tf2_gnn_tpu_torch"
SOURCES = ("pair_stream.cu", "pair_attention.cu", "pair_edge_mlp.cu",
           "sorted_scatter.cu", "dyngather.cu")
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default install
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location. Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_NVCC)
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError(
        "nvcc not found (checked $CUDA_HOME/bin, PATH and the CUDA "
        "toolkit's default location); the port's CUDA kernels cannot be "
        "built on this machine."
    )


def library_path(source: str) -> Path:
    """The library's path, named by a hash of the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    text = (CSRC_DIR / source).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}_{digest[:16]}.so"


def build_all(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together. Returns ``{source: compiler output}`` for the
    sources built in this call (ptxas register/spill report included);
    raises on the first failed build."""
    pending = [s for s in sources if not library_path(s).exists()]
    if not pending:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    for source in pending:
        target = library_path(source)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
        procs.append((source, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failures = {}, []
    for source, target, tmp, proc in procs:
        output, _ = proc.communicate()
        logs[source] = output
        if proc.returncode != 0:
            failures.append(f"{source}: nvcc exit {proc.returncode}\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: concurrent builds agree
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return logs


def load_library(source: str,
                 signatures: Optional[Dict[str, tuple]] = None
                 ) -> ctypes.CDLL:
    """The loaded library of ``source``, building it first if needed.
    ``signatures`` (``{entry: (restype, argtypes)}``) are set on the
    library's functions once, when it is loaded."""
    lib = _LOADED.get(source)
    if lib is None:
        build_all([source])
        lib = ctypes.CDLL(str(library_path(source)))
        for name, (restype, argtypes) in (signatures or {}).items():
            fn = getattr(lib, name)  # CDLL keeps this object for the name
            fn.restype, fn.argtypes = restype, argtypes
        _LOADED[source] = lib
    return lib
