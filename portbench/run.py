"""Run one benchmark cell once and print its result as the last line of
standard output:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (see portbench/README.md).
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Caches of any kernel compiler stay in fixed directories of the checkout.
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "portbench" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(ROOT / "build" / "portbench" / "triton"))
# Python's bytecode too: without a cache every run compiles the modules
# of torch and of the port from source again, some 8 s of set-up.
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / "build" / "portbench" / "pycache")
# The checkout's root, not this folder, heads the import path: the
# benchmark's modules are imported as ``portbench.*``.
sys.path[0] = str(ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
