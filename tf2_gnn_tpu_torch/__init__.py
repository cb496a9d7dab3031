"""PyTorch + CUDA port of ``tf2_gnn_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module paths
(``data/graph_batch.py``, ``ops/pair_spmm.py``, ``layers/gnn.py``, ...) so
each counterpart is easy to find. It imports torch and numpy only.

Entry points default to ``device="cuda"`` and raise when no card is present;
the CPU runs only when the caller asks for it (``device="cpu"``), as the
tests do. On CPU tensors the hand-written kernels' plain PyTorch versions
run; on CUDA tensors the kernels launch or raise.
"""
