"""Ops: activations and the block-pair streamed SpMM with its CUDA kernels."""
