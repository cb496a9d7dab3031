"""Training harness (port of ``tf2_gnn_tpu/harness``: optimizer, train/eval
steps and the flax-params bridge)."""
