"""Training harness (port of ``tf2_gnn_tpu/harness``): config, tasks,
optimizer, train/eval steps and loop, checkpoints, run orchestration and
the flax-params bridge."""
