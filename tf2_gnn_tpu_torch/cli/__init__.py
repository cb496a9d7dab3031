"""Command-line entry points of the port (``tf2_gnn_tpu_torch_train``,
``tf2_gnn_tpu_torch_test``)."""
