"""GNN layers (port of ``tf2_gnn_tpu/layers``)."""
