"""Padded graph batches (port of ``tf2_gnn_tpu/data``)."""
