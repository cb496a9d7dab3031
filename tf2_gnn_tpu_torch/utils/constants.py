"""Numerical constants shared across the port.

Mirrors ``tf2_gnn_tpu/utils/constants.py`` (the reference's SMALL_NUMBER).
"""

# Small epsilon used to avoid division by zero (reference: utils/constants.py:1).
SMALL_NUMBER = 1e-7
