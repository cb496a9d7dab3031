"""table_rows_share (layer: model step): the share of the full per-type
tables' rows that the pair-joint route's table products computed, from
the program's counters ``pair_tables.rows_computed`` and
``pair_tables.rows_full`` (``tf2_gnn_tpu_torch/utils/tracing.py``),
counted at every pair-joint layer's forward whether tracing is on or off,
over every step the process ran: 1.0 where every layer computed the full
``L * v_src`` rows, below it where the layers computed only the rows their
plans read. A program that counts no table rows reads nothing."""


def read(ctx):
    from tf2_gnn_tpu_torch.utils import tracing

    counters = tracing.counters("pair_tables")
    if not counters.get("rows_full"):
        return None
    return counters.get("rows_computed", 0) / counters["rows_full"]
