"""Structured run metrics: JSONL event log + step/epoch timing (port of
``tf2_gnn_tpu/harness/metrics_log.py``, flushing every record).

The reference's observability is a text log plus optional AzureML
``aml_run.log`` calls (tf2_gnn/cli_utils/training_utils.py:75-79,177-182).
The equivalent here is backend-neutral: every epoch/evaluation emits a
JSON line with metrics, throughput, and wall-clock timestamps that any
downstream system (BigQuery, W&B, TensorBoard converters) can ingest.
"""
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics log for one training run."""

    def __init__(self, path, run_id: str):
        self._path = Path(path)
        self._path.parent.mkdir(parents=True, exist_ok=True)
        self._run_id = run_id
        self._file = open(self._path, "a")
        self._start = time.time()

    def log(self, event: str, **fields: Any) -> None:
        record: Dict[str, Any] = {
            "run_id": self._run_id,
            "event": event,
            "time": round(time.time(), 3),
            "elapsed_s": round(time.time() - self._start, 3),
        }
        record.update(fields)
        self._file.write(json.dumps(record, default=float) + "\n")
        self._file.flush()

    def log_epoch(self, epoch: int, fold: str, loss: float, metric: float,
                  metric_str: str, graphs_per_s: float,
                  extra: Optional[Dict[str, Any]] = None) -> None:
        self.log(
            "epoch",
            epoch=epoch,
            fold=fold,
            loss=float(loss),
            metric=float(metric),
            metric_description=metric_str,
            graphs_per_s=float(graphs_per_s),
            **(extra or {}),
        )

    def close(self) -> None:
        self._file.flush()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
