"""Training and test run orchestration, the harness behind the command-line
entry points (port of ``tf2_gnn_tpu/harness/run.py``).

Wires the layered config system, the task registry, checkpointing and the
train loop into ``run_train_from_args`` and ``test_model``. The runs take
``device`` (``--device``, default ``cuda``): without a card they raise
unless the CPU is asked for. The port runs eagerly, so
``--disable-tf-func`` changes nothing and is only logged; ``--profile-dir``
writes a ``torch.profiler`` trace of the training loop.
"""
import argparse
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..data.graph_dataset import DataFold, GraphDataset
from ..layers.message_passing import MESSAGE_PASSING_IMPLEMENTATIONS
from ..utils.device import resolve_device
from .checkpoint import (
    load_checkpoint_metadata,
    load_weights_verbosely,
    restore_dataset,
    restore_model_and_params,
    restore_opt_state,
    save_model,
)
from .config import (
    apply_hyperdrive_overrides,
    load_default_hypers,
    merge_params,
    parse_params_override,
)
from .evaluation import evaluate_model
from .metrics_log import MetricsLogger
from .tasks import task_name_to_dataset_class, task_name_to_model_class
from .training import build_training, make_eval_step, run_eval_epoch, train_loop


def make_run_id(model_name: str, task_name: str,
                run_name: Optional[str] = None) -> str:
    """Unique run id (reference training_utils.py:26-31)."""
    if run_name is not None:
        return run_name
    return f"{model_name}_{task_name}__{time.strftime('%Y-%m-%d_%H-%M-%S')}"


def log_line(log_file: Optional[Path], msg: str) -> None:
    if log_file is not None:
        with open(log_file, "a") as f:
            f.write(msg + "\n")
    print(msg, flush=True)


def get_model_and_dataset_from_args(
    args: argparse.Namespace,
    hyperdrive_overrides: Optional[Dict[str, str]] = None,
) -> Tuple[Any, Dict[str, Any], GraphDataset]:
    """Resolve (model on the run's device, model_params, dataset with TRAIN
    and VALIDATION loaded) for a training run, in the reference's three
    modes (model_utils.py:232-321):

    * fresh: task registry + default hypers + overrides;
    * ``--load-saved-model``: everything from the checkpoint (its weights
      are restored later by the caller);
    * ``--load-weights-only``: a fresh config; the caller then restores
      the weights that match by name.

    TRAIN shuffles draw from ``np.random.RandomState(seed)``; the model's
    initial weights come from ``seed``.
    """
    device = resolve_device(getattr(args, "device", "cuda"))
    seed = getattr(args, "random_seed", 0)
    dataset_kwargs = dict(
        use_worker_threads=getattr(args, "use_worker_threads", False),
        rng=np.random.RandomState(seed))
    data_override = parse_params_override(
        getattr(args, "data_params_override", None))
    folds = {DataFold.TRAIN, DataFold.VALIDATION}
    if getattr(args, "load_saved_model", None):
        checkpoint = load_checkpoint_metadata(args.load_saved_model)
        dataset = restore_dataset(checkpoint, data_override, **dataset_kwargs)
        dataset.load_data(args.data_path, folds)
        model, model_params = restore_model_and_params(checkpoint, dataset,
                                                       device=device)
        return model, model_params, dataset

    dataset_cls, task_dataset_hypers = task_name_to_dataset_class(args.task)
    model_cls, task_model_hypers = task_name_to_model_class(args.task)
    shipped = load_default_hypers(args.task, args.model)

    dataset_params = merge_params(
        dataset_cls.get_default_hyperparameters(),
        task_dataset_hypers,
        shipped["task_params"],
        data_override,
    )
    model_params = merge_params(
        model_cls.get_default_hyperparameters(mp_style=args.model.lower()),
        task_model_hypers,
        shipped["model_params"],
        parse_params_override(getattr(args, "model_params_override", None)),
    )
    if hyperdrive_overrides:
        dataset_params = apply_hyperdrive_overrides(dataset_params,
                                                    hyperdrive_overrides)
        model_params = apply_hyperdrive_overrides(model_params,
                                                  hyperdrive_overrides)

    dataset = dataset_cls(dataset_params, **dataset_kwargs)
    dataset.load_data(args.data_path, folds)
    model = model_cls.from_dataset(model_params, dataset, device=device,
                                   seed=seed)
    return model, model_params, dataset


def run_train_from_args(
    args: argparse.Namespace,
    hyperdrive_overrides: Optional[Dict[str, str]] = None,
) -> Path:
    """Full training run; returns the path of the best checkpoint."""
    run_id = make_run_id(args.model, args.task, getattr(args, "run_name", None))
    save_dir = Path(getattr(args, "save_dir", "trained_models"))
    save_dir.mkdir(parents=True, exist_ok=True)
    log_file = save_dir / f"{run_id}.log"
    log = lambda msg: log_line(log_file, msg)  # noqa: E731

    if getattr(args, "disable_jit", False):
        log("--disable-tf-func accepted: the port runs eagerly, every step "
            "as written.")
    if getattr(args, "azure_info", None):
        log("--azure-info accepted for compatibility; azure:// paths "
            "resolve through data/io.py::register_path_resolver.")

    seed = getattr(args, "random_seed", 0)
    model, model_params, dataset = get_model_and_dataset_from_args(
        args, hyperdrive_overrides)
    log(f"Dataset parameters: {json.dumps(dict(dataset.params), default=str)}")
    log(f"Model parameters: {json.dumps(model_params, default=str)}")
    log(f"Device: {next(model.parameters()).device}")

    state, train_step, eval_step = build_training(model, model_params,
                                                  seed=seed)
    restore_from = (getattr(args, "load_weights_only", None)
                    or getattr(args, "load_saved_model", None))
    if restore_from:
        checkpoint = load_checkpoint_metadata(restore_from)
        load_weights_verbosely(checkpoint, model, log=log)
        if getattr(args, "load_saved_model", None):
            # Full restore: the optimizer state and the step counter too,
            # for an exact resume.
            restore_opt_state(checkpoint, state.optimizer)
            state.step = int(checkpoint.get("step", 0))

    checkpoint_path = save_dir / f"{run_id}_best.pkl"

    def save_fun(s):
        save_model(checkpoint_path, model, model_params, dataset,
                   optimizer=s.optimizer, step=s.step)

    profile_dir = getattr(args, "profile_dir", None)
    profiler = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if next(model.parameters()).is_cuda:
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()

    try:
        with MetricsLogger(save_dir / f"{run_id}_metrics.jsonl",
                           run_id) as mlog:
            mlog.log("run_start", model=args.model, task=args.task,
                     seed=seed)
            state, best_metric = train_loop(
                model, state, train_step, eval_step, dataset,
                max_epochs=getattr(args, "max_epochs", 10000),
                patience=getattr(args, "patience", 25),
                log_fun=log,
                save_model_fun=save_fun,
                quiet=getattr(args, "quiet", True),
                metrics_logger=mlog,
            )
            mlog.log("run_end", best_valid_metric=float(best_metric))
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
    if profiler is not None:
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        trace = Path(profile_dir) / f"{run_id}_trace.json"
        profiler.export_chrome_trace(str(trace))
        log(f"Profiler trace written to {trace}.")
    log(f"Best validation metric: {best_metric:.5f} "
        f"(checkpoint {checkpoint_path}).")

    if getattr(args, "run_test", False):
        test_model(checkpoint_path, args.data_path, log=log,
                   device=getattr(args, "device", "cuda"))
    return checkpoint_path


def test_model(checkpoint_path, data_path, log: Callable[[str], None] = print,
               model_params_override=None, data_params_override=None,
               device="cuda") -> float:
    """Load a checkpoint and evaluate it on the TEST fold (reference
    cli/test.py:12-36); returns the epoch metric (lower is better)."""
    dev = resolve_device(device)
    checkpoint = load_checkpoint_metadata(checkpoint_path)
    dataset = restore_dataset(checkpoint,
                              parse_params_override(data_params_override))
    dataset.load_data(data_path, {DataFold.TEST})
    model, _ = restore_model_and_params(
        checkpoint, dataset,
        params_override=parse_params_override(model_params_override),
        device=dev)
    load_weights_verbosely(checkpoint, model, log=log)

    loss, speed, results = run_eval_epoch(
        make_eval_step(model), dataset.batch_iterator(DataFold.TEST), dev)
    metric, metric_str = model.compute_epoch_metrics(results)
    log(f"Test: {loss:.4f} loss | {metric_str} | {speed:.2f} graphs/s")

    if getattr(model, "EVAL_KIND", None):
        evaluate_model(model, dataset.batch_iterator(DataFold.TEST), dev,
                       log=log)
    return metric


def get_train_cli_arg_parser() -> argparse.ArgumentParser:
    """The reference's CLI surface (cli_utils/training_utils.py:223-360),
    with ``--device``."""
    parser = argparse.ArgumentParser(
        description="Train a GNN model with the PyTorch port.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("model", type=str,
                        help="GNN model type to train: one of "
                        f"{sorted(MESSAGE_PASSING_IMPLEMENTATIONS)} "
                        "(any case).")
    parser.add_argument("task", type=str, help="Task to train on.")
    parser.add_argument("data_path", type=str,
                        help="Directory with the task data.")
    parser.add_argument("--save-dir", type=str, default="trained_models")
    parser.add_argument("--model-params-override", type=str, default=None,
                        help="JSON string or file overriding model hypers.")
    parser.add_argument("--data-params-override", type=str, default=None,
                        help="JSON string or file overriding dataset hypers.")
    parser.add_argument("--max-epochs", type=int, default=10000)
    parser.add_argument("--patience", type=int, default=25)
    parser.add_argument("--seed", dest="random_seed", type=int, default=0)
    parser.add_argument("--run-name", type=str, default=None)
    parser.add_argument("--load-saved-model", type=str, default=None,
                        help="Checkpoint to fully restore (config, weights, "
                        "optimizer state).")
    parser.add_argument("--load-weights-only", type=str, default=None,
                        help="Checkpoint whose weights initialise a fresh "
                        "run.")
    parser.add_argument("--run-test", action="store_true",
                        help="Evaluate the best checkpoint on TEST after "
                        "training.")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Write a torch.profiler trace (Chrome trace "
                        "JSON) of the training loop into this directory.")
    parser.add_argument("--no-worker-threads", dest="use_worker_threads",
                        action="store_false", default=True,
                        help="Assemble batches in the main thread instead "
                        "of a background thread.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to run on; 'cpu' runs the kernels' "
                        "plain PyTorch versions (for tests).")
    parser.add_argument("--quiet", action="store_true", default=False)
    parser.add_argument("--debug", action="store_true", default=False,
                        help="Drop into pdb post-mortem on exceptions.")
    # Drop-in compatibility with the reference CLI surface
    # (cli_utils/training_utils.py:302-345):
    parser.add_argument("--disable-tf-func", dest="disable_jit",
                        action="store_true", default=False,
                        help="Accepted for compatibility; the port runs "
                        "eagerly.")
    parser.add_argument("--azure-info", type=str, default=None,
                        help="Accepted for reference compatibility; azure:// "
                        "data paths need a resolver (data/io.py).")
    parser.add_argument("--azureml_logging", action="store_true",
                        default=False,
                        help="Accepted for reference compatibility; metrics "
                        "stream to <run>_metrics.jsonl.")
    return parser


def parse_hyperdrive_leftovers(leftovers) -> Dict[str, str]:
    """Interpret leftover ``--key value`` pairs as string overrides
    (reference cli/train.py:17-26)."""
    if len(leftovers) % 2 != 0:
        raise ValueError(
            f"Unmatched hyperdrive override arguments: {leftovers}"
        )
    overrides = {}
    for i in range(0, len(leftovers), 2):
        key = leftovers[i]
        if not key.startswith("--"):
            raise ValueError(f"Override key {key} must start with '--'.")
        overrides[key[2:]] = leftovers[i + 1]
    return overrides


def run_and_debug(func: Callable[[], Any], enable_debugging: bool):
    """pdb-on-exception wrapper (dpu-utils run_and_debug equivalent)."""
    try:
        return func()
    except Exception:
        if enable_debugging:
            import pdb
            import sys
            import traceback

            traceback.print_exc()
            pdb.post_mortem(sys.exc_info()[2])
        raise
