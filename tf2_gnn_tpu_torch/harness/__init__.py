"""Training/eval harness (port of ``tf2_gnn_tpu/harness``): config, tasks,
optimizer, train/eval steps and loop, checkpoints, run orchestration, the
flax-params bridge (``import_jax``) and the reference-checkpoint import
(``import_reference``)."""
from .checkpoint import (
    load_checkpoint_metadata,
    load_weights_verbosely,
    restore_dataset,
    restore_model_and_params,
    save_model,
)
from .config import (
    apply_hyperdrive_overrides,
    load_default_hypers,
    merge_params,
    parse_params_override,
)
from .import_reference import import_reference_weights
from .optimizers import make_optimizer
from .run import (
    get_train_cli_arg_parser,
    make_run_id,
    parse_hyperdrive_leftovers,
    run_and_debug,
    run_train_from_args,
    test_model,
)
from .tasks import (
    get_known_tasks,
    register_task,
    task_name_to_dataset_class,
    task_name_to_model_class,
)
from .training import (
    TrainState,
    build_training,
    create_train_state,
    make_eval_step,
    make_predict_step,
    make_train_step,
    run_eval_epoch,
    run_train_epoch,
    train_loop,
)

__all__ = [
    "TrainState",
    "apply_hyperdrive_overrides",
    "build_training",
    "create_train_state",
    "get_known_tasks",
    "get_train_cli_arg_parser",
    "import_reference_weights",
    "load_checkpoint_metadata",
    "load_default_hypers",
    "load_weights_verbosely",
    "make_eval_step",
    "make_optimizer",
    "make_predict_step",
    "make_run_id",
    "make_train_step",
    "merge_params",
    "parse_hyperdrive_leftovers",
    "parse_params_override",
    "register_task",
    "restore_dataset",
    "restore_model_and_params",
    "run_and_debug",
    "run_eval_epoch",
    "run_train_epoch",
    "run_train_from_args",
    "save_model",
    "task_name_to_dataset_class",
    "task_name_to_model_class",
    "test_model",
    "train_loop",
]
