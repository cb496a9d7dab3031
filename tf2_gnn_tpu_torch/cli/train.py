"""``tf2_gnn_tpu_torch_train`` console entry (port of
``tf2_gnn_tpu/cli/train.py``; reference tf2_gnn/cli/train.py:13-38).

Usage: ``tf2_gnn_tpu_torch_train RGCN PPI data/ppi/ [options] [--hyper
value ...]``, or ``python -m tf2_gnn_tpu_torch.cli.train ...``. Leftover
``--key value`` pairs are hyperdrive-style overrides, coerced to the type
of the matching hyperparameter (``--gnn_use_remat True``). Runs on the
card; ``--device cpu`` asks for the CPU.
"""
from typing import Optional, Sequence

from ..harness.run import (
    get_train_cli_arg_parser,
    parse_hyperdrive_leftovers,
    run_and_debug,
    run_train_from_args,
)


def run(argv: Optional[Sequence[str]] = None):
    """Parse ``argv`` (default: the command line), train, and return the
    best checkpoint's path."""
    parser = get_train_cli_arg_parser()
    args, leftovers = parser.parse_known_args(argv)
    overrides = parse_hyperdrive_leftovers(leftovers)
    return run_and_debug(lambda: run_train_from_args(args, overrides),
                         args.debug)


if __name__ == "__main__":
    run()
