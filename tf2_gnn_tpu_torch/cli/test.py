"""``tf2_gnn_tpu_torch_test`` console entry (port of
``tf2_gnn_tpu/cli/test.py``; reference tf2_gnn/cli/test.py:39-84).

Usage: ``tf2_gnn_tpu_torch_test trained_model.pkl data/ppi/``, or
``python -m tf2_gnn_tpu_torch.cli.test ...``. Runs on the card;
``--device cpu`` asks for the CPU.
"""
import argparse
from typing import Optional, Sequence

from ..harness.run import run_and_debug, test_model


def run(argv: Optional[Sequence[str]] = None):
    """Parse ``argv`` (default: the command line), evaluate the checkpoint
    on the TEST fold and return its metric (lower is better)."""
    parser = argparse.ArgumentParser(
        description="Evaluate a model trained with the PyTorch port.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("trained_model", type=str,
                        help="Checkpoint .pkl file.")
    parser.add_argument("data_path", type=str,
                        help="Directory with the task data.")
    parser.add_argument("--model-params-override", type=str, default=None,
                        help="JSON string or file overriding model hypers.")
    parser.add_argument("--data-params-override", type=str, default=None,
                        help="JSON string or file overriding dataset hypers.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to run on; 'cpu' runs the kernels' "
                        "plain PyTorch versions (for tests).")
    parser.add_argument("--azure-info", type=str, default=None,
                        help="Accepted for reference compatibility; azure:// "
                        "data paths need a resolver (data/io.py).")
    parser.add_argument("--quiet", action="store_true", default=False,
                        help="Accepted for reference compatibility.")
    parser.add_argument("--debug", action="store_true", default=False)
    args = parser.parse_args(argv)
    return run_and_debug(
        lambda: test_model(
            args.trained_model, args.data_path,
            model_params_override=args.model_params_override,
            data_params_override=args.data_params_override,
            device=args.device,
        ),
        args.debug,
    )


if __name__ == "__main__":
    run()
