"""Learning-rate schedules (port of ``tf2_gnn_tpu/utils/schedules.py``).

``polynomial_warmup_and_decay_schedule`` reproduces the reference's
PolynomialWarmupAndDecaySchedule: polynomial rise initial->peak over
``warmup_steps``, then polynomial decay peak->final over ``decay_steps``
(clamped afterwards). Schedules here are plain ``step -> float`` functions;
the optimizer sets the rate before each update.
"""
from typing import Callable, Union

Schedule = Callable[[int], float]


def polynomial_warmup_and_decay_schedule(
    learning_rate: float,
    warmup_steps: int,
    decay_steps: int,
    initial_learning_rate: float,
    final_learning_rate: float,
    power: float = 1.0,
) -> Schedule:
    def schedule(step: int) -> float:
        step = float(step)
        if step <= warmup_steps:
            return ((learning_rate - initial_learning_rate)
                    * (step / warmup_steps) ** power + initial_learning_rate)
        effective = min(step - warmup_steps, decay_steps)
        return ((learning_rate - final_learning_rate)
                * (1.0 - effective / decay_steps) ** power
                + final_learning_rate)

    return schedule


def make_learning_rate(params: dict) -> Union[float, Schedule]:
    """A plain float when no warmup/decay steps are configured, else the
    polynomial schedule with 1e-5 boundary rates substituted for the missing
    phase (reference graph_task_model.py:224-260)."""
    learning_rate = params.get("learning_rate", 0.001)
    num_warmup = params.get("learning_rate_warmup_steps")
    num_decay = params.get("learning_rate_decay_steps")
    if num_warmup is None and num_decay is None:
        return learning_rate

    initial_learning_rate = 1e-5
    final_learning_rate = 1e-5
    if num_warmup is None:
        num_warmup = -1  # no warmup phase
        initial_learning_rate = learning_rate
    if num_decay is None:
        num_decay = 1  # value irrelevant, must be non-zero
        final_learning_rate = learning_rate
    return polynomial_warmup_and_decay_schedule(
        learning_rate=learning_rate,
        warmup_steps=num_warmup,
        decay_steps=num_decay,
        initial_learning_rate=initial_learning_rate,
        final_learning_rate=final_learning_rate,
        power=1.0,
    )
