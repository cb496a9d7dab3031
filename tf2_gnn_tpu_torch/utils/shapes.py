"""Shared static-shape helpers."""
import math


def round_up(value: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= max(value, 1)."""
    return int(math.ceil(max(value, 1) / multiple) * multiple)
