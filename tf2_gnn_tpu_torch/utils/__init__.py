"""Small shared helpers (constants, shapes, schedules, device choice)."""
from .constants import SMALL_NUMBER

__all__ = ["SMALL_NUMBER"]
