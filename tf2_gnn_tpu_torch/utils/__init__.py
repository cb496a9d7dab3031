"""Small shared helpers (constants, shapes, schedules, device choice)."""
