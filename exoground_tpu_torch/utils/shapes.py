"""Tiny shared shape helpers (leaf module: no package-level imports)."""


def round_up(x: int, m: int) -> int:
    """x rounded up to the next multiple of m (m >= 1)."""
    return -(-x // m) * m
