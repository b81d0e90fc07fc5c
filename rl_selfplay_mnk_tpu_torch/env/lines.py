"""Every K-in-a-row line of an M x N board, as cell lists and as a matrix.

A numpy copy of the JAX package's ``env/lines.py``: the same enumeration
order (per cell: horizontal, vertical, main diagonal, anti-diagonal), so
``line_matrix`` is the same (M*N, n_lines) incidence matrix. The plain env
step counts a board's stones per line as ``plane @ line_matrix``; the CUDA
env-step kernel finds the same lines by arithmetic (runs of k along the four
directions of ``line_cells``) and reads no table.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def line_cells(m: int, n: int, k: int) -> tuple[tuple[int, ...], ...]:
    """All K-in-a-row lines as tuples of flat cell indices."""
    lines: list[tuple[int, ...]] = []
    for r in range(m):
        for c in range(n):
            if c + k <= n:  # horizontal
                lines.append(tuple(r * n + (c + i) for i in range(k)))
            if r + k <= m:  # vertical
                lines.append(tuple((r + i) * n + c for i in range(k)))
            if r + k <= m and c + k <= n:  # main diagonal
                lines.append(tuple((r + i) * n + (c + i) for i in range(k)))
            if r + k <= m and c - k + 1 >= 0:  # anti-diagonal
                lines.append(tuple((r + i) * n + (c - i) for i in range(k)))
    return tuple(lines)


@functools.lru_cache(maxsize=None)
def line_matrix(m: int, n: int, k: int) -> np.ndarray:
    """(M*N, n_lines) float32 incidence matrix: 1 where the cell is on the line."""
    lines = line_cells(m, n, k)
    mat = np.zeros((m * n, len(lines)), dtype=np.float32)
    for j, cells in enumerate(lines):
        mat[list(cells), j] = 1.0
    return mat


def num_lines(m: int, n: int, k: int) -> int:
    return len(line_cells(m, n, k))
