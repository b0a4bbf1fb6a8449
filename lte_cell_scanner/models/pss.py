"""Primary synchronization signals (Zadoff-Chu roots 25/29/34).

reference: src/lte_lib.cpp:155-193. The frequency-domain PSS is 62 samples
(DC deleted); the time-domain template maps those onto a 128-point IDFT grid,
scales by sqrt(128/62) and prepends a 9-sample cyclic prefix, yielding the
137-tap correlator kernel.
"""

from __future__ import annotations

import functools

import numpy as np

from lte_cell_scanner.utils.dsp import idft

ZC_ROOTS = (25, 29, 34)


@functools.lru_cache(maxsize=None)
def pss_fd(n_id_2: int) -> np.ndarray:
    """Frequency-domain PSS: 62 complex samples (element 31 = DC removed)."""
    u = ZC_ROOTS[n_id_2]
    n = np.arange(63, dtype=np.float64)
    r = np.exp(-1j * np.pi * u * n * (n + 1) / 63.0)
    return np.delete(r, 31)


def _fd_to_td(fd: np.ndarray) -> np.ndarray:
    """Map 62 sync subcarriers into a 128-point IDFT and prepend a 9-tap CP."""
    grid = np.concatenate([
        np.zeros(1, dtype=complex), fd[31:62],
        np.zeros(65, dtype=complex), fd[0:31],
    ])
    td = idft(grid) * np.sqrt(128.0 / 62.0)
    return np.concatenate([td[119:128], td])


@functools.lru_cache(maxsize=None)
def pss_td(n_id_2: int) -> np.ndarray:
    """Time-domain PSS template: 137 complex samples."""
    return _fd_to_td(pss_fd(n_id_2))


@functools.lru_cache(maxsize=1)
def pss_fd_all() -> np.ndarray:
    """(3, 62) array of all frequency-domain PSS."""
    return np.stack([pss_fd(t) for t in range(3)])


@functools.lru_cache(maxsize=1)
def pss_td_all() -> np.ndarray:
    """(3, 137) array of all time-domain PSS templates."""
    return np.stack([pss_td(t) for t in range(3)])
