"""Secondary synchronization signals (36.211 6.11.2).

reference: src/lte_lib.cpp:199-300. The SSS is a 62-long +/-1 sequence formed
by interleaving two scrambled 31-long m-sequences; the scrambling depends on
(n_id_1, n_id_2) and on whether the SSS sits in slot 0 or slot 10.

The three base m-sequences are generated from their 36.211 recurrences
rather than hard-coded.
"""

from __future__ import annotations

import functools

import numpy as np


def _mseq(taps) -> np.ndarray:
    """Length-31 binary m-sequence: x(i+5) = sum(x(i+t) for t in taps) mod 2,
    seed x = [0 0 0 0 1]."""
    x = np.zeros(31, dtype=np.int64)
    x[4] = 1
    for i in range(26):
        x[i + 5] = sum(x[i + t] for t in taps) % 2
    return 1 - 2 * x  # BPSK map


@functools.lru_cache(maxsize=1)
def _base_sequences():
    s_td = _mseq((0, 2))        # s~(i+5) = s~(i+2) + s~(i)
    c_td = _mseq((0, 3))        # c~(i+5) = c~(i+3) + c~(i)
    z_td = _mseq((0, 1, 2, 4))  # z~(i+5) = z~(i+4)+z~(i+2)+z~(i+1)+z~(i)
    return s_td, c_td, z_td


def _m0_m1(n_id_1: int):
    qp = n_id_1 // 30
    q = (n_id_1 + qp * (qp + 1) // 2) // 30
    mp = n_id_1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    return m0, m1


@functools.lru_cache(maxsize=None)
def sss_fd(n_id_1: int, n_id_2: int, slot_num: int) -> np.ndarray:
    """Frequency-domain SSS: 62-long vector of +/-1 (int64).

    slot_num must be 0 or 10.
    """
    s_td, c_td, z_td = _base_sequences()
    m0, m1 = _m0_m1(n_id_1)
    idx = np.arange(31)

    s0_m0 = s_td[(idx + m0) % 31]
    s1_m1 = s_td[(idx + m1) % 31]
    c0 = c_td[(idx + n_id_2) % 31]
    c1 = c_td[(idx + n_id_2 + 3) % 31]
    z1_m0 = z_td[(idx + (m0 % 8)) % 31]
    z1_m1 = z_td[(idx + (m1 % 8)) % 31]

    if slot_num == 0:
        ssc1 = s0_m0 * c0
        ssc2 = s1_m1 * c1 * z1_m0
    else:
        ssc1 = s1_m1 * c0
        ssc2 = s0_m0 * c1 * z1_m1

    out = np.empty(62, dtype=np.int64)
    out[0::2] = ssc1
    out[1::2] = ssc2
    return out


@functools.lru_cache(maxsize=None)
def sss_td(n_id_1: int, n_id_2: int, slot_num: int) -> np.ndarray:
    """Time-domain SSS: 62 subcarriers on a 128-point IDFT grid, scaled by
    sqrt(128/62), with a 9-sample cyclic prefix -> 137 complex samples.

    reference: src/lte_lib.cpp:277-300 (same grid mapping as PSS_td; not
    used by the search pipeline, provided for API parity).
    """
    from lte_cell_scanner.models.pss import _fd_to_td

    return _fd_to_td(sss_fd(n_id_1, n_id_2, slot_num).astype(complex))


@functools.lru_cache(maxsize=4)
def sss_fd_all(n_id_2: int) -> np.ndarray:
    """(168, 2, 62) table of all SSS for one n_id_2 (axis 1: slot 0, slot 10)."""
    return np.stack([
        np.stack([sss_fd(n1, n_id_2, 0), sss_fd(n1, n_id_2, 10)])
        for n1 in range(168)
    ])
