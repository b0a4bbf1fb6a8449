"""PBCH extraction and blind MIB decoding.

reference: src/searcher.cpp:1482-1692 (pbch_extract, decode_mib). The blind
search tries 4 frame timings x {1, 2, 4} antenna ports; each trial runs
SFBC (Alamouti) channel compensation, QPSK soft demod, descrambling,
de-ratematching, tail-biting Viterbi and a CRC16 check with the
antenna-count mask.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from lte_cell_scanner.models.cell import Cell
from lte_cell_scanner.models.convcode import lte_conv_decode
from lte_cell_scanner.models.crc import lte_calc_crc
from lte_cell_scanner.models.modulation import lte_demodulate
from lte_cell_scanner.models.pn import lte_pn
from lte_cell_scanner.models.ratematch import lte_conv_deratematch
from lte_cell_scanner.models.rs import RSDL
from lte_cell_scanner.ops.chanest import chan_est

N_RB_DL_TABLE = {0: 6, 1: 15, 2: 25, 3: 50, 4: 75, 5: 100}
PHICH_RES_TABLE = {0: 1 / 6, 1: 1 / 2, 2: 1.0, 3: 2.0}


def pbch_extract(cell: Cell, tfg: np.ndarray, ce: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather the PBCH REs of 4 frames.

    ``ce`` is (4, n_ofdm, 72). Returns (pbch_sym (m_bit/2,),
    pbch_ce (4, m_bit/2)).
    """
    n_symb_dl = cell.n_symb_dl
    m_bit = 1920 if cell.cp_type == "normal" else 1728
    v_shift_m3 = cell.n_id_cell() % 3

    sc = np.arange(72)
    sym_rows = []
    keep_cols = []
    for fr in range(4):
        for sym in range(4):
            rs_here = (sym in (0, 1)) or (sym == 3 and n_symb_dl == 6)
            mask = ~((sc % 3 == v_shift_m3) & rs_here)
            sym_num = fr * 10 * 2 * n_symb_dl + n_symb_dl + sym
            sym_rows.append(np.full(mask.sum(), sym_num))
            keep_cols.append(sc[mask])
    rows = np.concatenate(sym_rows)
    cols = np.concatenate(keep_cols)
    assert len(rows) == m_bit // 2
    return tfg[rows, cols], ce[:, rows, cols]


def _sfbc_compensate(pbch_sym, pbch_ce, np_v, n_ports):
    """Channel compensation: MRC (1 port) or Alamouti zero-forcing (2/4).

    Returns (syms, per-symbol noise power).
    """
    n = len(pbch_sym)
    if n_ports == 1:
        h = pbch_ce[0]
        gain = np.conj(h) / (h.real**2 + h.imag**2)
        syms = pbch_sym * gain
        np_out = np_v[0] * (gain.real**2 + gain.imag**2)
        return syms, np_out

    pairs = n // 2
    x1 = pbch_sym[0::2]
    x2 = pbch_sym[1::2]
    if n_ports == 2:
        h1 = 0.5 * (pbch_ce[0, 0::2] + pbch_ce[0, 1::2])
        h2 = 0.5 * (pbch_ce[1, 0::2] + pbch_ce[1, 1::2])
        np_temp = np.full(pairs, np.mean(np_v[:2]))
    else:
        # Port pairs alternate (0,2) / (1,3) every two symbols.
        h1a = 0.5 * (pbch_ce[0, 0::2] + pbch_ce[0, 1::2])
        h2a = 0.5 * (pbch_ce[2, 0::2] + pbch_ce[2, 1::2])
        h1b = 0.5 * (pbch_ce[1, 0::2] + pbch_ce[1, 1::2])
        h2b = 0.5 * (pbch_ce[3, 0::2] + pbch_ce[3, 1::2])
        use_a = (np.arange(pairs) % 2) == 0
        h1 = np.where(use_a, h1a, h1b)
        h2 = np.where(use_a, h2a, h2b)
        np_temp = np.where(use_a, (np_v[0] + np_v[2]) / 2, (np_v[1] + np_v[3]) / 2)
    scale = h1.real**2 + h1.imag**2 + h2.real**2 + h2.imag**2
    s1 = (np.conj(h1) * x1 + h2 * np.conj(x2)) / scale
    s2 = np.conj((-np.conj(h2) * x1 + h1 * np.conj(x2)) / scale)
    np_pair = ((np.abs(h1) / scale) ** 2 + (np.abs(h2) / scale) ** 2) * np_temp
    syms = np.empty(n, dtype=np.complex128)
    syms[0::2] = s1
    syms[1::2] = s2
    syms *= np.sqrt(2.0)  # transmit-diversity precoding factor
    np_out = np.repeat(np_pair, 2)
    return syms, np_out


def decode_mib(cell: Cell, tfg: np.ndarray, rs_dl: RSDL,
               interp: str = "hex") -> Cell:
    """Blind MIB decode; fills n_ports/n_rb_dl/phich_*/sfn on success."""
    n_symb_dl = cell.n_symb_dl
    n_ofdm = tfg.shape[0]

    ce_tfg = np.empty((4, n_ofdm, 72), dtype=np.complex128)
    np_v = np.empty(4)
    for port in range(4):
        ce_tfg[port], np_v[port] = chan_est(cell, rs_dl, tfg, port, interp=interp)

    n_id_cell = cell.n_id_cell()
    for frame_timing_guess in range(4):
        start = frame_timing_guess * 10 * 2 * n_symb_dl
        stop = start + 3 * 10 * 2 * n_symb_dl + 2 * n_symb_dl
        tfg_try = tfg[start:stop]
        ce_try = ce_tfg[:, start:stop]
        pbch_sym, pbch_ce = pbch_extract(cell, tfg_try, ce_try)

        for n_ports in (1, 2, 4):
            syms, np_sym = _sfbc_compensate(pbch_sym, pbch_ce, np_v, n_ports)
            e_est = lte_demodulate(syms, np_sym, "qpsk")
            scr = lte_pn(n_id_cell, len(e_est))
            e_est = np.where(scr == 1, -e_est, e_est)
            d_est = lte_conv_deratematch(e_est, 40)
            c_est = lte_conv_decode(d_est)
            crc_est = lte_calc_crc(c_est[:24], "crc16")
            if n_ports == 2:
                crc_est = 1 - crc_est
            elif n_ports == 4:
                crc_est[1::2] = 1 - crc_est[1::2]
            if np.array_equal(crc_est, c_est[24:]):
                return _unpack_mib(cell, c_est, n_ports, frame_timing_guess)
    return dataclasses.replace(cell)


def _unpack_mib(cell: Cell, c_est: np.ndarray, n_ports: int,
                frame_timing_guess: int) -> Cell:
    out = dataclasses.replace(cell)
    out.n_ports = n_ports
    bw_packed = int(c_est[0]) * 4 + int(c_est[1]) * 2 + int(c_est[2])
    out.n_rb_dl = N_RB_DL_TABLE.get(bw_packed, -1)
    out.phich_duration = "extended" if c_est[3] else "normal"
    out.phich_resource = PHICH_RES_TABLE[int(c_est[4]) * 2 + int(c_est[5])]
    sfn_high = 0
    for b in c_est[6:14]:
        sfn_high = 2 * sfn_high + int(b)
    out.sfn = int(np.mod(sfn_high * 4 - frame_timing_guess, 1024))
    return out
