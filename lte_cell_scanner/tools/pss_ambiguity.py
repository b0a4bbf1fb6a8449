"""PSS ambiguity study: correlation loss vs frequency and time offset.

Reproduces the analysis of Matlab/pss_foff.m — how much correlation power
each Zadoff-Chu PSS retains when the received signal carries a carrier
frequency offset (and/or a timing offset), and how strongly the three PSS
cross-correlate. This is the study that justifies the searcher's 5 kHz
hypothesis spacing and the "correlation at the 2x rate doubles as a matched
filter" design note (src/searcher.cpp:155-166).

Usage:
    python -m lte_cell_scanner.tools.pss_ambiguity \
        [--f-max 30e3] [--n-freq 241] [--t-max 64]
"""

from __future__ import annotations

import argparse

import numpy as np

from lte_cell_scanner.constants import FS_SEARCH
from lte_cell_scanner.models.pss import pss_td_all
from lte_cell_scanner.utils.dsp import db10, fshift


def freq_ambiguity(f_offsets: np.ndarray, fs: float = FS_SEARCH) -> np.ndarray:
    """Normalized |xcorr|^2 of each PSS pair vs frequency offset.

    Returns (3, 3, n_f): entry [t, r, k] is the correlation power of
    transmitted PSS t against receiver template r at offset f_offsets[k],
    normalized so a matched pair at zero offset gives 1.
    """
    tpl = pss_td_all()  # (3, 137)
    tpl = tpl / np.linalg.norm(tpl, axis=1, keepdims=True)
    out = np.empty((3, 3, len(f_offsets)))
    for k, f in enumerate(f_offsets):
        rx = np.stack([fshift(tpl[t], f, fs) for t in range(3)])
        xc = rx @ tpl.conj().T  # (3 tx, 3 rx-template)
        out[:, :, k] = np.abs(xc) ** 2
    return out


def time_ambiguity(t_offsets: np.ndarray) -> np.ndarray:
    """Normalized matched-filter response |xcorr|^2 vs integer lag.

    Returns (3, n_t): the self-ambiguity of each PSS along the time axis
    (zero-padded linear correlation), peak-normalized.
    """
    tpl = pss_td_all()
    n = tpl.shape[1]
    out = np.empty((3, len(t_offsets)))
    for i, t in enumerate(range(3)):
        x = tpl[t]
        for j, lag in enumerate(t_offsets):
            lag = int(lag)
            if lag >= 0:
                a, b = x[lag:], x[:n - lag]
            else:
                a, b = x[:n + lag], x[-lag:]
            out[i, j] = np.abs(np.vdot(b, a)) ** 2
        out[i] /= np.abs(np.vdot(x, x)) ** 2
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f-max", type=float, default=30e3)
    ap.add_argument("--n-freq", type=int, default=241)
    ap.add_argument("--t-max", type=int, default=16)
    args = ap.parse_args(argv)

    from lte_cell_scanner.tracker.display import ascii_plot

    f = np.linspace(-args.f_max, args.f_max, args.n_freq)
    amb = freq_ambiguity(f)
    print("PSS self-correlation loss vs frequency offset (dB):")
    for t in range(3):
        print(f"  PSS {t}:")
        print(ascii_plot(db10(np.maximum(amb[t, t], 1e-12)), width=64,
                         height=8))
    half = amb[0, 0] >= 0.5
    span = f[half]
    print(f"-3 dB full width of PSS 0: {span[-1] - span[0]:.0f} Hz "
          f"(5 kHz hypothesis spacing loses at most "
          f"{-db10(freq_ambiguity(np.array([2.5e3]))[0, 0, 0]):.2f} dB)")
    worst_cross = max(np.max(amb[t, r]) for t in range(3) for r in range(3)
                      if t != r)
    print(f"worst cross-PSS correlation over the grid: "
          f"{db10(worst_cross):.1f} dB")

    t = np.arange(-args.t_max, args.t_max + 1)
    ta = time_ambiguity(t)
    print("PSS 0 self-ambiguity vs time offset (dB):")
    print(ascii_plot(db10(np.maximum(ta[0], 1e-12)), width=64, height=8))


if __name__ == "__main__":
    main()
