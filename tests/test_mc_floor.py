"""Statistical detection-floor regression.

The reference pins its performance envelope at reliable PSS/SSS
detection down to ~-12 dB AWGN SNR and MIB decode to ~-10 dB
(src/searcher.cpp:99-104; threshold derivation
Matlab/pss_search_final.m:207-255). This test asserts the floor at those
two SNR points with binomial tolerance, so a detection-rate regression
fails CI (tools/mc_search.run_sweep_artifact gives full-resolution
rates with Wilson bounds).

-10 dB is the documented MIB floor, so a healthy search decodes there
with p >= 0.95; -12 dB sits ON the sync floor's shoulder by design, so
its threshold must tolerate p ~= 0.8-0.9. With n=8 trials:
  -10 dB, min 5:  under p >= 0.95, P[X <= 4] ~= 4e-4  (binomial)
  -12 dB, min 3:  under p >= 0.86, P[X <= 2] ~= 2e-4
                  (even at a conservative p = 0.80, ~1.2e-3)
so a CI failure means the detection rate genuinely collapsed at that
SNR (to p ~< 0.35 / ~< 0.2 respectively with ~90% power), not that the
RNG stream shifted. The thresholds live in tools/mc_search.FLOOR_POINTS,
which chip_smoke.py also holds the GPU's numerics to.
"""

import numpy as np
import pytest

from lte_cell_scanner.tools.mc_search import (FLOOR_MAX_FALSE, FLOOR_POINTS,
                                              FLOOR_TRIALS, run_mc,
                                              wilson_lower)


@pytest.mark.parametrize("snr_db,min_detect,min_mib", FLOOR_POINTS)
def test_detection_floor_point(snr_db, min_detect, min_mib):
    st = run_mc(FLOOR_TRIALS, snr_db, backend="jax", seed=int(-snr_db),
                ppm=10.0, verbose=0)
    assert st.trials == FLOOR_TRIALS
    assert st.detections >= min_detect, \
        f"{snr_db} dB: {st.detections}/8 detected (floor regression)"
    assert st.mib_successes >= min_mib, \
        f"{snr_db} dB: {st.mib_successes}/8 MIB decodes (floor regression)"
    # The chi^2 threshold calibration bounds false alarms, not just
    # detections (src/CellSearch.cpp:500-503).
    assert st.false_cells <= FLOOR_MAX_FALSE, \
        f"{st.false_cells} false cells"


def test_wilson_lower_bound():
    # Closed-form sanity: k=n gives the textbook z^2/(n+z^2) bound.
    n, z = 50, 1.96
    assert wilson_lower(50, 50) == pytest.approx(n / (n + z * z), abs=1e-9)
    assert wilson_lower(0, 50) == 0.0
    assert 0.83 < wilson_lower(49, 50) < 0.93
    assert wilson_lower(0, 0) == 0.0
    # Monotone in k.
    ks = [wilson_lower(k, 20) for k in range(21)]
    assert all(b >= a for a, b in zip(ks, ks[1:]))
    assert np.isclose(wilson_lower(10, 20), 0.299, atol=0.01)
