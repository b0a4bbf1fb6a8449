"""Noise-bias factor of the 13-tap frequency-domain channel smoother.

The sync chain smooths raw channel estimates with a moving average over
+/- 6 neighboring subcarriers (clipped at the band edges) and then
estimates the noise power as ``sigpower(h_smoothed - h_raw)``. Because the
smoother's output still contains a fraction of the input noise, that
residual-based noise estimate is biased; this tool computes the exact bias
factor and cross-checks it by Monte Carlo.

For white unit-power noise n and smoother matrix F, the residual is
(F - I) n, so  E|residual|^2 per subcarrier = trace((F-I)(F-I)^H) / 62.
The reference computes the same quantity in a scratch experiment
(src/exp.cpp:37-67, not built by default); the factor it derives is why
`sss_detect_getce_sss` treats `sigpower(h_sm - h_raw)` as an estimate of
(1 - 1/13-ish) of the true noise power (src/searcher.cpp:590-596).

Usage:  python -m lte_cell_scanner.tools.noise_bias [--trials N]
"""

from __future__ import annotations

import argparse

import numpy as np

N_SC_SYNC = 62  # sync channel width the smoother runs over
ARM = 6         # smoother half-width (13 taps in the clear)


def smoother_matrix(n: int = N_SC_SYNC, arm: int = ARM) -> np.ndarray:
    """The (n, n) moving-average smoother with edge clipping.

    Row t averages columns [max(0, t-arm), min(n-1, t+arm)] uniformly —
    the matrix form of the loop in sss_detect_getce_sss
    (src/searcher.cpp:584-588) and chan_est's frequency pass.
    """
    f = np.zeros((n, n))
    for t in range(n):
        lt, rt = max(0, t - arm), min(n - 1, t + arm)
        f[t, lt:rt + 1] = 1.0 / (rt - lt + 1)
    return f


def residual_noise_factor(n: int = N_SC_SYNC, arm: int = ARM) -> float:
    """E|((F-I) n)|^2 / E|n|^2 per subcarrier for white noise n."""
    f = smoother_matrix(n, arm)
    fmi = f - np.eye(n)
    return float(np.trace(fmi @ fmi.T) / n)


def smoothed_noise_factor(n: int = N_SC_SYNC, arm: int = ARM) -> float:
    """E|(F n)|^2 / E|n|^2 per subcarrier: noise remaining after smoothing."""
    f = smoother_matrix(n, arm)
    return float(np.trace(f @ f.T) / n)


def monte_carlo_factor(n: int = N_SC_SYNC, arm: int = ARM,
                       trials: int = 10000, seed: int = 0):
    """Monte-Carlo cross-check of both factors with complex white noise."""
    rng = np.random.default_rng(seed)
    f = smoother_matrix(n, arm)
    noise = (rng.standard_normal((trials, n))
             + 1j * rng.standard_normal((trials, n))) / np.sqrt(2.0)
    sm = noise @ f.T
    res = np.mean(np.abs(sm - noise) ** 2)
    kept = np.mean(np.abs(sm) ** 2)
    return float(res), float(kept)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=10000)
    args = ap.parse_args(argv)

    res = residual_noise_factor()
    kept = smoothed_noise_factor()
    mc_res, mc_kept = monte_carlo_factor(trials=args.trials)
    print(f"residual noise factor  E|(F-I)n|^2 : {res:.6f}  "
          f"(MC {mc_res:.6f})")
    print(f"smoothed noise factor  E|Fn|^2     : {kept:.6f}  "
          f"(MC {mc_kept:.6f})")
    print(f"-> np_est = sigpower(h_sm - h_raw) underestimates true noise "
          f"power by x{res:.4f}; correct with 1/{res:.4f} = {1 / res:.4f}")


if __name__ == "__main__":
    main()
