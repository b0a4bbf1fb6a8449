"""Device (JAX) vs float64 host-reference parity for the PSS scan."""

import numpy as np

from lte_cell_scanner.ops.xcorr import xcorr_pss


def _synthetic_capture(n=153600, seed=0, f_off=12e3):
    """Noise + embedded PSS repetitions at a known offset."""
    from lte_cell_scanner.models.pss import pss_td

    rng = np.random.default_rng(seed)
    cap = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.05
    tpl = pss_td(1)
    t = np.arange(137)
    shifted = tpl * np.exp(1j * 2 * np.pi * f_off * t / 1.92e6)
    for k in range(500, n - 137, 9600):
        cap[k:k + 137] += 0.3 * shifted
    return cap


def test_jax_matches_numpy_x64():
    cap = _synthetic_capture()
    fset = np.arange(-3, 4) * 5e3
    rn = xcorr_pss(cap, fset, 2, 739e6, 739e6, 1.92e6, backend="numpy")
    rj = xcorr_pss(cap, fset, 2, 739e6, 739e6, 1.92e6, backend="jax")
    # CPU x64: should agree to near machine precision.
    np.testing.assert_allclose(rj.xc_incoherent_collapsed_pow,
                               rn.xc_incoherent_collapsed_pow,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(rj.xc_incoherent_single),
                               np.asarray(rn.xc_incoherent_single),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(rj.sp_incoherent, rn.sp_incoherent,
                               rtol=0, atol=1e-12)
    assert (rj.xc_incoherent_collapsed_frq
            == rn.xc_incoherent_collapsed_frq).all()
    assert rj.n_comb_xc == rn.n_comb_xc and rj.n_comb_sp == rn.n_comb_sp


def test_jax_detects_planted_pss():
    cap = _synthetic_capture(f_off=12e3)
    fset = np.arange(-3, 4) * 5e3
    rj = xcorr_pss(cap, fset, 2, 739e6, 739e6, 1.92e6, backend="jax")
    pow_ = rj.xc_incoherent_collapsed_pow
    # Strongest response on PSS 1 near lag 500, at the 10 kHz hypothesis.
    n2, lag = np.unravel_index(np.argmax(pow_), pow_.shape)
    assert n2 == 1
    assert abs(lag - 500) <= 2
    foi = rj.xc_incoherent_collapsed_frq[n2, lag]
    assert fset[foi] in (10e3, 15e3)


def test_batched_core_matches_single():
    import jax.numpy as jnp

    from lte_cell_scanner.ops.xcorr import (fold_start_indices,
                                            shifted_templates)
    from lte_cell_scanner.ops.xcorr_jax import (xcorr_pss_core,
                                                xcorr_pss_core_batch)

    fset = np.arange(-2, 3) * 5e3
    caps = np.stack([_synthetic_capture(n=76800, seed=s) for s in range(3)])
    n_lags = 76800 - 136
    n_comb_xc = (n_lags - 100) // 9600
    n_comb_sp = (76800 - 136 - 137) // 9600
    tpl = shifted_templates(fset, 739e6, 739e6, 1.92e6).reshape(-1, 137)
    starts = fold_start_indices(fset, n_comb_xc, 739e6, 739e6, 1.92e6)

    cap_ri = np.stack([caps.real, caps.imag], axis=-1)
    args = (jnp.asarray(tpl.real), jnp.asarray(tpl.imag),
            jnp.asarray(starts.astype(np.int32)), n_comb_sp, 2)
    packed_b, single_b, _ = xcorr_pss_core_batch(jnp.asarray(cap_ri), *args)
    for b in range(3):
        packed, single, _ = xcorr_pss_core(jnp.asarray(cap_ri[b]), *args)
        np.testing.assert_allclose(np.asarray(packed_b[b]), np.asarray(packed),
                                   rtol=0, atol=1e-12)
