"""Multi-host (multi-process) distributed execution.

Spawns REAL OS processes: each worker calls jax.distributed.initialize
(gloo collectives over localhost), builds a global (seq, hyp) mesh that
spans the process boundary, runs the sharded PSS scan, and asserts 1e-12
full-table parity against the float64 host reference. SURVEY §2.9/§5
"distributed communication backend".
"""

from lte_cell_scanner.parallel.multihost import (dryrun_multihost,
                                                 measure_sweep_scaling)


def test_two_process_parity():
    # Smaller than the production dryrun (which the driver runs via
    # __graft_entry__) to keep the suite fast; still crosses the process
    # boundary with both the seq psum and the hyp all_gather.
    dryrun_multihost(n_procs=2, devices_per_proc=2, n_cap=76800, n_f=4,
                     n_hyp=2, verbose=False)


def test_sweep_scaling_measured():
    """The capture-sharded sweep runs at 1 and 2 processes and the
    estimator reports every pooled sample. Only the structure is
    asserted: a wall-clock ratio between CPU processes measures the
    host's scheduling, not the program (scaling across devices is
    measured on GPUs, not here)."""
    import numpy as np

    res = measure_sweep_scaling(n_procs=2, b_per_proc=2, n_f=2,
                                n_cap=76800, reps=2, verbose=False,
                                n_meas=2)
    assert len(res["scaling_samples"]) == 4, res   # two pooled sets
    assert all(np.isfinite(v) and v > 0 for v in res["scaling_samples"])
    assert res["scaling"] in res["scaling_samples"]
    assert res["samples_per_sec_1host"] > 0
    assert res["samples_per_sec_nhost_total"] > 0


def test_sweep_scaling_pooled_estimator(monkeypatch):
    """The estimator pools TWO full n_meas-sample sets and takes the
    lower-middle order statistic of the 2*n_meas samples — a fixed,
    unconditional stopping rule (an outside-band rerun trigger would
    inflate pass probability at the margin); all samples ship sorted
    for auditability."""
    from lte_cell_scanner.parallel import multihost as mh

    seq = iter([1.8, 0.95, 2.0, 1.05, 0.9, 1.0])
    monkeypatch.setattr(
        mh, "_measure_sweep_once",
        lambda *a, **k: {"scaling": next(seq)})
    res = mh.measure_sweep_scaling(verbose=False, n_meas=3)
    # sorted pool: [0.9, 0.95, 1.0, 1.05, 1.8, 2.0] -> lower-middle 1.0
    assert res["scaling"] == 1.0
    assert res["scaling_samples"] == [0.9, 0.95, 1.0, 1.05, 1.8, 2.0]
    assert "scaling_samples_discarded_run" not in res
