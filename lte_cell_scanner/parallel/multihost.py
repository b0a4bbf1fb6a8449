"""Multi-host distributed execution of the sharded PSS scan.

The reference's only "communication backend" is boost::mutex FIFOs inside
one process (include/LTE-Tracker.h:88-252); SURVEY §2.9/§5 names the
JAX equivalent: ``jax.distributed.initialize`` + shard_map collectives
within a host and across hosts. This module provides exactly that:

- :func:`init_multihost` — process bring-up (coordinator handshake).
- The (seq, hyp) search mesh of parallel/sharded_search.py spans the
  GLOBAL device list once distributed mode is up; each host stages only
  its addressable capture blocks/templates and the one ``psum`` of the
  partial fold tables is the only cross-host traffic.
- :func:`dryrun_multihost` — a driver-runnable 2-process CPU dryrun:
  spawns N real OS processes (gloo collectives over localhost), runs the
  production-shape scan sharded across the process boundary, and asserts
  1e-12 full-table parity against the float64 host reference in EVERY
  process.

Scaling: the fc sweep (the production workload) shards CAPTURES across
hosts with zero cross-host traffic; the single-capture (seq, hyp) mesh
adds one psum of a (3, 9600, n_f_local) float32 table per capture. No
multi-host number has been measured on GPUs; the dryrun's CPU
wall-clock ratios measure the host's scheduling, not the program.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Optional

import numpy as np

_OK_MARK = "MULTIHOST_PARITY_OK"


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int) -> None:
    """Bring this process into the distributed runtime.

    Must run before the first JAX backend touch. After it returns,
    jax.devices() is the global device list and make_search_mesh()
    builds meshes spanning every host.
    """
    import jax

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _planted_capture(n_cap: int, n_f: int):
    """Deterministic scan input: PSS planted in noise (same generator as
    __graft_entry__ so dryruns and tests agree)."""
    from lte_cell_scanner.models.pss import pss_td

    rng = np.random.default_rng(0)
    cap = (rng.standard_normal(n_cap) + 1j * rng.standard_normal(n_cap)) * 0.1
    tpl = pss_td(1)
    for k in range(300, n_cap - 137, 9600):
        cap[k:k + 137] += 0.5 * tpl
    fset = (np.arange(n_f) - n_f // 2) * 5e3
    return cap, fset, 739e6


def _sweep_worker() -> None:
    """Capture-sharded sweep throughput worker (MH_MODE=sweep).

    Measures this process's wall-clock for ITS shard of a production fc
    sweep inside a real ``jax.distributed`` session. Because this
    machine exposes a single CPU core, the processes take turns:
    process p computes while every other process sleeps in a gloo
    barrier (blocking socket read — no CPU), so each t_self is an
    honest full-core measurement, and the cross-host synchronization
    cost is measured separately. The parent combines them (see
    measure_sweep_scaling).
    """
    import jax

    jax.config.update("jax_platforms", "cpu")
    init_multihost(os.environ["MH_COORD"], int(os.environ["MH_NPROC"]),
                   int(os.environ["MH_PID"]))
    from jax._src import distributed

    def barrier(name: str) -> None:
        # Coordinator-service barrier: a blocking gRPC wait, so parked
        # processes consume NO cpu (multihost_utils.sync_global_devices
        # busy-spins on the CPU backend, which would falsify the
        # single-core turn-taking measurement below).
        distributed.global_state.client.wait_at_barrier(name, 600_000)

    n_procs = int(os.environ["MH_NPROC"])
    pid = int(os.environ["MH_PID"])
    n_cap = int(os.environ.get("MH_NCAP", "153600"))
    n_f = int(os.environ.get("MH_NF", "4"))
    b_local = int(os.environ.get("MH_B", "4"))
    reps = int(os.environ.get("MH_REPS", "2"))

    from jax.sharding import Mesh

    from lte_cell_scanner.parallel.fc_sweep import sharded_fc_sweep

    cap, fset, fc = _planted_capture(n_cap, n_f)
    caps = np.stack([cap] * b_local)
    fcs = [fc + 100e3 * (pid * b_local + i) for i in range(b_local)]
    # LOCAL mesh: the capture axis shards across hosts with zero
    # cross-host traffic, so each host sweeps its captures on its own
    # addressable devices (jax.devices() would span other processes).
    n_shards = max(d for d in range(1, len(jax.local_devices()) + 1)
                   if b_local % d == 0)
    mesh = Mesh(np.array(jax.local_devices()[:n_shards]), ("cap",))

    def sweep_once():
        return sharded_fc_sweep(caps, fcs, fset, mesh)

    peaks = sweep_once()                          # warm-up + compile
    assert all(len(p) >= 1 for p in peaks), "planted PSS not found"
    barrier("mh_sweep_warm")
    t_self = 0.0
    for slot in range(n_procs):
        barrier(f"mh_sweep_slot{slot}")
        if slot == pid:
            t0 = time.time()
            for _ in range(reps):
                sweep_once()
            t_self = time.time() - t0
    barrier("mh_sweep_done")
    t0 = time.time()
    for i in range(8):
        barrier(f"mh_sweep_bar{i}")
    t_comm = (time.time() - t0) / 8
    print(f"MULTIHOST_SWEEP proc={pid}/{n_procs} t_self={t_self:.3f} "
          f"t_comm={t_comm:.4f} samples={reps * b_local * n_cap}",
          flush=True)


def _worker_main() -> None:
    """Entry point of each dryrun process (configured via MH_* env)."""
    if os.environ.get("MH_MODE") == "sweep":
        _sweep_worker()
        return
    import jax

    # The dryrun validates the cross-process program on virtual CPU
    # devices, whatever accelerator the machine has.
    jax.config.update("jax_platforms", "cpu")
    init_multihost(os.environ["MH_COORD"], int(os.environ["MH_NPROC"]),
                   int(os.environ["MH_PID"]))
    jax.config.update("jax_enable_x64", True)

    n_cap = int(os.environ.get("MH_NCAP", "153600"))
    n_f = int(os.environ.get("MH_NF", "8"))
    n_seq = int(os.environ["MH_SEQ"])
    n_hyp = int(os.environ["MH_HYP"])

    from lte_cell_scanner.ops.xcorr import xcorr_pss
    from lte_cell_scanner.parallel.sharded_search import (
        make_search_mesh, sharded_xcorr_pss)

    assert len(jax.devices()) >= n_seq * n_hyp, "not enough global devices"
    assert jax.process_count() == int(os.environ["MH_NPROC"])
    mesh = make_search_mesh(n_seq, n_hyp)
    cap, fset, fc = _planted_capture(n_cap, n_f)

    t0 = time.time()
    out = sharded_xcorr_pss(cap, fset, 2, fc, fc, 1.92e6, mesh,
                            dtype=np.float64)
    t_dist = time.time() - t0
    ref = xcorr_pss(cap, fset, 2, fc, fc, 1.92e6, backend="numpy")

    np.testing.assert_allclose(out.xc_incoherent_collapsed_pow,
                               ref.xc_incoherent_collapsed_pow,
                               rtol=0, atol=1e-12)
    assert (out.xc_incoherent_collapsed_frq
            == ref.xc_incoherent_collapsed_frq).all()
    np.testing.assert_allclose(out.xc_incoherent_single,
                               ref.xc_incoherent_single,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(out.sp_incoherent, ref.sp_incoherent,
                               rtol=0, atol=1e-12)
    print(f"{_OK_MARK} proc={jax.process_index()}/{jax.process_count()} "
          f"mesh=seq{n_seq}xhyp{n_hyp} n_cap={n_cap} n_f={n_f} "
          f"dist_wallclock={t_dist:.1f}s", flush=True)


def dryrun_multihost(n_procs: int = 2, devices_per_proc: int = 4,
                     n_cap: int = 153600, n_f: int = 8,
                     n_hyp: int = 2, timeout: float = 900.0,
                     verbose: bool = True) -> None:
    """Launch the N-process CPU parity dryrun; raises on any failure.

    Each process gets ``devices_per_proc`` virtual CPU devices
    (xla_force_host_platform_device_count) and the (seq, hyp) mesh spans
    all of them, so the fold psum and the hypothesis all_gather both
    cross the process boundary (gloo over localhost here; DCN on a real
    multi-host pod).
    """
    n_dev = n_procs * devices_per_proc
    n_seq = n_dev // n_hyp
    # One retry: on a timeshared box a concurrent CPU-heavy job can
    # starve a worker past the gloo handshake deadline, which shows up
    # as a missing parity marker — a transient, not a correctness bug.
    last_detail = ""
    for attempt in range(2):
        try:
            outs = _launch_workers(n_procs, devices_per_proc,
                                   dict(MH_NCAP=n_cap, MH_NF=n_f,
                                        MH_SEQ=n_seq, MH_HYP=n_hyp),
                                   timeout)
        except RuntimeError as e:
            outs, last_detail = None, str(e)
        else:
            failures = [i for i, out in enumerate(outs)
                        if _OK_MARK not in out]
            if not failures:
                break
            last_detail = ("missing parity marker in process(es) "
                           f"{failures}:\n" + "\n---\n".join(
                               _tail(o) for o in outs))
    else:
        try:
            load = ", ".join(f"{v:.1f}" for v in os.getloadavg())
        except OSError:  # pragma: no cover - non-POSIX
            load = "unavailable"
        raise RuntimeError(
            "multihost dryrun failed twice. If the 1-min load average "
            f"({load}) exceeds the core count, CPU contention starving "
            "the gloo coordinator handshake is the likely cause — rerun "
            f"on an idle box.\n{last_detail}")
    if verbose:
        for out in outs:
            for line in out.splitlines():
                if _OK_MARK in line:
                    print(line)
        print(f"dryrun_multihost OK: {n_procs} processes x "
              f"{devices_per_proc} devices, mesh seq={n_seq} x hyp={n_hyp}, "
              "1e-12 table parity across the process boundary")


def _tail(out: str, n: int = 12) -> str:
    """Last ``n`` lines of a worker's combined output (diagnostics)."""
    return "\n".join(out.splitlines()[-n:])


def _launch_workers(n_procs: int, devices_per_proc: int, env_extra: dict,
                    timeout: float):
    """Spawn the N worker processes and collect their stdout."""
    coord = f"127.0.0.1:{_free_port()}"
    env_base = dict(os.environ)
    env_base.pop("JAX_PLATFORMS", None)  # the worker forces cpu itself
    flags = env_base.get("XLA_FLAGS", "")
    env_base["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count="
        f"{devices_per_proc}").strip()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for pid in range(n_procs):
        env = dict(env_base, MH_COORD=coord, MH_NPROC=str(n_procs),
                   MH_PID=str(pid), **{k: str(v)
                                       for k, v in env_extra.items()})
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "lte_cell_scanner.parallel.multihost"],
            env=env, cwd=repo_root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    deadline = time.time() + timeout
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError("multihost run timed out:\n" + "\n".join(outs))
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"multihost process(es) {bad} failed:\n"
                           + "\n---\n".join(outs))
    return outs


def _measure_sweep_once(n_procs: int, b_per_proc: int,
                        devices_per_proc: int, n_f: int, n_cap: int,
                        reps: int, timeout: float) -> dict:
    """One full 1-host + N-host throughput measurement (see
    measure_sweep_scaling for the methodology).

    Both legs sweep the SAME per-host batch (weak scaling — the
    BASELINE.md metric is samples/s scaling): a 1-host leg sweeping
    N*b captures has an N-times-larger working set, whose cache
    behavior on this one-core box systematically differed from the
    per-host runs and read as impossible super-linear scaling."""
    env = dict(MH_MODE="sweep", MH_NCAP=n_cap, MH_NF=n_f, MH_REPS=reps,
               MH_B=b_per_proc)

    def parse(outs):
        vals = []
        for out in outs:
            for line in out.splitlines():
                if line.startswith("MULTIHOST_SWEEP"):
                    d = dict(kv.split("=") for kv in line.split()[1:])
                    vals.append((float(d["t_self"]), float(d["t_comm"]),
                                 int(d["samples"])))
        if len(vals) != len(outs):
            raise RuntimeError("missing MULTIHOST_SWEEP marker:\n"
                               + "\n---\n".join(outs))
        return vals

    outs1 = _launch_workers(1, devices_per_proc, env, timeout)
    (t1, _, samples1), = parse(outs1)
    outsn = _launch_workers(n_procs, devices_per_proc, env, timeout)
    valsn = parse(outsn)
    t_n = max(v[0] for v in valsn) + max(v[1] for v in valsn)
    samples_n = sum(v[2] for v in valsn)
    rate1 = samples1 / t1
    rate_n = samples_n / t_n
    return {
        "n_procs": n_procs,
        "captures_per_host": b_per_proc,
        "t_1host_s": round(t1, 3),
        "t_nhost_s": round(t_n, 3),
        "t_comm_s": round(max(v[1] for v in valsn), 4),
        "samples_per_sec_1host": int(rate1),
        "samples_per_sec_nhost_total": int(rate_n),
        "scaling": round(rate_n / (n_procs * rate1), 3),
    }


def measure_sweep_scaling(n_procs: int = 2, b_per_proc: int = 8,
                          devices_per_proc: int = 1, n_f: int = 4,
                          n_cap: int = 153600, reps: int = 4,
                          timeout: float = 1200.0,
                          verbose: bool = True,
                          n_meas: int = 3) -> dict:
    """MEASURE capture-sharded fc-sweep throughput at 1 vs N hosts.

    Backs BASELINE.md's ">=0.9 samples/s scaling 1 -> 2 hosts" — a
    WEAK-scaling metric: both legs sweep the SAME per-host batch
    ``b_per_proc`` (see _measure_sweep_once; a strong-scaling 1-host
    leg sweeping N*b captures has an N-times-larger working set whose
    cache behavior on this one-core box read as impossible super-linear
    scaling) — with wall-clock measurements from real
    ``jax.distributed`` multi-process runs (gloo over localhost):

    - a 1-process run sweeping b_per_proc captures gives T1;
    - an N-process run gives each host's t_self for ITS b_per_proc
      captures and the cross-host barrier cost t_comm. This machine has
      one CPU core, so the N processes compute in barrier-coordinated
      turns (waiters sleep in a blocking gloo read) — each t_self is a
      real full-core wall-clock, exactly what an N-core/N-host
      deployment would run concurrently, because the capture axis needs
      ZERO cross-host traffic during compute (the only shared step is
      the host-level cell-list merge). T_N = max_p(t_self) + t_comm;
      scaling = rate_N / (N * rate_1) with rate_N over N*b samples.

    Wall-clock samples on a timeshared core are noisy in both
    directions (transient load during the 1-host leg reads as
    super-linear scaling, load during the N-host leg as sub-linear), so
    the estimator is the MEDIAN of TWO full ``n_meas``-sample sets
    pooled (2*n_meas samples total) — a plain order statistic with a
    fixed, unconditional stopping rule (no pass/fail-band rerun
    trigger, which would inflate pass probability at the margin); every
    sample's scaling ships in ``scaling_samples`` for auditability.

    Returns the pooled-median measurement's dict
    ({"samples_per_sec_1host", "samples_per_sec_nhost_total",
    "scaling", ...}) plus ``scaling_samples`` (all 2*n_meas values).
    """
    meas = [_measure_sweep_once(n_procs, b_per_proc, devices_per_proc,
                                n_f, n_cap, reps, timeout)
            for _ in range(2 * max(1, n_meas))]
    meas.sort(key=lambda m: m["scaling"])
    # Even pool: the lower-middle order statistic (conservative median).
    res = dict(meas[(len(meas) - 1) // 2],
               scaling_samples=[m["scaling"] for m in meas])
    if verbose:
        print(f"multihost sweep scaling: {res}")
    return res


if __name__ == "__main__":
    _worker_main()
