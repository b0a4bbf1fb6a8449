"""Multi-device parity of the production entry points: the pipelined
sweep driver and the batched tracker engine on an 8-device mesh vs the
single-device path. These are the same checks dryrun_multichip runs
(parallel/multichip_checks.py); the conftest's 8 virtual CPU devices
stand in for a multi-GPU host."""


def test_pipelined_sweep_multidevice():
    from lte_cell_scanner.parallel.multichip_checks import (
        check_pipelined_sweep_multidevice)

    n = check_pipelined_sweep_multidevice(8)
    assert n >= 8          # every capture decodes its planted cell


def test_tracker_cells_sharded():
    from lte_cell_scanner.parallel.multichip_checks import (
        check_tracker_cells_sharded)

    res = check_tracker_cells_sharded(8, cells=16)
    assert res["bucket"] % 8 == 0
