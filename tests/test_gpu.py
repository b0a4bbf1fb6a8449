"""Card-only precision parity checks (lte_cell_scanner/tools/gpu_checks).

They need the GPU's own numerics, so they skip on the CPU. Run them on
an NVIDIA GPU with: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
(chip_smoke.py runs the same checks in its own process).
"""

import pytest

from lte_cell_scanner.tools import gpu_checks


@pytest.mark.gpu
@pytest.mark.parametrize("name,check", gpu_checks.CHECKS,
                         ids=[n for n, _ in gpu_checks.CHECKS])
def test_gpu_precision_parity(gpu, name, check):
    check()
