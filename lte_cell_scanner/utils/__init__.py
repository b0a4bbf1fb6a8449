from lte_cell_scanner.utils import dsp  # noqa: F401
