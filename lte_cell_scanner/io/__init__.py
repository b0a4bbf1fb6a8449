from lte_cell_scanner.io.itfile import load_it, save_it  # noqa: F401
from lte_cell_scanner.io.raw import load_rtl_sdr  # noqa: F401
