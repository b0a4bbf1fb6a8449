from lte_cell_scanner.ops.xcorr import xcorr_pss, XcorrResult  # noqa: F401
from lte_cell_scanner.ops.peak import peak_search  # noqa: F401
from lte_cell_scanner.ops.sync import sss_detect, pss_sss_foe  # noqa: F401
from lte_cell_scanner.ops.tfg import extract_tfg, tfoec  # noqa: F401
from lte_cell_scanner.ops.chanest import chan_est  # noqa: F401
from lte_cell_scanner.ops.pbch import pbch_extract, decode_mib  # noqa: F401
