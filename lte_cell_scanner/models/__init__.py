from lte_cell_scanner.models.cell import Cell  # noqa: F401
from lte_cell_scanner.models.pn import lte_pn  # noqa: F401
from lte_cell_scanner.models.pss import pss_fd, pss_td  # noqa: F401
from lte_cell_scanner.models.sss import sss_fd  # noqa: F401
from lte_cell_scanner.models.rs import RSDL  # noqa: F401
from lte_cell_scanner.models.crc import lte_calc_crc  # noqa: F401
from lte_cell_scanner.models.convcode import (  # noqa: F401
    lte_conv_encode,
    lte_conv_decode,
)
from lte_cell_scanner.models.ratematch import (  # noqa: F401
    lte_conv_ratematch,
    lte_conv_deratematch,
)
from lte_cell_scanner.models.modulation import (  # noqa: F401
    lte_modulate,
    lte_demodulate,
)
