from lte_cell_scanner.tracker.runtime import LTETracker  # noqa: F401
from lte_cell_scanner.tracker.state import (  # noqa: F401
    GlobalState,
    TrackedCell,
)
