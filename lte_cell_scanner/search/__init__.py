from lte_cell_scanner.search.cell_search import (  # noqa: F401
    cell_search,
    detection_threshold,
    dedup,
    generate_search_sets,
)
