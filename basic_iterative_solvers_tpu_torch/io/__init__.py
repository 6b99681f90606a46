"""Matrix Market input and output."""
from .mmio import MatrixMarketError, read_mtx, read_mtx_coo, write_mtx  # noqa: F401
