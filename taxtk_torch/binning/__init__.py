"""Copy of taxtk/binning/__init__.py: the port keeps its own copy and imports nothing of taxtk."""

from .consensus import combine_prediction_ranges
from .binner import run_binner

__all__ = ["combine_prediction_ranges", "run_binner"]
