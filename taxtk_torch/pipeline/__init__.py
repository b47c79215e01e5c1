"""Copy of taxtk/pipeline/__init__.py: the port keeps its own copy and imports nothing of taxtk."""

from .summaries import binning_to_summary
from .workflows import run_binning_workflow

__all__ = ["binning_to_summary", "run_binning_workflow"]
