"""The entries' host-to-device copies, through one helper.

`h2d(array, device)` is `torch.from_numpy(array).to(device)`.  To a card,
from pageable host memory, PyTorch copies through c10::cuda::memcpy_and_sync:
the copy waits for the work queued before it on the current stream and
the host waits for the copy.  Each such copy is timed as an `h2d` span
(count: its bytes) and adds one to the `h2d.blocking` counter
(engine/metrics.py).  To the CPU it is no copy, and no span.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.metrics import count, span

BLOCKING = "h2d.blocking"


def h2d(array: np.ndarray, device) -> torch.Tensor:
    """`array` as a tensor on `device` (on the CPU, sharing its memory)."""
    host = torch.from_numpy(array)
    device = torch.device(device)
    if device.type == "cpu":
        return host.to(device)
    with span("h2d", count=host.nbytes):
        out = host.to(device)
    count(BLOCKING)
    return out
