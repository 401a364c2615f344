"""Device->host transfer helper.

The only per-frame host<->device traffic in this framework is the final u8
frame (SURVEY.md §5.8): 1.92 MB at 800x800, copied over the card's local
PCIe link.  `fetch` defaults to ONE transfer; `max_chunk_bytes` splits it
along axis 0 into bounded copies for callers that want them.  Its cost on
the card is not measured yet.
"""

from __future__ import annotations

import numpy as np

# None = single transfer; pass an int to chunk.
DEFAULT_CHUNK_BYTES = None


def fetch(array, max_chunk_bytes: int | None = DEFAULT_CHUNK_BYTES) -> np.ndarray:
    """Copy a device array to host, optionally chunking along axis 0."""
    if max_chunk_bytes is None:
        return np.asarray(array)
    shape = array.shape
    nbytes = int(np.prod(shape)) * array.dtype.itemsize
    if nbytes <= max_chunk_bytes or len(shape) == 0 or shape[0] <= 1:
        return np.asarray(array)
    row_bytes = max(1, nbytes // shape[0])
    rows = max(1, max_chunk_bytes // row_bytes)
    parts = [np.asarray(array[i : i + rows]) for i in range(0, shape[0], rows)]
    return np.concatenate(parts, axis=0)
