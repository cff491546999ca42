"""Host I/O and entry: the 95th percentile of the caller's frame time
(the frame handed to the entry to its flow where the caller reads it), in
ms, over the window's frames that ran outside the profiler.  The host
streams' tail, which the host's other tenants move too much for an
end-to-end bound."""

import numpy as np


def read(summary: dict):
    ms = summary.get("frame_ms")
    if ms is None or len(ms) == 0:
        return None
    return float(np.percentile(ms, 95))
