"""Row padding for the data-parallel layout.

The port's counterpart of ``flinkml_tpu.parallel`` — so far only
:func:`pad_to_multiple`: the port trains on one device, and the mesh and
its collectives (``DeviceMesh``, ``all_reduce_sum`` over
``torch.distributed``) come with the multi-device slice (ROADMAP.md
Queue 1 item 7).
"""

from __future__ import annotations

import numpy as np


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0):
    """Zero-pad ``array`` along ``axis`` to a multiple; returns (padded, n_valid).

    Algorithms carry ``n_valid`` (or a weight column) so padded rows never
    contribute to sums.
    """
    n = array.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return array, n
    pad_width = [(0, 0)] * array.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(array, pad_width), n
