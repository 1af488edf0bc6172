"""Pooling in NCHW layout, max forward (counterpart of
``puzzlelib_tpu/ops/pool.py``).

The reference's max mode pads with -inf, which is what
``torch.nn.functional.max_pool{1,2,3}d`` does.  The average modes and the
backward come with the modules that use them.
"""

import torch.nn.functional as F


MODE_MAX = "max"

_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def poolNd(x, size, stride, pad, mode=MODE_MAX):
    if mode != MODE_MAX:
        raise NotImplementedError("pool mode %s is not ported yet" % mode)

    return _MAXPOOL[x.dim() - 2](x, size, stride, pad)
