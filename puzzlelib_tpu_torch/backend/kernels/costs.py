"""CTC dispatch (counterpart of the CTC part of
``puzzlelib_tpu/backend/kernels/costs.py``)."""

import torch

from puzzlelib_tpu_torch.ops import ctc as _ctc


def ctcLoss(data, datalen, labels, lengths, blank, error=None, normalized=False):
    """(error, grad) of ``ops.ctc.ctcLoss``; the error is written into
    ``error`` (a 0-d f32 tensor) when it is given."""
    err, grad = _ctc.ctcLoss(data, datalen, labels, lengths, blank, normalized)

    if error is None:
        error = torch.empty((), dtype=torch.float32, device=data.device)

    error.copy_(err)
    return error, grad


def ctcLossTest(data, datalen, labels, lengths, blank):
    return _ctc.hostCTCLoss(data, datalen, labels, lengths, blank)
