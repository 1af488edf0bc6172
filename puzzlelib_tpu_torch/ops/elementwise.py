"""Elementwise activations, forward (counterpart of
``puzzlelib_tpu/ops/elementwise.py``).  Only relu, which the serving slice
runs, is ported yet."""

import torch


def relu(x):
    return torch.relu(x)


def relu_(x):
    """relu in place, for ``Activation(inplace=True)``."""
    return torch.relu_(x)
