"""Axis moves (counterpart of the axis functions of
``puzzlelib_tpu/backend/memory.py``): ``moveaxis``, ``swapaxes`` and
``transpose`` return views of the tensor, where the JAX package returns
copies.  A later write to the source shows through a view, so a caller that
writes the source in place copies first; none of the port's callers does."""

import torch


def moveaxis(data, src, dst):
    return torch.movedim(data, src, dst)


def swapaxes(data, axis1, axis2):
    return torch.swapaxes(data, axis1, axis2)


def transpose(data, axes):
    return data.permute(tuple(axes))
