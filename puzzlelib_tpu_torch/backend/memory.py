"""Axis moves and the depth concat (counterpart of
``puzzlelib_tpu/backend/memory.py``): ``moveaxis``, ``swapaxes`` and
``transpose`` return views of the tensor, where the JAX package returns
copies.  A later write to the source shows through a view, so a caller that
writes the source in place copies first; an inplace module does not write
through a view (``Module.writeOver``).

``depthConcat`` concatenates 4-d maps of different spatial extents along
the channels, each centered in the largest extent and padded with zeros;
``depthSplit`` cuts a gradient of that shape back into the inputs' pieces
by the same offsets, as views of it."""

import torch
import torch.nn.functional as F


def moveaxis(data, src, dst):
    return torch.movedim(data, src, dst)


def swapaxes(data, axis1, axis2):
    return torch.swapaxes(data, axis1, axis2)


def transpose(data, axes):
    return data.permute(tuple(axes))


def _offsets(extent, inner):
    top = (extent - inner) // 2
    return top, extent - inner - top


def depthConcat(tensors):
    h = max(t.shape[2] for t in tensors)
    w = max(t.shape[3] for t in tensors)

    parts = []
    for t in tensors:
        top, bottom = _offsets(h, t.shape[2])
        left, right = _offsets(w, t.shape[3])
        parts.append(F.pad(t, (left, right, top, bottom)))

    return torch.cat(parts, dim=1)


def depthSplit(grad, tensors):
    h, w = grad.shape[2], grad.shape[3]

    grads, offset = [], 0
    for t in tensors:
        c, th, tw = t.shape[1], t.shape[2], t.shape[3]
        top, left = _offsets(h, th)[0], _offsets(w, tw)[0]

        grads.append(grad[:, offset:offset + c, top:top + th, left:left + tw])
        offset += c

    return grads
