"""Image I/O and filter visualization (counterpart of
``puzzlelib_tpu/visual.py``): load images into NCHW float arrays, dump
tensors and filters back to image files, ZCA / PCA whitening.

The functions take numpy arrays or tensors (on any device; a tensor is read
back to the host as float32, bf16 included) and write the files the JAX
package writes, pixel for pixel.  ``PIL`` is imported only inside the
functions that open, resize or write an image, so the module and its array
functions (``normalizeImageInplace``, ``imageToInt``, ``whiten``) need no
``PIL``; ``imageToArray`` needs it only to resize.
"""

import io
import os

import numpy as np
import torch


class VisualError(Exception):
    pass


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading and writing images needs PIL (pillow), which is not installed (%s)" % e) from e

    return Image


def _host(ary):
    """A host array of ``ary``: a tensor comes back as float32 where it is
    floating (numpy has no bfloat16), in its own type otherwise."""
    if isinstance(ary, torch.Tensor):
        ary = ary.detach()
        return (ary.float() if ary.is_floating_point() else ary).cpu().numpy()

    return ary


# -- loading ----------------------------------------------------------------------


def loadImage(filename, shape=None, normalize=True, mapsToFront=True, contiguous=True):
    return imageToArray(_pil().open(filename), shape, normalize, mapsToFront, contiguous)


def loadImageFromBytes(bytebuffer, shape=None, normalize=True, mapsToFront=True, contiguous=True):
    return imageToArray(_pil().open(io.BytesIO(bytebuffer)), shape, normalize, mapsToFront, contiguous)


def imageToArray(img, shape=None, normalize=True, mapsToFront=True, contiguous=True):
    """A PIL image as a uint8 array, (1, C, H, W) with ``mapsToFront`` (a
    grayscale image gets one map), else (H, W, C); with ``normalize`` as
    float32 scaled to [-1, 1] by its peak.  An alpha channel is dropped."""
    if shape is not None:
        img = img.resize(shape, _pil().LANCZOS)

    pixels = np.asarray(img, dtype=np.uint8)

    if pixels.ndim == 3 and pixels.shape[-1] == 4:
        pixels = pixels[..., :3]

    if mapsToFront:
        chw = pixels[np.newaxis] if pixels.ndim == 2 else np.rollaxis(pixels, 2)
        pixels = chw[np.newaxis]
    elif pixels.ndim == 2:
        pixels = pixels[..., np.newaxis]

    if normalize:
        pixels = pixels.astype(np.float32)
        peak = pixels.max()

        if peak > 0.0:
            pixels *= 2.0 / peak

        pixels -= 1.0

    return np.ascontiguousarray(pixels) if contiguous else pixels


# -- dumping ----------------------------------------------------------------------


def normalizeImageInplace(img):
    """Shift ``img`` (an array or a floating tensor) to a minimum of 0 and
    scale it to a peak of 1, in place."""
    img -= img.min()
    peak = img.max()

    if peak > 0.0:
        img /= peak


def imageToInt(img):
    if isinstance(img, torch.Tensor):
        return (img * 255.0).to(torch.uint8)

    return (img * 255.0).astype(np.uint8)


def showImage(img, filename, rollMaps=True):
    """Write one image, (1, C, H, W), (C, H, W) or (H, W): a float32 image
    normalized to [0, 255] (C > 1 rolled to HWC with ``rollMaps``), any
    other type written as it is."""
    img = _host(img)

    if img.ndim == 4:
        if img.shape[0] != 1:
            raise VisualError("Image tensor must be exactly one image")

        img = img[0]

    out = img
    if img.dtype == np.float32:
        out = img.copy()
        normalizeImageInplace(out)

        if rollMaps and out.ndim == 3 and out.shape[0] > 1:
            out = np.rollaxis(out, 0, 3)

        out = imageToInt(out)

    _pil().fromarray(out.squeeze()).save(filename)


def showImageBatch(batch, filebase, ext="png", rollMaps=True):
    batch = _host(batch)

    if batch.ndim != 4:
        raise VisualError("Imagebatch tensor must be 4d tensor")

    suffix = ext.lstrip(".")
    for i, img in enumerate(batch, start=1):
        showImage(img, "%s-%d.%s" % (filebase, i, suffix), rollMaps)


def showImageBatchInFolder(batch, foldername, basename, ext="png", rollMaps=True):
    os.makedirs(foldername, exist_ok=True)
    showImageBatch(batch, os.path.join(foldername, basename), ext, rollMaps)


def showFilters(filters, filename, offset=4, normalize=True):
    """Each (outmap, inmap) plane of ``filters`` (CO, C, FH, FW) as one
    grayscale tile, C tiles a row."""
    filters = _host(filters)
    outmaps, inmaps, fh, fw = filters.shape

    planes = filters.reshape(outmaps * inmaps, 1, fh, fw)
    showImageBasedFilters(planes, filename, cols=inmaps, offset=offset, normalize=normalize)


def showImageBasedFilters(filters, filename, cols=16, offset=4, normalize=True):
    """Each filter of ``filters`` (count, maps, FH, FW) as one tile of
    ``maps`` channels, ``cols`` tiles a row, ``offset`` pixels apart; 1 x 1
    filters are not written."""
    filters = _host(filters)
    count, maps, fh, fw = filters.shape

    if fh == fw == 1:
        print("Aborting showing 1x1 filters in file %s ..." % filename)
        return

    rows = -(-count // cols)
    mosaic = np.zeros((rows * (fh + offset) + offset, cols * (fw + offset) + offset, maps), dtype=np.uint8)

    for index, tile in enumerate(filters):
        if normalize:
            tile = tile.copy()
            normalizeImageInplace(tile)

        top = offset + (index // cols) * (fh + offset)
        left = offset + (index % cols) * (fw + offset)

        mosaic[top:top + fh, left:left + fw] = np.moveaxis(imageToInt(tile), 0, 2)

    _pil().fromarray(mosaic.squeeze()).save(filename)


# -- preprocessing -----------------------------------------------------------------


def whiten(batch, epsilon=1e-2, PCA=False):
    """ZCA (or, with ``PCA``, PCA) whitening of ``batch`` over its first
    axis, on the host in numpy.  As in the JAX package, an array's rows are
    centered in place; a tensor is read back, and the result comes back as
    a float32 tensor on its device."""
    if isinstance(batch, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(whiten(_host(batch), epsilon, PCA))).to(batch.device)

    shape = batch.shape
    flat = batch.reshape(shape[0], -1)
    flat -= flat.mean(axis=0, keepdims=True)

    covariance = (flat.T @ flat) / flat.shape[0]
    U, S, V = np.linalg.svd(covariance.astype(np.float32))

    transform = U * (1.0 / np.sqrt(S + epsilon))
    if not PCA:
        transform = transform @ V

    return (flat @ transform).reshape(shape)
