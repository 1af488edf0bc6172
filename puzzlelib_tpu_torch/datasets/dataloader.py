"""Dataset loader base (a copy of ``puzzlelib_tpu/datasets/dataloader.py``):
concrete loaders parse raw archives once and keep the arrays in an HDF5
cache named ``cachename``.

``h5py`` is imported only where a cache is opened (``_h5py``), so the
package imports on a machine without it; there a loader's ``load`` raises
an ``ImportError`` that names h5py, and the parse steps still run."""

import os


def _nameList(datanames):
    if datanames is None:
        return ["data"]

    return list(datanames) if isinstance(datanames, (list, tuple)) else [datanames]


def _h5py():
    """The ``h5py`` module, or an ``ImportError`` that names it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("the dataset cache needs h5py, which does not import here (%s)" % e) from e

    return h5py


class DataLoader:
    def __init__(self, datanames=None, cachename=None):
        self.cachename = cachename
        self.datanames = _nameList(datanames)

    def clear(self):
        if self.cachename is not None and os.path.exists(self.cachename):
            os.remove(self.cachename)
