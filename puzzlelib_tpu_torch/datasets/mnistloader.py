"""MNIST idx-format loader with an HDF5 cache (a copy of
``puzzlelib_tpu/datasets/mnistloader.py``).

``_parse`` reads the four idx files into the arrays the cache holds: the
test images before the training ones, as the reference stacks them, so
``data[:60000]`` is the 10000 test images and the first 50000 training
images.  ``load`` runs it when the cache is missing."""

import os
import struct

import numpy as np

from puzzlelib_tpu_torch.datasets.dataloader import DataLoader, _h5py


class MnistLoader(DataLoader):
    def __init__(self, onSample=None, cachename="mnist.hdf"):
        super().__init__(("data", "labels"), cachename)

        self.onSample = onSample if onSample else \
            (lambda smp: np.asarray(smp, dtype=np.float32).reshape((1, 28, 28)) / 255.0)

        self.testdata = "t10k-images.idx3-ubyte"
        self.testlabels = "t10k-labels.idx1-ubyte"
        self.traindata = "train-images.idx3-ubyte"
        self.trainlabels = "train-labels.idx1-ubyte"

    def _readLabels(self, filename):
        with open(filename, "rb") as file:
            magic, size = struct.unpack(">II", file.read(8))
            if magic != 2049:
                raise ValueError("Bad magic number (got %s, expected 2049)" % magic)

            return np.frombuffer(file.read(), dtype=np.uint8)

    def _readImages(self, filename):
        with open(filename, "rb") as file:
            magic, size, rows, cols = struct.unpack(">IIII", file.read(16))
            if magic != 2051:
                raise ValueError("Bad magic number (got %s, expected 2051)" % magic)

            raw = np.frombuffer(file.read(), dtype=np.uint8)
            return raw.reshape(size, rows, cols)

    def _parse(self, path, log=True):
        """(images f32 (N, 1, 28, 28), labels int32 (N, )) from the idx files
        in ``path``, test before train."""
        if log:
            print("[%s] Started unpacking ..." % self.__class__.__name__)

        lbls = np.concatenate([
            self._readLabels(os.path.join(path, f)) for f in (self.testlabels, self.trainlabels)
        ])
        imgs = np.concatenate([
            self._readImages(os.path.join(path, f)) for f in (self.testdata, self.traindata)
        ])

        if log:
            print("[%s] Building cache ..." % self.__class__.__name__)

        images = np.stack([self.onSample(img) for img in imgs]).astype(np.float32)
        return images, lbls.astype(np.int32)

    def load(self, path, compress="gzip", log=True):
        h5py = _h5py()
        self.cachename = os.path.join(path, self.cachename)

        if not os.path.exists(self.cachename):
            images, labels = self._parse(path, log)

            with h5py.File(self.cachename, "w") as hdf:
                dsetname, lblsetname = self.datanames
                hdf.create_dataset(dsetname, data=images, compression=compress)
                hdf.create_dataset(lblsetname, data=labels, compression=compress)

        hdf = h5py.File(self.cachename, "r")
        dsetname, lblsetname = self.datanames
        return hdf[dsetname], hdf[lblsetname]
