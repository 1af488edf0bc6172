"""CIFAR-10 tar loader with an HDF5 cache (a copy of
``puzzlelib_tpu/datasets/cifar10loader.py``).

``_parse`` unpickles the batches of ``cifar-10-python.tar.gz`` (or the
uncompressed ``cifar-10-python.tar``) in the archive's order into the
arrays the cache holds; ``load`` runs it when the cache is missing."""

import os
import tarfile
import pickle

import numpy as np

from puzzlelib_tpu_torch.datasets.dataloader import DataLoader, _h5py


class Cifar10Loader(DataLoader):
    def __init__(self, onSample=None, onSampleBatch=None, cachename="cifar10.hdf"):
        super().__init__(("data", "labels"), cachename)

        self.onSample = onSample if onSample else \
            (lambda smp: smp.reshape(3, 32, 32).astype(np.float32) * 2.0 / 255.0 - 1.0)

        self.onSampleBatch = onSampleBatch if onSampleBatch else \
            (lambda smp, b: smp.reshape(b, 3, 32, 32).astype(np.float32) * 2.0 / 255.0 - 1.0)

        self.datafiles = ["cifar-10-python.tar.gz", "cifar-10-python.tar"]

    def _parse(self, path, log=True):
        """(images f32 (N, 3, 32, 32) in [-1, 1], labels int32 (N, )) from
        the archive in ``path``."""
        filename = None
        for datafile in self.datafiles:
            candidate = os.path.join(path, datafile)
            if os.path.exists(candidate) and tarfile.is_tarfile(candidate):
                filename = candidate
                break

        if filename is None:
            raise ValueError("No proper datafile found in path %s (searched for %s)" % (path, self.datafiles))

        dicts = []

        with tarfile.open(filename) as tar:
            for name in tar.getnames():
                if "data_batch" in name or "test_batch" in name:
                    dicts.append(pickle.load(tar.extractfile(name), encoding="latin1"))

                    if log:
                        print("[%s] Unpacked %s" % (self.__class__.__name__, name))

        totallen = sum(len(d["labels"]) for d in dicts)

        images = np.empty((totallen, 3, 32, 32), dtype=np.float32)
        labels = np.empty((totallen, ), dtype=np.int32)

        idx = 0
        for i, d in enumerate(dicts):
            data, lbls = d["data"], d["labels"]

            images[idx:idx + data.shape[0]] = self.onSampleBatch(data, data.shape[0])
            labels[idx:idx + len(lbls)] = lbls
            idx += data.shape[0]

            if log:
                print("[%s] Merged #%d batch out of %d" % (self.__class__.__name__, i + 1, len(dicts)))

        return images, labels

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
