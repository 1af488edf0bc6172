"""Small-NORB binary .mat loader with an HDF5 cache (a copy of
``puzzlelib_tpu/datasets/smallnorbloader.py``)."""

import os
import struct

import numpy as np

from puzzlelib_tpu_torch.datasets.dataloader import DataLoader, _h5py


class SmallNorbLoader(DataLoader):
    def __init__(self, onSample=None, sampleInfo=None, cachename=None):
        super().__init__(("data", "labels", "info"), "smallnorb.hdf" if cachename is None else cachename)

        self.sampleInfo = (lambda: (np.float32, (28, 28))) if sampleInfo is None else sampleInfo

        if onSample is None:
            def onSample(sample):
                from PIL import Image
                return np.array(Image.fromarray(sample).resize((28, 28)))

        self.onSample = onSample

        self.testdata = "smallnorb-5x01235x9x18x6x2x96x96-testing-dat.mat"
        self.testlabels = "smallnorb-5x01235x9x18x6x2x96x96-testing-cat.mat"
        self.testinfo = "smallnorb-5x01235x9x18x6x2x96x96-testing-info.mat"

        self.traindata = "smallnorb-5x46789x9x18x6x2x96x96-training-dat.mat"
        self.trainlabels = "smallnorb-5x46789x9x18x6x2x96x96-training-cat.mat"
        self.traininfo = "smallnorb-5x46789x9x18x6x2x96x96-training-info.mat"

        self.nlabels, self.ninstances = 5, 10
        self.nelevs, self.nazimuths, self.nlights = 9, 18, 6

    @staticmethod
    def _readMat(filename, trueMagic):
        with open(filename, "rb") as file:
            magic, ndim = struct.unpack("<ii", file.read(8))
            dims = struct.unpack("<" + "i" * max(ndim, 3), file.read(max(ndim, 3) * 4))

            if magic != trueMagic:
                raise ValueError("Bad magic number (got 0x%x, expected 0x%x)" % (magic, trueMagic))

            return np.fromfile(file, dtype=np.uint8 if trueMagic == 0x1E3D4C55 else np.uint32), dims[:ndim]

    def load(self, path, sort=False, compress="gzip", log=True, onlyTest=False):
        h5py = _h5py()
        self.cachename = os.path.join(path, self.cachename)

        if not os.path.exists(self.cachename):
            if log:
                print("[%s] Started unpacking ..." % self.__class__.__name__)

            data, labels, info = None, None, None

            files = [self.testdata] if onlyTest else [self.traindata, self.testdata]
            for filename in files:
                raw, dims = self._readMat(os.path.join(path, filename), 0x1E3D4C55)
                indata = raw.reshape(*dims)

                dtype, reqdims = self.sampleInfo()
                outdata = np.empty(dims[:2] + reqdims, dtype=dtype)

                for i in range(dims[0]):
                    for j in range(dims[1]):
                        outdata[i, j] = self.onSample(indata[i, j])

                data = outdata if data is None else np.vstack((data, outdata))

            lblfiles = [self.testlabels] if onlyTest else [self.trainlabels, self.testlabels]
            for filename in lblfiles:
                raw, _ = self._readMat(os.path.join(path, filename), 0x1E3D4C54)
                labels = raw if labels is None else np.concatenate((labels, raw))

            infofiles = [self.testinfo] if onlyTest else [self.traininfo, self.testinfo]
            for filename in infofiles:
                raw, dims = self._readMat(os.path.join(path, filename), 0x1E3D4C54)
                ininfo = raw.reshape(dims[:2])
                info = ininfo if info is None else np.vstack((info, ininfo))

            if sort:
                data, labels, info = self.sortDataset(data, labels, info, log=log)

            with h5py.File(self.cachename, "w") as hdf:
                dsetname, lblsetname, infosetname = self.datanames
                hdf.create_dataset(dsetname, data=data, compression=compress)
                hdf.create_dataset(lblsetname, data=labels, compression=compress)
                hdf.create_dataset(infosetname, data=info, compression=compress)

        hdf = h5py.File(self.cachename, "r")
        dsetname, lblsetname, infosetname = self.datanames
        return hdf[dsetname], hdf[lblsetname], hdf[infosetname]

    def sortDataset(self, data, labels, info, log=True):
        shape = (self.nlabels, self.ninstances, self.nlights, self.nelevs, self.nazimuths)

        sortdata = np.empty(shape + data.shape[2:], dtype=np.float32)
        sortlabels = np.empty(shape, dtype=np.uint32)
        sortinfo = np.empty(shape + info.shape[1:], dtype=np.uint32)

        for i in range(data.shape[0]):
            instance, elev, azimuth, light = info[i]
            label = labels[i]

            sortdata[label, instance, light, elev, azimuth // 2] = data[i]
            sortlabels[label, instance, light, elev, azimuth // 2] = label
            sortinfo[label, instance, light, elev, azimuth // 2] = info[i]

        return sortdata, sortlabels, sortinfo
