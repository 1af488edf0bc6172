"""Generic archive / path -> HDF5 cache loader (a copy of
``puzzlelib_tpu/datasets/inputloader.py``).  Subclasses (Path / Tar / Zip)
provide archive access; this base walks the file list in packs, maps each
file through ``onFile`` and appends the batches to a growable HDF5 dataset,
keeping each input's time stamp (keyed with backslashes) so that the cache
is rebuilt when an input is newer.  It writes the cache as it reads, so it
runs only where ``h5py`` imports.
"""

import os

import numpy as np

from puzzlelib_tpu_torch.datasets.dataloader import DataLoader, _h5py

_IMAGE_EXTS = [".png", ".jpg", ".jpeg"]


def _defaultOnFile(f):
    from PIL import Image

    img = np.array(Image.open(f), dtype=np.float32) * 2.0 / 255.0 - 1.0
    img = np.rollaxis(img, 2)
    return img.reshape(1, *img.shape)


class InputLoader(DataLoader):
    def __init__(self, onFile=None, exts=None, dataname=None, cachename=None, onFileList=None):
        super().__init__(dataname, cachename)

        self.onFile = _defaultOnFile if onFile is None else onFile
        self.onFileList = onFileList

        exts = _IMAGE_EXTS if exts is None else exts
        self.exts = [ext if ext.startswith(".") else "." + ext for ext in exts]

        self.resizeFactor = 1.5
        self.log = True

        self.hdf, self.compress, self.dataset = None, None, None
        self.maxsamples, self.samples = 0, 0

    def _say(self, fmt, *args):
        if self.log:
            print(("[%s] " % type(self).__name__) + fmt % args)

    def _matches(self, filename):
        lowered = filename.lower()
        return any(lowered.endswith(ext) for ext in self.exts)

    # -- cache validity -----------------------------------------------------------

    def checkNeedToLoad(self, log=True):
        if not os.path.exists(self.cachename):
            return True

        with _h5py().File(self.cachename, "r") as hdf:
            for inputname, stamp in hdf["timestamps"].items():
                source = inputname.replace("\\", "/")
                if stamp[()] < os.path.getmtime(source):
                    if log:
                        print("[%s] Archive %s has newer time stamp" % (type(self).__name__, inputname))
                    return True

        return False

    # -- growable dataset sink -------------------------------------------------------

    def createDataset(self, unpacked):
        sink = self.hdf.create_dataset(
            self.datanames[0], shape=unpacked.shape, maxshape=(None, ) + unpacked.shape[1:],
            dtype=unpacked.dtype, compression=self.compress
        )
        sink[:] = unpacked
        return sink

    def _appendSamples(self, block):
        if self.dataset is None:
            self.dataset = self.createDataset(block)
        else:
            end = self.samples + block.shape[0]
            if end > self.dataset.shape[0]:
                self.dataset.resize((end, ) + self.dataset.shape[1:])

            self.dataset[self.samples:end] = block

        self.samples += block.shape[0]

    def _budgetLeft(self):
        return None if self.maxsamples is None else self.maxsamples - self.samples

    # -- main entry ---------------------------------------------------------------------

    def load(self, inputnames, maxsamples=None, filepacksize=5000, compress="gzip", log=True):
        h5py = _h5py()
        self.log = log
        sources = [inputnames] if isinstance(inputnames, str) else inputnames

        if self.cachename is None:
            self.cachename = os.path.splitext(sources[0])[0] + ".hdf"

        if not self.checkNeedToLoad(log):
            self._say("Using cache %s ...", self.cachename)
        else:
            self._say("Creating cache file %s ...", self.cachename)

            with h5py.File(self.cachename, "w") as hdf:
                stamps = hdf.create_group("timestamps")
                for source in sources:
                    key = os.path.normpath(source).replace("/", "\\")
                    stamps.create_dataset(key, data=os.path.getmtime(source))

                self.hdf, self.compress = hdf, compress
                self.dataset, self.maxsamples, self.samples = None, maxsamples, 0

                for i, source in enumerate(sources):
                    self._say("Unpacking archive %s (%d out of %d) ...", source, i + 1, len(sources))
                    self.unpack(source, filepacksize)

                    if self._budgetLeft() == 0:
                        print("[%s] Reached max limit of samples (%d)" % (type(self).__name__, self.maxsamples))
                        break

        return h5py.File(self.cachename, "r")[self.datanames[0]]

    def unpack(self, inputname, filepacksize):
        self.checkInput(inputname)

        with self.openInput(inputname) as inp:
            files = self.getFilelist(inp)

            for idx in range(0, len(files), filepacksize):
                packNo, packTotal = idx // filepacksize + 1, -(-len(files) // filepacksize)
                self._say("Started unpacking pack %d out of %d ...", packNo, packTotal)

                self.cacheFilepack(inp, files[idx:idx + filepacksize])

                if self._budgetLeft() == 0:
                    break

    def cacheFilepack(self, inp, pack):
        batches, pending = [], 0

        for file in pack:
            try:
                batch = self.onFile(self.openFile(inp, file))
            except Exception as e:
                raise RuntimeError("Unpacking failure: %s" % e)

            batches.append(batch)
            pending += batch.shape[0]

            budget = self._budgetLeft()
            if budget is not None and pending >= budget:
                break

        block = np.concatenate(batches, axis=0) if len(batches) > 1 else batches[0]

        budget = self._budgetLeft()
        if budget is not None:
            block = block[:budget]

        self._appendSamples(block)

    def getFilelist(self, inp):
        files = self.loadFilelist(inp)
        return files if self.onFileList is None else self.onFileList(files)

    # -- archive access (subclass surface) ---------------------------------------------

    def checkInput(self, inputname):
        raise NotImplementedError()

    def openInput(self, inputname):
        raise NotImplementedError()

    def loadFilelist(self, inp):
        raise NotImplementedError()

    def openFile(self, inp, file):
        raise NotImplementedError()
