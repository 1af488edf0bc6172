"""Zip-archive input source (a copy of ``puzzlelib_tpu/datasets/ziploader.py``)."""

import zipfile

from puzzlelib_tpu_torch.datasets.inputloader import InputLoader


class ZipLoader(InputLoader):
    _probe = staticmethod(zipfile.is_zipfile)
    _flavor = "zip"

    def checkInput(self, archivename):
        if not self._probe(archivename):
            raise RuntimeError("'%s' is not %s file" % (archivename, self._flavor))

    def openInput(self, archivename):
        return zipfile.ZipFile(archivename)

    def loadFilelist(self, archive):
        return list(filter(self._matches, archive.namelist()))

    def openFile(self, archive, file):
        return archive.open(file)
