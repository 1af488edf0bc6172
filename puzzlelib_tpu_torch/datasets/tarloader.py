"""Tar-archive input source (a copy of ``puzzlelib_tpu/datasets/tarloader.py``)."""

import tarfile

from puzzlelib_tpu_torch.datasets.inputloader import InputLoader


class TarLoader(InputLoader):
    _probe = staticmethod(tarfile.is_tarfile)
    _flavor = "tar"

    def checkInput(self, archivename):
        if not self._probe(archivename):
            raise RuntimeError("'%s' is not %s file" % (archivename, self._flavor))

    def openInput(self, archivename):
        return tarfile.open(archivename)

    def loadFilelist(self, archive):
        return list(filter(self._matches, archive.getnames()))

    def openFile(self, archive, file):
        return archive.extractfile(file)
