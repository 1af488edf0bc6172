"""Filesystem-directory input source (a copy of
``puzzlelib_tpu/datasets/pathloader.py``): walks a directory tree for files
with matching extensions; ``doOpen=False`` hands file paths to ``onFile``
instead of open handles.
"""

import contextlib
import os

from puzzlelib_tpu_torch.datasets.inputloader import InputLoader


class PathLoader(InputLoader):
    def __init__(self, onFile=None, exts=None, dataname=None, cachename=None, onFileList=None, doOpen=True):
        super().__init__(onFile, exts, dataname, cachename, onFileList)
        self.doOpen = doOpen

    def checkInput(self, path):
        if not os.path.exists(path):
            raise RuntimeError("Path '%s' does not exist" % path)

    def openInput(self, path):
        # a directory needs no closing; yield the root path itself
        return contextlib.nullcontext(path)

    def loadFilelist(self, root):
        found = []
        for _, _, filenames in os.walk(root):
            found += filter(self._matches, filenames)

        return found

    def openFile(self, root, file):
        fullname = os.path.join(root, file)
        return open(fullname, mode="rb") if self.doOpen else fullname
