"""IMDB sentiment loader with a vocabulary build (a copy of
``puzzlelib_tpu/datasets/imdbloader.py``): parses the ``imdb.npz`` +
``imdb_word_index.json`` pair, re-tokenizes with start / oov markers,
truncates the vocabulary, left-pads to a fixed length and caches the int32
arrays, the vocabulary and the parameters in HDF5.

``_parse`` is the part before the cache write: it returns (data, labels,
vocabulary), the vocabulary an ``object`` array of words (h5py's string
type is given only to ``create_dataset``).  Each split is shuffled with
``np.random.permutation``, train then test, as in the reference, so one
numpy seed gives both packages the same rows."""

import os
import json

import numpy as np

from puzzlelib_tpu_torch.datasets.dataloader import DataLoader, _h5py

_PARAMS = ("numwords", "skiptop", "maxlen", "padchar", "startchar", "oovchar", "indexFrom")


class IMDBLoader(DataLoader):
    def __init__(self, numwords=None, skiptop=0, maxlen=None, padchar=0, startchar=1, oovchar=2, indexFrom=3):
        super().__init__(("data", "labels", "vocabulary"), "imdb.hdf")

        self.numwords, self.skiptop, self.maxlen = numwords, skiptop, maxlen
        self.padchar, self.startchar, self.oovchar = padchar, startchar, oovchar
        self.indexFrom = indexFrom

        self.datafile = "imdb.npz"
        self.indexfile = "imdb_word_index.json"

    _paramNames = list(_PARAMS)

    def _paramsDict(self):
        return {name: getattr(self, name) for name in _PARAMS}

    def checkCacheParams(self, log=True):
        if not os.path.exists(self.cachename):
            return True

        with _h5py().File(self.cachename, "r") as hdf:
            cached = json.loads(str(np.array(hdf["params"], dtype=str)))

        for name, value in self._paramsDict().items():
            if cached[name] != value:
                if log:
                    print("[%s] Existing cache has different param '%s', clearing ..." %
                          (type(self).__name__, name))
                return False

        return True

    def loadVocabulary(self, path):
        with open(os.path.join(path, self.indexfile)) as f:
            index = json.load(f)

        vocab = np.empty((self.numwords, ), dtype=object)
        for word, idx in index.items():
            if idx < self.numwords:
                vocab[int(idx)] = word

        return vocab

    # -- tokenization pipeline ------------------------------------------------------

    def _retokenize(self, samples):
        """Shift word ids by indexFrom and optionally prepend the start marker."""
        if self.startchar is not None:
            return [[self.startchar] + [w + self.indexFrom for w in s] for s in samples]

        if self.indexFrom:
            return [[w + self.indexFrom for w in s] for s in samples]

        return samples

    def _clampVocab(self, samples):
        """Replace (or drop) words outside [skiptop, numwords)."""
        inVocab = lambda w: self.skiptop <= w < self.numwords

        if self.oovchar is not None:
            return [[w if inVocab(w) else self.oovchar for w in s] for s in samples]

        clamped = []
        for s in samples:
            kept = [w for w in s if inVocab(w)]
            clamped.append([self.padchar] * (len(s) - len(kept)) + kept)

        return clamped

    def _fitLength(self, samples):
        """Left-pad short samples, keep the tail of long ones."""
        fitted = []
        for s in samples:
            if len(s) >= self.maxlen:
                fitted.append(list(s[-self.maxlen:]))
            else:
                fitted.append([self.padchar] * (self.maxlen - len(s)) + list(s))

        return fitted

    # -- main entry ---------------------------------------------------------------------

    def _parse(self, path, log=True):
        """(data int32 (N, maxlen), labels int32 (N, ), vocabulary object
        (numwords, )) from the files in ``path``; a missing ``numwords`` or
        ``maxlen`` is set from the data, as in the reference."""
        if log:
            print("[%s] Started unpacking ..." % type(self).__name__)

        with np.load(os.path.join(path, self.datafile), allow_pickle=True) as f:
            parts = [(f["x_train"], f["y_train"]), (f["x_test"], f["y_test"])]

        shuffled = []
        for samples, labels in parts:
            perm = np.random.permutation(samples.shape[0])
            shuffled.append((samples[perm], labels[perm]))

        data = np.concatenate([s for s, _ in shuffled])
        labels = np.concatenate([l for _, l in shuffled])

        data = self._retokenize(data)

        if self.numwords is None:
            self.numwords = max(max(s) for s in data)

        if log:
            print("[%s] Started truncating vocabulary (%s max) ..." % (type(self).__name__, self.numwords))
        data = self._clampVocab(data)

        if self.maxlen is None:
            self.maxlen = max(len(s) for s in data)

        if log:
            print("[%s] Started adjusting samples length (%s max) ..." % (type(self).__name__, self.maxlen))
        data = self._fitLength(data)

        return np.array(data, dtype=np.int32), np.array(labels, dtype=np.int32), self.loadVocabulary(path)

    def _buildCache(self, path, compress, log):
        h5py = _h5py()
        data, labels, vocab = self._parse(path, log)
        string = h5py.special_dtype(vlen=str)

        with h5py.File(self.cachename, "w") as hdf:
            for setname, tensor in zip(self.datanames, (data, labels, vocab)):
                hdf.create_dataset(setname, data=tensor, compression=compress,
                                   dtype=string if tensor is vocab else None)

            hdf.create_dataset("params", (), dtype=string, data=json.dumps(self._paramsDict()))

    def load(self, path, compress="gzip", log=True):
        h5py = _h5py()
        self.cachename = os.path.join(path, self.cachename)

        if not self.checkCacheParams(log):
            self.clear()

        if not os.path.exists(self.cachename):
            self._buildCache(path, compress, log)

        hdf = h5py.File(self.cachename, "r")
        return tuple(hdf[setname] for setname in self.datanames)
