"""The port's nine dataset loaders against the JAX package's.

Each twin writes the same small files twice from one seed (MNIST's idx
files, the CIFAR-10 pickle tar and IMDB's npz and json through
``tools/dataslice.py``; SmallNORB's binary .mat files, and a directory, a
tar and a zip of PNGs, as ``tests/test_datasets.py`` writes them), loads
one copy with each package and holds the arrays and their types equal bit
for bit (tolerance 0).  A cache written by either package loads in the
other, with the same dataset names, types, shapes and compression; IMDB's
parameter check and ``InputLoader``'s time stamps act on the other
package's cache.  The parse steps of ``MnistLoader``, ``Cifar10Loader``
and ``IMDBLoader`` equal their ``load``; MNIST keeps its test images first.
A child process without ``h5py`` imports the port's data path, runs the
three parse steps, and finds each ``load`` refusing with an ``ImportError``
that names h5py."""

import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tarfile
import zipfile

import numpy as np
import pytest

from puzzlelib_tpu_torch import datasets as TD
from puzzlelib_tpu_torch.tools import dataslice as Data


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MNIST_SIZES = dict(train=12, test=5)
CIFAR_SIZES = dict(batches=2, batch=4)
IMDB_SIZES = dict(train=6, test=4, words=60, lengths=(3, 6, 14))


def _jax():
    """The JAX package's loaders; the twins skip where it does not import,
    as on the card's machine."""
    return pytest.importorskip("puzzlelib_tpu.datasets", reason="the twins need the JAX package")


def _host(datasets):
    """numpy copies of one h5py file's datasets, the file closed."""
    arrays = tuple(np.asarray(ds[()]) for ds in datasets)
    datasets[0].file.close()

    return arrays


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def _layout(filename):
    """{dataset name: (type, shape, compression)} of an HDF5 file, groups
    walked; a time stamp by its source's base name (its key holds the
    whole path, with backslashes)."""
    import h5py

    layout = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            if name.startswith("timestamps/"):
                name = "timestamps/" + name.split("\\")[-1]
            layout[name] = (obj.dtype, obj.shape, obj.compression)

    with h5py.File(filename, "r") as hdf:
        hdf.visititems(visit)

    return layout


def _png(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="png")
    return buf.getvalue()


def _images(seed, count=6, size=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, size=(size, size, 3), dtype=np.uint8) for _ in range(count)]


def _writeNorb(path, loader, seed=5):
    """SmallNORB's six binary files, 3 stereo 8 x 8 samples a split."""
    rng = np.random.RandomState(seed)

    def writeMat(name, magic, arr, ndim):
        dims = arr.shape[:ndim]
        with open(os.path.join(path, name), "wb") as f:
            f.write(struct.pack("<ii", magic, ndim))
            padded = tuple(dims) + (1, ) * max(0, 3 - ndim)
            f.write(struct.pack("<" + "i" * len(padded), *padded))
            f.write(arr.tobytes())

    for dataName, lblName, infoName in ((loader.traindata, loader.trainlabels, loader.traininfo),
                                        (loader.testdata, loader.testlabels, loader.testinfo)):
        writeMat(dataName, 0x1E3D4C55, rng.randint(0, 255, size=(3, 2, 8, 8)).astype(np.uint8), 4)
        writeMat(lblName, 0x1E3D4C54, rng.randint(0, 5, size=(3, )).astype(np.uint32), 1)
        info = np.stack([np.arange(3, dtype=np.uint32), rng.randint(0, 9, size=3).astype(np.uint32),
                         (2 * rng.randint(0, 18, size=3)).astype(np.uint32),
                         rng.randint(0, 6, size=3).astype(np.uint32)], axis=1)
        writeMat(infoName, 0x1E3D4C54, info, 2)


def _writeArchive(kind, path, seed=0):
    """A directory, tar or zip of 6 PNGs under ``path``; returns its name."""
    images = _images(seed)
    if kind == "path":
        root = os.path.join(path, "imgs")
        os.mkdir(root)
        for i, img in enumerate(images):
            with open(os.path.join(root, "img%d.png" % i), "wb") as f:
                f.write(_png(img))
        return root

    if kind == "tar":
        name = os.path.join(path, "imgs.tar")
        with tarfile.open(name, "w") as tf:
            for i, img in enumerate(images):
                payload = _png(img)
                info = tarfile.TarInfo("img%d.png" % i)
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
        return name

    name = os.path.join(path, "imgs.zip")
    with zipfile.ZipFile(name, "w") as zf:
        for i, img in enumerate(images):
            zf.writestr("img%d.png" % i, _png(img))
    return name


def _indexFromZero(path, words):
    """A word index with a word at every id from 0 to ``words`` (the
    published one starts at 1; ``words`` covers a vocabulary taken from the
    data, the ids shifted by 3): both packages' caches refuse a vocabulary
    with a gap (``testImdbVocabularyGapRefusedByBoth``)."""
    with open(os.path.join(path, "imdb_word_index.json"), "w") as f:
        json.dump({"w%d" % i: i for i in range(words + 1)}, f)


_ARCHIVES = {"path": "PathLoader", "tar": "TarLoader", "zip": "ZipLoader"}
_NORB = dict(onSample=lambda s: s, sampleInfo=lambda: (np.float32, (8, 8)))


class _Kind:
    """One loader's files and its ``load`` in either package (``pkg`` the
    datasets module), into directory ``path``; ``cache`` names the cache
    file the load writes."""

    def __init__(self, name, path):
        self.name, self.path = name, str(path)
        os.makedirs(self.path, exist_ok=True)

        if name == "mnist":
            self.arrays = Data.mnistArrays(*Data.writeMnist(self.path, **MNIST_SIZES))
        elif name == "cifar":
            self.arrays = Data.cifarArrays(Data.writeCifar(self.path, **CIFAR_SIZES))
        elif name == "imdb":
            Data.writeImdb(self.path, **IMDB_SIZES)
            _indexFromZero(self.path, IMDB_SIZES["words"] + 3)
        elif name == "smallnorb":
            _writeNorb(self.path, TD.SmallNorbLoader(**_NORB))
        else:
            self.source = _writeArchive(name, self.path)

    @property
    def cache(self):
        names = {"mnist": "mnist.hdf", "cifar": "cifar10.hdf", "imdb": "imdb.hdf", "smallnorb": "smallnorb.hdf"}
        return os.path.join(self.path, names.get(self.name, "inputs.hdf"))

    def load(self, pkg, **params):
        if self.name == "mnist":
            return _host(pkg.MnistLoader().load(path=self.path, log=False))
        if self.name == "cifar":
            return _host(pkg.Cifar10Loader().load(path=self.path, log=False))
        if self.name == "imdb":
            np.random.seed(3)
            return _host(pkg.IMDBLoader(**(params or dict(numwords=40, maxlen=10))).load(path=self.path, log=False))
        if self.name == "smallnorb":
            return _host(pkg.SmallNorbLoader(**_NORB).load(path=self.path, log=False))

        loader = getattr(pkg, _ARCHIVES[self.name])(cachename=self.cache)
        return _host([loader.load(self.source, log=False)])


KINDS = ("mnist", "cifar", "imdb", "smallnorb", "path", "tar", "zip")


@pytest.mark.parametrize("kind", KINDS)
def testLoadTwin(kind, tmp_path):
    """The same files loaded by each package: equal arrays and types, and
    caches of the same layout."""
    J = _jax()
    jkind, tkind = _Kind(kind, tmp_path / "jax"), _Kind(kind, tmp_path / "port")

    _equal(tkind.load(TD), jkind.load(J))
    assert _layout(tkind.cache) == _layout(jkind.cache)


@pytest.mark.parametrize("kind", KINDS)
def testCacheLoadsAcross(kind, tmp_path):
    """A cache written by either package loads in the other: the raw files
    removed after the first load, the other package's load reads the
    cache."""
    J = _jax()
    for writer, reader, sub in ((J, TD, "jax-cache"), (TD, J, "port-cache")):
        files = _Kind(kind, tmp_path / sub)
        written = files.load(writer)

        for name in os.listdir(files.path):
            full = os.path.join(files.path, name)
            if full != files.cache:
                shutil.rmtree(full) if os.path.isdir(full) else os.remove(full)
        if kind in _ARCHIVES:
            # an InputLoader checks its source's time stamp: keep the name
            os.makedirs(files.source) if kind == "path" else open(files.source, "wb").close()
            os.utime(files.source, (0, 0))

        _equal(files.load(reader), written)


@pytest.mark.parametrize("params", [dict(numwords=40, maxlen=10), dict(numwords=None, maxlen=None),
                                    dict(numwords=30, maxlen=5, skiptop=4, oovchar=None),
                                    dict(numwords=50, maxlen=12, startchar=None, indexFrom=2)])
def testImdbParamsTwin(params, tmp_path):
    """IMDB's options (a vocabulary and length from the data, skipped top
    words, no oov marker, no start marker): the same arrays, vocabulary
    included, in both packages."""
    J = _jax()
    jkind, tkind = _Kind("imdb", tmp_path / "jax"), _Kind("imdb", tmp_path / "port")
    _equal(tkind.load(TD, **params), jkind.load(J, **params))


def testImdbParamsCheckAcross(tmp_path):
    """Either package's cache is kept for the same parameters (the raw
    files gone, the load still succeeds) and cleared and rebuilt for
    others."""
    J = _jax()
    for writer, reader, sub in ((J, TD, "jax-cache"), (TD, J, "port-cache")):
        files = _Kind("imdb", tmp_path / sub)
        written = files.load(writer, numwords=40, maxlen=10)

        os.rename(os.path.join(files.path, "imdb.npz"), os.path.join(files.path, "imdb.keep"))
        _equal(files.load(reader, numwords=40, maxlen=10), written)

        os.rename(os.path.join(files.path, "imdb.keep"), os.path.join(files.path, "imdb.npz"))
        again = files.load(reader, numwords=30, maxlen=10)
        assert again[0].shape == (10, 10) and again[0].max() < 30
        assert not np.array_equal(again[0], written[0])


@pytest.mark.parametrize("kind", sorted(_ARCHIVES))
def testInputLoaderTimestampsAcross(kind, tmp_path):
    """The time stamps keyed with backslashes as the JAX package keys them;
    either package's cache is kept while its source is older and rebuilt by
    the other once the source is touched (a seventh image added)."""
    J = _jax()
    import h5py

    for writer, reader, sub in ((J, TD, "jax-cache"), (TD, J, "port-cache")):
        files = _Kind(kind, tmp_path / sub)
        assert files.load(writer)[0].shape == (6, 3, 8, 8)

        with h5py.File(files.cache, "r") as hdf:
            assert list(hdf["timestamps"].keys()) == [os.path.normpath(files.source).replace("/", "\\")]

        loader = getattr(reader, _ARCHIVES[kind])(cachename=files.cache)
        assert not loader.checkNeedToLoad(log=False)

        extra = _png(_images(1, count=1)[0])
        if kind == "path":
            with open(os.path.join(files.source, "img6.png"), "wb") as f:
                f.write(extra)
        elif kind == "tar":
            with tarfile.open(files.source, "a") as tf:
                info = tarfile.TarInfo("img6.png")
                info.size = len(extra)
                tf.addfile(info, io.BytesIO(extra))
        else:
            with zipfile.ZipFile(files.source, "a") as zf:
                zf.writestr("img6.png", extra)
        stamp = os.path.getmtime(files.source) + 10
        os.utime(files.source, (stamp, stamp))

        assert loader.checkNeedToLoad(log=False)
        assert files.load(reader)[0].shape == (7, 3, 8, 8)


def testMnistKeepsTestImagesFirst(tmp_path):
    """The parse stacks the 5 test images before the 12 training ones, as
    the JAX package does: ``data[:60000]`` of the full set trains on the
    test images and the first 50000 training ones."""
    testImages, testLabels, trainImages, trainLabels = Data.writeMnist(str(tmp_path), **MNIST_SIZES)
    images, labels = TD.MnistLoader()._parse(str(tmp_path), log=False)

    assert images.shape == (17, 1, 28, 28) and images.dtype == np.float32 and labels.dtype == np.int32
    assert np.array_equal(images[:5, 0] * 255, testImages) and np.array_equal(labels[:5], testLabels)
    assert np.array_equal(images[5:, 0] * 255, trainImages) and np.array_equal(labels[5:], trainLabels)
    _equal((images, labels), Data.mnistArrays(testImages, testLabels, trainImages, trainLabels))


@pytest.mark.parametrize("kind", ["mnist", "cifar", "imdb"])
def testParseEqualsLoad(kind, tmp_path):
    """Each parse step returns what ``load`` caches, bit for bit (IMDB's
    vocabulary as the words h5py reads back); MNIST's and CIFAR-10's what
    ``tools/dataslice.py`` computes from the bytes it wrote."""
    files = _Kind(kind, tmp_path)
    loaded = files.load(TD)

    if kind in ("mnist", "cifar"):
        parsed = (TD.MnistLoader() if kind == "mnist" else TD.Cifar10Loader())._parse(files.path, log=False)
        _equal(parsed, files.arrays)
    else:
        np.random.seed(3)
        data, labels, vocab = TD.IMDBLoader(numwords=40, maxlen=10)._parse(files.path, log=False)
        assert vocab.dtype == object and [w.decode() for w in loaded[2]] == list(vocab)
        parsed, loaded = (data, labels), loaded[:2]

    _equal(parsed, loaded)


def testLoaderErrorsTwin(tmp_path):
    """A bad magic number, a missing CIFAR archive and a missing directory
    (its time stamp read before ``checkInput``) raise the same errors in
    both packages."""
    J = _jax()
    bad, badMat = str(tmp_path / "bad.idx"), str(tmp_path / "bad.mat")
    with open(bad, "wb") as f:
        f.write(struct.pack(">IIII", 1234, 1, 28, 28) + bytes(784))
    with open(badMat, "wb") as f:
        f.write(struct.pack("<iiiii", 0x12345678, 3, 1, 1, 1) + bytes(1))

    for pkg in (J, TD):
        with pytest.raises(ValueError, match="Bad magic number"):
            pkg.MnistLoader()._readImages(bad)
        with pytest.raises(ValueError, match="Bad magic number"):
            pkg.SmallNorbLoader._readMat(badMat, 0x1E3D4C55)
        with pytest.raises(ValueError, match="No proper datafile"):
            pkg.Cifar10Loader().load(path=str(tmp_path), log=False)
        with pytest.raises(FileNotFoundError):
            pkg.PathLoader(cachename=str(tmp_path / ("%s.hdf" % pkg.__name__))).load(str(tmp_path / "missing"),
                                                                                   log=False)


def testImdbVocabularyGapRefusedByBoth(tmp_path):
    """The published word index starts at 1, so a vocabulary from it has no
    word at id 0: both packages' caches refuse to store that gap (h5py's
    string type takes no None), and the port's parse step returns the
    vocabulary with None there."""
    J = _jax()
    for pkg, sub in ((J, "jax"), (TD, "port")):
        path = str(tmp_path / sub)
        os.makedirs(path)
        Data.writeImdb(path, **IMDB_SIZES)

        np.random.seed(3)
        with pytest.raises(TypeError, match="non-string"):
            pkg.IMDBLoader(numwords=40, maxlen=10).load(path=path, log=False)

    np.random.seed(3)
    vocab = TD.IMDBLoader(numwords=40, maxlen=10)._parse(path, log=False)[2]
    assert vocab[0] is None and list(vocab[1:]) == ["w%d" % i for i in range(1, 40)]


_NO_H5PY = """
import os, sys
sys.modules["h5py"] = None
import numpy as np
from puzzlelib_tpu_torch import datasets, transformers, testlib
from puzzlelib_tpu_torch.testlib import (_imdb, birnnimdbtrain, cnncifar10nin, cnncifar10simple, cnnimdbtrain,
                                         cnnmnistlenet, rnnimdbtrain)
from puzzlelib_tpu_torch.tools import dataslice
path = sys.argv[1]
mnist = dataslice.writeMnist(path, train=12, test=5)
cifar = dataslice.writeCifar(path, batches=2, batch=4)
dataslice.writeImdb(path, train=6, test=4, words=60, lengths=(3, 6, 14))
images, labels = datasets.MnistLoader()._parse(path, log=False)
assert np.array_equal(images, dataslice.mnistArrays(*mnist)[0])
assert np.array_equal(datasets.Cifar10Loader()._parse(path, log=False)[0], dataslice.cifarArrays(cifar)[0])
assert datasets.IMDBLoader(numwords=40, maxlen=10)._parse(path, log=False)[0].shape == (10, 10)
refused = []
for loader, args in ((datasets.MnistLoader(), (path, )), (datasets.Cifar10Loader(), (path, )),
                     (datasets.IMDBLoader(numwords=40, maxlen=10), (path, )), (datasets.SmallNorbLoader(), (path, )),
                     (datasets.PathLoader(), (path, )), (datasets.TarLoader(), (path, )),
                     (datasets.ZipLoader(), (path, ))):
    try:
        loader.load(*args, log=False)
    except ImportError as e:
        refused.append("h5py" in str(e))
print("REFUSED", refused, sorted(os.listdir(path)))
print("LEAKED", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "puzzlelib_tpu", "h5py")
                       and sys.modules[m] is not None))
"""


def testDataPathWithoutH5py(tmp_path):
    """Without ``h5py`` the port's data path imports and parses, and every
    loader's ``load`` raises an ``ImportError`` that names h5py, writing no
    cache."""
    proc = subprocess.run([sys.executable, "-c", _NO_H5PY, str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))

    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "REFUSED [True, True, True, True, True, True, True]" in proc.stdout, proc.stdout
    assert ".hdf" not in proc.stdout
    assert "LEAKED []" in proc.stdout
