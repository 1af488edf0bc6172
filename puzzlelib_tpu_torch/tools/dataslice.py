"""The data slice, as ``chip_smoke.py`` and the tests run it.

The repo holds no MNIST, CIFAR-10 or IMDB file, so this module writes them
from a numpy seed, in the datasets' own formats and, by default, at their
published sizes:

- MNIST (``writeMnist``): the four idx files, 60000 training and 10000 test
  images of 28 x 28 uint8 with their labels.  Each image is its class's
  seeded prototype (an eighth of its pixels white) with 6 in 256 of its
  pixels flipped, a mean intensity of 0.14 (MNIST's is 0.13), so the
  labels can be learnt and a loader that misaligns images and labels shows
  as a held-out error near chance.  (With a fifth white and a tenth
  flipped, a mean of 0.26, ``testlib/cnnmnistlenet.py``'s recipe, a rate
  of 0.1 at momentum 0.9, diverged in both packages alike.)
- CIFAR-10 (``writeCifar``): ``cifar-10-python.tar`` (the uncompressed name
  ``Cifar10Loader`` also takes), five ``data_batch_k`` pickles and
  ``test_batch``, each ``{"data": (10000, 3072) uint8, "labels": [...]}``,
  each image its class's seeded prototype plus uniform noise in [-64, 63].
- IMDB (``writeImdb``): ``imdb.npz`` with 25000 + 25000 reviews as object
  arrays of word-id lists (ids 1 to 88584, log-uniform, so the rare ones
  fall outside a cut vocabulary) and int64 {0, 1} labels, and
  ``imdb_word_index.json`` with 88584 words (the published index's size).
  Review lengths are log-normal about a median of 178 words, as the
  published set's, cut to [10, 2494], the longest 2494.

``mnistArrays`` and ``cifarArrays`` compute what the loaders' parse steps
must return from the seeded bytes, independently of the loaders;
``parseImdb`` runs IMDB's parse under a seed.
- The UCI handwritten digits (``digits``): scikit-learn's bundled set
  (1797 images of 8 x 8 in [0, 16]) is not on every machine, so the card
  runs the ``digits*`` scripts' training on seeded arrays of its shape and
  range: each image its class's seeded template plus noise.

``ShiftAugment`` is ``augmentShift`` of the JAX package's
``testlib/digitsnin.py`` as a ``Transformer``: each shard's images shifted
by up to 2 pixels with edge padding, from one generator a thread.
"""

import io
import json
import os
import pickle
import struct
import tarfile
import time

import numpy as np

from puzzlelib_tpu_torch.transformers import Transformer


MNIST_TRAIN, MNIST_TEST = 60000, 10000
CIFAR_BATCHES, CIFAR_BATCH = 5, 10000
IMDB_TRAIN, IMDB_TEST = 25000, 25000
IMDB_WORDS = 88584
IMDB_LENGTHS = (10, 178, 2494)  # shortest, median, longest review
CLASSES = 10
DIGITS = 1797

MNIST_FILES = ("train-images.idx3-ubyte", "train-labels.idx1-ubyte", "t10k-images.idx3-ubyte",
               "t10k-labels.idx1-ubyte")
CIFAR_FILE = "cifar-10-python.tar"


def _bytes(rng, shape):
    """Seeded uniform uint8 values of ``shape``."""
    return np.frombuffer(rng.bytes(int(np.prod(shape))), dtype=np.uint8).reshape(shape)


def _classImages(rng, count, protos, noise):
    """(images uint8 (count, ...), labels uint8): each image ``noise`` of
    its class's prototype."""
    labels = rng.randint(0, CLASSES, size=count).astype(np.uint8)
    return noise(protos[labels]), labels


def digits(count=DIGITS, seed=0):
    """(images float64 (count, 8, 8) of integers in [0, 16], labels int64),
    as ``sklearn.datasets.load_digits()``'s ``images`` and ``target``: each
    image its class's seeded template (uniform in [0, 16]) with each pixel
    moved by -1, 0 or +1 and clipped."""
    rng = np.random.RandomState(seed)
    protos = rng.randint(0, 17, size=(CLASSES, 8, 8)).astype(np.int16)

    def jitter(images):
        return np.clip(images + rng.randint(-1, 2, size=images.shape), 0, 16)

    images, labels = _classImages(rng, count, protos, jitter)
    return images.astype(np.float64), labels.astype(np.int64)


def writeMnist(path, train=MNIST_TRAIN, test=MNIST_TEST, seed=0):
    """The four idx files in ``path``; returns (test images, test labels,
    train images, train labels) as uint8 arrays."""
    rng = np.random.RandomState(seed)
    protos = (rng.randint(0, 8, size=(CLASSES, 28, 28), dtype=np.uint8) == 0).astype(np.uint8) * 255

    def flip(images):
        return images ^ ((_bytes(rng, images.shape) < 6).astype(np.uint8) * 255)

    trainImages, trainLabels = _classImages(rng, train, protos, flip)
    testImages, testLabels = _classImages(rng, test, protos, flip)

    for name, array in zip(MNIST_FILES, (trainImages, trainLabels, testImages, testLabels)):
        with open(os.path.join(path, name), "wb") as file:
            if array.ndim == 3:
                file.write(struct.pack(">IIII", 2051, *array.shape))
            else:
                file.write(struct.pack(">II", 2049, array.shape[0]))
            file.write(array.tobytes())

    return testImages, testLabels, trainImages, trainLabels


def mnistArrays(testImages, testLabels, trainImages, trainLabels):
    """What ``MnistLoader._parse`` returns for these bytes: f32 images in
    [0, 1] of shape (N, 1, 28, 28) and int32 labels, test before train."""
    images = np.concatenate([testImages, trainImages]).astype(np.float32) / np.float32(255)
    return images.reshape(-1, 1, 28, 28), np.concatenate([testLabels, trainLabels]).astype(np.int32)


def writeCifar(path, batches=CIFAR_BATCHES, batch=CIFAR_BATCH, seed=0):
    """``cifar-10-python.tar`` in ``path``: ``batches`` training pickles and
    ``test_batch``, each of ``batch`` images; returns [(data uint8 (batch,
    3072), labels list)] in the archive's order."""
    rng = np.random.RandomState(seed)
    protos = rng.randint(0, 256, size=(CLASSES, 3072)).astype(np.int16)

    def jitter(images):
        noise = (_bytes(rng, images.shape) >> 1).astype(np.int16) - 64
        return np.clip(images + noise, 0, 255).astype(np.uint8)

    names = ["data_batch_%d" % (k + 1) for k in range(batches)] + ["test_batch"]
    written = []

    with tarfile.open(os.path.join(path, CIFAR_FILE), "w") as tar:
        for name in names:
            data, labels = _classImages(rng, batch, protos, jitter)
            payload = pickle.dumps({"data": data, "labels": labels.tolist()})

            info = tarfile.TarInfo("cifar-10-batches-py/%s" % name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
            written.append((data, labels.tolist()))

    return written


def cifarArrays(batches):
    """What ``Cifar10Loader._parse`` returns for ``batches``: f32 images in
    [-1, 1] of shape (N, 3, 32, 32) and int32 labels."""
    data = np.concatenate([data for data, _ in batches]).reshape(-1, 3, 32, 32)
    images = data.astype(np.float32) * np.float32(2) / np.float32(255) - np.float32(1)
    return images, np.concatenate([labels for _, labels in batches]).astype(np.int32)


def writeImdb(path, train=IMDB_TRAIN, test=IMDB_TEST, words=IMDB_WORDS, lengths=IMDB_LENGTHS, seed=0):
    """``imdb.npz`` and ``imdb_word_index.json`` in ``path``; returns the
    number of words in all reviews."""
    rng = np.random.RandomState(seed)
    shortest, median, longest = lengths
    count = train + test

    sizes = np.clip(np.exp(rng.normal(np.log(median), 0.76, size=count)), shortest, longest).astype(np.int64)
    sizes[rng.randint(0, count)] = longest

    ids = np.exp(rng.uniform(0.0, np.log(words + 1), size=int(sizes.sum()))).astype(np.int64)
    ids = np.clip(ids, 1, words)

    reviews = np.empty(count, dtype=object)
    for i, review in enumerate(np.split(ids, np.cumsum(sizes)[:-1])):
        reviews[i] = review.tolist()

    labels = rng.randint(0, 2, size=count).astype(np.int64)
    np.savez(os.path.join(path, "imdb.npz"), x_train=reviews[:train], y_train=labels[:train],
             x_test=reviews[train:], y_test=labels[train:])

    with open(os.path.join(path, "imdb_word_index.json"), "w") as file:
        json.dump({"w%d" % i: i for i in range(1, words + 1)}, file)

    return int(sizes.sum())


def parseImdb(path, seed, numwords, maxlen):
    """(data, labels, seconds) of ``IMDBLoader(numwords, maxlen)._parse``
    on the files in ``path`` after ``np.random.seed(seed)``: a top-level
    function, so that a process of its own can run a parse beside the
    card's work."""
    from puzzlelib_tpu_torch.datasets import IMDBLoader

    np.random.seed(seed)
    start = time.perf_counter()
    data, labels, _ = IMDBLoader(numwords=numwords, maxlen=maxlen)._parse(path, log=False)
    return data, labels, time.perf_counter() - start


def augmentShift(data, rng, maxshift=2):
    """Random +-maxshift pixel translations with edge padding (a copy of
    ``testlib/digitsnin.py`` ``augmentShift``)."""
    n = data.shape[0]
    out = np.empty_like(data)
    pad = np.pad(data, ((0, 0), (0, 0), (maxshift, maxshift), (maxshift, maxshift)), mode="edge")
    dys = rng.randint(0, 2 * maxshift + 1, size=n)
    dxs = rng.randint(0, 2 * maxshift + 1, size=n)
    for i in range(n):
        out[i] = pad[i, :, dys[i]:dys[i] + data.shape[2], dxs[i]:dxs[i] + data.shape[3]]
    return out


class ShiftAugment(Transformer):
    """``augmentShift`` on each (images, labels) shard, with the generator
    of its thread index (seeded (seed, index)), so the same shards in the
    same thread order get the same shifts, in threads or not."""

    def __init__(self, threads, seed=0):
        self.rngs = [np.random.RandomState([seed, idx]) for idx in range(threads)]

    def __call__(self, batch, threadidx):
        data, labels = batch
        return augmentShift(data, self.rngs[threadidx]), labels
