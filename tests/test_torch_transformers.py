"""The port's threaded data pipeline against the JAX package's.

``Serial`` (chunks that wrap around the dataset's end, a chunk as long as
the dataset or longer, with and without labels and transformers),
``Merger`` (ratios, ``randomize`` and ``permutate`` under the same
``random.seed`` and ``np.random.seed``), ``Generator`` and a 4-thread
``Provider`` whose transformer tags each shard with its thread index: each
gives the JAX package's chunks, chunk for chunk, bit for bit.  A stress
case runs more threads than cores with a short switch interval and checks
that the shards come back in thread order."""

import random
import sys

import numpy as np
import pytest

from puzzlelib_tpu_torch import transformers as TT


def _jax():
    """The JAX package's transformers; the twins skip where it does not
    import, as on the card's machine."""
    return pytest.importorskip("puzzlelib_tpu.transformers", reason="the twins need the JAX package")


def _tagger(base):
    """A transformer class on ``base`` that adds 1000 x (thread index + 1)
    to each shard's data and appends the index to ``seen``."""

    class Tag(base):
        def __init__(self):
            self.seen = []

        def __call__(self, batch, threadidx):
            self.seen.append(threadidx)
            if isinstance(batch, (list, tuple)):
                return [batch[0] + 1000 * (threadidx + 1)] + list(batch[1:])
            return batch + 1000 * (threadidx + 1)

    return Tag()


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return

    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _chunks(provider, count, **kwargs):
    chunks = []
    with provider:
        for _ in range(count):
            provider.prepareData(**kwargs)
            chunks.append(provider.getData())

    return chunks


@pytest.mark.parametrize("chunksize", [7, 20, 26])
@pytest.mark.parametrize("labelled", [False, True])
@pytest.mark.parametrize("tagged", [False, True])
def testSerialTwin(chunksize, labelled, tagged):
    """5 chunks of a 20-row dataset: wrapping past its end at 7, the whole
    dataset at 20 and 26; through 4 tagging threads or none."""
    J = _jax()
    data = np.arange(20 * 3, dtype=np.float32).reshape(20, 3)
    labels = np.arange(20, dtype=np.int32) if labelled else None

    got, want = [], []
    for pkg, out in ((TT, got), (J, want)):
        serial = pkg.Serial(data, labels, numofthreads=4)
        if tagged:
            serial.addTransformer(_tagger(pkg.Transformer))
        out.extend(_chunks(serial, 5, chunksize=chunksize))

    for g, w in zip(got, want):
        _same(g, w)

    rows = [chunk[0] if labelled else chunk for chunk in got]
    assert all(len(chunk) == min(chunksize, 20) for chunk in rows)
    if chunksize == 7 and not tagged:
        assert np.array_equal(rows[2], np.concatenate([data[14:], data[:1]]))


@pytest.mark.parametrize("randomize", [False, True])
@pytest.mark.parametrize("permutate", [False, True])
@pytest.mark.parametrize("ratios", [None, [3, 1], [1, 5]])
@pytest.mark.parametrize("labelIds", [None, [0, 1]])
def testMergerTwin(randomize, permutate, ratios, labelIds):
    """4 chunks of 8 from datasets of 10 and 6 rows under one
    ``random.seed`` and ``np.random.seed``: the same chunks and labels; the
    ratios list the caller passed is rewritten in both the same way."""
    J = _jax()
    d1 = np.random.RandomState(1).randn(10, 2, 3).astype(np.float32)
    d2 = np.random.RandomState(2).randn(6, 2, 3).astype(np.float32)

    got, want, passed = [], [], []
    for pkg, out in ((TT, got), (J, want)):
        random.seed(7)
        np.random.seed(7)
        given = None if ratios is None else list(ratios)
        out.extend(_chunks(pkg.Merger([d1, d2], labelIds), 4, ratios=given, chunksize=8, randomize=randomize,
                           permutate=permutate))
        passed.append(given)

    assert passed[0] == passed[1]
    for g, w in zip(got, want):
        _same(g, w)


def testMergerRefusesMixedShapes():
    J = _jax()
    for pkg in (TT, J):
        with pytest.raises(ValueError, match="same shapes"):
            pkg.Merger([np.zeros((3, 2)), np.zeros((3, 4))])


def testGeneratorTwin():
    """A generator's 4 threads each make a shard from a generator of their
    index: the same merged chunk in both packages, in thread order."""
    J = _jax()

    def make(base):
        class Gen(base):
            def __call__(self, batch, threadidx):
                assert batch is None
                return np.random.RandomState(threadidx).randn(5, 2).astype(np.float32)

        return Gen()

    got, want = [], []
    for pkg, out in ((TT, got), (J, want)):
        generator = pkg.Generator(numofthreads=4)
        generator.addTransformer(make(pkg.Transformer))
        out.extend(_chunks(generator, 2))

    for g, w in zip(got, want):
        _same(g, w)
    assert np.array_equal(got[0][:5], np.random.RandomState(0).randn(5, 2).astype(np.float32))


def testProviderShardsByThread():
    """A 4-thread provider over a (data, labels) chunk of 10 rows: shards of
    3, 3, 2, 2 rows, each tagged by its thread, merged in thread order, the
    labels untouched; two chained transformers run in order."""
    J = _jax()
    data = np.arange(10, dtype=np.float32)
    labels = np.arange(10, dtype=np.int32)

    class Whole:
        def getNextChunk(self, chunksize, **kwargs):
            return data[:chunksize], labels[:chunksize]

    got, want = {}, {}
    for pkg, out in ((TT, got), (J, want)):
        provider = type("Whole", (Whole, pkg.Provider), {})(numofthreads=4)
        first, second = _tagger(pkg.Transformer), _tagger(pkg.Transformer)
        provider.addTransformer(first)
        provider.addTransformer(second)
        out["chunks"] = _chunks(provider, 2, chunksize=10)
        out["seen"] = sorted(first.seen), sorted(second.seen)

    for g, w in zip(got["chunks"], want["chunks"]):
        _same(g, w)
    assert got["seen"] == want["seen"] == ([0, 0, 1, 1, 2, 2, 3, 3], ) * 2

    tags = (got["chunks"][0][0] - data) // 2000
    assert tags.tolist() == [1, 1, 1, 2, 2, 2, 3, 3, 4, 4]
    assert np.array_equal(got["chunks"][0][1], labels)


def testProviderWithoutTransformers():
    """With no transformer the chunk is handed over as it is, in both
    packages."""
    J = _jax()
    for pkg in (TT, J):
        serial = pkg.Serial(np.arange(6), numofthreads=2)
        with serial:
            serial.prepareData(chunksize=4)
            assert serial.poolresults is None
            assert serial.getData().tolist() == [0, 1, 2, 3]


def testTransformerIsTheIdentity():
    batch = np.arange(4)
    assert TT.Transformer()(batch, 3) is batch


def testProviderThreadOrderUnderStress():
    """32 threads or twice the cores, with a short switch interval and
    shards that finish in reverse order: every whole-dataset chunk comes
    back in thread order, 20 times."""
    import os
    import time

    class Slow(TT.Transformer):
        def __call__(self, batch, threadidx):
            time.sleep(0.001 * (32 - threadidx) / 32)
            return batch * 1

    data = np.arange(32 * 5, dtype=np.int64)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = max(32, 2 * (os.cpu_count() or 1))
        serial = TT.Serial(data, numofthreads=threads)
        serial.addTransformer(Slow())
        for chunk in _chunks(serial, 20, chunksize=len(data)):
            assert np.array_equal(chunk, data)
    finally:
        sys.setswitchinterval(interval)


def testShiftAugmentTwin():
    """``dataslice.ShiftAugment`` shifts a shard as ``augmentShift`` of
    ``testlib/digitsnin.py`` does with its thread's generator, and a Serial
    over 4 threads gives what the same transformer gives run inline on the
    same shards."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twin needs the JAX package")
    from testlib import digitsnin
    from puzzlelib_tpu_torch.tools import dataslice

    data = np.random.RandomState(0).randn(10, 3, 32, 32).astype(np.float32)
    labels = np.arange(10, dtype=np.int32)

    images, kept = dataslice.ShiftAugment(4, seed=3)([data, labels], 2)
    assert kept is labels
    assert np.array_equal(images, digitsnin.augmentShift(data, np.random.RandomState([3, 2])))
    assert not np.array_equal(images, data)

    serial = TT.Serial(data, labels, numofthreads=4)
    serial.addTransformer(dataslice.ShiftAugment(4, seed=3))
    threaded = _chunks(serial, 2, chunksize=10)

    inline = dataslice.ShiftAugment(4, seed=3)
    for chunk in threaded:
        shards = [inline([data[rows], labels[rows]], idx)
                  for idx, rows in enumerate(np.array_split(np.arange(10), 4))]
        _same(chunk, (np.concatenate([s[0] for s in shards]), np.concatenate([s[1] for s in shards])))
