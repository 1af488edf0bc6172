"""Threaded data pipeline base (a copy of
``puzzlelib_tpu/transformers/provider.py``).  ``prepareData`` fans a chunk
out over a thread pool and runs the transformer chain on each shard while
the card trains on the previous chunk; ``getData`` joins and reassembles the
shards in thread order.  The transformers run host numpy; none launches
work on the card.
"""

from multiprocessing.pool import ThreadPool

import numpy as np


def _shardChunk(chunk, nshards):
    """Split a chunk (array or tuple of parallel arrays) into nshards shards."""
    if isinstance(chunk, (tuple, list)):
        perArray = [np.array_split(arr, nshards) for arr in chunk]
        return [[parts[i] for parts in perArray] for i in range(nshards)]

    return np.array_split(chunk, nshards)


def _mergeShards(shards):
    """Concatenate transformed shards back into one chunk."""
    if isinstance(shards[0], (tuple, list)):
        width = len(shards[0])
        return tuple(np.concatenate([shard[i] for shard in shards]) for i in range(width))

    return np.concatenate(shards)


class Provider:
    def __init__(self, numofthreads=4):
        self.transformers = []
        self.numofthreads = numofthreads

        self.pool = ThreadPool(numofthreads)
        self.poolresults = None
        self.data = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.closePool()

    def closePool(self):
        self.pool.close()
        self.pool.join()

    def addTransformer(self, transformer):
        self.transformers.append(transformer)

    def getNextChunk(self, chunksize, **kwargs):
        raise NotImplementedError()

    @staticmethod
    def worker(transformers, batch, threadidx):
        for transformer in transformers:
            batch = transformer(batch, threadidx)

        return batch, threadidx

    def prepareData(self, chunksize=20000, **kwargs):
        chunk = self.getNextChunk(chunksize, **kwargs)

        if not self.transformers:
            self.data = chunk
            return

        if chunk is None:
            shards = [None] * self.numofthreads
        else:
            shards = _shardChunk(chunk, self.numofthreads)

        jobs = [(self.transformers, shard, idx) for idx, shard in enumerate(shards)]
        self.poolresults = self.pool.starmap_async(self.worker, jobs)

    def getData(self):
        if self.poolresults is None:
            return self.data

        self.poolresults.wait()

        ordered = [None] * self.numofthreads
        for shard, threadidx in self.poolresults.get():
            ordered[threadidx] = shard

        self.poolresults = None
        self.data = _mergeShards(ordered)

        return self.data
