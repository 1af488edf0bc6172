"""Multi-dataset ratio-sampling provider (a copy of
``puzzlelib_tpu/transformers/merger.py``).  It draws from ``random`` and
``np.random`` as the reference does, so the same ``random.seed`` and
``np.random.seed`` give both packages the same chunks."""

import random

import numpy as np

from puzzlelib_tpu_torch.transformers.provider import Provider


class Merger(Provider):
    def __init__(self, datasets, labelIds=None, numofthreads=4):
        super().__init__(numofthreads)

        self.datalens = []
        self.datasets = datasets
        self.indices = [0] * len(self.datasets)
        self.labelIds = labelIds

        for dataset in datasets:
            self.datalens.append(dataset.shape[0])

            if dataset.shape[1:] != datasets[0].shape[1:]:
                raise ValueError("Datasets must have same shapes")

    def getNextChunk(self, chunksize, **kwargs):
        ratios, randomize, permutate = kwargs["ratios"], kwargs["randomize"], kwargs["permutate"]

        if not randomize and chunksize >= sum(self.datalens):
            chunksize = sum(self.datalens)

        self.deriveChunkRatios(ratios, chunksize)

        if randomize:
            return self.getRandomChunk(chunksize, ratios, permutate)

        reviseRatios = False
        for i in range(len(self.datasets)):
            if self.datalens[i] < ratios[i]:
                ratios[i] = self.datalens[i]
                reviseRatios = True

        if reviseRatios:
            chunksize = sum(ratios)

        return self.getRationedChunk(chunksize, ratios, permutate)

    def _alloc(self, chunksize):
        chunk = np.empty((chunksize, ) + self.datasets[0].shape[1:], dtype=self.datasets[0].dtype)
        labels = np.empty((chunksize, ), dtype=np.int32) if self.labelIds is not None else None
        return chunk, labels

    def getRandomChunk(self, chunksize, ratios, permutate):
        chunk, labels = self._alloc(chunksize)

        order = np.random.permutation(chunksize) if permutate else np.arange(chunksize)

        idx = 0
        for i, dataset in enumerate(self.datasets):
            for _ in range(ratios[i]):
                chunk[order[idx]] = dataset[random.randint(0, self.datalens[i] - 1)]

                if labels is not None:
                    labels[order[idx]] = self.labelIds[i]

                idx += 1

        return (chunk, labels) if labels is not None else chunk

    def getRationedChunk(self, chunksize, ratios, permutate):
        chunk, labels = self._alloc(chunksize)
        order = np.random.permutation(chunksize) if permutate else np.arange(chunksize)

        idx = 0
        for i, dataset in enumerate(self.datasets):
            begin = self.indices[i]
            end = begin + ratios[i]

            wraps = end > self.datalens[i]
            self.indices[i] = end - self.datalens[i] if wraps else end

            for d in range(ratios[i]):
                src = begin + d if begin + d < self.datalens[i] else begin + d - self.datalens[i]
                chunk[order[idx + d]] = dataset[src]

                if labels is not None:
                    labels[order[idx + d]] = self.labelIds[i]

            idx += ratios[i]

        return (chunk, labels) if labels is not None else chunk

    @staticmethod
    def deriveChunkRatios(ratios, chunksize):
        norm = sum(ratios)

        for i in range(len(ratios) - 1):
            ratios[i] = int(ratios[i] / norm * chunksize)

        ratios[-1] = chunksize - sum(ratios[:-1])

    def prepareData(self, ratios=None, chunksize=20000, randomize=False, permutate=True):
        if ratios is None:
            ratios = [1] * len(self.datasets)
        else:
            assert len(ratios) == len(self.datasets)

        super().prepareData(chunksize, ratios=ratios, randomize=randomize, permutate=permutate)
