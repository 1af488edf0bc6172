"""The identity transformer, the base of a provider's chain (a copy of
``puzzlelib_tpu/transformers/transformer.py``): ``__call__(batch,
threadidx)`` gets a shard of a chunk and the index of the thread that runs
it."""


class Transformer:
    def __call__(self, batch, threadidx):
        return batch
