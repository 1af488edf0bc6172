"""Pure-generator provider (a copy of ``puzzlelib_tpu/transformers/generator.py``):
each thread's transformers make a shard from nothing."""

from puzzlelib_tpu_torch.transformers.provider import Provider


class Generator(Provider):
    def getNextChunk(self, chunksize, **kwargs):
        return None
