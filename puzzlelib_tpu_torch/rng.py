"""A seeded random number generator with the reference's facade
(counterpart of ``puzzlelib_tpu/rng.py``): ``fillUniform``, ``fillNormal``
and ``fillInteger`` write draws into existing tensors.

Behind it sits one ``torch.Generator`` per device, made at the first draw
on that device from the generator's seed, so that ``seed(s)`` makes every
device's draws repeat.  ``seed`` reseeds the generators in place, so a CUDA
graph that draws from one (a fused step's dropout) sees the new seed.  The draws are torch's, not JAX's: a test that
holds the two packages to each other injects the same draws into both.
"""

import numpy as np
import torch


class RandomNumberGenerator:
    def __init__(self, seed=None):
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2 ** 63))

        self._generators = {}
        self.seed(seed)

    def seed(self, seed):
        """Start every device's draws again from ``seed``.  A generator made
        already is seeded in place, not replaced: a CUDA graph of a fused
        step that registered it (``fused.FusedStep``) goes on drawing from
        it, from the new seed."""
        self._seed = seed
        for gen in self._generators.values():
            gen.manual_seed(seed)

    def generator(self, device):
        """The generator of ``device`` (a tensor's), made on first use."""
        gen = self._generators.get(device)
        if gen is None:
            gen = self._generators[device] = torch.Generator(device=device)
            gen.manual_seed(self._seed)

        return gen

    def fillUniform(self, data, minval=0.0, maxval=1.0):
        data.uniform_(minval, maxval, generator=self.generator(data.device))

    def fillNormal(self, data, mean=0.0, sigma=1.0):
        data.normal_(mean, sigma, generator=self.generator(data.device))

    def fillInteger(self, data, high=None):
        """Uniform integers into the integer tensor ``data``: over [0,
        high) where ``high`` is given, else over [min, max) of data's type,
        as the reference's signed draws.  torch has no uint32 draw, so the
        reference's full-range uint32 draws go into int64 with ``high =
        2**32``."""
        if high is None:
            info = torch.iinfo(data.dtype)
            low, high = info.min, info.max
        else:
            low = 0

        data.random_(low, high, generator=self.generator(data.device))


globalRng = RandomNumberGenerator()
