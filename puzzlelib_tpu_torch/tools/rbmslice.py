"""The RBM slice, as ``chip_smoke.py`` and the tests run it.

``RBM(784, 500)`` in f32 (an MNIST-sized visible layer and a hidden layer
of 500; the repo names no RBM configuration, so the size is this slice's
choice) trained by CD-1 or PCD under ``MomentumSGD`` at batch 128, on
seeded binary data built as ``tests/test_rbm.py`` builds its data: each row
one of a few binary prototypes, here with a share of its pixels flipped.
``train`` starts from the weights of ``np.random.seed(0)`` and draws its
units from a ``RandomNumberGenerator`` seeded by ``seed``, so a second run
gives the same bits.  ``reconError`` is the test's mean squared error of
the mean-field reconstruction.  The device is the caller's
``Config.device``.
"""

import numpy as np


VSIZE, HSIZE = 784, 500
BATCH = 128
STEPS = 20
PROTOTYPES = 10
FLIP = 0.05
LEARN_RATE, MOM_RATE = 0.05 / BATCH, 0.9


def data(count=BATCH, vsize=VSIZE, prototypes=PROTOTYPES, flip=FLIP, seed=4):
    """``count`` binary f32 rows: a seeded prototype each (each pixel of a
    prototype on with probability 0.3), with a share ``flip`` of its pixels
    flipped."""
    rng = np.random.RandomState(seed)
    protos = (rng.uniform(size=(prototypes, vsize)) < 0.3).astype(np.float32)
    rows = protos[rng.randint(0, prototypes, size=count)]
    flips = rng.uniform(size=rows.shape) < flip
    return np.where(flips, 1.0 - rows, rows).astype(np.float32)


def reconError(rbm, rows):
    """Mean squared error of sigmoid(sigmoid(v W + c) W^T + b) against the
    rows ``v`` (a tensor on the RBM's device), as a float."""
    import torch

    probs = torch.sigmoid(torch.sigmoid(rows @ rbm.W + rbm.c) @ rbm.W.T + rbm.b)
    return float(((probs - rows) ** 2).mean())


def build(vsize=VSIZE, hsize=HSIZE, seed=1):
    """The RBM, its weights from ``np.random.seed(0)``, drawing from a
    ``RandomNumberGenerator`` seeded by ``seed``."""
    from puzzlelib_tpu_torch.models.misc import RBM
    from puzzlelib_tpu_torch.rng import RandomNumberGenerator

    np.random.seed(0)
    return RBM(vsize, hsize, rng=RandomNumberGenerator(seed))


def train(rows, persistent=False, steps=STEPS, rbm=None, errors=None):
    """``steps`` CD-1 (or PCD) steps of ``MomentumSGD(LEARN_RATE, 0.9)`` on
    ``rows`` (a tensor) from ``build()`` or ``rbm``; the reconstruction
    error before and after each step is appended to ``errors`` when it is
    given.  Returns the RBM."""
    from puzzlelib_tpu_torch.optimizers import MomentumSGD

    rbm = build(rows.shape[1]) if rbm is None else rbm
    optimizer = MomentumSGD(learnRate=LEARN_RATE, momRate=MOM_RATE)
    optimizer.setupOn(rbm)

    if errors is not None:
        errors.append(reconError(rbm, rows))

    np.random.seed(5)   # the persistent particles' start
    for _ in range(steps):
        if persistent:
            rbm.calcPCDGrad(rows)
        else:
            rbm.calcCDGrad(rows)
        optimizer.update()

        if errors is not None:
            errors.append(reconError(rbm, rows))

    return rbm
