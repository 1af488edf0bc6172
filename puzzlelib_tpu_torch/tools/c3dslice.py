"""The C3D slice, as ``chip_smoke.py`` and the tests run it.

C3D (Tran, Bourdev, Fergus, Torresani and Paluri, ICCV 2015) at full
width, built here from the port's modules (the zoo has no loader for it):

- eight ``Conv3D``, 3 x 3 x 3 with pad 1, of 64, 128, 256, 256, 512, 512,
  512 and 512 maps (conv1a to conv5b), each followed by a relu;
- ``MaxPool3D``: pool1 1 x 2 x 2 at stride 1 x 2 x 2, pool2 to pool4
  2 x 2 x 2 at stride 2, pool5 2 x 2 x 2 at stride 2 with pad (0, 1, 1),
  which leaves 512 x 1 x 4 x 4 = 8192 features of a 16 x 112 x 112 clip;
- fc6 8192 -> 4096 and fc7 4096 -> 4096, each with a relu and
  ``Dropout(0.5)``, then fc8 4096 -> 487 (Sports-1M's classes).

79,991,015 parameters (``buildNet().numOfParams()``).  Input: the paper's
3 x 16 x 112 x 112 clips at batch 16 (the paper's is 30; cut for the smoke
test's time), in bf16, as the other bf16 slices run.  K1 takes the three
Linears' forward products: fc6 and fc7 on ``wgmma``, fc8 (N = 487, off a
multiple of 8) on the WMMA kernel.  The 3-d convs and pools go to cuDNN and
the library's pools (no hand kernel takes a 3-d conv; no Pallas kernel does
in the JAX package).  No two windows of C3D's pools share a cell, so their
library backwards repeat bit for bit (``ops/pool.py``).

Weights, data and training are ``alexnetslice``'s: He weights from
``np.random.seed(0)``, seeded clips whose labels are read off them,
``CrossEntropy`` and ``MomentumSGD(LEARN_RATE, 0.9)`` in global state, a
``resnetslice.Run`` on the routes "hopper", "torch" and "fused".  At 1e-3
and 3e-4 every step's loss fell on both routes on an H100; at 3e-3 the
second step's rose, from 1e-2 on the loss went to NaN.  ``python3 -m
puzzlelib_tpu_torch.tools.c3dslice --rates ...`` trains 4 steps at each
rate on both routes and prints the losses.
"""

import argparse

import numpy as np

from puzzlelib_tpu_torch.tools import alexnetslice as Alex
from puzzlelib_tpu_torch.tools import zooslice as Zoo


BATCH = 16
STEPS = 4
SHAPE = (3, 16, 112, 112)
CLASSES = 487
LEARN_RATE, MOM_RATE = 1e-3, 0.9

# (convs, maps) a stage, and each stage's pool (size = stride, pad)
STAGES = ((1, 64), (1, 128), (2, 256), (2, 512), (2, 512))
POOLS = (((1, 2, 2), 0), ((2, 2, 2), 0), ((2, 2, 2), 0), ((2, 2, 2), 0), ((2, 2, 2), (0, 1, 1)))
FCS = (4096, 4096)


def buildNet(maps=None, fcs=FCS, classes=CLASSES, shape=SHAPE, modules=None, containers=None):
    """C3D with stage widths ``maps`` (STAGES' by default) and fc widths
    ``fcs`` to ``classes`` scores, for clips of ``shape``, from ``modules``
    and ``containers`` (the port's by default; the tests pass the JAX
    package's), its weights unset ("none")."""
    if modules is None:
        from puzzlelib_tpu_torch import containers, modules

    M = modules
    net = containers.Sequential(name="C3D")

    width = shape[0]
    for stage, ((convs, _), narrow, (size, pad)) in enumerate(zip(STAGES, maps or [s[1] for s in STAGES], POOLS), 1):
        for k in range(convs):
            name = "conv%d%s" % (stage, "ab"[k])
            net.append(M.Conv3D(width, narrow, 3, pad=1, initscheme="none", name=name))
            net.append(M.Activation(M.relu, name="relu%d%s" % (stage, "ab"[k])))
            width = narrow

        net.append(M.MaxPool3D(size, size, pad=pad, name="pool%d" % stage))

    features = int(np.prod(net.dataShapeFrom((1, ) + tuple(shape))[1:]))
    net.append(M.Flatten(name="flatten"))

    for i, outsize in enumerate(fcs, 6):
        net.append(M.Linear(features, outsize, initscheme="none", name="fc%d" % i))
        net.append(M.Activation(M.relu, name="relu%d" % i))
        net.append(M.Dropout(0.5, name="drop%d" % i))
        features = outsize

    net.append(M.Linear(features, classes, initscheme="none", name="fc%d" % (6 + len(fcs))))
    return net


def build(dtype=None, **widths):
    """C3D (``buildNet(**widths)``) with ``zooslice.heTable``'s weights from
    ``np.random.seed(0)``, in ``dtype`` (bf16 by default).  Clears
    ``Config.globalEvalMode``: training needs gradient buffers."""
    import torch

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.convert import paramsFromNumpy

    Config.globalEvalMode = False
    net = buildNet(**widths)
    np.random.seed(0)
    paramsFromNumpy(net, Zoo.heTable(net))
    net.calcMode(torch.bfloat16 if dtype is None else dtype)
    return net


def data(count, seed=1, shape=SHAPE, classes=CLASSES):
    """``count`` seeded f32 clips of ``shape`` and their int32 labels
    (``alexnetslice.data``)."""
    return Alex.data(count, seed, shape, classes)


def buildRun(net=None, dtype=None, batch=BATCH, learnRate=None):
    """``alexnetslice.buildRun`` of ``net`` (default ``build(dtype)``) at
    ``LEARN_RATE`` and C3D's classes."""
    net = build(dtype) if net is None else net
    return Alex.buildRun(net, batch=batch, learnRate=LEARN_RATE if learnRate is None else learnRate,
                         classes=CLASSES)


def main(argv=None):
    """Train ``STEPS`` steps of ``BATCH`` at each rate of ``--rates`` on the
    hand and the library route, from the same start, and print each run's
    losses; returns {rate: {route: losses}}."""
    import torch

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.tools.timing import cardName

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--rates", type=float, nargs="+", default=[LEARN_RATE])
    args = parser.parse_args(argv)

    if Config.device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: the C3D slice needs an NVIDIA GPU")
        print(cardName())
        Config.device = "cuda"

    return Alex.rates(buildRun(), *data(BATCH * STEPS), args.rates)


if __name__ == "__main__":
    main()
