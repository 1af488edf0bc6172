"""The AlexNet slice, as ``chip_smoke.py`` and the tests run it.

AlexNet (Krizhevsky, Sutskever and Hinton, NIPS 2012) as Caffe's
``bvlc_alexnet`` lays it out, at full width, built here from the port's
modules (the zoo has no loader for it):

- conv1: 96 maps, 11 x 11 at stride 4, relu, ``CrossMapLRN(N=5, alpha=1e-4,
  beta=0.75, K=1.0)``, ``MaxPool2D(3, 2)``;
- conv2: 256 maps, 5 x 5, pad 2, two groups, relu, LRN, pool;
- conv3: 384 maps, 3 x 3, pad 1, relu; conv4: 384 maps, two groups, relu;
  conv5: 256 maps, two groups, relu, pool;
- fc6 9216 -> 4096 and fc7 4096 -> 4096, each with a relu and
  ``Dropout(0.5)``, then fc8 4096 -> 1000.

60,965,224 parameters (``buildNet().numOfParams()``).  Input: 3 x 227 x 227
at batch 128 (the paper's batch), in f32: the LRN modules take f32 only,
in the JAX package and here, so the net runs in f32.  Its three Linears'
forward products go to K1 (``gemmF32``); its convs go to cuDNN (K2 takes
bf16 only), TF32 off.

Weights come from ``np.random.seed(0)``: He-scaled normals for every
weight and zero biases (``zooslice.heTable``).  The repo holds no ImageNet
file: ``data`` seeds images whose labels are read off them (``segslice``'s
way, a whole image a block).  Training: ``CrossEntropy`` and
``MomentumSGD(LEARN_RATE, 0.9)`` in global state.  From 1e-2 down to 1e-4
every step's loss fell on the hand and the library route on an H100, but
the two routes' losses part as the rate grows (K1's f32 rounding against
cuBLAS's, carried through 4 steps): 4th-step losses 1.2e-3 apart at 1e-2,
5.7e-5 at 3e-4, 1.6e-5 at 1e-4, so the slice trains at 1e-4, well inside
the f32 gate of 1e-4 (``python3 -m puzzlelib_tpu_torch.tools.alexnetslice
--rates ...`` trains 4 steps at each rate on both routes and prints the
losses).  A ``resnetslice.Run`` restarts
every ``train`` from the same weights, zero momentum and the dropout draws'
seed, on the route ``algo`` names: "hopper" (K1), "torch" (cuBLAS) or
"fused" (``FusedTrainer``, ``FusedValidator`` and ``FusedCalculator`` on
K1).  The device is the caller's ``Config.device``.
"""

import argparse

import numpy as np

from puzzlelib_tpu_torch.tools import resnetslice as Res
from puzzlelib_tpu_torch.tools import zooslice as Zoo


BATCH = 128
STEPS = 4
SHAPE = (3, 227, 227)
CLASSES = 1000
LEARN_RATE, MOM_RATE = 1e-4, 0.9
LRN = dict(N=5, alpha=1e-4, beta=0.75, K=1.0)

# (name, maps, size, stride, pad, groups, LRN, pool) a conv
CONVS = (("conv1", 96, 11, 4, 0, 1, True, True), ("conv2", 256, 5, 1, 2, 2, True, True),
         ("conv3", 384, 3, 1, 1, 1, False, False), ("conv4", 384, 3, 1, 1, 2, False, False),
         ("conv5", 256, 3, 1, 1, 2, False, True))
FCS = (4096, 4096)


def buildNet(maps=None, fcs=FCS, classes=CLASSES, shape=SHAPE, modules=None, containers=None):
    """AlexNet with conv widths ``maps`` (CONVS' by default) and fc widths
    ``fcs`` to ``classes`` scores, for inputs of ``shape``, from ``modules``
    and ``containers`` (the port's by default; the tests pass the JAX
    package's), its weights unset ("none")."""
    if modules is None:
        from puzzlelib_tpu_torch import containers, modules

    M = modules
    net = containers.Sequential(name="AlexNet")

    width = shape[0]
    for (name, outmaps, size, stride, pad, groups, lrn, pool), narrow in zip(CONVS, maps or [c[1] for c in CONVS]):
        net.append(M.Conv2D(width, narrow, size, stride=stride, pad=pad, groups=groups, initscheme="none",
                            name=name))
        net.append(M.Activation(M.relu, name="relu" + name[-1]))
        if lrn:
            net.append(M.CrossMapLRN(name="norm" + name[-1], **LRN))
        if pool:
            net.append(M.MaxPool2D(3, 2, name="pool" + name[-1]))
        width = narrow

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
    """AlexNet (``buildNet(**widths)``) with ``zooslice.heTable``'s weights
    from ``np.random.seed(0)``, in ``dtype`` (f32 by default).  Clears
    ``Config.globalEvalMode``: training needs gradient buffers."""
    import torch

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.convert import paramsFromNumpy

    Config.globalEvalMode = False
    net = buildNet(**widths)
    np.random.seed(0)
    paramsFromNumpy(net, Zoo.heTable(net))
    net.calcMode(torch.float32 if dtype is None else dtype)
    return net


def data(count, seed=1, shape=SHAPE, classes=CLASSES):
    """``count`` seeded f32 images of ``shape`` and their int32 labels: each
    image is twice a seeded colour plus unit noise a pixel, its colour its
    class's seeded colour plus a small seeded shift, and its label the class
    whose colour lies nearest, read off the image's colour."""
    rng = np.random.RandomState(seed)
    centroids = rng.randn(classes, shape[0])
    colours = centroids[rng.randint(0, classes, size=count)] + 0.05 * rng.randn(count, shape[0])
    labels = np.argmin(((colours[:, None, :] - centroids) ** 2).sum(axis=-1), axis=-1).astype(np.int32)

    images = rng.randn(count, *shape).astype(np.float32)
    images += (2 * colours).astype(np.float32).reshape((count, shape[0]) + (1, ) * (len(shape) - 1))
    return images, labels


def buildRun(net=None, dtype=None, batch=BATCH, learnRate=None, classes=CLASSES):
    """A ``resnetslice.Run`` of ``net`` (default ``build(dtype)``; a given net
    is in its type already) with ``MomentumSGD(learnRate, 0.9)``
    (``LEARN_RATE`` by default) in global state and ``CrossEntropy``."""
    from puzzlelib_tpu_torch.cost import CrossEntropy
    from puzzlelib_tpu_torch.optimizers import MomentumSGD

    net = build(dtype) if net is None else net
    optimizer = MomentumSGD(LEARN_RATE if learnRate is None else learnRate, momRate=MOM_RATE)
    optimizer.setupOn(net, useGlobalState=True)
    return Res.Run(net, optimizer, CrossEntropy(maxlabels=classes), batch)


def linearLaunches(net, batch, sms=132):
    """{name: (K1 launches, of them on wgmma)} of one forward of ``batch``
    rows through each Linear of ``net``, as ``matmul._route`` sends its
    product on a card of ``sms`` SMs (the backward's products are
    transposed and go to the library)."""
    from puzzlelib_tpu_torch.modules import Linear
    from puzzlelib_tpu_torch.ops.hopper import matmul

    launches = {}
    for mod in net.modules():
        if isinstance(mod, Linear):
            k, n = mod.W.shape
            path = matmul._route(batch, n, k, mod.W.dtype, True, sms)
            launches[mod.name] = (1, int(path.startswith("wgmma")))

    return launches


def rates(run, images, labels, learnRates):
    """{rate: {algo: losses}} of ``run`` trained from its start on the hand
    and the library route at each of ``learnRates``, printed."""
    seen = {}
    for rate in learnRates:
        run.optimizer.learnRate = rate
        for algo in ("hopper", "torch"):
            losses = seen.setdefault(rate, {}).setdefault(algo, [])
            run.train(algo, images, labels, losses)
            print("%s, rate %g, %s route: losses %s, falling %s" %
                  (run.net.name, rate, algo, " ".join("%.6f" % loss for loss in losses),
                   all(b < a for a, b in zip(losses, losses[1:]))))

    return seen


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
            raise SystemExit("no CUDA device: the AlexNet slice needs an NVIDIA GPU")
        print(cardName())
        Config.device = "cuda"

    return rates(buildRun(), *data(BATCH * STEPS), args.rates)


if __name__ == "__main__":
    main()
