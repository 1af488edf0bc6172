"""The ResNet-50 slice, as ``chip_smoke.py`` and the tests run it.

ResNet-50 (``models/nets/resnet.py``) at full width, 224 x 224 x 3 in and
1000 classes, without its SoftMax, in bf16 at batch 32: trained through
``Trainer.trainFromHost`` with ``CrossEntropy`` and ``MomentumSGD(0.01,
0.9)`` in global state, validated through ``Validator.validateFromHost``
and served through ``Calculator.calcFromHost``, on seeded images of
ImageNet's shape (the repo holds no ImageNet file).  The batch norms' scales,
biases and running stats stay f32, in the optimizer's f32 flat buffer beside
the bf16 one.

On the card K2 takes the forward, K2 the bwd-data and K3 the bwd-filter of
the 3x3 convs whose channels are multiples of 128 (``winograd.applicable``):
conv3_x, conv4_x and conv5_x, 13 of the 16 (``winogradConvs`` counts them
from the net), and K1 ``fc1000``.  The 7x7 conv1, the 1x1 convs and
conv2_x's 64-channel 3x3 convs go to cuDNN, as ``lax.conv_general_dilated``
goes to XLA in the JAX package.

Weights come from ``np.random.seed(0)`` and the He scheme; "none" leaves
them unset, which suits timing only.  A ``Run`` (``tools/cnnslice.py``'s,
with a ``Calculator`` and a ``FusedCalculator``) restarts every ``train``
from the same weights, running stats and zero momentum, on the route that
``algo`` names: "hopper" (the hand kernels), "torch" (``Config.convAlgo`` /
``gemmAlgo`` set to the library) or "fused" (``FusedTrainer``,
``FusedValidator`` and ``FusedCalculator`` on the hand kernels).  The device
is the caller's ``Config.device``.
"""

import time

import numpy as np

from puzzlelib_tpu_torch.tools import cnnslice as Cnn


BATCH = 32
STEPS = 12
LEARN_RATE, MOM_RATE = 0.01, 0.9
SHAPE = (3, 224, 224)
CLASSES = 1000

# ResNet-50's three 3x3 conv shapes that K2 and K3 take: (stage, x shape at
# batch 1, output maps)
KERNEL_CONVS = [("conv3_x", (128, 28, 28), 128), ("conv4_x", (256, 14, 14), 256), ("conv5_x", (512, 7, 7), 512)]


def data(count, seed=1, shape=SHAPE, classes=CLASSES):
    """``count`` seeded f32 images of ``shape`` and int32 labels."""
    rng = np.random.RandomState(seed)
    images = rng.randn(count, *shape).astype(np.float32)
    return images, rng.randint(0, classes, size=count).astype(np.int32)


def build(initscheme="he"):
    """ResNet-50 with its SoftMax, weights from ``np.random.seed(0)``."""
    from puzzlelib_tpu_torch.models.nets import loadResNet

    np.random.seed(0)
    return loadResNet(None, "50", initscheme=initscheme)


def convInputs(net, inshape):
    """[(conv, input shape)] of every conv of ``net`` for an input of
    ``inshape``, in the order the forward runs them."""
    from puzzlelib_tpu_torch.containers import Parallel, Sequential
    from puzzlelib_tpu_torch.modules import ConvND

    found = []

    def walk(mod, shape):
        if isinstance(mod, Parallel):
            for branch, branchShape in zip(mod.graph, shape):
                walk(branch, branchShape)

        elif isinstance(mod, Sequential):
            for child in mod.graph:
                shape = walk(child, shape)
            return shape

        elif isinstance(mod, ConvND):
            found.append((mod, tuple(shape)))

        return mod.dataShapeFrom(shape)

    walk(net, tuple(inshape))
    return found


def winogradConvs(net, inshape):
    """The names of the convs of ``net`` that K2 and K3 take for an input of
    ``inshape`` (``winograd.applicable``)."""
    from puzzlelib_tpu_torch.ops.hopper import winograd

    return [conv.name for conv, shape in convInputs(net, inshape)
            if winograd.applicable(shape, tuple(conv.W.shape), conv.stride, conv.pad, conv.dilation, conv.groups)]


class Served:
    """A ``Calculator`` and a ``FusedCalculator`` of ``served``."""

    def __init__(self, served, batch):
        from puzzlelib_tpu_torch.fused import FusedCalculator
        from puzzlelib_tpu_torch.handlers import Calculator

        self.calculator = Calculator(served, batchsize=batch)
        self.fusedCalculator = FusedCalculator(served, batchsize=batch)

    def serve(self, algo, images):
        """One timed ``calcFromHost`` of the images on a route from the
        weights and running stats the net holds: (logits, seconds)."""
        from puzzlelib_tpu_torch.backend.device import synchronize

        calculator = self.fusedCalculator if Cnn._route(algo) else self.calculator
        synchronize()
        start = time.perf_counter()
        out = calculator.calcFromHost(images, macroBatchSize=len(images))
        synchronize()
        return out, time.perf_counter() - start


class Run(Cnn.Run, Served):
    """``cnnslice.Run`` with ``Served``'s calculators of ``served`` (the
    trained net by default)."""

    def __init__(self, net, optimizer, cost, batch, served=None):
        Cnn.Run.__init__(self, net, optimizer, cost, batch)
        Served.__init__(self, net if served is None else served, batch)


def buildRun(net=None, dtype=None, batch=BATCH, classes=CLASSES):
    """A ``Run`` of ``net`` (default ``build()``), its SoftMax popped, in
    ``dtype`` (bf16 by default), with ``MomentumSGD(0.01, 0.9)`` in global
    state and ``CrossEntropy``.  Clears ``Config.globalEvalMode``: training
    needs gradient buffers."""
    import torch

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.cost import CrossEntropy
    from puzzlelib_tpu_torch.modules import SoftMax
    from puzzlelib_tpu_torch.optimizers import MomentumSGD

    Config.globalEvalMode = False
    net = build() if net is None else net

    if isinstance(net.graph[-1], SoftMax):
        net.pop()   # CrossEntropy takes the raw scores

    net.calcMode(torch.bfloat16 if dtype is None else dtype)

    optimizer = MomentumSGD(LEARN_RATE, momRate=MOM_RATE)
    optimizer.setupOn(net, useGlobalState=True)
    return Run(net, optimizer, CrossEntropy(maxlabels=classes), batch)
