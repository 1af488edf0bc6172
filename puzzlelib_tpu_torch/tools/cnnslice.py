"""The CNN training slices, as ``chip_smoke.py`` and the tests run them.

Three nets, each trained through ``Trainer.trainFromHost`` with
``CrossEntropy`` and ``MomentumSGD`` in global state and validated through
``Validator.validateFromHost``, on seeded data of the datasets' shapes (the
repo holds no MNIST or CIFAR-10 file):

- LeNet (``models/nets/lenet.py``), as the JAX package's ``bench.py`` trains
  it: f32 (also bf16), batch 128, ``MomentumSGD(0.01, 0.9)``, images (1,
  28, 28) with 10 labels.  K1 runs both ``Linear``s forward.
- The CIFAR-10 Network-in-Network of ``testlib/cnncifar10nin.py``: this
  module's copy of its block table (``NIN_BLOCKS``) and ``buildNet``, f32,
  batch 128, ``MomentumSGD(0.01, 0.9)`` with ``hooks.WeightDecay(1e-4)`` as
  its ``main`` adds it, images (3, 32, 32) with 10 labels.  Its dropout
  draws come from ``rng.globalRng``, seeded again at each run's start.
- The ImageNet NiN (``models/nets/nin.py``, 224 x 224 x 3, 1000 classes)
  without its SoftMax, bf16, batch 128, ``MomentumSGD(1e-4, 0.9)``.  K2
  runs conv3 and conv4-1024 forward, and in training K2 as bwd-data and K3
  on both.

Weights come from ``np.random.seed(0)``: LeNet's from the default scheme
(``initscheme=None``, as ``testlib/cnnmnistlenet.py`` builds it), the
CIFAR-10 NIN's from its script's Gaussian of 0.05, the ImageNet NiN's He.
A ``Run`` holds one net, its optimizer, trainer and validator, and the
start values of the optimizer's flat buffers: every ``train`` starts from
the same weights, a zero momentum and the same dropout draws, on the route
that ``algo`` names (``Config.gemmAlgo`` / ``Config.convAlgo``: "hopper",
the hand kernels, "torch", the library, or "auto", the routes that
``optimizeForShape`` measured), or on route "fused": the hand kernels
through the run's ``FusedTrainer`` and ``FusedValidator``, as
``testlib/digitsnin.py`` trains and validates ("fused-auto": the measured
routes through them).  The device is the caller's
``Config.device``.
"""

import time

import numpy as np

from puzzlelib_tpu_torch.modules import AvgPool2D, MaxPool2D


BATCH = 128
STEPS = 8
VALIDATION = 1024
LEARN_RATE, MOM_RATE = 0.01, 0.9
WEIGHT_DECAY = 1e-4
NIN_LEARN_RATE = 1e-4
DROPOUT_SEED = 7

# the CIFAR-10 NIN of testlib/cnncifar10nin.py: per block, its convs
# (inmaps, outmaps, size, pad), its pool (class, size, stride, pad) and its
# dropout's name
NIN_BLOCKS = [
    {"idx": 1, "convs": [(3, 192, 5, 2), (192, 160, 1, 0), (160, 96, 1, 0)],
     "pool": (MaxPool2D, 3, 2, 1), "dropout": "drop3"},
    {"idx": 2, "convs": [(96, 192, 5, 2), (192, 192, 1, 0), (192, 192, 1, 0)],
     "pool": (AvgPool2D, 3, 2, 1), "dropout": "drop6"},
    {"idx": 3, "convs": [(192, 192, 3, 1), (192, 192, 1, 0), (192, 10, 1, 0)],
     "pool": (AvgPool2D, 8, 1, 0), "dropout": None},
]

SHAPES = {"lenet": (1, 28, 28), "nin-cifar": (3, 32, 32), "nin": (3, 224, 224)}
CLASSES = {"lenet": 10, "nin-cifar": 10, "nin": 1000}

# the two convs of the ImageNet NiN that K2 and K3 take: (name, x shape at
# batch 1, output maps)
NIN_KERNEL_CONVS = [("conv3", (256, 12, 12), 384), ("conv4-1024", (384, 5, 5), 1024)]


def buildNet(blocks=NIN_BLOCKS):
    """The CIFAR-10 NIN of ``blocks``, as ``testlib/cnncifar10nin.py``
    builds it, with its convs and relus named as there."""
    from puzzlelib_tpu_torch.containers import Sequential
    from puzzlelib_tpu_torch.modules import Activation, Conv2D, Dropout, Flatten, relu

    seq = Sequential(name="cifar")
    cccp = 0

    for block in blocks:
        for k, (inmaps, outmaps, size, pad) in enumerate(block["convs"]):
            if k == 0:
                convName, reluName = "conv%d" % block["idx"], "relu%d" % block["idx"]
            else:
                cccp += 1
                convName, reluName = "cccp%d" % cccp, "relu_cccp%d" % cccp

            seq.append(Conv2D(inmaps, outmaps, size, pad=pad, initscheme="gaussian", wscale=0.05, name=convName))
            seq.append(Activation(relu, name=reluName))

        poolCls, size, stride, pad = block["pool"]
        seq.append(poolCls(size, stride, pad=pad, name="pool%d" % block["idx"]))

        if block["dropout"]:
            seq.append(Dropout(name=block["dropout"]))

    seq.append(Flatten())
    return seq


def data(kind, count, seed=1):
    """``count`` seeded f32 images of ``kind``'s shape and int32 labels."""
    rng = np.random.RandomState(seed)
    images = rng.randn(count, *SHAPES[kind]).astype(np.float32)
    return images, rng.randint(0, CLASSES[kind], size=count).astype(np.int32)


def build(kind):
    """``kind``'s net, weights from ``np.random.seed(0)`` (the ImageNet NiN
    with its SoftMax)."""
    from puzzlelib_tpu_torch.models.nets import loadLeNet, loadNiNImageNet

    np.random.seed(0)
    if kind == "lenet":
        return loadLeNet(None, initscheme=None)

    if kind == "nin":
        return loadNiNImageNet(None, initscheme="he")

    return buildNet()


class Run:
    """One net with its optimizer, trainer and validator, and the start
    values of the optimizer's flat parameter buffers (of each variable under
    local state) and of the modules' attributes (a batch norm's running
    stats)."""

    def __init__(self, net, optimizer, cost, batch):
        from puzzlelib_tpu_torch.fused import FusedTrainer, FusedValidator
        from puzzlelib_tpu_torch.handlers import Trainer, Validator

        self.net, self.optimizer, self.cost = net, optimizer, cost
        self.trainer = Trainer(net, cost, optimizer, batchsize=batch)
        self.validator = Validator(net, cost, batchsize=batch)
        self.fusedTrainer = FusedTrainer(net, cost, optimizer, batchsize=batch)
        self.fusedValidator = FusedValidator(net, cost, batchsize=batch)
        self.start = {dtype: pack.ary.clone() for dtype, pack in optimizer.shParams.items()}
        self.startVars = [] if optimizer.globalState else [(var.data, var.data.clone()) for var in net.getVarTable()]
        self.startAttrs = {name: attr.clone() for name, attr in net.getAttrTable().items()}
        self.startStates = _stateValues(optimizer)

    def restore(self):
        """The start weights and attributes, the optimizer's start state
        (zero moments; SMORMS3's memory of ones) and a zero step count (the
        batch norms' counts of train forwards too), and the dropout draws
        from their start."""
        from puzzlelib_tpu_torch.rng import globalRng

        for dtype, pack in self.optimizer.shParams.items():
            pack.ary.copy_(self.start[dtype])

        for data, value in self.startVars:
            data.copy_(value)

        for name, attr in self.net.getAttrTable().items():
            attr.copy_(self.startAttrs[name])

        for mod in self.net.modules():
            if hasattr(mod, "numOfProps"):
                mod.numOfProps = 0

        for tensor, value in self.startStates:
            tensor.copy_(value)

        self.optimizer.t = 0
        globalRng.seed(DROPOUT_SEED)

    def train(self, algo, images, labels, losses=None):
        """One timed ``trainFromHost`` of all the images on a route from the
        start, shuffled by one numpy seed: seconds, host clock around work
        that ends in a device synchronize.  Each step's loss is appended to
        ``losses`` when it is given."""
        from puzzlelib_tpu_torch.backend.device import synchronize

        trainer = self.fusedTrainer if _route(algo) else self.trainer
        self.restore()
        trainer.onBatchFinish = None if losses is None else (lambda h: losses.append(h.cost.getError()))

        np.random.seed(4)
        synchronize()
        start = time.perf_counter()
        trainer.trainFromHost(images, labels, macroBatchSize=len(images))
        synchronize()
        return time.perf_counter() - start

    def validate(self, algo, images, labels):
        """One timed ``validateFromHost`` on a route from the weights the net
        holds: (error, seconds)."""
        from puzzlelib_tpu_torch.backend.device import synchronize

        validator = self.fusedValidator if _route(algo) else self.validator
        synchronize()
        start = time.perf_counter()
        error = validator.validateFromHost(images, labels, macroBatchSize=len(images))
        return error, time.perf_counter() - start


def _stateValues(optimizer):
    """[(state tensor, a copy of its value)] of every state of
    ``optimizer``."""
    return [(tensor, tensor.clone()) for state in optimizer.states.values() for tensor in state.values()]


def _route(algo):
    """Set the kernels of ``algo`` ("fused" takes the hand kernels,
    "fused-auto" the measured routes of "auto"); True for the fused
    routes."""
    from puzzlelib_tpu_torch import config as Config

    fused = algo in ("fused", "fused-auto")
    Config.gemmAlgo = Config.convAlgo = {"fused": "hopper", "fused-auto": "auto"}.get(algo, algo)
    return fused


def buildRun(kind, dtype=None, batch=BATCH, net=None):
    """A ``Run`` of ``kind`` ("lenet", "nin-cifar" or "nin") in ``dtype``
    (f32 by default, bf16 for "nin"), from ``net`` or ``build(kind)``.
    Clears ``Config.globalEvalMode``: training needs gradient buffers."""
    import torch

    from puzzlelib_tpu_torch import config as Config
    from puzzlelib_tpu_torch.cost import CrossEntropy
    from puzzlelib_tpu_torch.modules import SoftMax
    from puzzlelib_tpu_torch.optimizers import MomentumSGD
    from puzzlelib_tpu_torch.optimizers.hooks import WeightDecay

    Config.globalEvalMode = False
    net = build(kind) if net is None else net

    if isinstance(net.graph[-1], SoftMax):
        net.pop()   # CrossEntropy takes the raw scores

    net.calcMode(dtype or (torch.bfloat16 if kind == "nin" else torch.float32))

    optimizer = MomentumSGD(NIN_LEARN_RATE if kind == "nin" else LEARN_RATE, momRate=MOM_RATE)
    if kind == "nin-cifar":
        optimizer.addHook(WeightDecay(WEIGHT_DECAY))

    optimizer.setupOn(net, useGlobalState=True)
    return Run(net, optimizer, CrossEntropy(maxlabels=CLASSES[kind]), batch)
