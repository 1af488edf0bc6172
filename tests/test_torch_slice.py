"""The serving slice as a whole: a VGG-shaped net through both packages'
``Calculator.calcFromHost``, VGG-16's structure in both, and the port's
independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import paramsFromNumpy
from puzzlelib_tpu_torch.handlers import Calculator as TCalculator
from puzzlelib_tpu_torch.models.nets import loadVGG as tLoadVGG


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax():
    """The JAX package's modules, containers and handlers, for the twin tests.
    They skip where the JAX package does not import, as on the card's
    machine, where only the CUDA case runs."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import containers, handlers, modules

    return modules, containers, handlers


def _narrowVGG(M, C, initscheme, widths=(8, 16)):
    """Conv 3x3 pad 1 -> relu -> max-pool stages, then Flatten -> Linear ->
    SoftMax, at VGG's layout and names but narrow."""
    net = C.Sequential(name="narrow")

    inmaps = 3
    for stage, maps in enumerate(widths, start=1):
        for i in (1, 2):
            net.append(M.Conv2D(inmaps, maps, 3, pad=1, initscheme=initscheme, name="conv%d_%d" % (stage, i)))
            net.append(M.Activation(M.relu, name="relu%d_%d" % (stage, i)))
            inmaps = maps

        net.append(M.MaxPool2D(2, 2, name="pool%d" % stage))

    net.append(M.Flatten())
    net.append(M.Linear(widths[-1] * 4 * 4, 10, initscheme=initscheme, name="fc"))
    net.append(M.SoftMax())
    return net


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card, for every test
    of this file (the card-only ones set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def testNarrowVGGThroughCalculatorTwin(onCpu):
    """6 images at batch size 4 (the last batch partial), weights carried from
    the JAX net by ``paramsFromNumpy``, f32 within 1e-4 of max|ref| (the
    BASELINE whole-net tolerance of tests/torchoracle.py)."""
    J, JC, JH = _jax()
    np.random.seed(0)
    jnet = _narrowVGG(J, JC, "he")

    rng = np.random.RandomState(1)
    table = {}
    for var, names in jnet.getVarTable().items():
        ary = var.data.get()
        if names[0].endswith(".b"):
            ary = (rng.randn(*ary.shape) * 0.1).astype(np.float32)
            var.data.set(ary)
        table.update({name: ary for name in names})

    tnet = _narrowVGG(T, TC, "none")
    paramsFromNumpy(tnet, table)

    x = rng.randn(6, 3, 16, 16).astype(np.float32)
    want = JH.Calculator(jnet, batchsize=4).calcFromHost(x)
    got = TCalculator(tnet, batchsize=4).calcFromHost(x)

    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == want.shape == (6, 10)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert tnet.data is None and not tnet.training   # the handler reset the net after each batch


def testCalculatorBf16ReturnsFloat32(onCpu):
    """A bf16 net takes float32 host data and returns float32 host arrays."""
    np.random.seed(2)
    net = _narrowVGG(T, TC, "he")
    x = np.random.RandomState(3).randn(5, 3, 16, 16).astype(np.float32)

    want = TCalculator(net, batchsize=2).calcFromHost(x)
    net.calcMode(torch.bfloat16)
    got = TCalculator(net, batchsize=2).calcFromHost(x)

    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()

    dev = TCalculator(net, batchsize=2).calc(torch.from_numpy(x).to(torch.bfloat16))
    assert dev.dtype == torch.bfloat16 and tuple(dev.shape) == (5, 10)


def testVGG16StructureTwin(monkeypatch, onCpu):
    """Same layer names, variable names and shapes, and the same
    ``dataShapeFrom`` chain from (1, 3, 224, 224) in both packages."""
    _jax()
    from puzzlelib_tpu import config as JConfig
    from puzzlelib_tpu.models.nets.vgg import loadVGG as jLoadVGG

    monkeypatch.setattr(JConfig, "globalEvalMode", True)
    monkeypatch.setattr(TConfig, "globalEvalMode", True)

    jnet = jLoadVGG(None, "16", initscheme="none")
    tnet = tLoadVGG(None, "16", initscheme="none")

    assert [m.name for m in tnet.graph] == [m.name for m in jnet.graph]
    assert [type(m).__name__ for m in tnet.graph] == [type(m).__name__ for m in jnet.graph]

    jvars = {name: tuple(var.data.shape) for var, names in jnet.getVarTable().items() for name in names}
    tvars = {name: tuple(var.data.shape) for var, names in tnet.getVarTable().items() for name in names}
    assert tvars == jvars and len(tvars) == 32

    shape = (1, 3, 224, 224)
    for jmod, tmod in zip(jnet.graph, tnet.graph):
        assert tuple(tmod.dataShapeFrom(shape)) == tuple(jmod.dataShapeFrom(shape))
        shape = jmod.dataShapeFrom(shape)

    assert shape == (1, 1000) and tnet.numOfParams() == jnet.numOfParams() == 138357544


_NO_JAX = """
import sys
import tempfile
import numpy as np
import torch
from puzzlelib_tpu_torch import checkinstall
from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.containers import Sequential
from puzzlelib_tpu_torch.converter.engine import DataCalibrator, buildEngine
from puzzlelib_tpu_torch.handlers import Calculator
from puzzlelib_tpu_torch.models.nets import buildTransformerClassifier, loadVGG
from puzzlelib_tpu_torch import modules as T

Config.device = "cpu"
np.random.seed(0)
net = Sequential()
net.append(T.Conv2D(3, 8, 3, pad=1, initscheme="he", name="conv1_1"))
net.append(T.Activation(T.relu, name="relu1_1"))
net.append(T.MaxPool2D(name="pool1"))
net.append(T.Flatten())
net.append(T.Linear(8 * 4 * 4, 10, initscheme="he", name="fc"))
net.append(T.SoftMax())
net.calcMode(torch.bfloat16)
out = Calculator(net, batchsize=2).calcFromHost(np.random.randn(3, 3, 8, 8).astype(np.float32))
assert out.shape == (3, 10)
loadVGG(None, "11", withLinear=False)
tnet = buildTransformerClassifier(50, 16, 32, nheads=2, nlayers=1, nclasses=3, attnAlgo="flash")
tnet.calcMode(torch.bfloat16)
logits = Calculator(tnet, batchsize=4).calcFromHost(np.random.randint(-1, 50, size=(6, 16)).astype(np.int32))
assert logits.shape == (6, 3) and np.isfinite(logits).all()
qnet = Sequential(name="q")
qnet.append(T.Conv2D(3, 8, 3, pad=1, initscheme="he"))
qnet.append(T.Activation(T.relu))
qnet.append(T.Flatten())
qnet.append(T.Linear(8 * 8 * 8, 4, initscheme="he"))
calib = np.random.randn(8, 3, 8, 8).astype(np.float32)
with tempfile.TemporaryDirectory() as tmp:
    engine = buildEngine(qnet, (4, 3, 8, 8), tmp, dtype="int8", calibrator=DataCalibrator(calib, batchsize=4))
    served = Calculator(engine, batchsize=4).calcFromHost(calib)
assert served.shape == (8, 4) and np.isfinite(served).all()
checkinstall.main()
from puzzlelib_tpu_torch import profiler
from puzzlelib_tpu_torch.backend.dnn import convNdbenchmark
from puzzlelib_tpu_torch.benchmarks import attnspeed, convspeed, gemmspeed
from puzzlelib_tpu_torch.ops.hopper import phasesplit, streamcopy, tapdot
from puzzlelib_tpu_torch.tools import roofline_probe, strided_dma_probe, tapdot_probe
assert torch.equal(streamcopy.addOne(torch.zeros(4, dtype=torch.bfloat16)), torch.ones(4, dtype=torch.bfloat16))
x6 = torch.arange(2 * 4 * 2 * 3 * 2 * 16, dtype=torch.float32).reshape(2, 4, 2, 3, 2, 16)
assert phasesplit.phaseSplit(x6, 2, 3, 16, 2).shape == (2, 4, 2, 3, 16)
assert tapdot.conv2d(torch.randn(1, 16, 6, 5), torch.randn(16, 16, 3, 3), (1, 1)).shape == (1, 16, 6, 5)
profiler.startTraceMalloc()
assert convNdbenchmark((1, 4, 6, 6), (4, 4, 3, 3), (1, 1), (1, 1), (1, 1), 1)[0][0].time > 0
profiler.stopTraceMalloc()
from puzzlelib_tpu_torch import rng
from puzzlelib_tpu_torch.cost import CrossEntropy
from puzzlelib_tpu_torch.handlers import Trainer, Validator
from puzzlelib_tpu_torch.models.nets import loadLeNet, loadNiNImageNet
from puzzlelib_tpu_torch.optimizers import MomentumSGD, hooks
from puzzlelib_tpu_torch.tools import cnnslice
rng.globalRng.seed(1)
lenet = loadLeNet(None, initscheme=None)
opt = MomentumSGD(0.01, momRate=0.9)
opt.addHook(hooks.WeightDecay(1e-4))
opt.addHook(hooks.GradClip(1.0))
opt.setupOn(lenet, useGlobalState=True)
digits = np.random.randn(8, 1, 28, 28).astype(np.float32)
digitLabels = np.random.randint(0, 10, size=8).astype(np.int32)
Trainer(lenet, CrossEntropy(maxlabels=10), opt, batchsize=4).trainFromHost(digits, digitLabels)
assert 0.0 <= Validator(lenet, CrossEntropy(), batchsize=4).validateFromHost(digits, digitLabels) <= 1.0
from puzzlelib_tpu_torch import fused, fusedctx
fusedCost = fused.FusedStep(lenet, CrossEntropy(maxlabels=10), opt)(torch.from_numpy(digits[:4]),
                                                                   torch.from_numpy(digitLabels[:4]))
assert np.isfinite(fusedCost.getError()) and not fusedctx.active()
drop = Sequential(name="drop")
drop.append(T.Conv2D(3, 4, 3, pad=1, initscheme="he"))
drop.append(T.Dropout(0.5))
drop.append(T.AvgPool2D(3, 2, pad=1))
drop.append(T.Dropout2D(0.5))
dropped = drop(torch.randn(2, 3, 8, 8))
drop.backward(torch.ones_like(dropped))
assert dropped.shape == (2, 4, 4, 4)
nin = loadNiNImageNet(None, poolmode="avg", initscheme="he")
assert nin(torch.randn(1, 3, 224, 224)).shape == (1, 1000)
cifar = cnnslice.buildRun("nin-cifar", batch=4)
cifar.train("hopper", *cnnslice.data("nin-cifar", 4))
from puzzlelib_tpu_torch.benchmarks import netspeed
from puzzlelib_tpu_torch.containers import Parallel
from puzzlelib_tpu_torch.convert import attrsFromNumpy, attrsToNumpy
from puzzlelib_tpu_torch.models.nets import loadResNet, residBlock
from puzzlelib_tpu_torch.ops import norm
from puzzlelib_tpu_torch.tools import profileresnet, resnetslice
block = Sequential(name="block")
block.extend(residBlock(8, 4, 1, "2a", True, False, False, "he"))
block.append(T.InstanceNorm2D(16))
block.append(T.Flatten())
block.append(T.BatchNorm(16 * 4 * 4))
blockOut = block(torch.randn(2, 8, 4, 4))
block.backward(torch.ones_like(blockOut))
attrsFromNumpy(block, attrsToNumpy(block))
assert isinstance(block[1], Parallel) and T.BatchNorm1D(3)(torch.randn(2, 3, 5)).shape == (2, 3, 5)
assert T.BatchNorm3D(3)(torch.randn(2, 3, 2, 2, 2)).shape == (2, 3, 2, 2, 2) and norm.MODE_SPATIAL == "spatial"
assert profileresnet.REQUESTS == 4
assert len(resnetslice.winogradConvs(loadResNet(None, "50"), (32, 3, 224, 224))) == 13
netspeed.main(["--net", "lenet", "--infer", "--iters", "1", "--batch", "2"])
from puzzlelib_tpu_torch.cost import BCE
from puzzlelib_tpu_torch.models.nets import loadInceptionBN, loadInceptionV3, loadUNet
from puzzlelib_tpu_torch.tools import inceptionslice, profileunet, unetslice
glue = Sequential(name="glue")
glue.append(T.Deconv2D(4, 6, 2, stride=2, useBias=False))
glue.append(T.Replicate(2))
fork = Sequential()
fork.append(T.Activation(T.leakyRelu, slc=slice(2, 50), args=(0.2, )))
fork.append(T.Replicate(2))
fork.append(Parallel().append(T.Activation(T.tanh)).append(T.Activation(T.elu)))
glue.append(Parallel().append(T.Activation(T.sigmoid)).append(fork))
glue.append(T.ToList())
glue.append(T.Concat(axis=1))
glue.append(T.Activation(T.clip, args=(-1.0, 1.0)))
glue.append(T.Activation(T.softPlus))
glue.append(T.Conv2D(18, 1, 1))
bceOpt = MomentumSGD(0.01, momRate=0.99)
bceOpt.setupOn(glue, useGlobalState=True)
Trainer(glue, BCE(), bceOpt, batchsize=2).trainFromHost(np.random.randn(4, 4, 3, 3).astype(np.float32),
                                                        np.random.randint(0, 2, size=(4, 6, 6)).astype(np.int32))
unet = loadUNet(None, initscheme="he")
assert unet(torch.randn(1, 1, 32, 32)).shape == (1, 1, 32, 32) and len(resnetslice.winogradConvs(unet, (unetslice.BATCH, ) + unetslice.SHAPE)) == 15
assert profileunet.Unet is unetslice
assert loadInceptionBN(None).dataShapeFrom((1, 3, 224, 224)) == (1, 1000)
assert loadInceptionV3(None).dataShapeFrom((1, 3, 299, 299)) == (1, 1008) and inceptionslice.BATCH == 32
from puzzlelib_tpu_torch.backend import memory
from puzzlelib_tpu_torch.converter.rnnweights import convertRnnWeights, cudnnRnnLayout
from puzzlelib_tpu_torch.cost import CTC, MSE
from puzzlelib_tpu_torch.models.nets import loadW2L
from puzzlelib_tpu_torch.models.nets.wavetoletter import convBlock
from puzzlelib_tpu_torch.tools import profilesequence, sequenceslice
assert profilesequence.ROUTES[0][0] == "hopper"
for kind, widths in (("bilstm", dict(numwords=30, maxlen=5)), ("cnn", dict(numwords=30, maxlen=6, embsize=4))):
    seqRun = sequenceslice.buildRun(kind, net=sequenceslice.build(kind, **widths), batch=2)
    seqRun.train("fused", *sequenceslice.data(kind, 4, **widths))
gru = Sequential(name="gru")
gru.append(T.SwapAxes(0, 1))
gru.append(T.RNN(3, 4, layers=2, mode="gru", dropout=0.5, getSequences=True))
gru.append(T.SwapAxes(0, 1))
gru.append(T.SwapAxes(2, 1))
gru.append(T.Pad1D(1))
gru.append(T.AvgPool1D(2, 1))
gru.append(T.Flatten())
rnnOpt = MomentumSGD(0.01, momRate=0.9)
rnnOpt.setupOn(gru, useGlobalState=True)
Trainer(gru, MSE(), rnnOpt, batchsize=2).trainFromHost(np.random.randn(4, 5, 3).astype(np.float32),
                                                       np.random.randn(4, 24).astype(np.float32))
_, wsize = cudnnRnnLayout("gru", 3, 4, 2)
assert convertRnnWeights(np.arange(wsize, dtype=np.float32), "gru", 3, 4, 2).shape == (wsize, )
w2l = Sequential(name="w2l")
w2l.extend(convBlock(5, 8, 11, 2, 5, 0.2, None, name="c0"))
w2l.extend(convBlock(8, 29, 1, 1, 0, 0.0, None, bnAct=False, name="c1"))
w2lRun = sequenceslice.W2LRun(w2l, batch=2)
w2lRun.train(*sequenceslice.w2lData(2, frames=40, inmaps=5, labelRange=(2, 4)))
assert memory.moveaxis(torch.zeros(2, 3, 4), 2, 0).shape == (4, 2, 3) and isinstance(w2lRun.cost, CTC)
assert loadW2L(None, 161, 29, initscheme="none").dataShapeFrom((1, 161, 200)) == (1, 29, 100)
from puzzlelib_tpu_torch import cost as zooCosts, optimizers as zooOpts, statistics
from puzzlelib_tpu_torch.backend.kernels import costs as costKernels
from puzzlelib_tpu_torch.datasets import utils as datasetUtils
from puzzlelib_tpu_torch.models.nets import loadCOCO, loadMiniYolo, loadMPI, loadSentiNet
from puzzlelib_tpu_torch.models.nets.presets import sentinet as sentiPreset
from puzzlelib_tpu_torch.tools import zooslice
assert loadMiniYolo(None, 1470).dataShapeFrom((1, 3, 448, 448)) == (1, 1470)
assert loadCOCO(None).dataShapeFrom((1, 3, 64, 64)) == (1, 57, 8, 8) and loadMPI(None).dataShapeFrom((1, 3, 64, 64)) == (1, 71, 8, 8)
senti = loadSentiNet(None, vocabulary=30, branches=[2, 3], sentlength=8, embsize=4, branchMaps=3)
sentiTokens, sentiLabels = zooslice.sentiData(40, vocab=30, length=4, padding=2, lexicon=(5, 2))
sentiPreset.train(senti, sentiTokens, sentiLabels, sentiTokens[:8], sentiLabels[:8], 2, epochs=1, saving=False, printing=False)
sentiRun = zooslice.SentiRun(senti, batch=8)
for name in zooslice.OPTIMIZERS:
    sentiRun.optimizer(name).train("fused", sentiTokens[:16], sentiLabels[:16])
assert 0.0 <= datasetUtils.validate(senti, sentiTokens, sentiLabels)[2] <= 1.0
assert statistics.accuracy([[1, 0], [0, 1]], log=False) == 1.0
scores, ints = torch.randn(6, 4), torch.randint(0, 4, (6, ), dtype=torch.int32)
for costName in ("Abs", "Hinge", "KLDivergence", "L1Hinge", "Multi", "SmoothL1", "SVM"):
    assert hasattr(zooCosts, costName)
assert zooCosts.SVM(mode="l2")(scores, ints)[1].shape == (6, 4) and costKernels.getAccuracyKernel("calcAccuracy")(ints, ints) == 0
assert len(zooCosts.Multi().append(zooCosts.Abs()).append(zooCosts.SVM())([scores, scores], [scores, ints])[0]) == 2
from puzzlelib_tpu_torch.tools import layerslice, segslice
for layerName in layerslice.CASES:
    layerShapes = {"DepthConcat": [(2, 3, 5, 5), (2, 2, 3, 3)], "Split": [(64, 3)], "Mul": [(3, 4)] * 2,
                   "Glue": [(2, layerslice.GLUE_SIZE)], "Upsample3D": [(1, 2, 2, 3, 2)], "Upsample2D": [(1, 2, 3, 4)],
                   "Pad2D": [(2, 64, 5, 6)], "PRelu": [(2, 64, 5, 6)], "MaxPool2D-MaxUnpool2D": [(2, 64, 5, 6)],
                   "CrossMapLRN": [(2, 6, 5, 5)], "MapLRN": [(2, 6, 5, 5)], "SubtractMean": [(2, 3, 9, 9)],
                   "LCN": [(2, 3, 9, 9)], "SpatialTf": [(2, 3, 6, 6), (2, 2, 3)],
                   "GroupLinear": [(2, layerslice.GROUPS, layerslice.GROUP_SIZE)], "Deconv1D": [(2, 256, 9)],
                   "Deconv3D": [(1, 256, 2, 3, 3)], "MaxPool3D": [(1, 2, 4, 6, 6)], "AvgPool3D": [(1, 2, 4, 6, 6)],
                   "GroupLinear batchDim 1": [(layerslice.GROUPS, 2, layerslice.GROUP_SIZE)],
                   "GroupLinear wmode one batchDim 1": [(layerslice.GROUPS, 2, layerslice.GROUP_SIZE)]}
    layerslice.run(layerName, layerShapes.get(layerName, layerShapes.get(layerName.split()[0], [(2, 6, 5)])),
                   layerslice.CASES[layerName].dtypes[-1], "cpu")
from puzzlelib_tpu_torch.tools import alexnetslice, c3dslice
alexRun = alexnetslice.buildRun(alexnetslice.build(maps=(4, 4, 4, 4, 4), fcs=(8, 8), classes=4, shape=(3, 67, 67)),
                                batch=2, classes=4)
alexRun.train("fused", *alexnetslice.data(2, shape=(3, 67, 67), classes=4))
c3dRun = alexnetslice.buildRun(c3dslice.build(maps=(2, 2, 2, 2, 2), fcs=(4, 4), classes=4, shape=(3, 16, 16, 16)),
                               batch=2, classes=4)
assert c3dRun.serve("hopper", c3dslice.data(2, shape=(3, 16, 16, 16), classes=4)[0])[0].shape == (2, 4)
segRun = segslice.buildRun(segslice.build(torch.bfloat16, encoder=((1, 8), (1, 8))), batch=2)
segRun.train("fused", *segslice.data(2, shape=(3, 20, 24), block=4))
assert segRun.serve("hopper", segslice.data(2, shape=(3, 20, 24))[0])[0].shape == (2, 12, 20, 24)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "puzzlelib_tpu"))
print("LEAKED", leaked)
"""


def testPortRunsWithoutJax():
    """A process that imports the port, serves a narrow VGG-shaped net and a
    narrow transformer (attnAlgo="flash"), builds and serves a narrow int8
    engine, runs ``checkinstall``, imports the measurement path (the
    benchmarks, the probe scripts, the profiler), runs the plain versions of
    the probes P1-P3 and ``convNdbenchmark`` on the CPU, trains and
    validates LeNet with the hooks (``rng``, ``Validator``), takes one
    ``FusedStep`` of it (``fused``, ``fusedctx``), runs dropout and average
    pooling forward and backward, the ImageNet NiN forward and a CIFAR-10
    NIN training step of ``tools/cnnslice.py``, a residual block with the
    batch-norm family forward and backward, ResNet-50's Winograd convs
    (``tools/resnetslice.py``, ``profileresnet``), ``netspeed``, a training
    step with ``BCE`` through ``Deconv2D``, ``Concat``, ``ToList`` and the
    six other activations, the U-Net forward on (1, 1, 32, 32) and the
    Inception nets by shape (``tools/{unet,inception}slice.py``), the
    sequence slice (``tools/sequenceslice.py``: a fused BiLSTM and 1-d CNN
    step, a two-level GRU with ``SwapAxes``, ``Pad1D`` and ``AvgPool1D``
    trained with ``MSE``, ``converter/rnnweights``, a narrow Wave2Letter
    step with ``CTC`` and ``loadW2L`` by shape), the zoo slice (MiniYolo
    and OpenPose COCO / MPI by shape, a narrow SentiNet through
    ``presets.sentinet`` and ``datasets.utils.validate`` with ``statistics``,
    and through a fused step under each of the six new optimizers of
    ``tools/zooslice.py``, the seven new costs with ``Multi`` and the cost
    kernels' wrappers), the glue, upsampling and unpooling modules in bf16
    and the LRN family, the spatial transformer, ``GroupLinear``, the noise
    and penalty layers and the 1-d and 3-d modules, each in the last type it
    takes (``tools/layerslice.py``), a narrow AlexNet trained fused and a
    narrow C3D in bf16 served (``tools/{alexnet,c3d}slice.py``), and a
    narrow SegNet trained fused and
    served (``tools/segslice.py``) imports no JAX and nothing of the JAX
    package (``ml_dtypes`` neither)."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))

    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LEAKED []" in proc.stdout


@pytest.mark.cuda
def testSliceOnCardThroughKernels(monkeypatch):
    """A narrow net whose 3x3 convs the Winograd kernel takes (C = CO = 128),
    in bf16 on the card: the kernels run, and the output agrees with the f32
    run on the CPU at the bf16 tier."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")

    from puzzlelib_tpu_torch.backend import gpuarray
    from puzzlelib_tpu_torch.ops.hopper import matmul, winograd

    monkeypatch.setattr(TConfig, "device", "cpu")
    np.random.seed(4)
    net = TC.Sequential()
    net.append(T.Conv2D(3, 128, 3, pad=1, initscheme="he", name="c1"))
    net.append(T.Activation(T.relu, name="r1"))
    net.append(T.Conv2D(128, 128, 3, pad=1, initscheme="he", name="c2"))
    net.append(T.Activation(T.relu, name="r2"))
    net.append(T.MaxPool2D(name="p"))
    net.append(T.Flatten())
    net.append(T.Linear(128 * 4 * 4, 16, initscheme="he", name="fc"))
    net.append(T.SoftMax())

    x = np.random.RandomState(5).randn(6, 3, 8, 8).astype(np.float32)
    want = TCalculator(net, batchsize=4).calcFromHost(x)

    net.to("cuda")
    net.calcMode(torch.bfloat16)
    before = (winograd.launches, matmul.launches)

    monkeypatch.setattr(TConfig, "device", "cuda")
    got = TCalculator(net, batchsize=4).calcFromHost(x)

    assert (winograd.launches - before[0], matmul.launches - before[1]) == (2, 2)
    assert gpuarray.get(net["fc"].W).dtype == np.float32
    assert np.abs(got - want).max() <= 5e-2
