"""The ResNet slice against the JAX package: ``loadResNet`` and its blocks,
training a narrow residual net eagerly and through the fused step, the
full-width ResNet-50 forward, ``tools/resnetslice.py`` and the port of
``benchmarks/netspeed.py``.

Each twin builds the JAX net and the port's from one numpy seed and carries
the JAX net's weights and running stats over through ``convert``
(``paramsFromNumpy``, ``attrsFromNumpy``); the data come from seeded numpy.
f32 is held within 1e-5 of max(1, max |want|), bf16 within 5e-2 relative L2,
and the 50-layer chain of the full-width forward within 1e-4 relative L2.

The narrow net trains at a learning rate of 1e-3.  Its relus see about
16 k values a layer a step, and the two packages' f32 convs differ by ~1e-5
where the values are O(1), so in five steps one or two relu inputs this close
to zero take the other sign in one package: that value's gradient is
dropped on one side, and the step's weight gradients differ there by up to
1.5e-3 (seen on the CPU at this seed and order).  At 1e-2 such a step moves
the weights apart by 1.5e-5, past the f32 tier; at 1e-3 by 1.5e-6.  The
card-only cases (``cuda`` marker) run the hand kernels."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import fused
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.benchmarks import netspeed
from puzzlelib_tpu_torch.convert import attrsFromNumpy, attrsToNumpy, paramsFromNumpy, paramsToNumpy
from puzzlelib_tpu_torch.cost import CrossEntropy as TCrossEntropy
from puzzlelib_tpu_torch.handlers import Trainer
from puzzlelib_tpu_torch.models import nets as TNets
from puzzlelib_tpu_torch.optimizers import MomentumSGD as TMomentumSGD
from puzzlelib_tpu_torch.tools import resnetslice


F32_BOUND = 1e-5
BF16_BOUND = 5e-2
CHAIN_BOUND = 1e-4
BATCH, STEPS, LEARN_RATE, MOM_RATE = 8, 5, 1e-3, 0.9


def _jax():
    """The JAX package's pieces; the twins skip where it does not import, as
    on the card's machine, where only the card-only cases run."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import containers, cost, fused as jfused, handlers, modules, optimizers
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.models.nets import resnet as nets

    return modules, containers, nets, cost, optimizers, handlers, jfused, gpuarray


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()

    return np.asarray(value.get() if hasattr(value, "get") else value, dtype=np.float32)


def _close(got, want, bound=F32_BOUND):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _relL2(got, want):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jvars(jnet):
    return {name: np.asarray(var.data.get(), np.float32) for var, names in jnet.getVarTable().items()
            for name in names}


def _jattrs(jnet, prefix=""):
    """The JAX net's module attributes by the names of its checkpoint, as the
    port's ``getAttrTable`` names them."""
    table = {}
    for name, child in getattr(jnet, "modules", {}).items():
        path = "%s%s." % (prefix, name)
        table.update({path + attr: np.asarray(value.get(), np.float32) for attr, value in child.attrs.items()})
        table.update(_jattrs(child, path))

    return table


def _carry(jnet, tnet):
    """The JAX net's weights and running stats into the port's net."""
    paramsFromNumpy(tnet, _jvars(jnet))
    attrsFromNumpy(tnet, _jattrs(jnet))


def _assertTables(got, want, bound):
    """f32: each array within the tier.  bf16: the table as one vector
    within ``bound`` relative L2 (a batch norm's bias starts at zero and
    moves by ~1e-4 in five steps, a sum of bf16 gradients that cancel, so
    alone it holds the noise of that sum and not the net's agreement)."""
    assert sorted(got) == sorted(want)
    if bound == F32_BOUND:
        for name, ary in want.items():
            _close(got[name], ary, bound)
        return

    names = sorted(want)
    assert _relL2(np.concatenate([got[n].ravel() for n in names]),
                  np.concatenate([want[n].ravel() for n in names])) <= bound


# -- the builders ---------------------------------------------------------------------------------

@pytest.mark.parametrize("layers, nvars, nparams", [("50", 161, 25557032), ("101", 314, 44549160),
                                                    ("152", 467, 60192808)])
def testResNetStructureTwin(monkeypatch, layers, nvars, nparams):
    """Same module names and types, variable names and shapes, attribute
    names and shapes, and the same ``dataShapeFrom`` chain in both
    packages."""
    _, _, JNets, _, _, _, _, _ = _jax()
    from puzzlelib_tpu import config as JConfig

    monkeypatch.setattr(JConfig, "globalEvalMode", True)
    monkeypatch.setattr(TConfig, "globalEvalMode", True)

    jnet = JNets.loadResNet(None, layers, initscheme="none")
    tnet = TNets.loadResNet(None, layers, initscheme="none")

    assert tnet.name == jnet.name == "ResNet-%s" % layers
    assert [(m.name, type(m).__name__) for m in tnet.graph] == [(m.name, type(m).__name__) for m in jnet.graph]

    jvars = {name: tuple(var.data.shape) for var, names in jnet.getVarTable().items() for name in names}
    tvars = {name: tuple(var.data.shape) for var, names in tnet.getVarTable().items() for name in names}
    assert tvars == jvars and len(tvars) == nvars
    assert tnet.numOfParams() == jnet.numOfParams() == nparams

    jattrs = {name: ary.shape for name, ary in _jattrs(jnet).items()}
    assert {name: tuple(attr.shape) for name, attr in tnet.getAttrTable().items()} == jattrs

    shape = (1, 3, 224, 224)
    for jmod, tmod in zip(jnet.graph, tnet.graph):
        assert tmod.dataShapeFrom(shape) == jmod.dataShapeFrom(shape)
        shape = jmod.dataShapeFrom(shape)
    assert tuple(shape) == (1, 1000)


def testLoadResNetRefusesACheckpointAndUnknownDepths():
    with pytest.raises(NotImplementedError, match="checkpoint"):
        TNets.loadResNet("resnet50.hdf", "50")

    with pytest.raises(ValueError, match="layers"):
        TNets.loadResNet(None, "34")


def testResidualBlockInplaceBatchNormRefusesTraining():
    """``bnInplace`` builds, serves in eval mode and refuses train mode, as
    the reference's batch norm does; the defaults leave every layer out of
    place (``Replicate`` hands one tensor to both branches)."""
    block = TNets.residBlock(8, 4, 1, "2a", True, False, True, "he")
    x = torch.randn(2, 8, 6, 6)

    with pytest.raises(T.ModuleError, match="inplace"):
        block(x)

    block.evalMode()
    assert block(x.clone()).shape == (2, 16, 6, 6)
    defaults = TNets.residBlock(8, 4, 1, "2b", False, False, False, "he")
    assert not any(getattr(m, "inplace", False) for m in defaults.modules() if not isinstance(m, TC.Container))


# -- a narrow residual net: eager and fused training ------------------------------------------------

def _narrow(M, C, Nets):
    """A stem conv with its batch norm, then two bottleneck blocks at widths
    8 and 16 (the second strided, both with conv shortcuts), on 16x16 maps."""
    net = C.Sequential(name="narrow")
    net.append(M.Conv2D(3, 8, 3, pad=1, useBias=False, initscheme="he", name="conv1"))
    net.append(M.BatchNorm2D(8, name="bn_conv1"))
    net.append(M.Activation(M.relu, name="conv1_relu"))
    net.extend(Nets.residBlock(8, 8, 1, "2a", True, False, False, "he"))
    net.extend(Nets.residBlock(32, 16, 2, "3a", True, False, False, "he"))
    net.append(M.AvgPool2D(8, 1))
    net.append(M.Flatten())
    net.append(M.Linear(64, 10, initscheme="he", name="fc"))
    return net


def _narrowTwins(dtype="f32"):
    """(JAX net, port net) with the JAX net's weights, each with MomentumSGD
    in global state, and the data: (images, labels)."""
    J, JC, JNets, _, JOpt, _, _, _ = _jax()
    import ml_dtypes

    np.random.seed(3)
    jnet = _narrow(J, JC, JNets)
    tnet = _narrow(T, TC, TNets)
    _carry(jnet, tnet)

    if dtype == "bf16":
        jnet.calcMode(ml_dtypes.bfloat16)
        tnet.calcMode(torch.bfloat16)

    jopt, topt = JOpt.MomentumSGD(LEARN_RATE, momRate=MOM_RATE), TMomentumSGD(LEARN_RATE, momRate=MOM_RATE)
    jopt.setupOn(jnet, useGlobalState=True)
    topt.setupOn(tnet, useGlobalState=True)

    images, labels = resnetslice.data(BATCH * STEPS, seed=4, shape=(3, 16, 16), classes=10)
    return (jnet, jopt), (tnet, topt), images, labels


def _train(trainerCls, net, cost, opt, images, labels):
    """One ``trainFromHost`` from one numpy seed: each step's loss."""
    losses = []
    np.random.seed(9)
    trainerCls(net, cost, opt, onBatchFinish=lambda h: losses.append(h.cost.getError()),
               batchsize=BATCH).trainFromHost(images, labels)
    return losses


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def testNarrowResidualTrainingTwin(dtype):
    """Five MomentumSGD steps in global state through ``Trainer``: the
    per-step losses, the final weights and the running stats (carried by
    the step's factor across the blocks) against the JAX package's; in bf16
    the scales, biases and running stats sit in an f32 flat buffer."""
    _, _, _, JCost, _, JHandlers, _, _ = _jax()
    (jnet, jopt), (tnet, topt), images, labels = _narrowTwins(dtype)
    bound = F32_BOUND if dtype == "f32" else BF16_BOUND

    import ml_dtypes

    # the JAX package uploads host data as it is, the port casts f32 to the
    # net's type
    jimages = images if dtype == "f32" else images.astype(ml_dtypes.bfloat16)
    want = _train(JHandlers.Trainer, jnet, JCost.CrossEntropy(maxlabels=10), jopt, jimages, labels)
    got = _train(Trainer, tnet, TCrossEntropy(maxlabels=10), topt, images, labels)

    assert len(got) == STEPS and np.isfinite(got).all()
    _close(np.array(got), np.array(want), bound)
    _assertTables(paramsToNumpy(tnet), _jvars(jnet), bound)
    _assertTables(attrsToNumpy(tnet), _jattrs(jnet), bound)

    if dtype == "bf16":
        assert set(topt.shParams) == {torch.bfloat16, torch.float32}


def testNarrowResidualFusedTwin():
    """``FusedTrainer`` five steps against the JAX package's (its
    ``FusedStep``, the factor from the step counter): the per-step losses
    and the running stats; then ``FusedCalculator`` and ``FusedValidator``
    after the training, which read the running stats as they now are, and
    the eager Trainer of the port from the same start, whose running stats
    the fused step's equal."""
    _, _, _, JCost, _, _, jfused, _ = _jax()
    (jnet, jopt), (tnet, topt), images, labels = _narrowTwins()
    start = ({name: ary.copy() for name, ary in paramsToNumpy(tnet).items()}, attrsToNumpy(tnet))

    want = _train(jfused.FusedTrainer, jnet, JCost.CrossEntropy(maxlabels=10), jopt, images, labels)
    got = _train(fused.FusedTrainer, tnet, TCrossEntropy(maxlabels=10), topt, images, labels)

    _close(np.array(got), np.array(want))
    _assertTables(attrsToNumpy(tnet), _jattrs(jnet), F32_BOUND)
    _assertTables(paramsToNumpy(tnet), _jvars(jnet), F32_BOUND)

    evalImages = images[:13]
    wantLogits = jfused.FusedCalculator(jnet, batchsize=BATCH).calcFromHost(evalImages)
    gotLogits = fused.FusedCalculator(tnet, batchsize=BATCH).calcFromHost(evalImages)
    _close(gotLogits, wantLogits)

    wantError = jfused.FusedValidator(jnet, JCost.CrossEntropy(), batchsize=BATCH).validateFromHost(images, labels)
    gotError = fused.FusedValidator(tnet, TCrossEntropy(), batchsize=BATCH).validateFromHost(images, labels)
    assert abs(gotError - wantError) <= F32_BOUND

    fusedStats = attrsToNumpy(tnet)
    paramsFromNumpy(tnet, start[0])
    attrsFromNumpy(tnet, start[1])
    for state in topt.states.values():
        for tensor in state.values():
            tensor.zero_()

    eager = _train(Trainer, tnet, TCrossEntropy(maxlabels=10), topt, images, labels)
    _close(np.array(got), np.array(eager))
    _assertTables(attrsToNumpy(tnet), fusedStats, F32_BOUND)


# -- full width ----------------------------------------------------------------------------------

def testResNet50FullWidthForwardTwin():
    """ResNet-50 at full width, 224x224 at batch 1, f32, the JAX net's He
    weights carried over: the train-mode forward (which sets every running
    stat to its batch's, the factor being 1 at the first forward) and then
    the eval-mode forward on those stats, each within 1e-4 relative L2 of
    the JAX package's, and the running stats too."""
    _, _, JNets, _, _, _, _, jgpu = _jax()

    np.random.seed(0)
    jnet = JNets.loadResNet(None, "50", initscheme="he")
    tnet = TNets.loadResNet(None, "50", initscheme="none")
    _carry(jnet, tnet)

    x = np.random.RandomState(2).randn(1, 3, 224, 224).astype(np.float32)

    jnet(jgpu.to_gpu(x))
    got = tnet(torch.from_numpy(x))
    assert got.shape == (1, 1000) and _relL2(tnet[-2].data, jnet[-2].data) <= CHAIN_BOUND

    wantStats, gotStats = _jattrs(jnet), attrsToNumpy(tnet)
    for stat in ("mean", "var"):
        names = sorted(name for name in wantStats if name.endswith(stat))
        assert _relL2(np.concatenate([gotStats[n].ravel() for n in names]),
                      np.concatenate([wantStats[n].ravel() for n in names])) <= CHAIN_BOUND

    jnet.evalMode()
    tnet.evalMode()
    jnet(jgpu.to_gpu(x))
    tnet(torch.from_numpy(x))
    assert _relL2(tnet[-2].data, jnet[-2].data) <= CHAIN_BOUND


# -- the slice's tool and netspeed ------------------------------------------------------------------

def testResNetSliceCountsThe13WinogradConvs():
    """``winogradConvs`` takes conv3_x, conv4_x and conv5_x's 3x3 convs, 13
    of ResNet-50's 53 convs, at ``KERNEL_CONVS``'s shapes."""
    net = resnetslice.build(initscheme="none")
    convs = resnetslice.convInputs(net, (resnetslice.BATCH, ) + resnetslice.SHAPE)
    names = resnetslice.winogradConvs(net, (resnetslice.BATCH, ) + resnetslice.SHAPE)

    assert len(convs) == 53 and len(names) == 13
    assert all(name.endswith("branch2b") and name[3] in "345" for name in names)
    shapes = {(shape[1:], conv.W.shape[0]) for conv, shape in convs if conv.name in names}
    assert shapes == {(inshape, co) for _, inshape, co in resnetslice.KERNEL_CONVS}


def testResNetSliceRunRestartsTheSame():
    """``resnetslice.buildRun`` on the narrow net in f32: two ``train`` runs
    on one route from the same start give the same losses and running
    stats; the fused route's losses and the eager route's agree; ``serve``
    on the eager and the fused route gives the same logits."""
    np.random.seed(3)
    run = resnetslice.buildRun(net=_narrow(T, TC, TNets), dtype=torch.float32, batch=BATCH, classes=10)
    images, labels = resnetslice.data(BATCH * 3, seed=4, shape=(3, 16, 16), classes=10)

    first, again, fusedLosses = [], [], []
    run.train("hopper", images, labels, first)
    stats = attrsToNumpy(run.net)
    run.train("hopper", images, labels, again)
    assert first == again and len(first) == 3
    assert all(np.array_equal(ary, stats[name]) for name, ary in attrsToNumpy(run.net).items())

    run.train("fused", images, labels, fusedLosses)
    _close(np.array(fusedLosses), np.array(first))

    eager, _ = run.serve("hopper", images)
    viaFused, _ = run.serve("fused", images)
    assert eager.shape == (BATCH * 3, 10)
    _close(viaFused, eager)


@pytest.mark.parametrize("args", [["--infer"], [], ["--many", "2"]])
def testNetspeedOnCpu(args, capsys):
    """``netspeed.main`` for LeNet on the CPU, inference, training and the
    ``many`` difference: the reference's line."""
    result = netspeed.main(["--net", "lenet", "--batch", "4", "--iters", "2"] + args)
    line = capsys.readouterr().out.strip().splitlines()[-1]

    assert result["net"] == "lenet" and result["batch"] == 4
    assert line.startswith("lenet %s float32 batch 4:" % result["mode"]) and line.endswith("images/sec")


def testNetspeedBuildsTheZooAndRefusesProfile():
    net, inshape, classes = netspeed.buildNet("resnet50")
    assert net.name == "ResNet-50" and inshape == (3, 224, 224) and classes == 1000

    with pytest.raises(NotImplementedError, match="layerprofile"):
        netspeed.main(["--net", "lenet", "--profile"])

    with pytest.raises(ValueError, match="unknown net"):
        netspeed.buildNet("alexnet")


# -- on the card --------------------------------------------------------------------------------

def _needsCard():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")


@pytest.mark.cuda
def testResidualBlockOnCardThroughKernels(monkeypatch):
    """A bottleneck block whose 3x3 conv K2 and K3 take (128 maps), bf16 on
    the card, three steps: K2 forward, K2 bwd-data and K3 once a step, eager
    and fused; the fused step's losses and running stats as the eager
    step's, one recording, and a FusedCalculator replay after more
    training reading the new running stats."""
    _needsCard()
    from puzzlelib_tpu_torch.ops.hopper import winograd

    monkeypatch.setattr(TConfig, "device", "cuda")
    np.random.seed(5)
    net = TC.Sequential(name="card")
    net.extend(TNets.residBlock(128, 128, 1, "3b", True, False, False, "he"))
    net.append(T.AvgPool2D(8, 1))
    net.append(T.Flatten())
    net.append(T.Linear(512, 10, initscheme="he", name="fc"))

    run = resnetslice.buildRun(net=net, batch=4, classes=10)
    images, labels = resnetslice.data(12, seed=6, shape=(128, 8, 8), classes=10)

    eager, replayed = [], []
    counts = (winograd.launches, winograd.dataGradLaunches, winograd.filterGradLaunches)
    run.train("hopper", images, labels, eager)
    after = (winograd.launches, winograd.dataGradLaunches, winograd.filterGradLaunches)
    assert tuple(b - a for a, b in zip(counts, after)) == (6, 3, 3)
    eagerStats = attrsToNumpy(run.net)

    run.train("fused", images, labels, replayed)
    assert replayed[0] == eager[0] and np.allclose(replayed, eager, rtol=BF16_BOUND)
    for name, ary in attrsToNumpy(run.net).items():
        assert np.allclose(ary, eagerStats[name], rtol=BF16_BOUND, atol=1e-3), name
    assert run.fusedTrainer.step.captures == 1

    first, _ = run.serve("fused", images)
    run.trainer.trainFromHost(images, labels)
    again, _ = run.serve("fused", images)
    assert not np.array_equal(first, again)
    assert np.allclose(again, run.serve("hopper", images)[0], rtol=BF16_BOUND, atol=1e-2)
    assert run.fusedCalculator._program.captures == 1
