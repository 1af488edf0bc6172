"""The CNN training slice against the JAX package: average and padded max
pooling, dropout on injected draws, the optimizer hooks, LeNet trained 20
steps, a narrowed CIFAR-10 NIN with its dropout and hooks, the ImageNet
NiN's forward, the parameter tables of the three nets, the port's random
number generator, and the slice driver ``tools/cnnslice.py``.

Dropout's twins cannot share a generator: each test gives both packages'
modules the same seeded uint32 draws by overriding ``_drawRands`` on the
instances.  f32 is held within 1e-5 of max|ref| (the reference's f32 tier),
bf16 within 5e-2 (its bf16 tier), unless a test says otherwise."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import handlers as TH
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy
from puzzlelib_tpu_torch.cost import CrossEntropy as TCrossEntropy
from puzzlelib_tpu_torch.models import nets as TNets
from puzzlelib_tpu_torch.optimizers import MomentumSGD as TMomentumSGD
from puzzlelib_tpu_torch.optimizers import hooks as THooks
from puzzlelib_tpu_torch.rng import RandomNumberGenerator
from puzzlelib_tpu_torch.tools import cnnslice


BOUNDS = {"f32": 1e-5, "bf16": 5e-2}


def _jax():
    """The JAX package's pieces for the twins; they skip where it does not
    import, as on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import ml_dtypes
    from puzzlelib_tpu import containers, cost, handlers, modules, optimizers
    from puzzlelib_tpu.backend import gpuarray

    types = {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}
    return modules, containers, handlers, cost, optimizers, gpuarray, types


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _close(got, want, bound):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, dtype=np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _table(jnet):
    return {name: var.data.get() for var, names in jnet.getVarTable().items() for name in names}


def _moduleTwin(jmod, tmod, x, dtype, seed=9):
    """Forward x and backward a seeded output gradient through both modules
    in ``dtype``: (JAX output, port output, JAX input gradient, port input
    gradient), the JAX ones as f32 host arrays."""
    _, _, _, _, _, jgpu, types = _jax()
    jtype, ttype = types[dtype]
    if dtype != "f32":
        jmod.calcMode(jtype)
        tmod.calcMode(ttype)

    jout = jmod(jgpu.to_gpu(x.astype(jtype)))
    tout = tmod(torch.from_numpy(x).to(ttype))
    grad = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)

    jmod.backward(jgpu.to_gpu(grad.astype(jtype)))
    tmod.backward(torch.from_numpy(grad).to(ttype))
    return (np.asarray(jout.get(), np.float32), tout, np.asarray(jmod.grad.get(), np.float32), tmod.grad)


# -- pooling ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("includePad", [True, False])
@pytest.mark.parametrize("size, stride, pad", [(2, 2, 0), (3, 2, 1), (3, 1, 1), (5, 1, 0)])
def testAvgPool2DTwin(size, stride, pad, includePad, dtype):
    """Both modes, pads 0 and 1, forward and backward; the NiN's 5x5 window
    on a 5x5 map among them."""
    J = _jax()[0]
    x = np.random.RandomState(1).randn(2, 3, 9, 8).astype(np.float32)
    if size == 5:
        x = x[:, :, :5, :5].copy()

    jout, tout, jgrad, tgrad = _moduleTwin(J.AvgPool2D(size, stride, pad, includePad=includePad),
                                           T.AvgPool2D(size, stride, pad, includePad=includePad), x, dtype)
    _close(tout, jout, BOUNDS[dtype])
    _close(tgrad, jgrad, BOUNDS[dtype])
    assert tout.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]


def testAvgPoolModesDivideAsTheirNamesSay():
    """At a corner window of 3x3 at pad 1, four cells lie inside: the
    padded mode divides their sum by 9, the other by 4."""
    x = torch.ones(1, 1, 4, 4)
    withPad = T.AvgPool2D(3, 2, 1, includePad=True)(x)
    noPad = T.AvgPool2D(3, 2, 1, includePad=False)(x)

    assert withPad[0, 0, 0, 0].item() == pytest.approx(4 / 9)
    assert torch.equal(noPad, torch.ones_like(noPad))


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
def testMaxPool2DPadOneTwin(dtype):
    """Padded max pooling at the CIFAR-10 NIN's first pool (3, 2, pad 1) on
    a 32x32 map, forward and backward."""
    J = _jax()[0]
    x = np.random.RandomState(2).randn(2, 6, 32, 32).astype(np.float32)

    jout, tout, jgrad, tgrad = _moduleTwin(J.MaxPool2D(3, 2, 1), T.MaxPool2D(3, 2, 1), x, dtype)
    assert tout.shape == (2, 6, 16, 16)
    _close(tout, jout, BOUNDS[dtype])
    _close(tgrad, jgrad, BOUNDS[dtype])


# -- dropout ---------------------------------------------------------------------------

class _Draws:
    """Seeded uint32 draws per module name, in the order a module asks for
    them; one feed for each package, from the same seeds."""

    def __init__(self, seed):
        self.seed, self.calls = seed, {}

    def inject(self, mod, name, asTensor):
        def draw(size):
            call = self.calls[name] = self.calls.get(name, 0) + 1
            rng = np.random.RandomState([self.seed, call, sum(map(ord, name))])
            return asTensor(rng.randint(0, 2 ** 32, size=size, dtype=np.uint64).astype(np.uint32))

        mod._drawRands = draw


def _injectDraws(jmods, tmods, seed=11):
    _, _, _, _, _, jgpu, _ = _jax()
    jdraws, tdraws = _Draws(seed), _Draws(seed)

    for (name, jmod), tmod in zip(jmods, tmods):
        jdraws.inject(jmod, name, jgpu.to_gpu)
        tdraws.inject(tmod, name, lambda ary: torch.from_numpy(ary.astype(np.int64)))


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("cls, p, slicing", [("Dropout", 0.5, None), ("Dropout", 0.3, slice(7, 200)),
                                             ("Dropout2D", 0.5, None), ("Dropout2D", 0.25, None)])
def testDropoutTwin(cls, p, slicing, dtype):
    """Train mode on the same draws: the same output and gradient (f32 to
    the bit); eval mode: the identity in both."""
    J = _jax()[0]
    jmod, tmod = getattr(J, cls)(p, slicing=slicing), getattr(T, cls)(p, slicing=slicing)
    _injectDraws([("drop", jmod)], [tmod])
    x = np.random.RandomState(3).randn(4, 5, 6, 7).astype(np.float32)

    jout, tout, jgrad, tgrad = _moduleTwin(jmod, tmod, x, dtype)
    if dtype == "f32":
        assert np.array_equal(tout.numpy(), jout) and np.array_equal(tgrad.numpy(), jgrad)
    else:
        _close(tout, jout, BOUNDS[dtype])
        _close(tgrad, jgrad, BOUNDS[dtype])

    dropped = (tout.float().numpy() == 0).mean()
    assert 0.0 < dropped < 1.0

    if slicing is not None and dtype == "f32":
        assert np.array_equal(tout.numpy().reshape(-1)[:slicing.start], x.reshape(-1)[:slicing.start])

    _, _, _, _, _, jgpu, types = _jax()
    jtype, ttype = types[dtype]
    jmod.evalMode()
    tmod.evalMode()

    tx, jx = torch.from_numpy(x).to(ttype), jgpu.to_gpu(x.astype(jtype))
    assert tmod(tx) is tx
    assert np.array_equal(np.asarray(jmod(jx).get(), np.float32), np.asarray(jx.get(), np.float32))


def testDropoutKeepsTheReferencesThreshold():
    """A draw keeps its cell where it lies below int((1 - p) * (2**32 - 1)),
    and the kept cells are divided by 1 - p."""
    mod = T.Dropout(0.25)
    partition = int(0.75 * (2 ** 32 - 1))
    draws = torch.tensor([0, partition - 1, partition, 2 ** 32 - 1], dtype=torch.int64)
    mod._drawRands = lambda size: draws[:size]

    out = mod(torch.ones(4))
    assert mod.partition == partition
    assert torch.equal(out, torch.tensor([1 / 0.75, 1 / 0.75, 0.0, 0.0]))


def testDropoutDrawsFromItsGenerator():
    """Without injected draws, a seeded generator gives the same mask again,
    and another seed another mask; about p of the cells drop."""
    x = torch.ones(64, 64)
    masks = []
    for seed in (5, 5, 6):
        out = T.Dropout(0.5, rng=RandomNumberGenerator(seed))(x)
        masks.append(out == 0)

    assert torch.equal(masks[0], masks[1]) and not torch.equal(masks[0], masks[2])
    assert 0.45 < masks[0].float().mean().item() < 0.55


# -- the port's generator --------------------------------------------------------------

def testRandomNumberGeneratorFacade():
    """``seed`` repeats every fill; each fill draws in its range."""
    def fills(rng):
        u, n = torch.empty(1000), torch.empty(1000)
        i, b = torch.empty(1000, dtype=torch.int64), torch.empty(1000, dtype=torch.int32)
        rng.fillUniform(u, -2.0, 3.0)
        rng.fillNormal(n, 1.0, 0.5)
        rng.fillInteger(i, high=2 ** 32)
        rng.fillInteger(b)
        return u, n, i, b

    rng = RandomNumberGenerator(3)
    first = fills(rng)
    rng.seed(3)
    again = fills(rng)

    assert all(torch.equal(a, b) for a, b in zip(first, again))
    u, n, i, b = first
    assert -2.0 <= u.min().item() and u.max().item() < 3.0
    assert abs(n.mean().item() - 1.0) < 0.1 and abs(n.std().item() - 0.5) < 0.1
    assert 0 <= i.min().item() and i.max().item() < 2 ** 32 and i.max().item() > 2 ** 31
    assert b.min().item() < 0 < b.max().item()


# -- hooks -----------------------------------------------------------------------------

def _hookNet(M, C):
    net = C.Sequential(name="hooked")
    net.append(M.Conv2D(2, 4, 3, pad=1, initscheme="he", name="conv"))
    net.append(M.Activation(M.relu, name="relu"))
    net.append(M.Flatten())
    net.append(M.Linear(4 * 5 * 5, 3, initscheme="he", name="fc"))
    return net


def _trainWithHooks(M, C, H, Cost, Opt, hooks, useGlobalState, wc, table=None):
    """Two steps of 4 in order: (the per-step errors, the weights)."""
    np.random.seed(0)
    net = _hookNet(M, C)
    if table is not None:
        paramsFromNumpy(net, table)

    opt = Opt.MomentumSGD(0.1, momRate=0.9)
    for hook in hooks:
        opt.addHook(hook)
    opt.setupOn(net, useGlobalState=useGlobalState)

    if wc:
        for var in net.getVarTable():
            var.wc = wc

    x = np.random.RandomState(5).randn(8, 2, 5, 5).astype(np.float32)
    y = np.random.RandomState(6).randint(0, 3, size=8).astype(np.int32)
    errors = []
    trainer = H.Trainer(net, Cost.CrossEntropy(), opt, batchsize=4, onBatchFinish=lambda h: errors.append(
        h.cost.getError()))
    trainer.trainFromHost(x, y, random=False)
    return errors, net


@pytest.mark.parametrize("hooks", ["decay", "clip", "both"])
@pytest.mark.parametrize("useGlobalState, wc", [(False, 1.0), (False, 0.0), (True, 0.0)])
def testHooksTwin(hooks, useGlobalState, wc):
    """``WeightDecay`` and ``GradClip`` in local state with ``wc`` set on
    every variable, in local state without, and in global state (where the
    flat variable's ``wc`` is 0): the JAX package's errors and weights.
    Decay acts only where ``wc`` is set; clipping acts in every state."""
    J, JC, JH, JCost, JOpt, _, _ = _jax()
    from puzzlelib_tpu.optimizers import hooks as JHooks
    from puzzlelib_tpu_torch import containers as TC
    from puzzlelib_tpu_torch import cost as TCost
    from puzzlelib_tpu_torch import optimizers as TOpt

    def make(Hooks):
        return {"decay": [Hooks.WeightDecay(0.05)], "clip": [Hooks.GradClip(0.2)],
                "both": [Hooks.WeightDecay(0.05), Hooks.GradClip(0.2)]}[hooks]

    want, jnet = _trainWithHooks(J, JC, JH, JCost, JOpt, make(JHooks), useGlobalState, wc)
    table = _table(jnet)

    np.random.seed(0)
    start = _table(_hookNet(J, JC))
    got, tnet = _trainWithHooks(T, TC, TH, TCost, TOpt, make(THooks), useGlobalState, wc, table=start)
    plain, pnet = _trainWithHooks(T, TC, TH, TCost, TOpt, [], useGlobalState, 0.0, table=start)

    _close(np.array(got), np.array(want), BOUNDS["f32"])
    weights = paramsToNumpy(tnet)
    for name, ary in table.items():
        _close(weights[name], ary, BOUNDS["f32"])

    acts = hooks != "decay" or wc > 0.0
    same = all(np.array_equal(weights[name], ary) for name, ary in paramsToNumpy(pnet).items())
    assert same != acts


def testWeightDecaySubtractsTheDecayAndRefusesHalfGradients():
    """The gradient is the descent direction: decay subtracts rate * wc *
    param.  A bf16 gradient is refused, as in the reference."""
    from puzzlelib_tpu_torch.variable import Variable

    var = Variable(torch.full((3, ), 2.0))
    var.grad.fill_(1.0)
    var.wc = 0.5
    THooks.WeightDecay(0.1)(var, {})
    assert torch.allclose(var.grad, torch.full((3, ), 1.0 - 0.1 * 0.5 * 2.0))

    half = Variable(torch.ones(3, dtype=torch.bfloat16))
    half.wc = 1.0
    with pytest.raises(TypeError, match="fp32"):
        THooks.WeightDecay(0.1)(half, {})


# -- the nets ----------------------------------------------------------------------------

def _steps(H, net, cost, opt, x, y, batch, seed):
    errors = []
    trainer = H.Trainer(net, cost, opt, batchsize=batch, onBatchFinish=lambda h: errors.append(h.cost.getError()))
    np.random.seed(seed)
    trainer.trainFromHost(x, y, macroBatchSize=len(x))
    return errors


@pytest.mark.parametrize("initscheme", [None, "none"])
def testLeNetMomentumSGDTwin(initscheme):
    """20 shuffled ``MomentumSGD(0.01, 0.9)`` steps of 16 in global state,
    as ``bench.py`` trains LeNet, from the same weights: per-step losses and
    final weights within 1e-5 relative.  The net builds with the default
    scheme ``None`` (the testlib script's) and with "none"; for "none" both
    get one seeded table."""
    J, JC, JH, JCost, JOpt, _, _ = _jax()
    from puzzlelib_tpu.models.nets.lenet import loadLeNet

    np.random.seed(0)
    jnet = loadLeNet(None, initscheme=initscheme)
    tnet = TNets.loadLeNet(None, initscheme=initscheme)
    table = _table(jnet)

    if initscheme == "none":
        rng = np.random.RandomState(7)
        table = {name: (rng.randn(*ary.shape) * 0.05).astype(np.float32) for name, ary in table.items()}
        for var, names in jnet.getVarTable().items():
            var.data.set(table[names[0]])

    paramsFromNumpy(tnet, table)

    jopt, topt = JOpt.MomentumSGD(0.01, momRate=0.9), TMomentumSGD(0.01, momRate=0.9)
    jopt.setupOn(jnet, useGlobalState=True)
    topt.setupOn(tnet, useGlobalState=True)

    x, y = cnnslice.data("lenet", 20 * 16)
    want = _steps(JH, jnet, JCost.CrossEntropy(maxlabels=10), jopt, x, y, 16, seed=3)
    got = _steps(TH, tnet, TCrossEntropy(maxlabels=10), topt, x, y, 16, seed=3)

    assert len(got) == len(want) == 20
    assert np.abs(np.array(got) - np.array(want)).max() <= 1e-5 * np.abs(want).max()

    weights = paramsToNumpy(tnet)
    for var, names in jnet.getVarTable().items():
        ref = var.data.get()
        assert np.abs(weights[names[0]] - ref).max() <= 1e-5 * np.abs(ref).max(), names[0]


def _quarter(blocks):
    """The CIFAR-10 NIN's block table at a quarter of its width (its 3 input
    and 10 output maps kept)."""
    def narrow(maps):
        return maps if maps in (3, 10) else maps // 4

    return [dict(block, convs=[(narrow(i), narrow(o), size, pad) for i, o, size, pad in block["convs"]])
            for block in blocks]


def _cifarTwins(monkeypatch):
    """The narrowed CIFAR-10 NIN in both packages, the JAX one by the testlib
    script's ``buildNet`` on its narrowed table, with the same weights and
    the same dropout draws."""
    _jax()
    from testlib import cnncifar10nin

    monkeypatch.setattr(cnncifar10nin, "NIN_BLOCKS", _quarter(cnncifar10nin.NIN_BLOCKS))
    np.random.seed(0)
    jnet = cnncifar10nin.buildNet()
    tnet = cnnslice.buildNet(_quarter(cnnslice.NIN_BLOCKS))
    paramsFromNumpy(tnet, _table(jnet))

    drops = ["drop3", "drop6"]
    _injectDraws([(name, jnet[name]) for name in drops], [tnet[name] for name in drops])
    return jnet, tnet


def testCifarNINForwardBackwardTwin(monkeypatch):
    """One batch in train mode on injected draws: the same scores, and the
    same gradient of every parameter after the backward of the same
    output gradient."""
    _, _, _, _, _, jgpu, _ = _jax()
    jnet, tnet = _cifarTwins(monkeypatch)
    x, _ = cnnslice.data("nin-cifar", 4)

    jout, tout = jnet(jgpu.to_gpu(x)), tnet(torch.from_numpy(x))
    _close(tout, jout.get(), BOUNDS["f32"])
    assert tout.shape == (4, 10)

    grad = np.random.RandomState(8).randn(4, 10).astype(np.float32)
    jnet.backward(jgpu.to_gpu(grad))
    tnet.backward(torch.from_numpy(grad))
    _close(tnet.grad, jnet.grad.get(), BOUNDS["f32"])

    for var, names in jnet.getVarTable().items():
        _close(tnet.getVar(names[0]).grad, var.grad.get(), BOUNDS["f32"])


@pytest.mark.parametrize("useGlobalState", [True, False])
def testCifarNINTrainingTwin(monkeypatch, useGlobalState):
    """3 shuffled steps of 8 with ``MomentumSGD(0.01, 0.9)`` and
    ``WeightDecay(1e-4)``, as the testlib script sets them up, on injected
    dropout draws: the same losses and weights, then the same validation
    error.  In global state the decay is a no-op, as in the reference; in
    local state ``wc`` is set on every variable, so it acts."""
    J, JC, JH, JCost, JOpt, _, _ = _jax()
    from puzzlelib_tpu.optimizers import hooks as JHooks

    jnet, tnet = _cifarTwins(monkeypatch)
    jopt, topt = JOpt.MomentumSGD(0.01, momRate=0.9), TMomentumSGD(0.01, momRate=0.9)
    jopt.addHook(JHooks.WeightDecay(1e-4))
    topt.addHook(THooks.WeightDecay(1e-4))
    jopt.setupOn(jnet, useGlobalState=useGlobalState)
    topt.setupOn(tnet, useGlobalState=useGlobalState)

    if not useGlobalState:
        for net in (jnet, tnet):
            for var in net.getVarTable():
                var.wc = 1.0

    x, y = cnnslice.data("nin-cifar", 24)
    want = _steps(JH, jnet, JCost.CrossEntropy(maxlabels=10), jopt, x, y, 8, seed=4)
    got = _steps(TH, tnet, TCrossEntropy(maxlabels=10), topt, x, y, 8, seed=4)
    _close(np.array(got), np.array(want), BOUNDS["f32"])

    weights = paramsToNumpy(tnet)
    for var, names in jnet.getVarTable().items():
        _close(weights[names[0]], var.data.get(), BOUNDS["f32"])

    vx, vy = cnnslice.data("nin-cifar", 12, seed=2)
    jerr = JH.Validator(jnet, JCost.CrossEntropy(), batchsize=8).validateFromHost(vx, vy)
    assert TH.Validator(tnet, TCrossEntropy(), batchsize=8).validateFromHost(vx, vy) == jerr


@pytest.mark.parametrize("poolmode", ["max", "avg"])
def testNiNImageNetForwardTwin(poolmode):
    """``loadNiNImageNet`` at batch 1, 224x224, f32, in eval mode: the JAX
    package's softmax output, and its logits through the port's
    ``paramsFromNumpy`` of the JAX weights."""
    J, _, _, _, _, jgpu, _ = _jax()
    from puzzlelib_tpu.models.nets.nin import loadNiNImageNet

    np.random.seed(0)
    jnet = loadNiNImageNet(None, poolmode=poolmode, initscheme="he")
    tnet = TNets.loadNiNImageNet(None, poolmode=poolmode)
    paramsFromNumpy(tnet, _table(jnet))
    jnet.evalMode()
    tnet.evalMode()

    x = np.random.RandomState(1).randn(1, 3, 224, 224).astype(np.float32)
    jout, tout = jnet(jgpu.to_gpu(x)), tnet(torch.from_numpy(x))

    assert tout.shape == (1, 1000)
    _close(tout, jout.get(), BOUNDS["f32"])
    _close(tnet.graph[-2].data, jnet.modules[list(jnet.modules)[-2]].data.get(), 1e-4)


def testVGGAveragePoolingTwin():
    """``loadVGG(poolmode="avg")`` builds (it raised before average pooling
    was ported) and gives the JAX package's features."""
    J, _, _, _, _, jgpu, _ = _jax()
    from puzzlelib_tpu.models.nets.vgg import loadVGG

    np.random.seed(0)
    jnet = loadVGG(None, "11", poolmode="avg", initscheme="he", withLinear=False)
    tnet = TNets.loadVGG(None, "11", poolmode="avg", withLinear=False)
    paramsFromNumpy(tnet, _table(jnet))
    assert isinstance(tnet["pool1"], T.AvgPool2D)

    x = np.random.RandomState(2).randn(1, 3, 32, 32).astype(np.float32)
    _close(tnet(torch.from_numpy(x)), jnet(jgpu.to_gpu(x)).get(), BOUNDS["f32"])


@pytest.mark.parametrize("kind", ["lenet", "nin-cifar", "nin"])
def testParamsRoundTripThroughTheJaxPackage(kind):
    """Each net of the slice loads the JAX package's parameters under their
    names and gives them back unchanged."""
    J, _, _, _, _, _, _ = _jax()
    from puzzlelib_tpu.models.nets.lenet import loadLeNet
    from puzzlelib_tpu.models.nets.nin import loadNiNImageNet
    from testlib import cnncifar10nin

    np.random.seed(0)
    jnet = {"lenet": lambda: loadLeNet(None, initscheme=None), "nin-cifar": cnncifar10nin.buildNet,
            "nin": lambda: loadNiNImageNet(None, initscheme="he")}[kind]()
    table = _table(jnet)

    tnet = cnnslice.build(kind)
    paramsFromNumpy(tnet, table)
    back = paramsToNumpy(tnet)

    assert sorted(back) == sorted(table)
    assert all(np.array_equal(back[name], ary) for name, ary in table.items())


# -- the slice driver ------------------------------------------------------------------

def testCnnSliceRunsRepeatAndValidationLeavesDropoutToTraining():
    """The slice driver on the CPU at a small size: a run repeats its losses
    from ``restore``; a validation between two training calls puts dropout
    in eval mode (two validations, the same error) and the next training
    call draws again, with the same losses as a run without it."""
    run = cnnslice.buildRun("nin-cifar", batch=4)
    x, y = cnnslice.data("nin-cifar", 8)
    vx, vy = cnnslice.data("nin-cifar", 8, seed=2)

    first, second = [], []
    run.train("hopper", x, y, first)
    error, _ = run.validate("hopper", vx, vy)
    assert not run.net["drop3"].training
    assert run.validate("hopper", vx, vy)[0] == error

    run.train("hopper", x, y, second)
    assert run.net["drop3"].training
    assert second == first and len(first) == 2 and np.isfinite(first).all()


@pytest.mark.parametrize("kind, count", [("lenet", 8), ("nin", 2)])
def testCnnSliceBuildsAndTrains(kind, count):
    """LeNet in f32 and the ImageNet NiN in bf16, without its SoftMax, train
    two steps and validate through the driver; the library route gives the
    same on the CPU, where both routes are the library's."""
    run = cnnslice.buildRun(kind, batch=count // 2)
    x, y = cnnslice.data(kind, count)

    losses, again = [], []
    run.train("hopper", x, y, losses)
    run.train("torch", x, y, again)
    error, _ = run.validate("hopper", x, y)

    assert losses == again and len(losses) == 2 and np.isfinite(losses).all()
    assert 0.0 <= error <= 1.0
    assert type(run.net.graph[-1]).__name__ == ("Flatten" if kind == "nin" else "Linear")
    assert run.net.calctype == (torch.bfloat16 if kind == "nin" else torch.float32)


@pytest.mark.cuda
def testSliceDriverOnCard(monkeypatch):
    """On the card: LeNet's two ``Linear``s launch K1 in training (one each
    a step) and the step losses agree with the library route's within
    1e-4; the CIFAR-10 NIN's dropout draws from the card's generator repeat
    from their seed, so a run repeats its losses (within 1e-5: cuDNN's
    backward may sum in another order; another mask would move them by
    far more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ built with nvcc")

    from puzzlelib_tpu_torch.ops.hopper import matmul

    monkeypatch.setattr(TConfig, "device", "cuda")
    run = cnnslice.buildRun("lenet", batch=16)
    x, y = cnnslice.data("lenet", 32)

    before = matmul.launches
    hand, library = [], []
    run.train("hopper", x, y, hand)
    assert matmul.launches == before + 4

    run.train("torch", x, y, library)
    assert max(abs(a - b) / abs(b) for a, b in zip(hand, library)) <= 1e-4
    assert run.validate("hopper", x, y)[0] == run.validate("torch", x, y)[0]

    cifar = cnnslice.buildRun("nin-cifar", batch=8)
    x, y = cnnslice.data("nin-cifar", 16)
    first, second = [], []
    cifar.train("hopper", x, y, first)
    cifar.train("hopper", x, y, second)
    assert np.isfinite(first).all() and np.abs(np.array(first) - np.array(second)).max() <= 1e-5 * max(first)
