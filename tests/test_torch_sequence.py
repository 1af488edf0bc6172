"""The sequence slice against the JAX package: ``SwapAxes``, ``Conv1D``,
``Pad1D``, ``MaxPool1D``, ``AvgPool1D`` and ``MSE``; the three IMDB
sentiment nets of ``tools/sequenceslice.py`` narrowed (vocabulary and
length) through ``Trainer`` and ``Validator``; a narrow Wave2Letter through
two CTC steps of ``sequenceslice.W2LRun``; and ``loadW2L``'s shapes.

Each twin builds the JAX object and the port's from one numpy seed; f32 is
held within 1e-5 of max(1, max |want|), bf16 within 5e-2 (the reference's
tiers).  Dropout draws are injected into both packages (``_Draws``, as in
``test_torch_cnn.py``).  The card-only cases (``cuda`` marker) hold the 1-d
modules and a narrow slice on the card to the CPU."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.containers import Sequential as TSequential
from puzzlelib_tpu_torch.convert import attrsToNumpy, paramsFromNumpy, paramsToNumpy
from puzzlelib_tpu_torch.cost import MSE as TMSE
from puzzlelib_tpu_torch.cost import CostError
from puzzlelib_tpu_torch.models.nets import loadW2L as tLoadW2L
from puzzlelib_tpu_torch.models.nets import wavetoletter as TW2L
from puzzlelib_tpu_torch.tools import sequenceslice as Seq


BOUNDS = {"f32": 1e-5, "bf16": 5e-2}

# a narrow Wave2Letter: the rows of wavetoletter._LAYOUT that differ in
# kind (strided, reflect-padded, dilated, 1x1, the last without batch norm)
# at narrow widths
NARROW_W2L = [(13, 16, 11, 2, 5, 0.2, 1, True), (16, 16, 11, 1, 5, 0.2, 1, True),
              (16, 24, 29, 1, 28, 0.4, 2, True), (24, 32, 1, 1, 0, 0.4, 1, True), (32, 29, 1, 1, 0, 0.0, 1, False)]


# the narrow Wave2Letter's first-step weight gradients, relative to max
# |want|: the JAX package runs CTC's recursions in f32 and the port in f64,
# and their gradients differ by some 1e-6 (tests/test_torch_ctc.py); the
# batch norms' backward subtracts the gradient's means, which takes that to
# 2.3e-5 of the weights' gradients (measured on this CPU)
W2L_GRAD_BOUND = 1e-4


def _jax():
    """The JAX package's pieces; the twins skip where it does not import, as
    on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import ml_dtypes
    from puzzlelib_tpu import containers, cost, handlers, modules, optimizers
    from puzzlelib_tpu.backend import gpuarray

    types = {"f32": (np.float32, torch.float32), "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}
    return modules, containers, handlers, cost, optimizers, gpuarray, types


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()

    return np.asarray(value.get() if hasattr(value, "get") else value, dtype=np.float32)


def _close(got, want, bound=BOUNDS["f32"]):
    got, want = _host(got), _host(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _twin(jmod, tmod, x, dtype="f32", seed=9):
    """Forward x and backward a seeded output gradient through both modules
    in ``dtype``: (JAX output, port output, JAX input gradient, port input
    gradient)."""
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
    return jout, tout, jmod.grad, tmod.grad


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


def _injectDropouts(jnet, tnet, seed=11):
    """The same draws into the nets' dropouts, paired in order."""
    jgpu = _jax()[5]
    jdraws, tdraws = _Draws(seed), _Draws(seed)
    jdrops = [mod for mod in jnet.graph if type(mod).__name__ == "Dropout"]
    tdrops = [mod for mod in tnet.graph if isinstance(mod, T.Dropout)]
    assert len(jdrops) == len(tdrops)

    for i, (jmod, tmod) in enumerate(zip(jdrops, tdrops)):
        jdraws.inject(jmod, "drop%d" % i, jgpu.to_gpu)
        tdraws.inject(tmod, "drop%d" % i, lambda ary: torch.from_numpy(ary.astype(np.int64)))


def _jattrs(jnet, prefix=""):
    """The JAX net's module attributes (the batch norms' running stats) by
    the names the port's ``getAttrTable`` gives them."""
    table = {}
    for name, child in getattr(jnet, "modules", {}).items():
        path = "%s%s." % (prefix, name)
        table.update({path + attr: np.asarray(value.get(), np.float32) for attr, value in child.attrs.items()})
        table.update(_jattrs(child, path))

    return table


def _table(jnet):
    return {name: var.data.get() for var, names in jnet.getVarTable().items() for name in names}


# -- the modules -------------------------------------------------------------------------------

@pytest.mark.parametrize("axes, shape", [((0, 1), (3, 4, 5)), ((1, 2), (3, 4, 5)), ((2, 0), (2, 3, 4, 5))])
def testSwapAxesTwin(axes, shape):
    """Forward and backward, the axes in either order, and the shapes."""
    J = _jax()[0]
    jmod, tmod = J.SwapAxes(*axes), T.SwapAxes(*axes)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)

    jout, tout, jgrad, tgrad = _twin(jmod, tmod, x)
    assert np.array_equal(tout.numpy(), jout.get()) and np.array_equal(tgrad.numpy(), jgrad.get())
    assert tmod.dataShapeFrom(shape) == jmod.dataShapeFrom(shape) == tuple(tout.shape)


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("stride, pad, dilation, groups", [(1, 0, 1, 1), (2, 1, 1, 1), (1, 2, 2, 1), (2, 3, 2, 2),
                                                           (1, 1, 1, 4)])
def testConv1DTwin(stride, pad, dilation, groups, dtype):
    """Strided, dilated and grouped 1-d convs, forward, input gradient and
    the weight and bias gradients; the weights from one seed."""
    J = _jax()[0]
    np.random.seed(5)
    jmod = J.Conv1D(8, 12, 3, stride=stride, pad=pad, dilation=dilation, groups=groups)
    np.random.seed(5)
    tmod = T.Conv1D(8, 12, 3, stride=stride, pad=pad, dilation=dilation, groups=groups)
    assert np.array_equal(tmod.W.numpy(), jmod.W.get())

    x = np.random.RandomState(2).randn(3, 8, 17).astype(np.float32)
    jout, tout, jgrad, tgrad = _twin(jmod, tmod, x, dtype)

    _close(tout, jout, BOUNDS[dtype])
    _close(tgrad, jgrad, BOUNDS[dtype])
    for name in ("W", "b"):
        _close(tmod.vars[name].grad, jmod.vars[name].grad, BOUNDS[dtype])

    assert tmod.dataShapeFrom(x.shape) == tuple(tout.shape)
    assert tmod.gradShapeFrom(tuple(tout.shape))[:2] == (3, 8)


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("pad", [3, (2, 5), (0, 4)])
def testPad1DReflectTwin(pad, dtype):
    """Reflect mode, forward and the backward that folds the margins back."""
    J = _jax()[0]
    x = np.random.RandomState(3).randn(2, 3, 9).astype(np.float32)

    jout, tout, jgrad, tgrad = _twin(J.Pad1D(pad, mode="reflect"), T.Pad1D(pad, mode="reflect"), x, dtype)
    _close(tout, jout, BOUNDS[dtype])
    _close(tgrad, jgrad, BOUNDS[dtype])


@pytest.mark.parametrize("fillValue", [None, 1.5])
def testPad1DConstantTwin(fillValue):
    """Constant mode in f32, forward and backward."""
    J = _jax()[0]
    x = np.random.RandomState(4).randn(2, 3, 7).astype(np.float32)

    jout, tout, jgrad, tgrad = _twin(J.Pad1D((2, 3), fillValue=fillValue), T.Pad1D((2, 3), fillValue=fillValue), x)
    assert np.array_equal(tout.numpy(), jout.get()) and np.array_equal(tgrad.numpy(), jgrad.get())


def testPad1DConstantKeepsTheInputsType():
    """The kept divergence: the port's constant pad gives bf16 for bf16
    data, where the reference's allocates f32 whatever the input's type."""
    mod = T.Pad1D(2, fillValue=0.5)
    mod.calcMode(torch.bfloat16)
    out = mod(torch.ones(1, 2, 3, dtype=torch.bfloat16))

    assert out.dtype == torch.bfloat16
    assert torch.equal(out[0, 0].float(), torch.tensor([0.5, 0.5, 1.0, 1.0, 1.0, 0.5, 0.5]))

    J, _, _, _, _, jgpu, types = _jax()
    jmod = J.Pad1D(2, fillValue=0.5)
    jmod.calcMode(types["bf16"][0])
    assert jmod(jgpu.to_gpu(np.ones((1, 2, 3), dtype=types["bf16"][0]))).dtype == np.float32


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("cls, args", [("MaxPool1D", (2, 2, 0)), ("MaxPool1D", (3, 2, 1)), ("MaxPool1D", (11, 1, 0)),
                                       ("AvgPool1D", (2, 2, 0)), ("AvgPool1D", (3, 1, 1)),
                                       ("AvgPool1D", (3, 2, 1, False))])
def testPool1DTwin(cls, args, dtype):
    """Max and average pooling over (N, C, T), padded and not; the global
    window of the IMDB CNN's pool among them."""
    J = _jax()[0]
    x = np.random.RandomState(5).randn(2, 4, 13).astype(np.float32)

    jout, tout, jgrad, tgrad = _twin(getattr(J, cls)(*args), getattr(T, cls)(*args), x, dtype)
    _close(tout, jout, BOUNDS[dtype])
    _close(tgrad, jgrad, BOUNDS[dtype])
    assert tout.dtype == _jax()[6][dtype][1]


@pytest.mark.parametrize("shape", [(4, 3), (2, 3, 5)])
def testMSETwin(shape):
    """The gradient, the error and the validation error."""
    _, _, _, JCost, _, jgpu, _ = _jax()
    rng = np.random.RandomState(6)
    pred, target = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)

    jcost, tcost = JCost.MSE(), TMSE()
    jerr, jgrad = jcost(jgpu.to_gpu(pred), jgpu.to_gpu(target))
    terr, tgrad = tcost(torch.from_numpy(pred), torch.from_numpy(target))

    assert terr == pytest.approx(jerr, rel=1e-6)
    _close(tgrad, jgrad)
    assert tcost.validate(torch.from_numpy(pred), torch.from_numpy(target)) == \
        pytest.approx(jcost.validate(jgpu.to_gpu(pred), jgpu.to_gpu(target)), rel=1e-6)

    with pytest.raises(CostError):
        tcost(torch.from_numpy(pred), torch.zeros((shape[0], 7)))


# -- the IMDB nets -----------------------------------------------------------------------------

_JAX_BUILDERS = {"lstm": "testlib.rnnimdbtrain", "bilstm": "testlib.birnnimdbtrain", "cnn": "testlib.cnnimdbtrain"}


@pytest.mark.parametrize("kind", Seq.NETS)
def testImdbNetTwin(kind):
    """Each net of ``sequenceslice`` at a vocabulary of 50 and 8 to 12
    tokens against the testlib script's net: the same weights from
    ``np.random.seed(0)``, 3 shuffled ``Adam(1e-3)`` steps of 4 in global
    state with ``BCE`` through ``Trainer`` on the same dropout draws, the
    per-step losses within 1e-5 relative, the weights within 1e-5, and the
    ``Validator``'s error over 8 rows equal."""
    import importlib

    J, JC, JH, JCost, JOpt, _, _ = _jax()
    from puzzlelib_tpu_torch import handlers as TH
    from puzzlelib_tpu_torch.cost import BCE as TBCE
    from puzzlelib_tpu_torch.optimizers import Adam as TAdam

    widths = dict(numwords=50, maxlen=12 if kind == "cnn" else 8)
    if kind == "cnn":
        widths["embsize"] = 10

    np.random.seed(0)
    jnet = importlib.import_module(_JAX_BUILDERS[kind]).buildNet(**widths)
    tnet = Seq.build(kind, **widths)

    table = _table(jnet)
    assert all(np.array_equal(ary, table[name]) for name, ary in paramsToNumpy(tnet).items())
    paramsFromNumpy(tnet, table)
    _injectDropouts(jnet, tnet)

    x, y = Seq.data(kind, 12, **widths)
    vx, vy = Seq.data(kind, 8, seed=2, **widths)

    def train(handlers, bce, opt, net):
        opt.setupOn(net, useGlobalState=True)
        losses = []
        trainer = handlers.Trainer(net, bce(), opt, batchsize=4,
                                   onBatchFinish=lambda h: losses.append(h.cost.getError()))
        np.random.seed(5)
        trainer.trainFromHost(x, y, macroBatchSize=len(x))
        return losses, handlers.Validator(net, bce(), batchsize=4).validateFromHost(vx, vy)

    jlosses, jerr = train(JH, JCost.BCE, JOpt.Adam(alpha=Seq.ALPHA), jnet)
    tlosses, terr = train(TH, TBCE, TAdam(alpha=Seq.ALPHA), tnet)

    assert len(tlosses) == 3
    assert np.allclose(tlosses, jlosses, rtol=1e-5, atol=0.0), (tlosses, jlosses)
    assert terr == jerr

    jtable = _table(jnet)
    for name, ary in paramsToNumpy(tnet).items():
        _close(ary, jtable[name])


def testSequenceSliceRoutesOnCpu():
    """``sequenceslice.buildRun`` on the CPU: the three routes of a narrowed
    LSTM give the same losses (the hand kernels run their plain versions
    there), each ``train`` starts from the same weights, and validation
    gives one error."""
    widths = dict(numwords=40, maxlen=6)
    run = Seq.buildRun("lstm", net=Seq.build("lstm", **widths), batch=4)
    x, y = Seq.data("lstm", 12, **widths)

    results = {}
    for algo in ("hopper", "torch", "fused", "hopper"):
        losses = []
        run.train(algo, x, y, losses)
        results.setdefault(algo, []).append(losses)

    assert results["hopper"][0] == results["hopper"][1] == results["torch"][0]
    assert np.allclose(results["fused"][0], results["hopper"][0], rtol=1e-5)
    assert 0.0 <= run.validate("hopper", x, y)[0] <= 1.0


# -- Wave2Letter ------------------------------------------------------------------------------

def _narrowW2L(convBlock, Sequential):
    net = Sequential(name="w2l")
    for i, (inm, outm, size, stride, pad, dropout, dilation, bnAct) in enumerate(NARROW_W2L):
        net.extend(convBlock(inm, outm, size=size, stride=stride, pad=pad, dropout=dropout, initscheme=None,
                             dilation=dilation, bnAct=bnAct, name="conv1d_%d" % i))
    return net


def _gradTable(net):
    return {name: _host(var.grad) for var, names in net.getVarTable().items() for name in names}


def testW2LNarrowCtcStepsTwin():
    """A narrow Wave2Letter (every kind of block of ``_LAYOUT``) through
    ``testlib/ctctrain.py``'s loop with ``Adam(1e-3)`` in global state and
    ``CTC(blank=0, vocabsize=29)``, on the same dropout draws: the JAX
    package's loop against ``sequenceslice.W2LRun``.  After the first step,
    its gradients within W2L_GRAD_BOUND of max |want| and the running stats
    within 1e-5; the losses of two steps within 1e-5 relative.  Adam's first
    step moves a weight by the rate in its gradient's sign whatever the
    gradient's size, so a weight whose gradient lies below the packages'
    differences may move the other way: the weights are held within 1e-5
    but for one in a thousand, and all within two steps of the rate.  A conv
    bias before a batch norm has a gradient of zero but for rounding: those
    biases are held to the two steps alone."""
    J, JC, _, JCost, JOpt, jgpu, _ = _jax()
    from puzzlelib_tpu.backend.memory import moveaxis as jMoveaxis
    from puzzlelib_tpu.models.nets import wavetoletter as JW2L

    np.random.seed(0)
    jnet = _narrowW2L(JW2L.convBlock, JC.Sequential)
    np.random.seed(0)
    tnet = _narrowW2L(TW2L.convBlock, TSequential)
    assert all(np.array_equal(ary, _table(jnet)[name]) for name, ary in paramsToNumpy(tnet).items())

    frames, labels, lengths = Seq.w2lData(8, frames=120, inmaps=13, labelRange=(5, 12))
    offsets = np.concatenate([[0], np.cumsum(lengths)])

    jopt = JOpt.Adam(alpha=1e-3)
    jopt.setupOn(jnet, useGlobalState=True)
    jcost = JCost.CTC(blank=0, vocabsize=29)
    _injectDropouts(jnet, tnet)

    jlosses, jfirst = [], None
    for i in range(0, 8, 4):
        out = jnet(jgpu.to_gpu(frames[i:i + 4]))
        datalen = jgpu.to_gpu(np.full(4, out.shape[2], dtype=np.int32))
        error, grad = jcost((jMoveaxis(out, 2, 0), datalen),
                            (jgpu.to_gpu(labels[offsets[i]:offsets[i + 4]]), jgpu.to_gpu(lengths[i:i + 4])))
        jopt.zeroGradParams()
        jnet.backward(jMoveaxis(grad, 0, 2), updGrad=False)
        jopt.update()
        jnet.reset()
        jlosses.append(jcost.getError())
        jfirst = (_gradTable(jnet), _table(jnet), _jattrs(jnet)) if jfirst is None else jfirst

    run = Seq.W2LRun(tnet, alpha=1e-3, batch=4)
    first = []
    run.train(frames[:4], labels[:offsets[4]], lengths[:4], first)

    jgrads, jtable, jattrs = jfirst
    for name, ary in _gradTable(tnet).items():
        _close(ary, jgrads[name], W2L_GRAD_BOUND)

    for name, ary in paramsToNumpy(tnet).items():
        diff = np.abs(ary - jtable[name])
        assert diff.max() <= 2 * 1e-3 * (1 + 1e-3), name

        if not (name.endswith("_conv.b") and name != "conv1d_%d_conv.b" % (len(NARROW_W2L) - 1)):
            assert (diff > 1e-5 * max(1.0, np.abs(jtable[name]).max())).mean() <= 1e-3, name

    tattrs = attrsToNumpy(tnet)
    assert sorted(tattrs) == sorted(jattrs) and len(tattrs) == 8
    for name, ary in tattrs.items():
        _close(ary, jattrs[name])

    _injectDropouts(jnet, tnet)
    tlosses = []
    run.train(frames, labels, lengths, tlosses)

    assert first[0] == tlosses[0]
    assert np.allclose(tlosses, jlosses, rtol=1e-5, atol=0.0), (tlosses, jlosses)
    assert tlosses[1] < tlosses[0]

    scores, _ = run.serve(frames)
    assert scores.shape == (8, 29, 60) and np.isfinite(scores).all()


def testW2LShape(monkeypatch):
    """The twin of the JAX package's ``testW2LShape``: 161 features over
    200 frames give 29 scores over 100 steps; 106.8 M parameters.  Built
    without initialising or gradient buffers (``initscheme="none"``,
    ``globalEvalMode``)."""
    monkeypatch.setattr(TConfig, "globalEvalMode", True)
    net = tLoadW2L(None, inmaps=161, nlabels=29, initscheme="none")

    assert net.dataShapeFrom((1, 161, 200)) == (1, 29, 100)
    assert net.numOfParams() == 106779293

    with pytest.raises(NotImplementedError):
        tLoadW2L("w2l.hdf", inmaps=161, nlabels=29)


# -- on the card ------------------------------------------------------------------------------

def _needsCard():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the 1-d modules' CUDA path runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def testOneDModulesOnCardMatchCpu(dtype, monkeypatch):
    """Conv1D (strided, dilated), reflect Pad1D, MaxPool1D and AvgPool1D in
    a row on the card against the CPU, forward and backward, in f32 (TF32
    off) at 1e-5 and bf16 at 5e-2; the conv's weight gradient repeats bit
    for bit."""
    _needsCard()
    x = np.random.RandomState(1).randn(4, 8, 64).astype(np.float32)

    results = []
    for device in ("cpu", "cuda"):
        monkeypatch.setattr(TConfig, "device", device)
        np.random.seed(3)
        net = TSequential()
        net.append(T.Pad1D(4, mode="reflect"))
        net.append(T.Conv1D(8, 16, 5, stride=2, dilation=2))
        net.append(T.MaxPool1D(3, 2, 1))
        net.append(T.AvgPool1D(2, 2))
        net.calcMode(dtype)

        out = net(torch.from_numpy(x).to(device, dtype))
        grad = torch.from_numpy(np.random.RandomState(2).randn(*out.shape).astype(np.float32)).to(device, dtype)
        net.backward(grad)
        first = net.graph[1].vars["W"].grad.clone()
        net.graph[1].vars["W"].grad.zero_()
        net(torch.from_numpy(x).to(device, dtype))
        net.backward(grad)
        assert torch.equal(first, net.graph[1].vars["W"].grad)
        results.append([out, net.grad, first])

    bound = BOUNDS["f32" if dtype == torch.float32 else "bf16"]
    for got, want in zip(results[1], results[0]):
        assert got.is_cuda
        _close(got, want, bound)


def _noDropout(net):
    """``net`` with its dropouts at p = 0: the CPU's and the card's
    generators draw different masks."""
    for mod in net.graph:
        if isinstance(mod, T.Dropout):
            mod.p = 0.0

    return net


@pytest.mark.cuda
def testNarrowSliceOnCard(monkeypatch):
    """The narrowed IMDB CNN and LSTM trained on the card's hand route
    (dropout off): K1 takes each head a step and the losses follow the
    CPU's within 1e-4; the narrow Wave2Letter's two CTC steps on the card
    follow the CPU's within 1e-4."""
    _needsCard()
    from puzzlelib_tpu_torch.ops.hopper import matmul

    for kind, widths in (("cnn", dict(numwords=50, maxlen=12, embsize=10)), ("lstm", dict(numwords=50, maxlen=8))):
        x, y = Seq.data(kind, 12, **widths)
        losses = {}
        for device in ("cpu", "cuda"):
            monkeypatch.setattr(TConfig, "device", device)
            run = Seq.buildRun(kind, net=_noDropout(Seq.build(kind, **widths)), batch=4)
            before = matmul.launches
            losses[device] = []
            run.train("hopper", x, y, losses[device])
            launches = matmul.launches - before

        assert launches == 3 * len(Seq.GEMMS[kind])
        assert np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4, atol=0.0)

    frames, labels, lengths = Seq.w2lData(8, frames=120, inmaps=13, labelRange=(5, 12))
    w2l = {}
    for device in ("cpu", "cuda"):
        monkeypatch.setattr(TConfig, "device", device)
        np.random.seed(0)
        run = Seq.W2LRun(_noDropout(_narrowW2L(TW2L.convBlock, TSequential)), alpha=1e-3, batch=4)
        w2l[device] = []
        run.train(frames, labels, lengths, w2l[device])

    assert np.allclose(w2l["cuda"], w2l["cpu"], rtol=1e-4, atol=0.0)
