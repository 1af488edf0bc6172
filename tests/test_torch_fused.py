"""The fused step against the JAX package's: ``FusedStep`` (``__call__`` and
``many``), ``FusedTrainer``, ``FusedValidator`` and ``FusedCalculator``, and
what they stand on (``fusedctx``, the buffer collectors, the updates'
device-side scalars, the generators' reseeding).

On the CPU the port's fused classes run the eager step body under
``fusedctx``, the body that a CUDA graph records on the card.  Each twin
builds the JAX package's fused class and the port's from the same numpy seed
(``convert.paramsFromNumpy``) and holds them to each other: f32 within 1e-5
and bf16 within 5e-2 of max(1, max |want|), the reference's dtype tiers.
The JAX package's "flash" attention runs its XLA route on the CPU; the JAX
package cannot train the transformer in bf16 (ROADMAP Queue 3), so the bf16
twins hold the port to its f32 run.  The key biases ``bk`` have an exact
gradient of zero, so Adam moves them on round-off by up to alpha a step in
either direction: they are held to 2 * alpha * steps, as in
``test_torch_transformer_train.py``.  An entry whose first gradient lies
near Adam's epsilon is held to the gap that Adam's first step can make of
the gradients' f32 gap (``_adamSlack``).  The card-only cases (``cuda``
marker) record and replay CUDA graphs."""

import functools

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import fused, fusedctx
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.convert import optimizerStateToNumpy, paramsFromNumpy, paramsToNumpy
from puzzlelib_tpu_torch.cost import CrossEntropy as TCrossEntropy
from puzzlelib_tpu_torch.handlers import Trainer, Validator
from puzzlelib_tpu_torch.models.nets import buildTransformerClassifier as tBuild
from puzzlelib_tpu_torch.models.nets import loadLeNet as tLoadLeNet
from puzzlelib_tpu_torch.ops import elementwise as ew
from puzzlelib_tpu_torch.optimizers import Adam as TAdam
from puzzlelib_tpu_torch.optimizers import MomentumSGD as TMomentumSGD
from puzzlelib_tpu_torch.optimizers import hooks as THooks
from puzzlelib_tpu_torch.rng import RandomNumberGenerator
from puzzlelib_tpu_torch.tools import cnnslice


BOUNDS = {"f32": 1e-5, "bf16": 5e-2}

# the narrow classifier of test_torch_transformer_train.py
NARROW = dict(vocabsize=50, seqlen=16, embsize=64, nheads=2, nlayers=2, nclasses=3)
ALPHA, BATCH, STEPS, K = 1e-3, 8, 3, 3


def _jax():
    """The JAX package's pieces for the twins; they skip where it does not
    import, as on the card's machine, where only the card-only cases run."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import cost, fused as jfused, handlers, modules, optimizers
    from puzzlelib_tpu.backend import gpuarray

    return modules, handlers, cost, optimizers, jfused, gpuarray


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()

    return np.asarray(value, dtype=np.float32)


def _close(got, want, bound):
    got, want = _host(got), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _jtable(jnet):
    return {name: np.asarray(var.data.get(), np.float32) for var, names in jnet.getVarTable().items()
            for name in names}


def _assertWeights(ttable, jtable, bound, steps, slack=None):
    """Every weight within ``bound`` of max(1, max |want|), ``bk`` within
    2 * alpha * steps; ``slack`` (a table of per-entry allowances, from
    ``_adamSlack``) widens the bound entry by entry."""
    assert sorted(ttable) == sorted(jtable)
    for name, want in jtable.items():
        gap = np.abs(ttable[name] - want)
        if name.endswith(".bk"):
            assert gap.max() <= max(2 * ALPHA * steps, bound), name
        else:
            extra = 0.0 if slack is None else slack[name]
            assert (gap <= bound * max(1.0, np.abs(want).max()) + extra).all(), (name, gap.max())


def _grads(net, cost, upload):
    """Each variable's gradient of one eager forward and backward on the
    first batch of ``_driveStep``, by name."""
    x, y = (ary[:BATCH] for ary in _tokens((STEPS + K) * BATCH))
    _, grad = cost(net(upload(x)), upload(y))
    net.backward(grad, updGrad=False)
    return {name: np.asarray(_host(var.grad) if isinstance(var.grad, torch.Tensor) else var.grad.get(), np.float32)
            for var, names in net.getVarTable().items() for name in names}


def _adamSlack(tgrads, jgrads, beta2=0.999, epsilon=1e-8):
    """What Adam's first step can make of the gradients' gap, entry by entry.

    The first step moves an entry by s(g) = lr * (1 - beta1) g / (sqrt((1 -
    beta2) g^2) + epsilon) with lr = alpha * sqrt(1 - beta2) / (1 - beta1),
    that is by s(g) = alpha * g / (|g| + e) with e = epsilon / sqrt(1 -
    beta2) (3.16e-7 at the defaults).  Its slope is alpha * e / (|g| + e)^2:
    alpha / e (3162 * alpha) at g = 0, and ~alpha * e / g^2 once |g| >> e,
    where every step is ~alpha whatever the gradient's last bits.  Two
    gradients d apart in an entry whose |g| lies within d of 0 to a few e
    thus give steps up to alpha * d / e apart.  With d the variable's
    largest gradient gap (held to the f32 tier of the gradient's own scale
    first), the entry's allowance is d times the slope's largest value on
    [|g| - d, |g| + d]: alpha * e * d / (max(|g| - d, 0) + e)^2.  Entries
    far from 0 get ~0.  ``bk`` (an exact zero gradient, moved on round-off
    at every step) skips the gradient check and keeps a bound of its own.  The later steps add no
    such gap where the entries' gradients have moved off 0: the weights
    after all the steps are held to this one-step allowance, so a gap that
    grows later fails."""
    e = epsilon / np.sqrt(1.0 - beta2)
    slack = {}
    for name, want in jgrads.items():
        got = tgrads[name]
        gap = np.abs(got - want).max()
        if not name.endswith(".bk"):
            assert gap <= BOUNDS["f32"] * np.abs(want).max(), (name, gap)

        near = np.maximum(np.abs(want) - gap, 0.0) + e
        slack[name] = ALPHA * e * gap / near ** 2

    return slack


# -- the transformer: FusedStep and FusedTrainer ---------------------------------------------------

def _tokens(rows, seed=43):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(-1, NARROW["vocabsize"], size=(rows, NARROW["seqlen"])).astype(np.int32)
    return tokens, rng.randint(0, NARROW["nclasses"], size=rows).astype(np.int32)


def _jaxTransformer(algo):
    """The JAX package's narrow classifier in f32 with Adam in global state:
    (net, cost, optimizer)."""
    _, _, JCost, JOpt, _, _ = _jax()
    from puzzlelib_tpu.models.nets.transformer import buildTransformerClassifier as jBuild

    np.random.seed(44)
    jnet = jBuild(**NARROW, attnAlgo=algo)
    jopt = JOpt.Adam(alpha=ALPHA)
    jopt.setupOn(jnet, useGlobalState=True)
    return jnet, JCost.CrossEntropy(maxlabels=NARROW["nclasses"]), jopt


def _portTransformer(algo, dtype="f32"):
    """The port's narrow classifier with the JAX package's start weights (the
    same numpy seed and sampler), in ``dtype``, with Adam in global state."""
    np.random.seed(44)
    tnet = tBuild(**NARROW, attnAlgo=algo)
    if dtype == "bf16":
        tnet.calcMode(torch.bfloat16)

    topt = TAdam(alpha=ALPHA)
    topt.setupOn(tnet, useGlobalState=True)
    return tnet, TCrossEntropy(maxlabels=NARROW["nclasses"]), topt


def _driveStep(step, cost, upload):
    """STEPS single steps of BATCH, then ``many`` over K more: (the single
    steps' losses, the error after ``many``, the mean error of all)."""
    tokens, labels = _tokens((STEPS + K) * BATCH)
    losses = []
    for i in range(STEPS):
        rows = slice(i * BATCH, (i + 1) * BATCH)
        step(upload(tokens[rows]), upload(labels[rows]))
        losses.append(cost.getError())

    rows = slice(STEPS * BATCH, (STEPS + K) * BATCH)
    step.many(upload(tokens[rows]), upload(labels[rows]), steps=K)
    return losses, cost.getError(), cost.getMeanError()


@functools.lru_cache(maxsize=None)
def _jaxStepRun(algo):
    """The JAX package's FusedStep on the narrow classifier: the losses and
    errors of ``_driveStep``, the weights and the Adam tables after it."""
    _, _, _, _, jfused, jgpu = _jax()
    grads = _grads(*_jaxTransformer(algo)[:2], jgpu.to_gpu)

    jnet, jcost, jopt = _jaxTransformer(algo)
    step = jfused.FusedStep(jnet, jcost, jopt)
    run = _driveStep(step, jcost, jgpu.to_gpu)
    adam = {"%s.%s" % (key, entity): np.asarray(t.get()) for key, state in jopt.states.items()
            for entity, t in state.items()}
    return run, _jtable(jnet), adam, jopt.t, grads


@pytest.mark.parametrize("dtype", sorted(BOUNDS))
@pytest.mark.parametrize("algo", ["xla", "flash"])
def testFusedStepTwin(algo, dtype):
    """3 single ``FusedStep`` calls, then ``many`` over 3 more batches, with
    Adam in global state, against the JAX package's FusedStep from the same
    weights: the single steps' losses, ``getError()`` after ``many`` (the
    mean over its 3 * 8 samples), the mean error of all 6 steps, the
    weights and (f32) the Adam tables; t is 6 in both.  In f32 the first
    step's gradients agree within the f32 tier of their own scale, and the
    weights may part further where ``_adamSlack`` allows it."""
    (want, wantMany, wantMean), jtable, jadam, jt, jgrads = _jaxStepRun(algo)

    slack = None
    if dtype == "f32":
        slack = _adamSlack(_grads(*_portTransformer(algo)[:2], torch.from_numpy), jgrads)

    tnet, tcost, topt = _portTransformer(algo, dtype)
    step = fused.FusedStep(tnet, tcost, topt)
    got, gotMany, gotMean = _driveStep(step, tcost, torch.from_numpy)

    bound = BOUNDS[dtype]
    _close(got, want, bound)
    _close(gotMany, wantMany, bound)
    _close(gotMean, wantMean, bound)
    assert topt.t == jt == STEPS + K and tcost.batchsize == K * BATCH
    _assertWeights(paramsToNumpy(tnet), jtable, bound, STEPS + K, slack)

    if dtype == "f32":
        tadam = optimizerStateToNumpy(topt)
        assert sorted(tadam) == sorted(jadam)
        for name, ref in jadam.items():
            _close(tadam[name], ref, bound)
    else:
        assert set(topt.shParams) == {torch.float32, torch.bfloat16}


@pytest.mark.parametrize("stepsPerDispatch", [1, 2])
def testFusedTrainerTwin(stepsPerDispatch):
    """``FusedTrainer`` over 5 full batches of 8 and a partial one of 3 (at 2
    steps a dispatch: two ``many`` calls, a leftover full batch and the
    partial one through single steps), shuffled under one numpy seed: the
    JAX package's batch order (numpy's stream ends where the reference's
    does), mean error and weights."""
    jfused = _jax()[4]
    tokens, labels = _tokens(5 * BATCH + 3, seed=45)

    def train(trainerCls, net, cost, opt):
        trainer = trainerCls(net, cost, opt, batchsize=BATCH, stepsPerDispatch=stepsPerDispatch)
        np.random.seed(7)
        trainer.trainFromHost(tokens, labels, macroBatchSize=len(tokens))
        return trainer, cost.getMeanError(), np.random.randint(1 << 30)

    jnet, jcost, jopt = _jaxTransformer("flash")
    jtrainer, want, wantNext = train(jfused.FusedTrainer, jnet, jcost, jopt)

    tnet, tcost, topt = _portTransformer("flash")
    ttrainer, got, gotNext = train(fused.FusedTrainer, tnet, tcost, topt)

    assert gotNext == wantNext
    assert (ttrainer.currBatch, ttrainer.totalBatches) == (jtrainer.currBatch, jtrainer.totalBatches) == (6, 6)
    assert topt.t == jopt.t == 6 and tcost.numOfSamples == jcost.numOfSamples == len(tokens)
    _close(got, want, BOUNDS["f32"])
    _assertWeights(paramsToNumpy(tnet), _jtable(jnet), BOUNDS["f32"], 6)


def testFusedTrainerGroupsOnlyWithoutACallback(monkeypatch):
    """``stepsPerDispatch`` groups batches into ``many`` calls; a per-batch
    callback makes every batch a single step, as in the reference."""
    calls = []
    monkeypatch.setattr(fused.FusedStep, "many", lambda self, d, t, steps: calls.append(("many", steps)))
    monkeypatch.setattr(fused.FusedStep, "__call__", lambda self, d, t: calls.append(("step", d.shape[0])))
    tokens, labels = _tokens(5 * BATCH + 3)

    for callback in (None, lambda h: None):
        tnet, tcost, topt = _portTransformer("xla")
        fused.FusedTrainer(tnet, tcost, topt, onBatchFinish=callback, batchsize=BATCH,
                           stepsPerDispatch=2).trainFromHost(tokens, labels)

    assert calls[:4] == [("many", 2), ("many", 2), ("step", BATCH), ("step", 3)]
    assert sorted(calls[4:]) == sorted([("step", BATCH)] * 5 + [("step", 3)])


def testFusedStepKeepsThePythonSideCounters():
    """The hyper-parameters are the optimizer's Python floats again after a
    call; t, the cost's sample counts and the mean error advance as the
    eager Trainer's do (``many``: K steps, K * b samples)."""
    tnet, tcost, topt = _portTransformer("xla")
    step = fused.FusedStep(tnet, tcost, topt)
    tokens, labels = _tokens(4 * BATCH)

    step(torch.from_numpy(tokens[:BATCH]), torch.from_numpy(labels[:BATCH]))
    assert topt.t == 1 and (tcost.batchsize, tcost.numOfSamples) == (BATCH, BATCH)
    step.many(torch.from_numpy(tokens[BATCH:]), torch.from_numpy(labels[BATCH:]), steps=3)
    assert topt.t == 4 and (tcost.batchsize, tcost.numOfSamples) == (3 * BATCH, 4 * BATCH)

    for name in ("alpha", "beta1", "beta2", "epsilon", "learnRate"):
        assert type(getattr(topt, name)) is float, name
    assert not fusedctx.active()
    assert np.isfinite(tcost.getError()) and np.isfinite(tcost.getMeanError())

    with pytest.raises(ValueError, match="divisible"):
        step.many(torch.from_numpy(tokens[:10]), torch.from_numpy(labels[:10]), steps=3)


# -- LeNet and the CIFAR-10 NIN: MomentumSGD, hooks, dropout -------------------------------------------

def _lenetTwins():
    J, _, _, _, _, _ = _jax()
    from puzzlelib_tpu.models.nets.lenet import loadLeNet

    np.random.seed(0)
    jnet = loadLeNet(None, initscheme=None)
    tnet = tLoadLeNet(None, initscheme=None)
    paramsFromNumpy(tnet, _jtable(jnet))
    return jnet, tnet


def testMomentumSGDLocalStateHooksAndRateChangeTwin():
    """LeNet with ``MomentumSGD`` in local state, ``WeightDecay`` (``wc`` set
    on every variable) and ``GradClip``: two steps, the learning rate raised
    between calls, two more, against the JAX package's FusedStep: the losses
    and weights.  Without the change the port's weights differ: the new
    rate acts in the same step object."""
    _, _, JCost, JOpt, jfused, jgpu = _jax()
    from puzzlelib_tpu.optimizers import hooks as JHooks

    x, y = cnnslice.data("lenet", 4 * 16)

    def run(H, Opt, Cost, Step, net, upload, change=True):
        opt = Opt.MomentumSGD(0.01, momRate=0.9)
        opt.addHook(H.WeightDecay(1e-3))
        opt.addHook(H.GradClip(1.0))
        opt.setupOn(net, useGlobalState=False)
        for var in net.getVarTable():
            var.wc = 1.0

        cost = Cost(maxlabels=10)
        step, losses = Step(net, cost, opt), []
        for i in range(4):
            if i == 2 and change:
                opt.learnRate = 0.05

            step(upload(x[i * 16:(i + 1) * 16]), upload(y[i * 16:(i + 1) * 16]))
            losses.append(cost.getError())

        return losses

    jnet, tnet = _lenetTwins()
    start = {name: ary.copy() for name, ary in paramsToNumpy(tnet).items()}
    want = run(JHooks, JOpt, JCost.CrossEntropy, jfused.FusedStep, jnet, jgpu.to_gpu)

    from puzzlelib_tpu_torch import optimizers as TOpt
    got = run(THooks, TOpt, TCrossEntropy, fused.FusedStep, tnet, torch.from_numpy)
    _close(got, want, BOUNDS["f32"])
    _assertWeights(paramsToNumpy(tnet), _jtable(jnet), BOUNDS["f32"], 4)

    plain = tLoadLeNet(None, initscheme=None)
    paramsFromNumpy(plain, start)
    same = run(THooks, TOpt, TCrossEntropy, fused.FusedStep, plain, torch.from_numpy, change=False)
    assert same[:2] == got[:2] and same[2:] != got[2:]

    weights, plainWeights = paramsToNumpy(tnet), paramsToNumpy(plain)
    assert all(not np.array_equal(weights[name], plainWeights[name]) for name in weights)


class _FixedDraws:
    """The same seeded uint32 draws at every call, per module name: the JAX
    package's FusedStep draws while it traces, once, and its program reuses
    those draws at every step."""

    def __init__(self, seed):
        self.seed = seed

    def inject(self, mod, name, asTensor):
        def draw(size):
            rng = np.random.RandomState([self.seed, sum(map(ord, name))])
            return asTensor(rng.randint(0, 2 ** 32, size=size, dtype=np.uint64).astype(np.uint32))

        mod._drawRands = draw


def testCifarNINDropoutTwin(monkeypatch):
    """The quarter-width CIFAR-10 NIN (two dropouts, on injected draws) with
    ``MomentumSGD`` and ``WeightDecay`` in global state: two single steps,
    then ``many`` over two batches, against the JAX package's FusedStep:
    the losses, the error after ``many`` and the weights."""
    _, _, JCost, JOpt, jfused, jgpu = _jax()
    from puzzlelib_tpu.optimizers import hooks as JHooks
    from testlib import cnncifar10nin

    from test_torch_cnn import _quarter

    monkeypatch.setattr(cnncifar10nin, "NIN_BLOCKS", _quarter(cnncifar10nin.NIN_BLOCKS))
    np.random.seed(0)
    jnet = cnncifar10nin.buildNet()
    tnet = cnnslice.buildNet(_quarter(cnnslice.NIN_BLOCKS))
    paramsFromNumpy(tnet, _jtable(jnet))

    for name in ("drop3", "drop6"):
        _FixedDraws(11).inject(jnet[name], name, jgpu.to_gpu)
        _FixedDraws(11).inject(tnet[name], name, lambda ary: torch.from_numpy(ary.astype(np.int64)))

    x, y = cnnslice.data("nin-cifar", 4 * 8)

    def run(H, Opt, Cost, Step, net, upload):
        opt = Opt.MomentumSGD(0.01, momRate=0.9)
        opt.addHook(H.WeightDecay(1e-4))
        opt.setupOn(net, useGlobalState=True)
        cost = Cost(maxlabels=10)
        step, errors = Step(net, cost, opt), []

        for i in range(2):
            step(upload(x[i * 8:(i + 1) * 8]), upload(y[i * 8:(i + 1) * 8]))
            errors.append(cost.getError())

        step.many(upload(x[16:]), upload(y[16:]), steps=2)
        return errors + [cost.getError()]

    want = run(JHooks, JOpt, JCost.CrossEntropy, jfused.FusedStep, jnet, jgpu.to_gpu)

    from puzzlelib_tpu_torch import optimizers as TOpt
    got = run(THooks, TOpt, TCrossEntropy, fused.FusedStep, tnet, torch.from_numpy)

    _close(got, want, BOUNDS["f32"])
    _assertWeights(paramsToNumpy(tnet), _jtable(jnet), BOUNDS["f32"], 4)


# -- FusedValidator and FusedCalculator ----------------------------------------------------------------

def _evalTwins(kind):
    """(JAX net, port net with its weights, data, labels): 21 rows, so that
    batches of 8 end in a ragged one of 5."""
    if kind == "lenet":
        jnet, tnet = _lenetTwins()
        data, labels = cnnslice.data("lenet", 21)
        return jnet, tnet, data, labels

    jnet, _, _ = _jaxTransformer("flash")
    tnet = tBuild(**NARROW, attnAlgo="flash")
    paramsFromNumpy(tnet, _jtable(jnet))
    data, labels = _tokens(21, seed=46)
    return jnet, tnet, data, labels


@pytest.mark.parametrize("kind", ["transformer", "lenet"])
def testFusedValidatorTwin(kind):
    """``validateFromHost`` in batches of 8 with a ragged last one: the JAX
    package's FusedValidator's error, and the port's eager Validator's to
    the bit."""
    _, _, JCost, _, jfused, _ = _jax()
    jnet, tnet, data, labels = _evalTwins(kind)

    want = jfused.FusedValidator(jnet, JCost.CrossEntropy(), batchsize=8).validateFromHost(data, labels)
    validator = fused.FusedValidator(tnet, TCrossEntropy(), batchsize=8)
    got = validator.validateFromHost(data, labels)

    assert abs(got - want) <= BOUNDS["f32"] and 0.0 <= got <= 1.0
    assert got == Validator(tnet, TCrossEntropy(), batchsize=8).validateFromHost(data, labels)
    assert validator.validate(torch.from_numpy(data), torch.from_numpy(labels)) == got


@pytest.mark.parametrize("kind", ["transformer", "lenet"])
def testFusedCalculatorTwin(kind):
    """``calcFromHost`` in batches of 8 with a ragged last one: the JAX
    package's FusedCalculator's outputs."""
    _, _, _, _, jfused, _ = _jax()
    jnet, tnet, data, _ = _evalTwins(kind)

    want = jfused.FusedCalculator(jnet, batchsize=8).calcFromHost(data)
    got = fused.FusedCalculator(tnet, batchsize=8).calcFromHost(data)

    assert got.shape == want.shape == (21, NARROW["nclasses"] if kind == "transformer" else 10)
    _close(got, want, BOUNDS["f32"])


def testFusedValidatorTakesTheEagerPathForCostsWithoutCalcValDev():
    """A cost with no ``calcValDev`` (only the host-side ``calcVal``) goes
    the reference's eager way, one ``cost.validate`` a batch, as the JAX
    package's FusedValidator does: the same error as the Validator's."""
    class HostOnly(TCrossEntropy):
        def calcValDev(self, pred, target):
            raise NotImplementedError()

        def calcVal(self, pred, target):
            return TCrossEntropy.calcValDev(self, pred, target).item()

    np.random.seed(0)
    net = tLoadLeNet(None, initscheme=None)
    data, labels = cnnslice.data("lenet", 21)

    validator = fused.FusedValidator(net, HostOnly(), batchsize=8)
    got = validator.validateFromHost(data, labels)
    assert validator._fallback and validator._program is None
    assert got == Validator(net, TCrossEntropy(), batchsize=8).validateFromHost(data, labels)


# -- refusals, collectors, scalars -----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["step", "many", "validator", "calculator"])
def testVerifyDataIsRefused(monkeypatch, kind):
    """``Config.verifyData`` reads the labels back at every batch, which a
    graph cannot hold: every fused entry refuses it, naming it."""
    np.random.seed(0)
    net = tLoadLeNet(None, initscheme=None)
    opt = TMomentumSGD(0.01)
    opt.setupOn(net, useGlobalState=True)
    data, labels = cnnslice.data("lenet", 8)
    monkeypatch.setattr(TConfig, "verifyData", True)

    calls = {
        "step": lambda: fused.FusedStep(net, TCrossEntropy(), opt)(torch.from_numpy(data), torch.from_numpy(labels)),
        "many": lambda: fused.FusedStep(net, TCrossEntropy(), opt).many(data, labels, steps=2),
        "validator": lambda: fused.FusedValidator(net, TCrossEntropy(), batchsize=4).validateFromHost(data, labels),
        "calculator": lambda: fused.FusedCalculator(net, batchsize=4).calcFromHost(data),
    }
    with pytest.raises(TConfig.ConfigError, match="Config.verifyData"):
        calls[kind]()

    assert opt.t == 0


def testFusedStepOverAMeshIsNotPorted():
    """The mesh step's sharding specs (model parallelism, which runs:
    ``test_torch_tensorparallel.py``) need the optimizer's local state, as
    the JAX package's docstring says: under global state a spec list raises
    ``ValueError`` before the mesh is touched."""
    np.random.seed(0)
    net = tLoadLeNet(None, initscheme=None)
    opt = TMomentumSGD(0.01)
    opt.setupOn(net, useGlobalState=True)

    with pytest.raises(ValueError, match="stateShardings take an optimizer in local state"):
        fused.FusedStep(net, TCrossEntropy(), opt, mesh=object(), stateShardings=[])


@pytest.mark.parametrize("useGlobalState", [True, False])
def testCollectorsTwin(useGlobalState):
    """The root buffers a step writes, the weights' and the eval forward's:
    as many as the JAX package's collectors find, of the same sizes, in the
    same order; under global state each variable's root is its flat
    buffer."""
    _, _, JCost, JOpt, jfused, _ = _jax()
    jnet, tnet = _lenetTwins()
    jopt, topt = JOpt.MomentumSGD(0.01), TMomentumSGD(0.01)
    jopt.setupOn(jnet, useGlobalState=useGlobalState)
    topt.setupOn(tnet, useGlobalState=useGlobalState)
    jcost, tcost = JCost.CrossEntropy(), TCrossEntropy()

    pairs = [(jfused.collectStateBuffers(jnet, jcost, jopt), fused.collectStateBuffers(tnet, tcost, topt)),
             (jfused.collectParamBuffers(jnet), fused.collectParamBuffers(tnet)),
             (jfused.collectEvalBuffers(jnet), fused.collectEvalBuffers(tnet))]
    for want, got in pairs:
        assert [int(np.prod(buf.shape)) for buf in got] == [int(np.prod(buf.shape)) for buf in want]

    roots = fused.collectStateBuffers(tnet, tcost, topt)
    if useGlobalState:
        assert roots[0].data_ptr() == topt.shParams[torch.float32].ary.data_ptr()
        assert len(roots) == 5   # params, grads, momentum, devErr, accumErr
    assert roots[-2].data_ptr() == tcost.devErr.data_ptr()


def testScalarsRoundOnTheirDevice():
    """A Python scalar is rounded to the tensor's type on the host; a 0-d
    tensor (a fused step's hyper-parameter) is rounded on its device and
    stays a tensor, to the same value."""
    half = ew._scalar(0.1, torch.bfloat16)
    onDevice = ew._scalar(torch.tensor(0.1, dtype=torch.float32), torch.bfloat16)

    assert isinstance(half, float) and isinstance(onDevice, torch.Tensor)
    assert onDevice.dtype == torch.bfloat16 and onDevice.item() == half == 0.10009765625

    param, grad, mom = torch.ones(4), torch.full((4, ), 0.5), torch.full((4, ), 0.25)
    want = (mom.clone(), param.clone())
    ew.classicMomSGD_(want[1], grad, want[0], 0.01, 0.9)
    ew.classicMomSGD_(param, grad, mom, torch.tensor(0.01), torch.tensor(0.9))
    assert torch.equal(mom, want[0]) and torch.equal(param, want[1])


def testAdamTakesItsRateInF32UnderFusedctx():
    """Under ``fusedctx`` Adam reads t from it and takes alpha * sqrt(1 -
    beta2^t) / (1 - beta1^t) as a 0-d f32 tensor, as the reference's traced
    step does; outside, the same rate in f64 on the host."""
    from puzzlelib_tpu_torch.variable import Variable

    var = Variable(torch.ones(3))
    var.grad.fill_(0.5)
    opt = TAdam(alpha=1e-3)
    opt.t = 3
    opt.updateVar(var, opt.setupState(var))
    host = opt.learnRate

    hyper = {name: torch.tensor(float(getattr(opt, name))) for name in ("alpha", "beta1", "beta2", "epsilon")}
    t = torch.tensor(3.0)
    for name, value in hyper.items():
        setattr(opt, name, value)

    with fusedctx.activate(hyper, t):
        opt.updateVar(var, opt.setupState(var))

    # 1 - beta2^t cancels in f32: 1 - 0.999^3 keeps about 4 of its 7 digits
    want = hyper["alpha"] * torch.sqrt(1.0 - hyper["beta2"] ** t) / (1.0 - hyper["beta1"] ** t)
    assert isinstance(opt.learnRate, torch.Tensor) and opt.learnRate.dtype == torch.float32
    assert torch.equal(opt.learnRate, want) and abs(opt.learnRate.item() - host) <= 1e-4 * host


def testFusedctxPassesValuesThroughOutsideAStep():
    assert not fusedctx.active() and fusedctx.stepOr(5) == 5 and fusedctx.hyperOr("alpha", 0.1) == 0.1

    with fusedctx.activate({"alpha": "a"}, "t"):
        assert fusedctx.active() and fusedctx.stepOr(5) == "t"
        assert fusedctx.hyperOr("alpha", 0.1) == "a" and fusedctx.hyperOr("beta1", 0.9) == 0.9

        with fusedctx.activate({}, "u"):
            assert fusedctx.stepOr(5) == "u"
        assert fusedctx.stepOr(5) == "t"

    assert not fusedctx.active()


def testSeedReseedsTheGeneratorsInPlace():
    """``seed`` keeps each device's generator object (a CUDA graph that
    registered it goes on drawing from it) and starts its draws again."""
    rng = RandomNumberGenerator(3)
    gen = rng.generator(torch.device("cpu"))
    first = torch.empty(16, dtype=torch.int64)
    rng.fillInteger(first, high=2 ** 32)

    rng.seed(3)
    again = torch.empty(16, dtype=torch.int64)
    rng.fillInteger(again, high=2 ** 32)

    assert rng.generator(torch.device("cpu")) is gen and torch.equal(first, again)


# -- on the card ---------------------------------------------------------------------------------------

def _onCard(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused step records CUDA graphs of the CUDA C++ kernels")

    monkeypatch.setattr(TConfig, "device", "cuda")


class _CardTransformer:
    """The narrow classifier in bf16 on the card (attnAlgo "flash": K4, K5a,
    K5b, K1) with Adam in global state, an eager Trainer and a FusedTrainer
    on it, and its start values."""

    def __init__(self):
        np.random.seed(44)
        self.net = tBuild(**NARROW, attnAlgo="flash")
        self.net.calcMode(torch.bfloat16)
        self.opt = TAdam(alpha=ALPHA)
        self.opt.setupOn(self.net, useGlobalState=True)
        self.cost = TCrossEntropy(maxlabels=NARROW["nclasses"])
        self.start = {dtype: pack.ary.clone() for dtype, pack in self.opt.shParams.items()}
        self.tokens, self.labels = _tokens(4 * BATCH)
        self.fused = fused.FusedTrainer(self.net, self.cost, self.opt, batchsize=BATCH)
        self.eager = Trainer(self.net, self.cost, self.opt, batchsize=BATCH)

    def train(self, trainer):
        for dtype, pack in self.opt.shParams.items():
            pack.ary.copy_(self.start[dtype])
        for state in self.opt.states.values():
            for tensor in state.values():
                tensor.zero_()
        self.opt.t = 0

        losses = []
        trainer.onBatchFinish = lambda h: losses.append(h.cost.getError())
        np.random.seed(4)
        trainer.trainFromHost(self.tokens, self.labels)
        return losses, {dtype: pack.ary.clone() for dtype, pack in self.opt.shParams.items()}


@pytest.mark.cuda
def testFusedStepOnCardEqualsTheEagerStep(monkeypatch):
    """4 steps recorded once and replayed, against the eager Trainer from the
    same start and batch order: the first step's loss to the bit (the same
    kernels on the same weights), the rest within the bf16 tier (Adam's rate
    is taken in f32 on the device, in f64 on the host eagerly); one
    recording."""
    _onCard(monkeypatch)
    run = _CardTransformer()

    eager, _ = run.train(run.eager)
    got, _ = run.train(run.fused)

    assert got[0] == eager[0] and len(got) == len(eager) == 4
    _close(got, eager, BOUNDS["bf16"])
    assert run.fused.step.captures == 1


@pytest.mark.cuda
def testReplaysRepeatBitForBit(monkeypatch):
    _onCard(monkeypatch)
    run = _CardTransformer()

    first, firstWeights = run.train(run.fused)
    again, againWeights = run.train(run.fused)

    assert first == again
    assert all(torch.equal(firstWeights[dtype], againWeights[dtype]) for dtype in firstWeights)
    assert run.fused.step.captures == 1


@pytest.mark.cuda
def testCountersAddTheRecordedLaunchesAtEachReplay(monkeypatch):
    """Per replayed step: one K4, K5a and K5b launch per attention layer and
    one K1 launch per Linear forward, as the eager step counts them."""
    _onCard(monkeypatch)
    from puzzlelib_tpu_torch.ops.hopper import flash, matmul

    run = _CardTransformer()
    run.train(run.fused)

    def counts():
        return flash.launches, flash.launchesDq, flash.launchesDkv, matmul.launches

    before = counts()
    run.train(run.fused)
    fusedCounts = tuple(a - b for a, b in zip(counts(), before))

    before = counts()
    run.train(run.eager)
    eagerCounts = tuple(a - b for a, b in zip(counts(), before))

    assert fusedCounts == eagerCounts == (2 * 4, 2 * 4, 2 * 4, 5 * 4)


def _cardLeNet(lr=0.01, mom=0.9, useGlobalState=False):
    np.random.seed(0)
    net = tLoadLeNet(None, initscheme=None)
    opt = TMomentumSGD(lr, momRate=mom)
    opt.setupOn(net, useGlobalState=useGlobalState)
    return net, opt


@pytest.mark.cuda
def testAReboundWeightIsRecordedAnew(monkeypatch):
    """A variable rebound to a new tensor moves an address the graph holds:
    the next call records anew and trains the new tensor, and the old one
    is left as it was."""
    _onCard(monkeypatch)
    from puzzlelib_tpu_torch.variable import Variable

    net, opt = _cardLeNet()
    step = fused.FusedStep(net, TCrossEntropy(maxlabels=10), opt)
    x, y = (torch.from_numpy(a).cuda() for a in cnnslice.data("lenet", 16))

    step(x, y)
    step(x, y)
    assert step.captures == 1

    layer = net["9"]
    old = layer.vars["W"].data
    kept = old.clone()
    layer.setVar("W", Variable(old.clone()))
    new = layer.vars["W"].data
    start = new.clone()

    step(x, y)
    assert step.captures == 2
    assert torch.equal(old, kept) and not torch.equal(new, start)


@pytest.mark.cuda
def testDropoutMasksDifferBetweenReplays(monkeypatch):
    """At learning and momentum rate 0 the weights stay, so three steps on
    one batch differ only by their dropout masks: three different losses,
    the same three again from the same seed, one recording."""
    _onCard(monkeypatch)

    rng = RandomNumberGenerator(5)
    np.random.seed(1)
    net = TC.Sequential()
    net.append(T.Conv2D(3, 8, 3, pad=1, initscheme="he"))
    net.append(T.Dropout(0.5, rng=rng))
    net.append(T.Flatten())
    net.append(T.Linear(8 * 8 * 8, 10, initscheme="he"))
    opt = TMomentumSGD(0.0, momRate=0.0)
    opt.setupOn(net, useGlobalState=True)
    cost = TCrossEntropy(maxlabels=10)
    step = fused.FusedStep(net, cost, opt)
    start = opt.shParams[torch.float32].ary.clone()

    x = torch.randn(4, 3, 8, 8, device="cuda", generator=torch.Generator("cuda").manual_seed(2))
    y = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")

    def three():
        rng.seed(5)
        losses = []
        for _ in range(3):
            step(x, y)
            losses.append(cost.getError())
        return losses

    first, again = three(), three()
    assert len(set(first)) == 3 and first == again
    assert torch.equal(opt.shParams[torch.float32].ary, start) and step.captures == 1


@pytest.mark.cuda
def testFusedCalculatorCallsReturnDistinctOutputs(monkeypatch):
    """Two ``calc`` calls on the card: each returns its own outputs, the
    first not overwritten by the second's replay, both equal to the eager
    Calculator's."""
    _onCard(monkeypatch)
    from puzzlelib_tpu_torch.handlers import Calculator

    net, _ = _cardLeNet()
    a, b = (torch.from_numpy(cnnslice.data("lenet", 12, seed=s)[0]).cuda() for s in (3, 4))
    calculator = fused.FusedCalculator(net, batchsize=8)

    first = calculator.calc(a)
    second = calculator.calc(b)
    eager = Calculator(net, batchsize=8)

    assert first.data_ptr() != second.data_ptr() and not torch.equal(first, second)
    assert torch.equal(first, eager.calc(a)) and torch.equal(second, eager.calc(b))
    assert calculator._program.captures == 2   # a batch of 8 and the ragged one of 4
