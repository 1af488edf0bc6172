"""The seven costs of the zoo slice against the JAX package: ``Hinge``,
``SmoothL1``, ``L1Hinge``, ``SVM`` ("l1" and "l2"), ``KLDivergence`` (with
and without ``normTarget``), ``Abs`` and ``Multi``, with the kernel
wrappers of ``backend/kernels/costs.py`` and the validation of a list of
targets (``Validator`` and ``FusedValidator`` take ``Multi`` the eager
way).

Each twin of ``tests/test_costs.py`` holds the port to that file's closed
form at its tolerance, and to the JAX package on the same seeded inputs:
the error (``getError``), the descent gradient, ``calcVal`` and
``calcValDev`` within 1e-5 of max(1, max |want|), the f32 tier; the
validation errors that count misses, and ``mostProb``, exactly.  The
card-only cases (``cuda`` marker) hold the costs on the card to the same
calls on the CPU and ``SVM`` under a recorded ``FusedValidator``."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import cost as TCost
from puzzlelib_tpu_torch import fused
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch.backend.kernels import costs as TKernels
from puzzlelib_tpu_torch.handlers import Validator


F32_BOUND = 1e-5


def _jax():
    """The JAX package's costs and gpuarray; the twins skip where it does not
    import, as on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.cost", reason="the twins need the JAX package")
    from puzzlelib_tpu import cost
    from puzzlelib_tpu.backend import gpuarray

    return cost, gpuarray


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


def _softmax(x):
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _tree(fn, data):
    return [fn(item) for item in data] if isinstance(data, list) else fn(data)


def _twin(name, pred, target, kwargs=None):
    """The JAX package's cost and the port's of ``name`` on the same host
    inputs: (jax error, jax grad, port error, port grad, jax cost, port
    cost), then both validations held to each other."""
    JCost, jgpu = _jax()
    kwargs = kwargs or {}
    jcost, tcost = getattr(JCost, name)(**kwargs), getattr(TCost, name)(**kwargs)

    jerr, jgrad = jcost(_tree(jgpu.to_gpu, pred), jgpu.to_gpu(target))
    terr, tgrad = tcost(_tree(torch.from_numpy, pred), torch.from_numpy(target))
    assert isinstance(terr, float)
    _close(terr, jerr)

    if isinstance(jgrad, list):
        assert len(tgrad) == len(jgrad)
        for got, want in zip(tgrad, jgrad):
            _close(got, want)
    else:
        _close(tgrad, jgrad)

    jval = jcost.validate(_tree(jgpu.to_gpu, pred), jgpu.to_gpu(target))
    tval = tcost.validate(_tree(torch.from_numpy, pred), torch.from_numpy(target))
    assert isinstance(tval, float) and tval == tcost.getValError()
    _close(tval, jval)

    jdev = jcost.calcValDev(_tree(jgpu.to_gpu, pred), jgpu.to_gpu(target))
    tdev = tcost.validateDev(_tree(torch.from_numpy, pred), torch.from_numpy(target))
    assert tdev.dtype == torch.float32 and tdev.dim() == 0
    _close(tdev, np.asarray(jdev))

    return terr, tgrad, tval, tcost


def testHingeTwin():
    np.random.seed(1)
    scores = np.random.randn(8, 4).astype(np.float32)
    labels = (np.random.randint(0, 2, size=(8, 4)) * 2 - 1).astype(np.int32)

    error, grad, _, _ = _twin("Hinge", scores, labels)

    refErr = np.maximum(0, 1 - scores * labels).sum() / 4 / 8
    refGrad = np.where(scores * labels < 1, labels / 8 / 4, 0).astype(np.float32)
    assert np.isclose(error, refErr, rtol=1e-4)
    assert np.allclose(grad.numpy(), refGrad, atol=1e-6)


def testSmoothL1Twin():
    np.random.seed(2)
    pred = np.random.randn(10, 10).astype(np.float32)
    target = np.random.randn(10, 10).astype(np.float32)

    error, grad, _, cost = _twin("SmoothL1", pred, target)

    diff = pred - target
    refGrad = (np.where(np.abs(diff) >= 1.0, np.sign(diff), diff) / pred.size).astype(np.float32)
    assert np.allclose(grad.numpy(), refGrad, atol=1e-6)

    refErr = np.mean(np.where(np.abs(diff) >= 1.0, np.abs(diff) - 0.5, diff ** 2 / 2))
    assert np.isclose(cost.error, refErr, rtol=1e-4) and cost.error == error


def testL1HingeTwin():
    np.random.seed(3)
    x1 = np.random.randn(6, 5).astype(np.float32)
    x2 = np.random.randn(6, 5).astype(np.float32)
    labels = np.random.randint(0, 2, size=(6, )).astype(np.int32)

    error, grad, val, _ = _twin("L1Hinge", [x1, x2], labels)

    absd = np.abs(x1 - x2)
    refErr = np.where(labels[:, None] == 0, np.maximum(0, 1 - absd), absd).sum() / 5 / 6
    assert np.isclose(error, refErr, rtol=1e-4)
    assert len(grad) == 2 and tuple(grad[0].shape) == x1.shape
    assert torch.equal(grad[1], -grad[0]) and 0.0 <= val <= 1.0


@pytest.mark.parametrize("mode", ["l1", "l2"])
def testSVMTwin(mode):
    np.random.seed(4)
    scores = np.random.randn(8, 5).astype(np.float32)
    labels = np.random.randint(0, 5, size=(8, )).astype(np.int32)

    error, grad, val, cost = _twin("SVM", scores, labels, dict(mode=mode))

    cls = np.where(labels[:, None] == np.arange(5)[None], 1.0, -1.0)
    margin = 1.0 - scores * cls
    if mode == "l1":
        refErr = np.maximum(margin, 0).sum() / 5 / 8
        refGrad = np.where(margin > 0, cls / 5 / 8, 0)
    else:
        hinge = np.maximum(margin, 0)
        refErr = (hinge ** 2).sum() / 5 / 8
        refGrad = 2 * cls * hinge / 5 / 8

    assert np.isclose(error, refErr, rtol=1e-4)
    assert np.allclose(grad.numpy(), refGrad, atol=1e-5)

    assert np.array_equal(cost.mostProb.numpy(), scores.argmax(axis=1))
    assert val == np.mean(scores.argmax(axis=1) != labels)


@pytest.mark.parametrize("normTarget", [False, True], ids=["target", "normTarget"])
def testKLDivergenceTwin(normTarget):
    np.random.seed(5)
    pred = np.random.randn(6, 8).astype(np.float32)
    target = np.abs(np.random.randn(6, 8).astype(np.float32))
    if not normTarget:
        target /= target.sum(axis=1, keepdims=True)

    error, grad, _, _ = _twin("KLDivergence", pred, target, dict(maxlabels=8, normTarget=normTarget))

    p, t = _softmax(pred), _softmax(target) if normTarget else target
    refErr = (t * (np.log(t) - np.log(p))).sum() / 6
    assert np.isclose(error, refErr, rtol=1e-3)
    assert np.allclose(grad.numpy(), (t - p) / 6, atol=1e-5)


def testKLDivergenceFlattensTheSample():
    """A prediction with trailing dims is softmaxed over the whole sample, and
    ``maxlabels`` is held to its second dim."""
    JCost, jgpu = _jax()
    np.random.seed(6)
    pred = np.random.randn(3, 4, 2, 2).astype(np.float32)
    target = _softmax(np.random.randn(3, 16)).reshape(pred.shape).astype(np.float32)

    _twin("KLDivergence", pred, target)
    with pytest.raises(TCost.CostError, match="expected 5 labels"):
        TCost.KLDivergence(maxlabels=5)(torch.from_numpy(pred), torch.from_numpy(target))


def testAbsTwin():
    np.random.seed(6)
    pred = np.random.randn(8, 4).astype(np.float32)
    target = np.random.randn(8, 4).astype(np.float32)

    error, grad, _, _ = _twin("Abs", pred, target)

    refErr = np.abs(pred - target).sum() / 4 / 8
    refGrad = np.where(pred > target, -1.0, 1.0) / pred.size
    assert np.isclose(error, refErr, rtol=1e-4)
    assert np.allclose(grad.numpy(), refGrad, atol=1e-6)


def _multiInputs():
    np.random.seed(7)
    pred1 = np.random.randn(4, 3).astype(np.float32)
    target1 = np.random.randn(4, 3).astype(np.float32)
    pred2 = np.random.randn(4, 5).astype(np.float32)
    target2 = np.random.randint(0, 5, size=(4, )).astype(np.int32)
    return [pred1, pred2], [target1, target2]


def testMultiTwin():
    """MSE and CrossEntropy side by side: the lists of errors, gradients,
    mean errors and validation errors against the JAX package's."""
    JCost, jgpu = _jax()
    preds, targets = _multiInputs()

    jmulti = JCost.Multi().append(JCost.MSE()).append(JCost.CrossEntropy())
    tmulti = TCost.Multi().append(TCost.MSE()).append(TCost.CrossEntropy())

    jerr, jgrads = jmulti([jgpu.to_gpu(p) for p in preds], [jgpu.to_gpu(t) for t in targets])
    terr, tgrads = tmulti([torch.from_numpy(p) for p in preds], [torch.from_numpy(t) for t in targets])

    assert len(terr) == len(tgrads) == 2
    assert tuple(tgrads[0].shape) == (4, 3) and tuple(tgrads[1].shape) == (4, 5)
    for got, want in zip(terr + tgrads, jerr + jgrads):
        _close(got, want)

    _close(tmulti.getMeanError(), jmulti.getMeanError())
    jval = jmulti.validate([jgpu.to_gpu(p) for p in preds], [jgpu.to_gpu(t) for t in targets])
    tval = tmulti.validate([torch.from_numpy(p) for p in preds], [torch.from_numpy(t) for t in targets])
    assert len(tval) == 2 and tval[1] == jval[1]
    _close(tval, jval)

    with pytest.raises(NotImplementedError):
        tmulti.validateDev([torch.from_numpy(p) for p in preds], [torch.from_numpy(t) for t in targets])


def _twoHeads(maps=(3, 5), name="heads"):
    """A net of one input and two outputs: a shared Linear, then two heads."""
    np.random.seed(8)
    net = TC.Sequential(name=name)
    net.append(T.Linear(6, 8, name="trunk"))
    net.append(T.Replicate(2))
    net.append(TC.Parallel().append(T.Linear(8, maps[0], name="head1")).append(T.Linear(8, maps[1], name="head2")))
    return net


def _twoHeadsData(count, maps=(3, 5)):
    rng = np.random.RandomState(9)
    x = rng.randn(count, 6).astype(np.float32)
    return x, [rng.randn(count, maps[0]).astype(np.float32), rng.randint(0, maps[1], size=count).astype(np.int32)]


@pytest.mark.parametrize("validator", ["Validator", "FusedValidator"])
def testMultiValidationTwin(validator):
    """A list of targets through ``Validator`` and ``FusedValidator`` (which
    takes ``Multi``'s eager path: no ``calcValDev``), in batches of 4 with a
    ragged last one: one error per cost, as the JAX package's Validator
    gives them."""
    _jax()
    from puzzlelib_tpu import containers as JC, modules as J
    from puzzlelib_tpu.cost import CrossEntropy as JCrossEntropy, MSE as JMSE, Multi as JMulti
    from puzzlelib_tpu.handlers import Validator as JValidator
    from puzzlelib_tpu_torch.convert import paramsFromNumpy

    x, targets = _twoHeadsData(10)
    np.random.seed(8)
    jnet = JC.Sequential(name="heads")
    jnet.append(J.Linear(6, 8, name="trunk"))
    jnet.append(J.Replicate(2))
    jnet.append(JC.Parallel().append(J.Linear(8, 3, name="head1")).append(J.Linear(8, 5, name="head2")))
    tnet = _twoHeads()
    paramsFromNumpy(tnet, {name: np.asarray(var.data.get()) for var, names in jnet.getVarTable().items()
                           for name in names})

    want = JValidator(jnet, JMulti().append(JMSE()).append(JCrossEntropy()), batchsize=4).validateFromHost(x, targets)
    handler = getattr(fused, validator) if validator == "FusedValidator" else Validator
    tvalidator = handler(tnet, TCost.Multi().append(TCost.MSE()).append(TCost.CrossEntropy()), batchsize=4)
    got = tvalidator.validateFromHost(x, targets)

    assert isinstance(got, list) and len(got) == 2 and got[1] == want[1]
    _close(got, want)
    if validator == "FusedValidator":
        assert tvalidator._fallback and tvalidator._program is None


def testSVMUnderFusedValidatorKeepsTheLastPredictions():
    """``SVM.calcValDev`` keeps its predictions in ``mostProb``: after a
    ``FusedValidator`` call they are the last batch's, as after the eager
    Validator's, and the errors are equal."""
    np.random.seed(10)
    net = TC.Sequential(name="svm")
    net.append(T.Linear(6, 5, name="fc"))
    x = np.random.RandomState(11).randn(10, 6).astype(np.float32)
    labels = np.random.RandomState(12).randint(0, 5, size=10).astype(np.int32)

    eagerCost, fusedCost = TCost.SVM(), TCost.SVM()
    eager = Validator(net, eagerCost, batchsize=4).validateFromHost(x, labels)
    got = fused.FusedValidator(net, fusedCost, batchsize=4).validateFromHost(x, labels)

    assert got == eager
    assert torch.equal(fusedCost.mostProb, eagerCost.mostProb) and fusedCost.mostProb.shape == (2, )


def testKernelWrappersTwin():
    """``backend/kernels/costs.py``: the ``*Kernel`` functions write their
    error, the ``*Ker`` functions add theirs and write their gradients into
    the buffers given, and the accuracy kernels count misses, against the
    JAX package's wrappers."""
    JCost, jgpu = _jax()
    from puzzlelib_tpu.backend.kernels import costs as JKernels

    rng = np.random.RandomState(13)
    scores = rng.randn(6, 4).astype(np.float32)
    labels = rng.randint(0, 4, size=6).astype(np.int32)
    signs = (rng.randint(0, 2, size=(6, 4)) * 2 - 1).astype(np.int32)
    pred, target = rng.randn(6, 4).astype(np.float32), rng.randn(6, 4).astype(np.float32)
    bits = rng.randint(0, 2, size=6).astype(np.int32)

    def both(jfn, tfn, *arrays):
        return jfn(*[jgpu.to_gpu(a) for a in arrays]), tfn(*[torch.from_numpy(a) for a in arrays])

    for name in ("crossEntropyKernel", "svmKernel"):
        (jerr, jgrad), (terr, tgrad) = both(getattr(JKernels, name), getattr(TKernels, name), scores, labels)
        _close(terr, jerr)
        _close(tgrad, jgrad)

    def accumulate(name, inputs, ngrads):
        jerror, terror = jgpu.to_gpu(np.float32(0.5)), torch.tensor(0.5)
        jgrads = [jgpu.to_gpu(np.zeros_like(inputs[0])) for _ in range(ngrads)]
        tgrads = [torch.zeros(inputs[0].shape) for _ in range(ngrads)]
        jout = getattr(JKernels, name)(*[jgpu.to_gpu(a) for a in inputs], jerror, *jgrads)
        tout = getattr(TKernels, name)(*[torch.from_numpy(a) for a in inputs], terror, *tgrads)
        assert tout[0] is terror and all(t is g for t, g in zip(tout[1:], tgrads))
        for got, want in zip(tout, jout):
            _close(got, want)

    accumulate("bceKer", [pred, bits[:, None].repeat(4, axis=1)], 1)
    accumulate("hingeKer", [scores, signs], 1)
    accumulate("l1HingeKer", [pred, target, bits], 2)
    _close(TKernels.smoothL1Ker(torch.from_numpy(pred), torch.from_numpy(target), torch.tensor(0.0),
                                torch.zeros(6, 4), 0.25, 1 / 24)[0],
           JKernels.smoothL1Ker(jgpu.to_gpu(pred), jgpu.to_gpu(target), jgpu.to_gpu(np.float32(0.0)),
                                jgpu.to_gpu(np.zeros((6, 4), np.float32)), 0.25, 1 / 24)[0])

    for name, inputs in (("calcAccuracy", [labels, np.roll(labels, 1)]), ("calcBCEAccuracy", [pred[:, 0].copy(), bits]),
                         ("l1HingeAccuracy", [np.abs(pred[:, 0]) * 2, bits])):
        jout, tout = both(JKernels.getAccuracyKernel(name), TKernels.getAccuracyKernel(name), *inputs)
        assert tout.dtype == torch.float32 and tout.item() == float(np.asarray(jout.get()))

    soft = _softmax(pred).astype(np.float32)
    dist = np.abs(_softmax(target)).astype(np.float32)
    jgrad, tgrad = jgpu.to_gpu(np.zeros_like(soft)), torch.zeros(soft.shape)
    jerr = JKernels.getAccuracyKernel("klDivergence")(jgpu.to_gpu(soft), jgpu.to_gpu(dist), jgrad, 0.5)
    terr = TKernels.getAccuracyKernel("klDivergence")(torch.from_numpy(soft), torch.from_numpy(dist), tgrad, 0.5)
    _close(terr, jerr)
    _close(tgrad, jgrad)


@pytest.mark.parametrize("name, bad", [("Hinge", "labels"), ("SVM", "labels"), ("L1Hinge", "dtype"),
                                       ("Abs", "shape"), ("SmoothL1", "shape")])
def testShapeContracts(name, bad):
    """Each cost refuses inputs off its contract with a ``CostError``."""
    scores = torch.zeros(4, 3)
    cases = {
        "labels": (scores, torch.zeros(4, 3, dtype=torch.int64)),
        "dtype": ([scores, scores.double()], torch.zeros(4, dtype=torch.int32)),
        "shape": (scores, torch.zeros(4, 2)),
    }
    pred, target = cases[bad]
    with pytest.raises(TCost.CostError):
        getattr(TCost, name)()(pred, target)


# -- on the card -------------------------------------------------------------------------------------

def _onCard(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")

    monkeypatch.setattr(TConfig, "device", "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name, kwargs", [("Hinge", {}), ("SmoothL1", {}), ("L1Hinge", {}), ("SVM", {}),
                                          ("SVM", {"mode": "l2"}), ("KLDivergence", {"normTarget": True}),
                                          ("Abs", {})])
def testCostOnCardAgainstTheCpu(monkeypatch, name, kwargs):
    """Each cost's error, gradient and validation error on the card within
    1e-5 of the same call on the CPU, in f32."""
    rng = np.random.RandomState(14)
    scores = rng.randn(16, 5).astype(np.float32)
    inputs = {
        "Hinge": (scores, (rng.randint(0, 2, size=(16, 5)) * 2 - 1).astype(np.int32)),
        "SVM": (scores, rng.randint(0, 5, size=16).astype(np.int32)),
        "L1Hinge": ([scores, rng.randn(16, 5).astype(np.float32)], rng.randint(0, 2, size=16).astype(np.int32)),
    }.get(name, (scores, np.abs(rng.randn(16, 5)).astype(np.float32)))

    results = {}
    for device in ("cpu", "cuda"):
        monkeypatch.setattr(TConfig, "device", device)
        if device == "cuda":
            _onCard(monkeypatch)
        cost = getattr(TCost, name)(**kwargs)
        pred = _tree(lambda a: torch.from_numpy(a).to(device), inputs[0])
        target = torch.from_numpy(inputs[1]).to(device)
        err, grad = cost(pred, target)
        results[device] = (err, _tree(lambda g: g.cpu(), grad), cost.validate(pred, target))

    (cpuErr, cpuGrad, cpuVal), (err, grad, val) = results["cpu"], results["cuda"]
    _close(err, cpuErr)
    for got, want in zip(_tree(lambda g: g, grad) if isinstance(grad, list) else [grad],
                         cpuGrad if isinstance(cpuGrad, list) else [cpuGrad]):
        _close(got, want)
    _close(val, cpuVal)


@pytest.mark.cuda
def testSVMUnderARecordedFusedValidatorOnCard(monkeypatch):
    """On the card ``FusedValidator`` records the forward and ``SVM``'s
    validation once as a CUDA graph: its error equals the eager Validator's
    and ``mostProb`` holds the last batch's predictions, a copy that the
    next replay leaves alone."""
    _onCard(monkeypatch)
    np.random.seed(10)
    net = TC.Sequential(name="svm")
    net.append(T.Linear(6, 5, name="fc"))
    x = np.random.RandomState(11).randn(16, 6).astype(np.float32)
    labels = np.random.RandomState(12).randint(0, 5, size=16).astype(np.int32)

    eagerCost, fusedCost = TCost.SVM(), TCost.SVM()
    eager = Validator(net, eagerCost, batchsize=4).validateFromHost(x, labels)
    validator = fused.FusedValidator(net, fusedCost, batchsize=4)
    got = validator.validateFromHost(x, labels)
    kept = fusedCost.mostProb

    assert got == eager and validator._program.captures == 1
    assert torch.equal(kept, eagerCost.mostProb)

    validator.validateFromHost(x[::-1].copy(), labels)
    assert torch.equal(kept, eagerCost.mostProb) and not kept.data_ptr() == fusedCost.mostProb.data_ptr()
