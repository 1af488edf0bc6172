"""The six optimizers of the zoo slice against the JAX package:
``NesterovSGD``, ``AdaGrad``, ``AdaDelta``, ``RMSProp``, ``RMSPropGraves``
and ``SMORMS3``.

Each twin of ``tests/test_optimizers.py`` holds one step of the port's
optimizer to that file's closed form (at its tolerance), then three steps
on seeded gradients to the JAX package's optimizer, in local and in global
state: weights and every state tensor within 1e-5 of max(1, max |want|),
the f32 tier.  The fused form (a ``FusedStep``, whose body takes the
hyper-parameters as 0-d f32 tensors under ``fusedctx``) gives the eager
step's bits: the steps round every product or sum of two scalars to the
tensor's type, as the reference's traced scalars are rounded, so no split
is left to record.  The states keep the reference's types, and
``convert`` carries each across.  The card-only cases (``cuda`` marker)
record and replay each optimizer's step as a CUDA graph."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import fused, fusedctx
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch import optimizers as TOpt
from puzzlelib_tpu_torch.convert import optimizerStateFromNumpy, optimizerStateToNumpy, paramsToNumpy
from puzzlelib_tpu_torch.cost import CrossEntropy as TCrossEntropy
from puzzlelib_tpu_torch.handlers import Trainer
from puzzlelib_tpu_torch.variable import Variable


F32_BOUND = 1e-5
STEPS = 3

# name: (constructor arguments, the closed form of one step from w and g, its tolerance)
OPTIMIZERS = {
    "NesterovSGD": (dict(learnRate=0.1, momRate=0.9), lambda w, g: w + (1 + 0.9) * 0.1 * g, 1e-5),
    "AdaGrad": (dict(learnRate=0.1, epsilon=1e-8), lambda w, g: w + 0.1 * g / (np.sqrt(g * g) + 1e-8), 1e-5),
    "AdaDelta": (dict(rho=0.95, epsilon=1e-6),
                 lambda w, g: w + np.sqrt(1e-6 / (0.05 * g * g + 1e-6)) * g, 1e-5),
    "RMSProp": (dict(learnRate=0.01, factor=0.9, epsilon=1e-5),
                lambda w, g: w + 0.01 * g / (np.sqrt(0.1 * g * g) + 1e-5), 1e-5),
    "RMSPropGraves": (dict(learnRate=1e-4, alpha=0.95, momRate=0.9, epsilon=1e-4),
                      lambda w, g: w + 1e-4 * g / np.sqrt(0.05 * g * g - (0.05 * g) ** 2 + 1e-4), 1e-6),
    "SMORMS3": (dict(learnRate=1e-3, epsilon=1e-16),
                lambda w, g: w + g * np.minimum(1e-3, (0.5 * g) ** 2 / (0.5 * g * g + 1e-16)) /
                (np.sqrt(0.5 * g * g) + 1e-16), 1e-6),
}

# the state tensors of each, with the type each takes: the variable's ("var") or f32
STATES = {
    "NesterovSGD": {"mom": "var"}, "AdaGrad": {"h": "var"}, "AdaDelta": {"msg": "var", "msdx": "var"},
    "RMSProp": {"ms": "var"}, "RMSPropGraves": {"mg": "var", "ms": "var", "delta": "var"},
    "SMORMS3": {"mem": torch.float32, "mg": torch.float32, "ms": torch.float32},
}


def _jax():
    """The JAX package's optimizers and gpuarray; the twins skip where it
    does not import, as on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.optimizers", reason="the twins need the JAX package")
    from puzzlelib_tpu import optimizers
    from puzzlelib_tpu import variable
    from puzzlelib_tpu.backend import gpuarray

    return optimizers, variable, gpuarray


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card (the card-only
    cases set "cuda" themselves)."""
    monkeypatch.setattr(TConfig, "device", "cpu")


class _OneVarModule:
    """The module protocol's stand-in of ``tests/test_optimizers.py``: one
    variable named "w", of either package."""

    def __init__(self, var):
        self.var = var

    def getVarTable(self):
        return {self.var: ["w"]}

    def getVar(self, name):
        return self.var

    def setVar(self, name, var):
        self.var = var


def _weights(shape=(7, 5)):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    grads = [np.random.RandomState(1 + i).randn(*shape).astype(np.float32) for i in range(STEPS)]
    return w, grads


def _portRun(name, w, grads, useGlobalState):
    mod = _OneVarModule(Variable(torch.from_numpy(w.copy()), grad=torch.zeros(w.shape)))
    opt = getattr(TOpt, name)(**OPTIMIZERS[name][0])
    opt.setupOn(mod, useGlobalState=useGlobalState)

    for g in grads:
        mod.getVar("w").grad.copy_(torch.from_numpy(g))
        opt.update()

    return mod.getVar("w").data.numpy().copy(), opt


def _jaxRun(name, w, grads, useGlobalState):
    JOpt, JVariable, jgpu = _jax()
    mod = _OneVarModule(JVariable.Variable(jgpu.to_gpu(w.copy()), grad=jgpu.to_gpu(np.zeros_like(w))))
    opt = getattr(JOpt, name)(**OPTIMIZERS[name][0])
    opt.setupOn(mod, useGlobalState=useGlobalState)

    for g in grads:
        mod.getVar("w").grad.set(g)
        opt.update()

    return np.asarray(mod.getVar("w").data.get()), opt


def _close(got, want, bound=F32_BOUND):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("useGlobalState", [False, True], ids=["local", "global"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def testOptimizerTwin(name, useGlobalState):
    """One step against ``tests/test_optimizers.py``'s closed form, then
    three steps against the JAX package: the weights and each state."""
    w, grads = _weights()
    _, closedForm, atol = OPTIMIZERS[name]

    once, _ = _portRun(name, w, grads[:1], useGlobalState)
    assert np.allclose(once, closedForm(w, grads[0]), atol=atol)

    got, topt = _portRun(name, w, grads, useGlobalState)
    want, jopt = _jaxRun(name, w, grads, useGlobalState)
    _close(got, want)
    assert topt.t == jopt.t == STEPS

    (tstate, ), (jstate, ) = topt.states.values(), jopt.states.values()
    assert sorted(tstate) == sorted(jstate) == sorted(STATES[name])
    for entity, tensor in tstate.items():
        # a global state spans its flat buffer, which each package may pad: the variable's cells lead it
        _close(tensor.numpy().ravel()[:w.size], np.asarray(jstate[entity].get()).ravel()[:w.size])


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def testStatesKeepTheReferencesTypes(name):
    """In bf16 SMORMS3's state is f32, every other state takes the
    variable's type; under global state each state spans its type's flat
    buffer."""
    var = Variable(torch.ones(4, 3, dtype=torch.bfloat16), grad=torch.zeros(4, 3, dtype=torch.bfloat16))
    opt = getattr(TOpt, name)(**OPTIMIZERS[name][0])
    opt.setupOn(_OneVarModule(var), useGlobalState=True)

    (state, ) = opt.states.values()
    for entity, kind in STATES[name].items():
        assert state[entity].dtype == (torch.bfloat16 if kind == "var" else kind)
        assert state[entity].shape == opt.shParams[torch.bfloat16].ary.shape


def _tinyNet():
    np.random.seed(3)
    net = TC.Sequential(name="tiny")
    net.append(T.Linear(6, 5, name="fc1"))
    net.append(T.Activation(T.relu))
    net.append(T.Linear(5, 3, name="fc2"))
    return net


def _tinyData(count):
    rng = np.random.RandomState(5)
    return rng.randn(count, 6).astype(np.float32), rng.randint(0, 3, size=count).astype(np.int32)


@pytest.mark.parametrize("useGlobalState", [False, True], ids=["local", "global"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def testFusedFormEqualsTheEagerStep(name, useGlobalState):
    """The fused form: three ``FusedStep`` calls (the hyper-parameters, and
    AdaDelta's unread ``learnRate`` of 1.0, as 0-d f32 tensors under
    ``fusedctx``) against three eager steps from the same start: the same
    losses, weights and states, bit for bit (no split to record)."""
    x, y = _tinyData(3 * 4)
    runs = []

    for fusedForm in (False, True):
        net, cost = _tinyNet(), TCrossEntropy(maxlabels=3)
        opt = getattr(TOpt, name)(**OPTIMIZERS[name][0])
        opt.setupOn(net, useGlobalState=useGlobalState)
        step, losses = fused.FusedStep(net, cost, opt), []

        for i in range(STEPS):
            data, labels = torch.from_numpy(x[i * 4:(i + 1) * 4]), torch.from_numpy(y[i * 4:(i + 1) * 4])
            if fusedForm:
                step(data, labels)
            else:
                Trainer(net, cost, opt, batchsize=4).train(data, labels, random=False)
            losses.append(cost.getError())

        runs.append((losses, paramsToNumpy(net), optimizerStateToNumpy(opt), opt.t))

    (eager, eagerWeights, eagerStates, eagerT), (got, weights, states, t) = runs
    assert got == eager and t == eagerT == STEPS
    assert all(np.array_equal(weights[key], eagerWeights[key]) for key in eagerWeights)
    assert sorted(states) == sorted(eagerStates)
    assert all(np.array_equal(states[key], eagerStates[key]) for key in eagerStates)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def testHyperParametersAreTensorsUnderFusedctx(name):
    """A fused step hands every numeric attribute in ``attrs`` to the body
    as a 0-d f32 tensor (AdaDelta's ``learnRate`` too, which its step never
    reads), and the step under ``fusedctx`` gives the eager bits."""
    w, grads = _weights((5, ))
    net = _OneVarModule(Variable(torch.from_numpy(w.copy()), grad=torch.from_numpy(grads[0])))
    opt = getattr(TOpt, name)(**OPTIMIZERS[name][0])
    opt.setupOn(net)

    hyper = fused.FusedStep(_tinyNet(), TCrossEntropy(), opt)._hyper()
    assert "learnRate" in hyper and set(hyper) == set(opt.attrs) - {"t"}
    if name == "AdaDelta":
        assert hyper["learnRate"] == 1.0

    state = opt.setupState(net.var)
    eagerVar = Variable(net.var.data.clone(), grad=net.var.grad.clone())
    eagerState = {entity: tensor.clone() for entity, tensor in state.items()}
    opt.updateVar(eagerVar, eagerState)

    tensors = {key: torch.tensor(value) for key, value in hyper.items()}
    saved = {key: getattr(opt, key) for key in tensors}
    for key, value in tensors.items():
        setattr(opt, key, value)

    with fusedctx.activate(tensors, torch.tensor(1.0)):
        opt.updateVar(net.var, state)

    for key, value in saved.items():
        setattr(opt, key, value)

    assert torch.equal(net.var.data, eagerVar.data)
    assert all(torch.equal(state[entity], eagerState[entity]) for entity in state)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def testStateCrossesThroughNumpy(name):
    """``convert.optimizerStateToNumpy`` / ``optimizerStateFromNumpy`` carry
    every state of the optimizer, under global state by the reference's
    names."""
    w, grads = _weights()
    _, opt = _portRun(name, w, grads, useGlobalState=True)
    table = optimizerStateToNumpy(opt)
    assert sorted(table) == sorted("<class 'numpy.float32'>.%s" % entity for entity in STATES[name])

    _, fresh = _portRun(name, w, grads[:1], useGlobalState=True)
    optimizerStateFromNumpy(fresh, table)
    for key, ary in optimizerStateToNumpy(fresh).items():
        assert np.array_equal(ary, table[key])


# -- on the card -------------------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def testFusedOptimizerOnCardEqualsTheEagerStep(monkeypatch, name):
    """Each optimizer's step recorded once as a CUDA graph and replayed: 4
    steps of 16 through ``FusedTrainer`` against the eager ``Trainer`` from
    the same start and batch order, the same losses and weights bit for bit,
    a second fused run the same again, one recording."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused step records CUDA graphs")

    monkeypatch.setattr(TConfig, "device", "cuda")
    x, y = _tinyData(4 * 16)
    net, cost = _tinyNet(), TCrossEntropy(maxlabels=3)
    opt = getattr(TOpt, name)(**OPTIMIZERS[name][0])
    opt.setupOn(net, useGlobalState=True)
    start = {dtype: pack.ary.clone() for dtype, pack in opt.shParams.items()}
    trainers = {"eager": Trainer(net, cost, opt, batchsize=16), "fused": fused.FusedTrainer(net, cost, opt, batchsize=16)}

    def train(kind):
        for dtype, pack in opt.shParams.items():
            pack.ary.copy_(start[dtype])
        for state in opt.states.values():
            for entity, tensor in state.items():
                tensor.fill_(1.0 if entity == "mem" else 0.0)
        opt.t = 0

        losses = []
        trainers[kind].onBatchFinish = lambda h: losses.append(h.cost.getError())
        np.random.seed(4)
        trainers[kind].trainFromHost(x, y)
        return losses, paramsToNumpy(net)

    eager, eagerWeights = train("eager")
    got, weights = train("fused")
    again, againWeights = train("fused")

    assert got == eager == again and len(got) == 4
    assert all(np.array_equal(weights[k], eagerWeights[k]) and np.array_equal(againWeights[k], weights[k])
               for k in weights)
    assert trainers["fused"].step.captures == 1
