"""``SwitchMoE``, ``Pipeline``, ``functionalize`` and the top-1 routing
against the JAX package, and the MoE trunk slice (``tools/moeslice.py``).

Twins of ``tests/test_moe_module.py`` (the blueprint and checkpoint round
trips included: a file written by either package rebuilds and loads in
the other) and of the single-device part of ``tests/test_pipeline.py``:
both packages build the same modules from the same numpy seeds.  f32 is held within 1e-5 of max(1, max |ref|), the
reference's f32 tier."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch import config as TConfig
from puzzlelib_tpu_torch import containers as TC
from puzzlelib_tpu_torch import handlers as TH
from puzzlelib_tpu_torch import modules as T
from puzzlelib_tpu_torch import fused as TFused
from puzzlelib_tpu_torch.convert import paramsFromNumpy, paramsToNumpy
from puzzlelib_tpu_torch.cost import CrossEntropy as TCrossEntropy
from puzzlelib_tpu_torch.optimizers import MomentumSGD as TMomentumSGD
from puzzlelib_tpu_torch.parallel import moe as TMoe
from puzzlelib_tpu_torch.tools import moeslice


BOUND = 1e-5


def _jax():
    """The JAX package's pieces for the twins; they skip where it does not
    import, as on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    from puzzlelib_tpu import containers, cost, handlers, modules, optimizers
    from puzzlelib_tpu.backend import gpuarray

    return modules, containers, handlers, cost, optimizers, gpuarray


@pytest.fixture(autouse=True)
def onCpu(monkeypatch):
    """Pin the port to the CPU, also on a machine with a card."""
    monkeypatch.setattr(TConfig, "device", "cpu")


def _close(got, want, bound=BOUND):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, dtype=np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _table(net):
    return {name: np.asarray(var.data.get()) for var, names in net.getVarTable().items() for name in names}


def _makeExpert(M, C, seed):
    np.random.seed(seed)
    s = C.Sequential()
    s.append(M.Linear(8, 8, initscheme="gaussian", wscale=0.4))
    s.append(M.Activation(M.tanh))
    return s


def _makeMoE(M, C, nExperts=4):
    moe = M.SwitchMoE(8, name="moe")
    for e in range(nExperts):
        moe.append(_makeExpert(M, C, 100 + e))
    return moe


def _twins(nExperts=4):
    J, JC, _, _, _, _ = _jax()
    return _makeMoE(J, JC, nExperts), _makeMoE(T, TC, nExperts)


# -- routing -----------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "overflow"])
def testDispatchTwin(case):
    """``_dispatch`` gives the JAX package's dispatch, combine and auxiliary
    loss: on random logits; on equal logits (a zero gate), where every token
    ties and goes to expert 0, the first index, and all past the capacity
    are dropped; and at a capacity of 2 for 16 tokens."""
    _jax()
    import jax.numpy as jnp
    from puzzlelib_tpu.parallel.moe import _dispatch

    rng = np.random.RandomState(3)
    x = rng.randn(16, 8).astype(np.float32)
    gateW = np.zeros((8, 4), np.float32) if case == "ties" else rng.randn(8, 4).astype(np.float32)
    capacity = 2 if case == "overflow" else 5

    want = _dispatch(jnp.asarray(gateW), jnp.asarray(x), 4, capacity)
    got = TMoe._dispatch(torch.from_numpy(gateW), torch.from_numpy(x), 4, capacity)

    for g, w in zip(got, want):
        _close(g, np.asarray(w))

    dispatch = got[0].numpy()
    assert dispatch.shape == (16, 4, capacity) and dispatch.sum(axis=(1, 2)).max() <= 1.0
    if case == "ties":
        assert dispatch[:, 0].sum() == capacity and dispatch[:, 1:].sum() == 0.0
    if case == "overflow":
        assert dispatch.sum() < 16 and (dispatch.sum(axis=0) <= 1.0).all()


def testStackExpertParams():
    """Per-expert lists stack along a new leading axis, a tensor a position,
    as the JAX package's ``stackExpertParams`` does."""
    _jax()
    import jax.numpy as jnp
    from puzzlelib_tpu.parallel.moe import stackExpertParams

    rng = np.random.RandomState(4)
    lists = [[rng.randn(3, 2).astype(np.float32), rng.randn(2).astype(np.float32)] for _ in range(3)]
    want = stackExpertParams([[jnp.asarray(a) for a in params] for params in lists])
    got = TMoe.stackExpertParams([[torch.from_numpy(a) for a in params] for params in lists])

    assert [tuple(g.shape) for g in got] == [(3, 3, 2), (3, 2)]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


# -- SwitchMoE ---------------------------------------------------------------------------

def testSwitchMoEForwardMatchesManualRoutingTwin():
    """The JAX package's output and auxiliary loss; and the manual oracle of
    ``testSwitchMoEForwardMatchesManualRouting``: the same dispatch and each
    expert called on its buffer."""
    _, _, _, _, _, jgpu = _jax()
    jmoe, tmoe = _twins()
    assert list(tmoe.modules) == list(jmoe.modules) == ["0", "__gate__", "2", "3", "4"]

    x = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    out = tmoe(torch.from_numpy(x))
    _close(out, jmoe(jgpu.to_gpu(x)).get())
    _close(tmoe.auxLoss, np.float32(jmoe.auxLoss.get()))
    assert out.shape == (16, 8) and float(tmoe.auxLoss) > 0.0

    disp, comb, _ = TMoe._dispatch(tmoe.gateVar.data, torch.from_numpy(x), 4, tmoe._capacity(16))
    expertIn = torch.einsum("bec,bd->ecd", disp, torch.from_numpy(x))
    outs = []
    for e, expert in enumerate(tmoe.graph):
        outs.append(expert(expertIn[e]).clone())
        expert.reset()
    _close(out, torch.einsum("bec,ecd->bd", comb, torch.stack(outs)).numpy())


@pytest.mark.parametrize("scale, momentum", [(1.0, 0.0), (0.5, 0.9)])
def testSwitchMoEGradientsTwin(scale, momentum):
    """The input gradient and every parameter gradient (gate and experts)
    of the JAX package's ``_vjp``, folded with ``scale`` and ``momentum``
    into gradients that held the same seeded values before."""
    _, _, _, _, _, jgpu = _jax()
    jmoe, tmoe = _twins()

    rng = np.random.RandomState(5)
    x = rng.randn(24, 8).astype(np.float32)
    grad = rng.randn(24, 8).astype(np.float32)
    for var, names in jmoe.getVarTable().items():
        held = rng.randn(*var.grad.shape).astype(np.float32)
        var.grad.set(held)
        tmoe.getVar(names[0]).grad.copy_(torch.from_numpy(held))

    jmoe(jgpu.to_gpu(x))
    tmoe(torch.from_numpy(x))
    jmoe.backward(jgpu.to_gpu(grad), scale=scale, momentum=momentum)
    tmoe.backward(torch.from_numpy(grad), scale=scale, momentum=momentum)

    _close(tmoe.grad, jmoe.grad.get())
    for var, names in jmoe.getVarTable().items():
        _close(tmoe.getVar(names[0]).grad, var.grad.get())


def testSwitchMoEProtocolHalves():
    """``updateGrad`` alone gives the input gradient and leaves the
    parameter gradients; ``accGradParams`` alone gives these."""
    _, tmoe = _twins()
    x = torch.from_numpy(np.random.RandomState(6).randn(16, 8).astype(np.float32))
    grad = torch.from_numpy(np.random.RandomState(7).randn(16, 8).astype(np.float32))

    tmoe(x)
    tmoe.backward(grad)
    full = tmoe.grad.clone()
    grads = {name: tmoe.getVar(name).grad.clone() for names in tmoe.getVarTable().values() for name in names}

    tmoe.zeroGradParams()
    tmoe(x)
    tmoe.updateGrad(grad)
    assert torch.equal(tmoe.grad, full)
    assert all(not tmoe.getVar(name).grad.any() for name in grads)

    tmoe.accGradParams(grad)
    for name, want in grads.items():
        assert torch.equal(tmoe.getVar(name).grad, want), name


def testSwitchMoETrainsTwin():
    """``testSwitchMoETrains``: 25 steps of ``MomentumSGD(0.3, 0.9)`` in
    local state on a tanh regression, each step's loss the JAX package's,
    the last below 0.9 of the first."""
    J, JC, _, _, JOpt, jgpu = _jax()
    jmoe, tmoe = _twins()
    jopt, topt = JOpt.MomentumSGD(learnRate=0.3, momRate=0.9), TMomentumSGD(learnRate=0.3, momRate=0.9)
    jopt.setupOn(jmoe, useGlobalState=False)
    topt.setupOn(tmoe, useGlobalState=False)

    np.random.seed(1)
    x = np.random.randn(32, 8).astype(np.float32)
    w = np.random.randn(8, 8).astype(np.float32)
    target = np.tanh(x @ w)

    losses = {"jax": [], "port": []}
    for _ in range(25):
        for key, moe, opt, up, down in (("jax", jmoe, jopt, jgpu.to_gpu, lambda t: t.get()),
                                        ("port", tmoe, topt, torch.from_numpy, lambda t: t.numpy())):
            diff = down(moe(up(x))) - target
            losses[key].append(float((diff ** 2).mean()))

            opt.zeroGradParams()
            moe.backward(up((-2.0 * diff / diff.size).astype(np.float32)), updGrad=False)
            opt.update()
            moe.reset()

    assert np.abs(np.array(losses["port"]) - np.array(losses["jax"])).max() <= BOUND * max(losses["jax"])
    assert losses["port"][-1] < losses["port"][0] * 0.9, losses["port"]


def testSwitchMoEParamTablesCarry():
    """A JAX ``SwitchMoE``'s table (its ``__gate__`` child's ``W`` too)
    loads into the port's by name, and comes back the same."""
    jmoe, _ = _twins()
    tmoe = _makeMoE(T, TC)
    table = {name: (ary + 1.0).astype(np.float32) for name, ary in _table(jmoe).items()}
    paramsFromNumpy(tmoe, table)

    back = paramsToNumpy(tmoe)
    assert sorted(back) == sorted(table) and "__gate__.W" in back
    assert all(np.array_equal(back[name], table[name]) for name in table)
    assert torch.equal(tmoe.gateVar.data, torch.from_numpy(table["__gate__.W"]))


def testSwitchMoETrainsUnderGlobalState():
    """The port's ``SwitchMoE`` trains under global state and gives the
    local-state run's numbers bit for bit (its experts read each variable's
    own tensor, a view of the flat buffer)."""
    runs = {}
    for globalState in (False, True):
        _, moe = _twins()
        opt = TMomentumSGD(learnRate=0.3, momRate=0.9)
        opt.setupOn(moe, useGlobalState=globalState)

        x = torch.from_numpy(np.random.RandomState(8).randn(32, 8).astype(np.float32))
        outs = []
        for _ in range(5):
            out = moe(x)
            outs.append(out.clone())
            opt.zeroGradParams()
            moe.backward(-out / out.numel(), updGrad=False)
            opt.update()
            moe.reset()
        runs[globalState] = (outs, paramsToNumpy(moe))

    assert all(torch.equal(a, b) for a, b in zip(runs[False][0], runs[True][0]))
    assert all(np.array_equal(runs[False][1][name], runs[True][1][name]) for name in runs[False][1])


def testJaxSwitchMoEFailsUnderGlobalState():
    """The divergence the port repairs: the JAX package's ``SwitchMoE``
    reads root buffers (``fused.collectParamBuffers``), which under global
    state are the optimizer's one flat buffer, and its backward fails."""
    J, JC, _, _, JOpt, jgpu = _jax()
    jmoe = _makeMoE(J, JC)
    JOpt.MomentumSGD(learnRate=0.3, momRate=0.9).setupOn(jmoe, useGlobalState=True)

    x = np.random.RandomState(8).randn(32, 8).astype(np.float32)
    out = jmoe(jgpu.to_gpu(x))
    with pytest.raises(Exception, match="reshape"):
        jmoe.backward(jgpu.to_gpu((-out.get() / out.size).astype(np.float32)), updGrad=False)


@pytest.fixture(scope="module")
def meshRefusals(tmp_path_factory):
    """The messages of ``mpnodes.refusals`` on a one-rank grid."""
    import mpnodes

    return mpnodes.runOnCpu(mpnodes.refusals, 1, "refusals", tmp_path_factory.mktemp("refusals"))


@pytest.mark.parametrize("method", ["SwitchMoE.distributedForward", "Pipeline.distributedForward",
                                    "Pipeline.distributedGrad"])
def testMeshMethodsRefuse(meshRefusals, method):
    """The mesh paths (which run: ``test_torch_pipeline.py``,
    ``test_torch_expert.py``) refuse on a mesh, with the JAX package's
    messages, what its ``moeForward`` and ``pipelineForward`` refuse: a gate
    whose width is not the expert count, a batch that does not split into
    the microbatches, a stage that changes the activation's shape."""
    want = {"SwitchMoE.distributedForward": "Gate width 2 does not match expert count 1",
            "Pipeline.distributedForward": "Batch 6 not divisible into 4 microbatches",
            "Pipeline.distributedGrad": "Pipeline stages must preserve activation shape/dtype"}[method]
    assert want in str(meshRefusals[method])


# -- Pipeline and functionalize ----------------------------------------------------------

def _pipes(seed=200, stages=4):
    J, JC, _, _, _, _ = _jax()
    pipes = []
    for M, C in ((J, JC), (T, TC)):
        pipe = C.Pipeline(name="pipe")
        for s in range(stages):
            pipe.append(_makeExpert(M, C, seed + s))
        pipes.append(pipe)

    return pipes


def testPipelineEagerEqualsSequentialTwin(tmp_path):
    """``testPipelineEagerEqualsSequentialAndRoundTrip``: the pipeline
    equals its stages run in turn, and the JAX package's output; saved with
    its blueprint, it rebuilds as a ``Pipeline`` (``blueprint.load``) that
    gives the same output bit for bit, and the JAX package rebuilds the
    port's file to its own output within 1e-5."""
    _, _, _, _, _, jgpu = _jax()
    from puzzlelib_tpu import blueprint as JBlueprint
    from puzzlelib_tpu_torch import blueprint as TBlueprint

    jpipe, tpipe = _pipes()
    x = np.random.RandomState(4).randn(8, 8).astype(np.float32)

    out = tpipe(torch.from_numpy(x)).clone()
    _close(out, jpipe(jgpu.to_gpu(x)).get())

    flow = torch.from_numpy(x)
    tpipe.reset()
    for stage in tpipe.graph:
        flow = stage(flow).clone()
        stage.reset()
    assert torch.equal(out, flow)

    tpipe.reset()
    path = str(tmp_path / "pipe.hdf")
    tpipe.save(path, withBlueprint=True)

    rebuilt = TBlueprint.load(path)
    assert type(rebuilt).__name__ == "Pipeline"
    assert torch.equal(rebuilt(torch.from_numpy(x)), out)

    jrebuilt = JBlueprint.load(path)
    assert type(jrebuilt).__name__ == "Pipeline"
    _close(out, jrebuilt(jgpu.to_gpu(x)).get())


@pytest.mark.parametrize("writer", ["port", "jax"])
def testSwitchMoEBlueprintAndCheckpointRoundTripTwin(writer, tmp_path):
    """``testSwitchMoEBlueprintAndCheckpointRoundTrip``: the layer saved
    with its blueprint by either package rebuilds in both as a
    ``SwitchMoE`` of 4 experts whose router and experts hold the written
    values bit for bit, and whose output agrees with the writer's (exact
    within a package, 1e-5 across)."""
    _, _, _, _, _, jgpu = _jax()
    from puzzlelib_tpu import blueprint as JBlueprint
    from puzzlelib_tpu_torch import blueprint as TBlueprint

    jmoe, tmoe = _twins()
    x = np.random.RandomState(2).randn(8, 8).astype(np.float32)
    if writer == "port":
        ref = tmoe(torch.from_numpy(x)).clone()
    else:
        ref = torch.from_numpy(np.array(jmoe(jgpu.to_gpu(x)).get()))
    written = tmoe if writer == "port" else jmoe
    written.reset()

    path = str(tmp_path / "moe.hdf")
    written.save(path, withBlueprint=True)

    trebuilt, jrebuilt = TBlueprint.load(path), JBlueprint.load(path)
    for rebuilt in (trebuilt, jrebuilt):
        assert type(rebuilt).__name__ == "SwitchMoE" and rebuilt.nExperts == 4
        got = {name: np.asarray(var.data.get() if hasattr(var.data, "get") else var.data.numpy())
               for var, names in rebuilt.getVarTable().items() for name in names}
        assert sorted(got) == sorted(_table(jmoe))
        for name, value in _table(jmoe).items():
            assert np.array_equal(got[name], value), name

    tout = trebuilt(torch.from_numpy(x))
    jout = jrebuilt(jgpu.to_gpu(x)).get()
    assert torch.equal(tout, ref) if writer == "port" else np.array_equal(jout, ref.numpy())
    _close(tout, jout)


def testPipelineStageParamsTwin():
    """``stackedStageParams`` stacks the JAX package's weights in its order,
    and ``checkStageStructure`` refuses a stage of another structure."""
    jpipe, tpipe = _pipes()
    want = jpipe.stackedStageParams()
    got = tpipe.stackedStageParams()

    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))

    tpipe.append(TC.Sequential().append(T.Linear(8, 4, initscheme="gaussian")))
    with pytest.raises(TC.ContainerError, match="stage 4"):
        tpipe.checkStageStructure()


@pytest.mark.parametrize("scale, momentum", [(1.0, 0.0), (0.3, 0.9)])
def testFoldStageGradsTwin(scale, momentum):
    """The same stacked numpy gradients fold into the same variable
    gradients in both packages: -scale * g + momentum * grad."""
    jpipe, tpipe = _pipes()
    rng = np.random.RandomState(9)
    stacked = [rng.randn(4, *np.asarray(p).shape[1:]).astype(np.float32) for p in jpipe.stackedStageParams()]

    for jstage, tstage in zip(jpipe.graph, tpipe.graph):
        for jvar, tvar in zip(jpipe._stageVars(jstage), tpipe._stageVars(tstage)):
            held = rng.randn(*jvar.grad.shape).astype(np.float32)
            jvar.grad.set(held)
            tvar.grad.copy_(torch.from_numpy(held))

    import jax.numpy as jnp
    jpipe.foldStageGrads([jnp.asarray(g) for g in stacked], scale, momentum)
    tpipe.foldStageGrads([torch.from_numpy(g) for g in stacked], scale, momentum)

    for jstage, tstage in zip(jpipe.graph, tpipe.graph):
        for jvar, tvar in zip(jpipe._stageVars(jstage), tpipe._stageVars(tstage)):
            _close(tvar.grad, jvar.grad.get())


def testFunctionalizeAppliesEachStage():
    """``functionalize(stage 0)`` applied with each stage's parameter list
    gives that stage's eager output bit for bit, and the JAX package's
    ``functionalize`` the same within the tier; stage 0 keeps its own
    weights after each call."""
    _jax()
    from puzzlelib_tpu.fused import collectParamBuffers, functionalize as jfunctionalize
    import jax.numpy as jnp

    jpipe, tpipe = _pipes(seed=300)
    apply, params = TFused.functionalize(tpipe.graph[0])
    assert tpipe._stageApply() is tpipe._stageApply()
    japply, _ = jfunctionalize(jpipe.graph[0])
    own = [p.clone() for p in params]

    x = np.random.RandomState(10).randn(16, 8).astype(np.float32)
    for jstage, tstage in zip(jpipe.graph, tpipe.graph):
        got = apply(TFused.paramList(tstage), torch.from_numpy(x))
        want = tstage(torch.from_numpy(x))
        assert torch.equal(got, want)
        tstage.reset()

        jwant = japply([buf.jax for buf in collectParamBuffers(jstage)], jnp.asarray(x))
        _close(got, np.asarray(jwant))

    assert all(torch.equal(p, q) for p, q in zip(TFused.paramList(tpipe.graph[0]), own))
    assert tpipe.graph[0].data is None


def testFunctionalizeSnapshotsAtCall():
    """The weights put back are those of the call, not of ``functionalize``:
    a module set up by an optimizer in between keeps its views of the flat
    buffer.  ``apply`` reads the tensors it is given (not copies of them
    into the weights), and leaves the weights' values alone."""
    stage = _makeExpert(T, TC, 11)
    apply, _ = TFused.functionalize(stage)

    opt = TMomentumSGD(0.1, momRate=0.9)
    opt.setupOn(stage, useGlobalState=True)
    views = TFused.paramList(stage)
    before = opt.shParams[torch.float32].ary.clone()

    x = torch.from_numpy(np.random.RandomState(12).randn(6, 8).astype(np.float32))
    doubled = apply([2.0 * p for p in views], x)
    own = apply(views, x)

    assert all(a is b for a, b in zip(TFused.paramList(stage), views))
    assert torch.equal(opt.shParams[torch.float32].ary, before)
    assert torch.equal(own, stage(x)) and not torch.equal(doubled, own)
    assert torch.equal(doubled, torch.tanh(x @ (2.0 * views[0]) + 2.0 * views[1]))


# -- the MoE trunk ---------------------------------------------------------------------

NARROW = dict(stages=2, dim=16, experts=3, classes=4)


def testMoETrunkTrainerTwin():
    """A 2-stage trunk at width 16 with 3 experts a stage, as
    ``tools/moeslice.py`` builds it from either package, through ``Trainer``
    with ``CrossEntropy`` and ``MomentumSGD(0.05, 0.9)`` in local state: 8
    shuffled steps of 16, each loss and every final weight the JAX
    package's."""
    J, JC, JH, JCost, JOpt, _ = _jax()
    jnet = moeslice.buildNet(modules=J, containers=JC, **NARROW)
    tnet = moeslice.buildNet(**NARROW)
    assert sorted(_table(jnet)) == sorted(paramsToNumpy(tnet))
    paramsFromNumpy(tnet, _table(jnet))

    x, y, _, _ = moeslice.data(128, 0, dim=16, classes=4)
    losses = {}
    for key, H, cost, opt, net in (("jax", JH, JCost.CrossEntropy(maxlabels=4), JOpt.MomentumSGD(0.05, 0.9), jnet),
                                   ("port", TH, TCrossEntropy(maxlabels=4), TMomentumSGD(0.05, 0.9), tnet)):
        opt.setupOn(net, useGlobalState=False)
        errors = []
        trainer = H.Trainer(net, cost, opt, batchsize=16, onBatchFinish=lambda h: errors.append(h.cost.getError()))
        np.random.seed(3)
        trainer.trainFromHost(x, y, macroBatchSize=len(x))
        losses[key] = errors

    assert len(losses["port"]) == len(losses["jax"]) == 8
    assert np.abs(np.array(losses["port"]) - np.array(losses["jax"])).max() <= BOUND * max(losses["jax"])

    weights = paramsToNumpy(tnet)
    for name, ref in _table(jnet).items():
        _close(weights[name], ref)


def testMoESliceStructure():
    """The slice's trunk at full width: 84,224 parameters, the JAX package's
    names and weights, 20 K1 products a forward at batch 128 (the experts'
    at the capacity of 64 rows) and the data's shape."""
    J, JC, _, _, _, _ = _jax()
    tnet = moeslice.buildNet()
    assert tnet.numOfParams() == 84224

    table = _table(moeslice.buildNet(modules=J, containers=JC))
    weights = paramsToNumpy(tnet)
    assert sorted(table) == sorted(weights) and all(np.array_equal(weights[n], table[n]) for n in table)

    launches = moeslice.linearLaunches(tnet, moeslice.BATCH)
    assert len(launches) == 20 and all(v == (1, 0) for v in launches.values())
    assert [mod._capacity(moeslice.BATCH) for mod in tnet.getAllByType(T.SwitchMoE)] == [64] * 4

    x, y, vx, vy = moeslice.data()
    assert x.shape == (1536, 64) and vx.shape == (256, 64) and 0.0 <= x.min() and x.max() <= 1.0
    assert set(np.unique(y)) == set(range(10)) and y.dtype == np.int32


def testMoESliceRoutesOnCpu():
    """On the CPU every route runs the plain versions: the same losses on
    the hand, library and fused routes and under global state, the same
    scores from ``Calculator`` and ``FusedCalculator``, and the stages
    through ``functionalize`` bit for bit."""
    x, y, _, _ = moeslice.data(64, 0, dim=16, classes=4)
    run = moeslice.buildRun(moeslice.buildNet(**NARROW), batch=16, classes=4)
    grun = moeslice.buildRun(moeslice.buildNet(**NARROW), globalState=True, batch=16, classes=4)

    losses = {}
    for key, r, algo in (("hopper", run, "hopper"), ("torch", run, "torch"), ("fused", run, "fused"),
                         ("global", grun, "hopper")):
        losses[key] = []
        r.train(algo, x, y, losses[key])

    assert len(losses["hopper"]) == 4 and np.isfinite(losses["hopper"]).all()
    assert losses["hopper"] == losses["torch"] == losses["fused"] == losses["global"]

    scores = [run.serve(algo, x)[0] for algo in ("hopper", "fused")]
    assert scores[0].shape == (64, 4) and np.array_equal(scores[0], scores[1])

    apply, _ = TFused.functionalize(run.net.graph[0].graph[0])
    for stage, (inp, out) in zip(run.net.graph[0].graph, moeslice.stageOutputs(run.net, torch.from_numpy(x[:16]))):
        assert torch.equal(apply(TFused.paramList(stage), inp), out)


@pytest.mark.cuda
def testSwitchMoEBackwardOnCard(monkeypatch):
    """On CUDA tensors the experts' products go to K1 (the custom operator
    ``puzzlelib::matmul``, which has no autograd formula) and the backward
    runs: it fails if the experts ever went through autograd.  The
    gradients are the CPU's within the f32 tier."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from puzzlelib_tpu_torch.ops.hopper import matmul

    x = np.random.RandomState(14).randn(32, 8).astype(np.float32)
    grad = np.random.RandomState(15).randn(32, 8).astype(np.float32)

    results = {}
    for device in ("cpu", "cuda"):
        monkeypatch.setattr(TConfig, "device", device)
        moe = _makeMoE(T, TC)
        matmul.launches = 0
        moe(torch.from_numpy(x).to(device))
        moe.backward(torch.from_numpy(grad).to(device), scale=0.5, momentum=0.0)
        results[device] = (moe.grad.cpu(), {n: moe.getVar(n).grad.cpu() for ns in moe.getVarTable().values()
                                             for n in ns}, matmul.launches)

    assert results["cuda"][2] == 4 and results["cpu"][2] == 0
    _close(results["cuda"][0], results["cpu"][0].numpy())
    for name, want in results["cpu"][1].items():
        _close(results["cuda"][1][name], want.numpy())


@pytest.mark.cuda
def testMoESliceOnCard(monkeypatch):
    """The narrow trunk on the card: K1 once a forward on each Linear on the
    hand and fused routes, none on the library route; the hand route's
    losses within 1e-4 of the library's, the fused ones within 1e-4 of
    eager's, the fused scores equal to eager's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from puzzlelib_tpu_torch.ops.hopper import matmul

    monkeypatch.setattr(TConfig, "device", "cuda")
    x, y, _, _ = moeslice.data(64, 0, dim=16, classes=4)
    run = moeslice.buildRun(moeslice.buildNet(**NARROW), batch=16, classes=4)

    losses = {}
    for algo in ("hopper", "torch", "fused"):
        run.train(algo, x, y)
        matmul.launches = 0
        losses[algo] = []
        run.train(algo, x, y, losses[algo])
        assert matmul.launches == (0 if algo == "torch" else 4 * 2 * 4)

    assert max(abs(a - b) for a, b in zip(losses["hopper"], losses["torch"])) <= 1e-4
    assert max(abs(a - b) for a, b in zip(losses["fused"], losses["hopper"])) <= 1e-4
    assert np.array_equal(run.serve("fused", x)[0], run.serve("hopper", x)[0])
