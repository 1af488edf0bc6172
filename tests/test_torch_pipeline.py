"""The GPipe schedule (``puzzlelib_tpu_torch/parallel/pipeline.py``) and the
``Pipeline`` container's mesh paths against the JAX package.

Twins of ``tests/test_pipeline.py`` (the functions) and of
``tests/test_moe_module.py``'s ``testPipelineDistributedGrad`` and
``testPipelineFoldedTrainingMatchesEagerModulePath`` (the container), with
the MoE trunk of ``testlib/pipelinemoe.py`` at its full width.  The port's
ranks are the four nodes of a ``runGrid`` on the CPU, each with a
``DeviceMesh`` of one "stage" axis (``mpnodes.py``); the JAX package runs on
four of its 8 virtual CPU devices.  The ranks must give the same bits, and
the port must be within f32's 1e-5 (of max(1, max |want|)) of the JAX
package, unless said otherwise.  Each module runs one grid, which every
test of it reads."""

import numpy as np
import pytest

import mpnodes
from puzzlelib_tpu_torch.tools import moeslice


BOUND = 1e-5
STAGES = 4
DIM = 8
TRUNK_STEPS = 2


def _jax():
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    return jax, jnp, Mesh(np.array(jax.devices()[:STAGES]), ("stage", ))


def _close(got, want, bound=BOUND):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _params(seed):
    """``tests/test_pipeline.py``'s ``makeParams``, stacked, as numpy."""
    rng = np.random.RandomState(seed)
    params = [{"w": rng.randn(DIM, DIM).astype(np.float32) * 0.5, "b": rng.randn(DIM).astype(np.float32) * 0.1}
              for _ in range(STAGES)]
    return {key: np.stack([p[key] for p in params]) for key in ("w", "b")}


def _functionInputs():
    rng1, rng3, rng5, rng8 = (np.random.RandomState(seed) for seed in (1, 3, 5, 8))
    inputs = {"forward": _params(0), "forwardX": rng1.randn(16, DIM).astype(np.float32), "grad": _params(2),
              "gradX": rng3.randn(8, DIM).astype(np.float32), "train": _params(4),
              "trainX": rng5.randn(16, DIM).astype(np.float32)}
    inputs["gradT"] = rng3.randn(8, DIM).astype(np.float32)
    inputs["trainT"] = np.tanh(rng5.randn(16, DIM)).astype(np.float32)
    inputs["moduleX"] = rng8.randn(16, DIM).astype(np.float32)
    inputs["moduleT"] = rng8.randn(16, DIM).astype(np.float32)
    return inputs


@pytest.fixture(scope="module")
def functions(tmp_path_factory):
    inputs = _functionInputs()
    outdir = tmp_path_factory.mktemp("functions")
    return inputs, mpnodes.runOnCpu(mpnodes.pipelineFunctions, STAGES, "functions", outdir, inputs)


def _blockFn(params, x):
    import jax.numpy as jnp
    return jnp.tanh(x @ params["w"] + params["b"])


def testPipelineForwardTwin(functions):
    """``testPipelineForwardMatchesSequential``: the four ranks' output
    equals the JAX package's ``pipelineForward`` and the stages run in
    turn."""
    jax, jnp, mesh = _jax()
    from puzzlelib_tpu.parallel.pipeline import pipelineForward

    inputs, got = functions
    want = pipelineForward(_blockFn, jax.tree.map(jnp.asarray, inputs["forward"]), jnp.asarray(inputs["forwardX"]),
                           mesh, "stage", microbatches=4)
    _close(got["forward"], want)

    ref = inputs["forwardX"]
    for s in range(STAGES):
        ref = np.tanh(ref @ inputs["forward"]["w"][s] + inputs["forward"]["b"][s])
    _close(got["forward"], ref)


def testPipelineGradTwin(functions):
    """``testPipelineGradMatchesSequential``: the loss and the stacked
    gradients of every rank equal the JAX package's ``pipelineGrad`` and
    ``jax.value_and_grad`` of the sequential composition."""
    jax, jnp, mesh = _jax()
    from puzzlelib_tpu.parallel.pipeline import pipelineGrad

    inputs, got = functions
    stacked = jax.tree.map(jnp.asarray, inputs["grad"])
    x, target = jnp.asarray(inputs["gradX"]), jnp.asarray(inputs["gradT"])

    def lossFn(out, tgt):
        return jnp.mean((out - tgt) ** 2)

    def seqLoss(params):
        h = x
        for i in range(STAGES):
            h = _blockFn(jax.tree.map(lambda p: p[i], params), h)
        return lossFn(h, target)

    for loss, grads in (pipelineGrad(_blockFn, lossFn, stacked, x, target, mesh, "stage", microbatches=4),
                        jax.value_and_grad(seqLoss)(stacked)):
        _close(got["grad/loss"], loss)
        for key in ("w", "b"):
            _close(got["grad/" + key], grads[key])


def testPipelineTrainingDecreasesLossTwin(functions):
    """``testPipelineTrainingDecreasesLoss``: 20 descent steps of 0.5 on the
    ranks' stacked gradients cut the loss below 0.7 of the first, each loss
    within 1e-4 relative of the JAX package's same loop."""
    jax, jnp, mesh = _jax()
    from puzzlelib_tpu.parallel.pipeline import pipelineGrad

    inputs, got = functions
    stacked = jax.tree.map(jnp.asarray, inputs["train"])
    x, target = jnp.asarray(inputs["trainX"]), jnp.asarray(inputs["trainT"])

    want = []
    for _ in range(20):
        loss, grads = pipelineGrad(_blockFn, lambda out, tgt: jnp.mean((out - tgt) ** 2), stacked, x, target, mesh,
                                   "stage", microbatches=4)
        stacked = jax.tree.map(lambda p, g: p - 0.5 * g, stacked, grads)
        want.append(float(loss))

    losses = got["train/losses"]
    assert losses[-1] < losses[0] * 0.7, losses
    assert np.abs(losses - np.array(want)).max() <= 1e-4 * np.abs(want).max()


def testPipelineValidationTwin(functions):
    """``testPipelineValidation``: a batch that does not split into the
    microbatches and a stage that changes the activation's shape raise the
    JAX package's messages, on every rank before anything is sent."""
    _, got = functions
    batch, shape = (str(text) for text in got["messages"])

    assert "not divisible into 4 microbatches" in batch
    assert "must preserve activation shape/dtype" in shape


def testPipelineModuleStagesTwin(functions):
    """``testPipelineModuleStages``: Module stages through ``pipelineForward``
    (``functionalize``'s apply, a forward) and through the ``Pipeline``
    container's ``distributedForward`` and ``distributedGrad`` (the module
    protocol) equal the stages run in turn, and the JAX package's
    ``pipelineForward`` / ``pipelineGrad`` of the same stages (loss at
    1e-6, gradients at 1e-4, as there)."""
    jax, jnp, mesh = _jax()
    from puzzlelib_tpu.backend import gpuarray
    from puzzlelib_tpu.containers import Sequential
    from puzzlelib_tpu.fused import collectParamBuffers, functionalize
    from puzzlelib_tpu.modules import Activation, Linear, tanh
    from puzzlelib_tpu.parallel.pipeline import pipelineForward, pipelineGrad, stackStageParams

    inputs, got = functions
    np.random.seed(7)

    def makeStage():
        stage = Sequential()
        stage.append(Linear(DIM, DIM, wscale=0.5, initscheme="gaussian"))
        stage.append(Activation(tanh))
        return stage

    stages = [makeStage() for _ in range(STAGES)]
    apply, _ = functionalize(makeStage())
    stacked = stackStageParams([[buf.jax for buf in collectParamBuffers(s)] for s in stages])
    x, target = jnp.asarray(inputs["moduleX"]), jnp.asarray(inputs["moduleT"])

    want = pipelineForward(apply, stacked, x, mesh, "stage", microbatches=4)
    cur = inputs["moduleX"]
    for stage in stages:
        cur = stage(gpuarray.to_gpu(cur)).get()

    for key in ("module/functions", "module/forward"):
        _close(got[key], want)
        _close(got[key], cur)

    loss, grads = pipelineGrad(apply, lambda o, t: jnp.mean((o - t) ** 2), stacked, x, target, mesh, "stage",
                               microbatches=4)
    assert abs(float(got["module/loss"]) - float(loss)) <= 1e-6
    for index, grad in enumerate(grads):
        _close(got["module/grad/%d" % index], grad, 1e-4)


@pytest.fixture(scope="module")
def container(tmp_path_factory):
    rng5, rng11 = np.random.RandomState(5), np.random.RandomState(11)
    trainX, trainT, _, _ = moeslice.data()
    inputs = {"gradX": rng5.randn(8, DIM).astype(np.float32), "foldX": rng11.randn(8, DIM).astype(np.float32),
              "trunkX": trainX[:TRUNK_STEPS * 128], "trunkT": trainT[:TRUNK_STEPS * 128], "trunkSteps": TRUNK_STEPS}
    inputs["gradT"] = rng5.randn(8, DIM).astype(np.float32)
    inputs["foldT"] = rng11.randn(8, DIM).astype(np.float32)
    outdir = tmp_path_factory.mktemp("container")
    return inputs, mpnodes.runOnCpu(mpnodes.pipelineContainer, STAGES, "container", outdir, inputs)


def _jaxPipe(seed):
    from puzzlelib_tpu.containers import Pipeline, Sequential
    from puzzlelib_tpu.modules import Activation, Linear, tanh

    pipe = Pipeline(name="pipe")
    for s in range(STAGES):
        np.random.seed(seed + s)
        stage = Sequential()
        stage.append(Linear(DIM, DIM, initscheme="gaussian", wscale=0.4))
        stage.append(Activation(tanh))
        pipe.append(stage)

    return pipe


def testPipelineDistributedGradTwin(container):
    """``testPipelineDistributedGrad``: the container's loss and stacked
    gradients equal the JAX package's ``distributedGrad``; its
    ``distributedForward`` equals the eager forward; the gradients fold
    into stage 0's variables."""
    jax, jnp, mesh = _jax()
    inputs, got = container

    pipe = _jaxPipe(300)
    loss, grads = pipe.distributedGrad(lambda out, tgt: jnp.mean((out - tgt) ** 2), jnp.asarray(inputs["gradX"]),
                                       jnp.asarray(inputs["gradT"]), mesh, microbatches=4)

    _close(got["grad/loss"], loss)
    for index, grad in enumerate(grads):
        _close(got["grad/%d" % index], grad)

    _close(got["grad/forward"], got["grad/eager"])
    _close(got["grad/forward"], pipe.distributedForward(jnp.asarray(inputs["gradX"]), mesh, microbatches=4).get())
    assert np.abs(got["grad/folded"]).sum() > 0.0


def testPipelineFoldedTrainingTwin(container):
    """``testPipelineFoldedTrainingMatchesEagerModulePath``: 3 steps of
    ``distributedGrad`` + ``foldStageGrads`` + ``MomentumSGD(0.1, 0.9)``
    give the JAX package's mesh loop's weights and the port's eager pipe's
    (the ``MSE`` cost)."""
    jax, jnp, mesh = _jax()
    from puzzlelib_tpu.fused import collectParamBuffers
    from puzzlelib_tpu.optimizers import MomentumSGD

    inputs, got = container
    pipe = _jaxPipe(500)
    optimizer = MomentumSGD(learnRate=0.1, momRate=0.9)
    optimizer.setupOn(pipe, useGlobalState=False)

    for _ in range(3):
        _, grads = pipe.distributedGrad(lambda out, tgt: 0.5 * jnp.mean((out - tgt) ** 2),
                                        jnp.asarray(inputs["foldX"]), jnp.asarray(inputs["foldT"]), mesh,
                                        microbatches=4)
        pipe.zeroGradParams()
        pipe.foldStageGrads(grads)
        optimizer.update()

    for index, buf in enumerate(collectParamBuffers(pipe)):
        _close(got["fold/mesh/%d" % index], buf.get())
        _close(got["fold/mesh/%d" % index], got["fold/eager/%d" % index])


def testMoETrunkDistributedGradTwin(container):
    """The MoE trunk of ``testlib/pipelinemoe.py`` at its full width (84,224
    parameters, batch 128 in 4 microbatches): each of 2 steps' loss and
    stacked gradients on the port's four ranks equal the JAX package's
    ``Pipeline.distributedGrad`` of the script's stages, and the weights
    after the two folded ``MomentumSGD`` updates equal the JAX loop's."""
    jax, jnp, mesh = _jax()
    from puzzlelib_tpu import containers as JC
    from puzzlelib_tpu import modules as J
    from puzzlelib_tpu.fused import collectParamBuffers
    from puzzlelib_tpu.optimizers import MomentumSGD

    inputs, got = container
    trunk = JC.Pipeline(name="trunk")
    for index in range(STAGES):
        trunk.append(moeslice.makeStage(index, modules=J, containers=JC))

    optimizer = MomentumSGD(learnRate=0.05, momRate=0.9)
    optimizer.setupOn(trunk, useGlobalState=False)

    def lossFn(out, tgt):
        logp = jax.nn.log_softmax(out[:, :10].astype(jnp.float32), axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, tgt[:, None], axis=1))

    for step in range(TRUNK_STEPS):
        rows = slice(step * 128, (step + 1) * 128)
        loss, grads = trunk.distributedGrad(lossFn, jnp.asarray(inputs["trunkX"][rows]),
                                            jnp.asarray(inputs["trunkT"][rows]), mesh, microbatches=4)

        _close(got["trunk/%d/loss" % step], loss)
        for index, grad in enumerate(grads):
            _close(got["trunk/%d/%d" % (step, index)], grad)

        trunk.foldStageGrads(grads)
        optimizer.update()

    buffers = collectParamBuffers(trunk)
    assert sum(int(np.prod(buf.shape)) for buf in buffers) == 84224
    for index, buf in enumerate(buffers):
        _close(got["trunk/weights/%d" % index], buf.get())
