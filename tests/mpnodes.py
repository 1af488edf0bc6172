"""Node targets of the model-parallel twins (``test_torch_pipeline.py``,
``test_torch_expert.py``, ``test_torch_seqparallel.py``,
``test_torch_tensorparallel.py``, ``test_torch_moe.py``).  ``runGrid``
spawns its nodes, which import their target by module name, so the targets
live here, in a module that imports neither JAX nor a test file.  Each
rank builds a ``DeviceMesh`` on the CPU over the grid's ranks and writes
what the test reads into ``outdir`` as ``<tag>-<rank>.npz``
(``tools/gridslice.py`` ``save``)."""

from pathlib import Path

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.placement_types import Replicate

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch import containers, fused, modules
from puzzlelib_tpu_torch import optimizers as TOpt
from puzzlelib_tpu_torch.cost import MSE
from puzzlelib_tpu_torch.grid import runGrid
from puzzlelib_tpu_torch.parallel import moe, pipeline, seqparallel
from puzzlelib_tpu_torch.parallel._tree import treeMap
from puzzlelib_tpu_torch.testlib import pipelinemoe
from puzzlelib_tpu_torch.tools.gridslice import load, save
from puzzlelib_tpu_torch.variable import Variable


# seconds a grid's collective may wait for its peers
TIMEOUT = 120


def runOnCpu(target, size, tag, outdir, *args):
    """Every rank's results (tagged ``tag``) of ``target(nodeinfo, *args,
    outdir)`` on a grid of ``size`` nodes on the CPU, after checking that
    the ranks agree bit for bit: rank 0's."""
    device, Config.device = Config.device, "cpu"
    try:
        runGrid(target, size, *args, outdir, timeout=TIMEOUT)
    finally:
        Config.device = device

    nodes = load(outdir, tag, size)
    for key in nodes[0]:
        for node in nodes[1:]:
            assert np.array_equal(node[key], nodes[0][key]), key

    return nodes[0]


def mesh(nodeinfo, names, shape=None):
    return init_device_mesh("cpu", shape or (nodeinfo.gridsize, ), mesh_dim_names=names)


def message(call):
    """The message of the ValueError that ``call`` raises, or ""."""
    try:
        call()
    except ValueError as e:
        return str(e)

    return ""


def tensors(tree):
    """A tree of numpy arrays as tensors."""
    return treeMap(torch.from_numpy, tree)


def arrays(prefix, tree):
    """{prefix/key: array} of a dict of tensors (or a list, keyed by
    position)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {"%s/%s" % (prefix, key): value.detach().numpy() for key, value in items}


# -- the GPipe functions (tests/test_pipeline.py) ----------------------------------------------------------

def blockFn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def meanSquare(out, target):
    return torch.mean((out - target) ** 2)


def halfMeanSquare(out, target):
    """The MSE cost's error: dot(diff, diff) / (2 N)."""
    return 0.5 * torch.mean((out - target) ** 2)


def _badBlock(params, x):
    return torch.cat([x, x], dim=1)


def stageParts(dim, stages, seed):
    """``tests/test_pipeline.py``'s Module stages: Linear(dim, dim) and tanh
    from ``np.random.seed(seed)``, then the template stage."""
    np.random.seed(seed)

    def makeStage():
        stage = containers.Sequential()
        stage.append(modules.Linear(dim, dim, wscale=0.5, initscheme="gaussian"))
        stage.append(modules.Activation(modules.tanh))
        return stage

    return [makeStage() for _ in range(stages)], makeStage()


def pipelineFunctions(nodeinfo, inputs, outdir):
    """The five cases of ``tests/test_pipeline.py`` on a stage axis of the
    grid's size: the forward, the loss and stacked gradients, 20 steps of
    descent, the two validation messages, and Module stages through the
    functions (a forward) and through ``Pipeline``."""
    stageMesh = mesh(nodeinfo, ("stage", ))
    results = {}

    stacked, x = tensors(inputs["forward"]), torch.from_numpy(inputs["forwardX"])
    results["forward"] = pipeline.pipelineForward(blockFn, stacked, x, stageMesh, "stage", microbatches=4).numpy()

    stacked, x = tensors(inputs["grad"]), torch.from_numpy(inputs["gradX"])
    target = torch.from_numpy(inputs["gradT"])
    loss, grads = pipeline.pipelineGrad(blockFn, meanSquare, stacked, x, target, stageMesh, "stage", 4)
    results.update(arrays("grad", grads), **{"grad/loss": loss.numpy()})

    stacked, x = tensors(inputs["train"]), torch.from_numpy(inputs["trainX"])
    target = torch.from_numpy(inputs["trainT"])
    losses = []
    for _ in range(20):
        loss, grads = pipeline.pipelineGrad(blockFn, meanSquare, stacked, x, target, stageMesh, "stage", 4)
        stacked = {key: stacked[key] - 0.5 * grads[key] for key in stacked}
        losses.append(float(loss))
    results["train/losses"] = np.array(losses)

    stacked = tensors(inputs["forward"])
    results["messages"] = np.array([message(lambda: pipeline.pipelineForward(fn, stacked, torch.zeros(rows, x.shape[1]),
                                                                             stageMesh, "stage", 4))
                                     for fn, rows in ((blockFn, 10), (_badBlock, 8))])

    stages, template = stageParts(inputs["moduleX"].shape[1], nodeinfo.gridsize, 7)
    apply, _ = fused.functionalize(template)
    stacked = pipeline.stackStageParams([fused.paramList(stage) for stage in stages])
    x, target = torch.from_numpy(inputs["moduleX"]), torch.from_numpy(inputs["moduleT"])
    results["module/functions"] = pipeline.pipelineForward(apply, stacked, x, stageMesh, "stage", 4).numpy()

    pipe = containers.Pipeline(name="pipe")
    for stage in stages:
        pipe.append(stage)

    results["module/forward"] = pipe.distributedForward(x, stageMesh, microbatches=4).numpy()
    loss, grads = pipe.distributedGrad(meanSquare, x, target, stageMesh, microbatches=4)
    results.update(arrays("module/grad", grads), **{"module/loss": loss.numpy()})

    save(outdir, "functions", nodeinfo.index, **results)


# -- the Pipeline container (tests/test_moe_module.py, testlib/pipelinemoe.py) -----------------------------

def expertStage(seed, dim=8):
    """``tests/test_moe_module.py``'s ``_makeExpert``."""
    np.random.seed(seed)
    stage = containers.Sequential()
    stage.append(modules.Linear(dim, dim, initscheme="gaussian", wscale=0.4))
    stage.append(modules.Activation(modules.tanh))
    return stage


def expertPipe(seed, stages):
    pipe = containers.Pipeline(name="pipe")
    for index in range(stages):
        pipe.append(expertStage(seed + index))

    return pipe


def pipelineContainer(nodeinfo, inputs, outdir):
    """``testPipelineDistributedGrad`` (seed 300), 3 folded MomentumSGD
    steps (seed 500; the mesh loop and the eager pipe with ``MSE``), and
    ``steps`` distributed steps of the MoE trunk on ``inputs["trunkX"]``:
    each step's loss and stacked gradients, and the weights after them."""
    stageMesh = mesh(nodeinfo, ("stage", ))
    stages = nodeinfo.gridsize
    results = {}

    pipe = expertPipe(300, stages)
    x, target = torch.from_numpy(inputs["gradX"]), torch.from_numpy(inputs["gradT"])
    loss, grads = pipe.distributedGrad(meanSquare, x, target, stageMesh, microbatches=4)
    results.update(arrays("grad", grads), **{"grad/loss": loss.numpy()})

    results["grad/forward"] = pipe.distributedForward(x, stageMesh, microbatches=4).numpy()
    results["grad/eager"] = pipe(x).numpy()
    pipe.reset()

    pipe.zeroGradParams()
    pipe.foldStageGrads(grads)
    results["grad/folded"] = pipe._stageVars(pipe.graph[0])[0].grad.numpy()

    x, target = torch.from_numpy(inputs["foldX"]), torch.from_numpy(inputs["foldT"])
    for route in ("mesh", "eager"):
        pipe = expertPipe(500, stages)
        optimizer = TOpt.MomentumSGD(learnRate=0.1, momRate=0.9)
        optimizer.setupOn(pipe, useGlobalState=False)
        cost = MSE()

        for _ in range(3):
            if route == "mesh":
                _, grads = pipe.distributedGrad(halfMeanSquare, x, target, stageMesh, microbatches=4)
                pipe.zeroGradParams()
                pipe.foldStageGrads(grads)
            else:
                grad = cost(pipe(x), target, queryError=False)
                pipe.zeroGradParams()
                pipe.backward(grad, updGrad=False)
                pipe.reset()

            optimizer.update()

        results.update(arrays("fold/" + route, fused.paramList(pipe)))

    trunk = pipelinemoe.buildPipe()
    optimizer = TOpt.MomentumSGD(learnRate=pipelinemoe.LEARN_RATE, momRate=pipelinemoe.MOM_RATE)
    optimizer.setupOn(trunk, useGlobalState=False)

    x, target = torch.from_numpy(inputs["trunkX"]), torch.from_numpy(inputs["trunkT"])
    for step in range(int(inputs["trunkSteps"])):
        rows = slice(step * pipelinemoe.BATCH, (step + 1) * pipelinemoe.BATCH)
        loss, grads = trunk.distributedGrad(pipelinemoe.lossFn, x[rows], target[rows], stageMesh,
                                            microbatches=pipelinemoe.MICROBATCHES)
        results.update(arrays("trunk/%d" % step, grads), **{"trunk/%d/loss" % step: loss.numpy()})

        trunk.foldStageGrads(grads)
        optimizer.update()

    results.update(arrays("trunk/weights", fused.paramList(trunk)))
    save(outdir, "container", nodeinfo.index, **results)


# -- expert parallelism (tests/test_moe.py, tests/test_moe_module.py) ----------------------------------------

def expertFn(params, tokens):
    return torch.relu(tokens @ params["w"]) @ params["w2"]


def rawExpert(params, tokens):
    w1, b1, w2, b2 = params
    return torch.relu(tokens @ w1 + b1) @ w2 + b2


def moduleExperts(dim, experts, seed):
    """``testMoEModuleExperts``' experts from ``np.random.seed(seed)``, then
    the template."""
    np.random.seed(seed)

    def makeExpert():
        expert = containers.Sequential()
        expert.append(modules.Linear(dim, 16, wscale=0.3, initscheme="gaussian"))
        expert.append(modules.Activation(modules.relu))
        expert.append(modules.Linear(16, dim, wscale=0.3, initscheme="gaussian"))
        return expert

    return [makeExpert() for _ in range(experts)], makeExpert()


def switchMoE(M=modules, C=containers, experts=4):
    """``tests/test_moe_module.py``'s ``_makeMoE`` of the modules ``M`` and
    containers ``C`` given."""
    moe = M.SwitchMoE(8, name="moe")
    for e in range(experts):
        np.random.seed(100 + e)
        expert = C.Sequential()
        expert.append(M.Linear(8, 8, initscheme="gaussian", wscale=0.4))
        expert.append(M.Activation(M.tanh))
        moe.append(expert)

    return moe


def expertParallel(nodeinfo, inputs, outdir):
    """``tests/test_moe.py``'s three cases on an expert axis of the grid's
    size (the first step's gradients of ``testMoETrains`` kept), the
    module layer's ``distributedForward`` under global state, and the
    gate-width message."""
    expertMesh = mesh(nodeinfo, ("expert", ))
    results = {}

    out, aux = moe.moeForward(expertFn, tensors(inputs["oracle"]), torch.from_numpy(inputs["oracleGate"]),
                              torch.from_numpy(inputs["oracleX"]), expertMesh, "expert", capacityFactor=1.25)
    results.update({"oracle/out": out.numpy(), "oracle/aux": aux.numpy()})

    stacked = treeMap(lambda leaf: leaf.requires_grad_(True), tensors(inputs["train"]))
    gateW = torch.from_numpy(inputs["trainGate"]).requires_grad_(True)
    x, target = torch.from_numpy(inputs["trainX"]), torch.from_numpy(inputs["trainT"])

    losses = []
    for step in range(25):
        out, aux = moe.moeForward(expertFn, stacked, gateW, x, expertMesh, "expert")
        loss = torch.mean((out - target) ** 2) + 0.01 * aux
        gw, gw2, gGate = torch.autograd.grad(loss, [stacked["w"], stacked["w2"], gateW])

        if step == 0:
            results.update({"train/w": gw.numpy(), "train/w2": gw2.numpy(), "train/gate": gGate.numpy()})

        with torch.no_grad():
            stacked = {"w": (stacked["w"] - 0.3 * gw).requires_grad_(True),
                       "w2": (stacked["w2"] - 0.3 * gw2).requires_grad_(True)}
            gateW = (gateW - 0.3 * gGate).requires_grad_(True)

        losses.append(float(loss))
    results["train/losses"] = np.array(losses)

    experts, template = moduleExperts(8, nodeinfo.gridsize, 21)
    apply, _ = fused.functionalize(template)
    stacked = moe.stackExpertParams([fused.paramList(expert) for expert in experts])
    gateW, x = torch.from_numpy(inputs["moduleGate"]), torch.from_numpy(inputs["moduleX"])

    out, aux = moe.moeForward(apply, stacked, gateW, x, expertMesh, "expert")
    ref, refAux = moe.moeForward(rawExpert, stacked, gateW, x, expertMesh, "expert")
    results.update({"module/out": out.detach().numpy(), "module/aux": aux.detach().numpy(),
                    "module/raw": ref.detach().numpy(), "module/rawAux": refAux.detach().numpy()})

    layer = switchMoE()
    TOpt.MomentumSGD(learnRate=0.3, momRate=0.9).setupOn(layer, useGlobalState=True)
    x = torch.from_numpy(inputs["layerX"])

    out, aux = layer.distributedForward(x, expertMesh)
    eager = layer(x).clone()
    results.update({"layer/out": out.numpy(), "layer/aux": aux.numpy(), "layer/eager": eager.numpy(),
                    "layer/eagerAux": layer.auxLoss.numpy()})

    wide = torch.zeros(8, nodeinfo.gridsize + 1)
    results["message"] = message(lambda: moe.moeForward(expertFn, tensors(inputs["oracle"]), wide,
                                                        torch.from_numpy(inputs["oracleX"]), expertMesh))

    save(outdir, "expert", nodeinfo.index, **results)


# -- sequence parallelism (tests/test_seqparallel.py) ---------------------------------------------------------

def seqParallel(nodeinfo, inputs, outdir):
    """``tests/test_seqparallel.py``'s three cases on a model axis of the
    grid's size: the output, the gradients of a loss on every rank, and the
    two messages."""
    modelMesh = mesh(nodeinfo, ("model", ))
    results = {}

    x, w1, w2 = (torch.from_numpy(inputs["dense/" + key]) for key in ("x", "w1", "w2"))
    results["dense"] = seqparallel.seqParallelMLP(x, w1, w2, modelMesh, axis="model").numpy()

    x, t = torch.from_numpy(inputs["grad/x"]), torch.from_numpy(inputs["grad/t"])
    w1, w2 = (torch.from_numpy(inputs["grad/" + key]).requires_grad_(True) for key in ("w1", "w2"))
    loss = torch.mean((seqparallel.seqParallelMLP(x, w1, w2, modelMesh) - t) ** 2)
    g1, g2 = torch.autograd.grad(loss, [w1, w2])
    results.update({"grad/w1": g1.numpy(), "grad/w2": g2.numpy(), "grad/loss": loss.detach().numpy()})

    results["messages"] = np.array([
        message(lambda: seqparallel.seqParallelMLP(torch.zeros(10, 8), torch.zeros(8, 32), torch.zeros(32, 8),
                                                   modelMesh)),
        message(lambda: seqparallel.seqParallelMLP(torch.zeros(16, 8), torch.zeros(8, 30), torch.zeros(30, 8),
                                                   modelMesh)),
    ])

    save(outdir, "seq", nodeinfo.index, **results)


# -- tensor parallelism and ZeRO (tests/test_parallel.py) -------------------------------------------------------

def tpNet(M=modules, C=containers):
    """``testFusedTensorParallelMatchesSingle``'s MLP, from seed 11."""
    np.random.seed(11)
    seq = C.Sequential()
    seq.append(M.Linear(16, 32))
    seq.append(M.Activation(M.relu))
    seq.append(M.Linear(32, 8))
    return seq


def zeroNet(width, M=modules, C=containers):
    """``testFusedZeroOptimizerSharding``'s MLP over ``width`` ranks, from
    seed 17."""
    np.random.seed(17)
    seq = C.Sequential()
    seq.append(M.Linear(8, 8 * width))
    seq.append(M.Activation(M.relu))
    seq.append(M.Linear(8 * width, 4))
    return seq


def squareNet(M=modules, C=containers):
    """A plain and a transposed Linear of one square shape, from seed 13:
    ``tensorParallelSpecs`` shards the first W on dim 1, the second on dim
    0, and places both W's optimizer slots as the second (the variable of
    their shape, the last such), so the first layer's slots lie across its
    blocks."""
    np.random.seed(13)
    seq = C.Sequential()
    seq.append(M.Linear(16, 16))
    seq.append(M.Activation(M.relu))
    seq.append(M.Linear(16, 16, transpose=True))
    return seq


def replicateSlots(specs, net, cost, optimizer):
    """``specs`` with every optimizer slot replicated: the tensor-parallel
    variables' slots then lie whole beside their sharded variables."""
    entries = fused._firstOfEachRoot(fused._stateProvenance(net, cost, optimizer))
    return [tuple(Replicate() for _ in placement) if isinstance(owner, Variable) else placement
            for (_, owner, _), placement in zip(entries, specs)]


def convNet(M=modules, C=containers):
    """A conv net with a batch norm (``gridnodes.bnNet``), from seed 5, for
    (B, 3, 8, 8) inputs and 4 outputs."""
    np.random.seed(5)
    seq = C.Sequential()
    seq.append(M.Conv2D(3, 4, 3, pad=1, name="conv"))
    seq.append(M.BatchNorm2D(4, name="bn"))
    seq.append(M.Activation(M.relu, name="relu"))
    seq.append(M.MaxPool2D(name="pool"))
    seq.append(M.Flatten(name="flat"))
    seq.append(M.Linear(64, 4, name="fc"))
    return seq


def encode(placements):
    """A placement list as an int array (buffer, mesh dim): the sharded dim,
    or -1 where replicated."""
    return np.array([[p.dim if p.is_shard() else -1 for p in placement] for placement in placements], dtype=np.int64)


def _fusedSteps(net, optimizer, data, target, steps, mesh=None, specs=None):
    optimizer.setupOn(net, useGlobalState=False)
    shardings = None if specs is None else specs(net, MSE(), optimizer)
    step = fused.FusedStep(net, MSE(), optimizer, mesh=mesh, stateShardings=shardings)

    for _ in range(steps):
        step(data, target)

    return step, shardings


def tensorParallel(nodeinfo, inputs, outdir):
    """3 steps of the MLP, of the conv net and of the square net
    (``MomentumSGD(0.05, 0.9)``, local state) through ``FusedStep`` with
    ``tensorParallelSpecs`` over a (data 2, model 2) mesh and over no mesh,
    and of the MLP with those specs but its slots replicated
    ("replicated"): the weights, the specs, and the variables whose
    gradient blocks the step gathers whole because their slots are placed
    otherwise."""
    tpMesh = mesh(nodeinfo, ("data", "model"), (2, nodeinfo.gridsize // 2))
    results = {}

    def specs(n, c, o):
        return fused.tensorParallelSpecs(n, c, o, tpMesh, modelAxis="model")

    def replicated(n, c, o):
        return replicateSlots(specs(n, c, o), n, c, o)

    for name, build, rule in (("mlp", tpNet, specs), ("conv", convNet, specs), ("square", squareNet, specs),
                              ("replicated", tpNet, replicated)):
        data, target = torch.from_numpy(inputs[name + "/x"]), torch.from_numpy(inputs[name + "/t"])

        net = build()
        step, placed = _fusedSteps(net, TOpt.MomentumSGD(0.05, momRate=0.9), data, target, 3, tpMesh, rule)
        results.update(arrays(name + "/mesh", fused.paramList(net)), **{name + "/specs": encode(placed),
                                                                        name + "/wholeGrads": len(step._wholeGrads)})

        net = build()
        _fusedSteps(net, TOpt.MomentumSGD(0.05, momRate=0.9), data, target, 3)
        results.update(arrays(name + "/single", fused.paramList(net)))

    save(outdir, "tp", nodeinfo.index, **results)


def zeroSharded(nodeinfo, inputs, outdir):
    """3 steps of the ZeRO MLP (``Adam(0.01)``, local state) through
    ``FusedStep`` with ``zeroOptimizerSpecs`` over a data axis of the grid's
    size and over no mesh: the weights, the specs (and the conv net's), the
    elements each Adam slot holds against its variable's, and the messages
    of what refuses the cut slots afterwards: a second step's specs, the
    optimizer's own update and its save."""
    dataMesh = mesh(nodeinfo, ("data", ))
    width = nodeinfo.gridsize
    data, target = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["t"])
    results = {}

    net = zeroNet(width)
    optimizer = TOpt.Adam(alpha=0.01)
    _, specs = _fusedSteps(net, optimizer, data, target, 3, dataMesh,
                           lambda n, c, o: fused.zeroOptimizerSpecs(n, c, o, dataMesh, dataAxis="data"))
    results.update(arrays("mesh", fused.paramList(net)), specs=encode(specs))
    results["slots"] = np.array([[state[slot].numel(), net.getVar(name).data.numel()]
                                 for name, state in optimizer.states.items() for slot in sorted(state)])
    results["refusals"] = np.array([
        message(lambda: fused.FusedStep(net, MSE(), optimizer, mesh=dataMesh, stateShardings=specs)),
        message(optimizer.update),
        message(lambda: optimizer.save(str(Path(outdir) / ("refused-%d.h5" % nodeinfo.index)))),
    ])

    net = zeroNet(width)
    _fusedSteps(net, TOpt.Adam(alpha=0.01), data, target, 3)
    results.update(arrays("single", fused.paramList(net)))

    conv = convNet()
    convOptimizer = TOpt.Adam(alpha=0.01)
    convOptimizer.setupOn(conv, useGlobalState=False)
    results["conv/specs"] = encode(fused.zeroOptimizerSpecs(conv, MSE(), convOptimizer, dataMesh))

    save(outdir, "zero", nodeinfo.index, **results)


# -- refusals ------------------------------------------------------------------------------------------------

def refusals(nodeinfo, outdir):
    """The messages of the mesh methods' refusals on a one-rank mesh: a
    batch that does not split into the microbatches, a stage that changes
    the activation's shape, and a gate that does not match the experts."""
    oneMesh = mesh(nodeinfo, ("stage", ))
    x = torch.zeros(6, 8)

    pipe = containers.Pipeline().append(expertStage(1))
    np.random.seed(2)
    wide = containers.Pipeline().append(modules.Linear(8, 16))

    layer = switchMoE(experts=1)
    layer._gateMod.setVar("W", Variable(torch.zeros(8, 2)))

    messages = {
        "Pipeline.distributedForward": message(lambda: pipe.distributedForward(x, oneMesh, microbatches=4)),
        "Pipeline.distributedGrad": message(lambda: wide.distributedGrad(meanSquare, x, x, oneMesh, microbatches=2)),
        "SwitchMoE.distributedForward": message(lambda: layer.distributedForward(x, mesh(nodeinfo, ("expert", )))),
    }
    save(outdir, "refusals", nodeinfo.index, **{key: np.array(value) for key, value in messages.items()})
