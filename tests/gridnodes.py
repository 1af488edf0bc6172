"""Node targets of the grid and mesh twins (``test_torch_grid.py``,
``test_torch_mesh.py``).  ``runGrid`` spawns its nodes, which import their
target by module name, so the targets live here, in a module that imports
neither JAX nor a test file.  Each node writes what the test reads into
``outdir`` as ``<tag>-<node index>.npz``."""

import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from puzzlelib_tpu_torch import containers, fused, modules
from puzzlelib_tpu_torch import optimizers as TOpt
from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.cost import MSE
from puzzlelib_tpu_torch.testlib import multigpucifar10, multigpumnist
from puzzlelib_tpu_torch.tools.gridslice import save, weights


JAX_MODULES = ("jax", "jaxlib", "ml_dtypes", "puzzlelib_tpu")

# the nine optimizers, built with a nodeinfo, by name
OPTIMIZERS = ("SGD", "MomentumSGD", "NesterovSGD", "Adam", "AdaGrad", "AdaDelta", "RMSProp", "RMSPropGraves",
              "SMORMS3")


def leakedJax():
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_MODULES)


def meanAndSum(nodeinfo, bf16Values, outdir):
    """``meanValue`` of the node index, ``sumTensor`` of index + 1 in f32
    and of ``bf16Values[index]`` in bf16, ``broadcastBuffer`` of a buffer
    that differs by node, and the JAX modules this process holds."""
    mean = nodeinfo.meanValue(float(nodeinfo.index))

    f32 = torch.full((4, ), float(nodeinfo.index + 1))
    nodeinfo.sumTensor("grad", f32)

    bf16 = torch.tensor(bf16Values[nodeinfo.index], dtype=torch.float32).to(torch.bfloat16)
    nodeinfo.sumTensor("grad", bf16)

    buffer = torch.arange(6, dtype=torch.float32) * (nodeinfo.index + 1)
    half = (torch.arange(6, dtype=torch.float32) / 3 * (nodeinfo.index + 1)).to(torch.bfloat16)
    nodeinfo.broadcastBuffer("data", buffer)
    nodeinfo.broadcastBuffer("data", half)

    save(outdir, "collectives", nodeinfo.index, mean=mean, f32=f32.numpy(), bf16=bf16.float().numpy(),
         buffer=buffer.numpy(), half=half.float().numpy(), device=nodeinfo.device,
         leaked=np.array(leakedJax(), dtype=str))


def parallelNet(M=modules, C=containers):
    """The net of ``tests/test_parallel.py``'s grid and mesh tests, of the
    modules ``M`` and containers ``C`` given (the port's by default)."""
    seq = C.Sequential()
    seq.append(M.Linear(8, 6, name="fc1"))
    seq.append(M.Activation(M.relu, name="relu"))
    seq.append(M.Linear(6, 4, name="fc2"))
    return seq


def bnNet(M=modules, C=containers):
    """A small conv net with a batch norm, for (B, 3, 8, 8) inputs and 4
    outputs."""
    seq = C.Sequential()
    seq.append(M.Conv2D(3, 4, 3, pad=1, name="conv"))
    seq.append(M.BatchNorm2D(4, name="bn"))
    seq.append(M.Activation(M.relu, name="relu"))
    seq.append(M.MaxPool2D(name="pool"))
    seq.append(M.Flatten(name="flat"))
    seq.append(M.Linear(64, 4, name="fc"))
    return seq


# the nets of the mesh twins by name: (the function that makes it, numpy seed)
NETS = {"parallel7": (parallelNet, 7), "parallel17": (parallelNet, 17), "bn": (bnNet, 5)}


def build(name, M=modules, C=containers):
    make, seed = NETS[name]
    np.random.seed(seed)
    return make(M, C)


def dataParallel(nodeinfo, fullData, fullTarget, steps, outdir):
    """``tests/test_parallel.py:26-72`` on this node: the net from seed 42,
    ``MomentumSGD(0.05)`` with the nodeinfo, node i's 8 rows, ``steps``
    eager steps."""
    np.random.seed(42)
    seq = parallelNet()

    optimizer = TOpt.MomentumSGD(learnRate=0.05, nodeinfo=nodeinfo)
    optimizer.setupOn(seq, useGlobalState=True)

    rows = slice(nodeinfo.index * 8, (nodeinfo.index + 1) * 8)
    data, target = gpuarray.to_gpu(fullData[rows]), gpuarray.to_gpu(fullTarget[rows])

    mse = MSE()
    for _ in range(steps):
        error, grad = mse(seq(data), target)

        optimizer.zeroGradParams()
        seq.backward(grad)
        optimizer.update()

    save(outdir, "dataparallel", nodeinfo.index, error=nodeinfo.meanValue(error), **weights(seq))


def optimizerGrid(nodeinfo, fullData, fullTarget, steps, outdir):
    """Each of the nine optimizers, built with the nodeinfo, trains the net
    of ``dataParallel`` from seed 42 for ``steps`` steps on node i's rows;
    a tenth, set up in local state, must assert."""
    rows = slice(nodeinfo.index * 8, (nodeinfo.index + 1) * 8)
    data, target = gpuarray.to_gpu(fullData[rows]), gpuarray.to_gpu(fullTarget[rows])

    results = {}
    for name in OPTIMIZERS:
        np.random.seed(42)
        seq = parallelNet()

        optimizer = getattr(TOpt, name)(nodeinfo=nodeinfo)
        optimizer.setupOn(seq, useGlobalState=True)

        mse = MSE()
        for _ in range(steps):
            _, grad = mse(seq(data), target)

            optimizer.zeroGradParams()
            seq.backward(grad)
            optimizer.update()

        results.update({"%s/%s" % (name, key): value for key, value in weights(seq).items()})

    try:
        TOpt.SGD(nodeinfo=nodeinfo).setupOn(parallelNet(), useGlobalState=False)
        localAsserts = False
    except AssertionError:
        localAsserts = True

    save(outdir, "optimizers", nodeinfo.index, localAsserts=localAsserts, **results)


def failing(nodeinfo, failAt):
    """Node ``failAt`` raises; the others wait for it in a collective."""
    if nodeinfo.index == failAt:
        raise ValueError("node %d failed on purpose" % nodeinfo.index)

    nodeinfo.meanValue(1.0)


def _mesh(nodeinfo):
    return init_device_mesh("cpu", (nodeinfo.gridsize, ), mesh_dim_names=("data", ))


def _meshSteps(net, cost, optimizer, data, target, steps, mesh, grouped=False):
    """``steps`` calls of a ``FusedStep`` over ``mesh`` (or one ``many``
    call of ``steps`` steps with ``grouped``)."""
    step = fused.FusedStep(net, cost, optimizer, mesh=mesh)
    if grouped:
        step.many(data, target, steps)
    else:
        for _ in range(steps):
            step(data, target)

    return step


def meshTwin(nodeinfo, netName, data, target, steps, useGlobalState, outdir, grouped=False, countCollectives=False):
    """``steps`` mesh steps of the net ``NETS[netName]`` (MSE,
    ``MomentumSGD(0.05)``) on the global batch, and the same steps over no
    mesh; the weights, the running statistics, the mean error and, with
    ``countCollectives``, the all-reduces of one more mesh step."""
    results = {}
    for route, mesh in (("mesh", _mesh(nodeinfo)), ("single", None)):
        net = build(netName)
        optimizer = TOpt.MomentumSGD(learnRate=0.05)
        optimizer.setupOn(net, useGlobalState=useGlobalState)

        cost = MSE()
        _meshSteps(net, cost, optimizer, data, target, steps, mesh, grouped)

        results.update({"%s/%s" % (route, key): value for key, value in weights(net).items()})
        results.update({"%s/attr/%s.%s" % (route, mod.name, name): gpuarray.get(attr).astype(np.float32)
                        for mod in net.modules() for name, attr in mod.attrs.items()})
        results["%s/error" % route] = cost.getMeanError()

        if countCollectives and mesh is not None:
            results["collectives"] = _countAllReduces(
                lambda: _meshSteps(net, cost, optimizer, data, target, 1, mesh))

    save(outdir, "mesh", nodeinfo.index, **results)


def _countAllReduces(run):
    calls = []
    allReduce = dist.all_reduce

    def counting(tensor, *args, **kwargs):
        calls.append(tuple(tensor.shape))
        return allReduce(tensor, *args, **kwargs)

    dist.all_reduce = counting
    try:
        run()
    finally:
        dist.all_reduce = allReduce

    return len(calls)


def stateShardings(nodeinfo, outdir):
    """``FusedStep(mesh=..., stateShardings=...)`` refusals on a real mesh:
    the messages of a spec list under global state and of one of the wrong
    length."""
    mesh = _mesh(nodeinfo)
    messages = {}

    for case, useGlobalState in (("globalState", True), ("length", False)):
        np.random.seed(42)
        net = parallelNet()
        optimizer = TOpt.MomentumSGD(0.05)
        optimizer.setupOn(net, useGlobalState=useGlobalState)

        try:
            fused.FusedStep(net, MSE(), optimizer, mesh=mesh, stateShardings=[])
            messages[case] = ""
        except ValueError as e:
            messages[case] = str(e)

    save(outdir, "shardings", nodeinfo.index, **messages)


def fusedRefusesNodeinfo(nodeinfo, outdir):
    np.random.seed(42)
    net = parallelNet()
    optimizer = TOpt.MomentumSGD(0.05, nodeinfo=nodeinfo)
    optimizer.setupOn(net, useGlobalState=True)

    try:
        fused.FusedStep(net, MSE(), optimizer)
        message = ""
    except ValueError as e:
        message = str(e)

    save(outdir, "refuses", nodeinfo.index, message=message)


def script(nodeinfo, name, data, labels, epochs, sizes, outdir):
    """A multi-GPU script's ``train`` on this node (``name`` "mnist" or
    "cifar10"), with each step's local error recorded."""
    losses = []
    onBatch = lambda trainer: losses.append(trainer.cost.getError())   # noqa: E731

    if name == "mnist":
        net, history = multigpumnist.train(nodeinfo, data, labels, epochs=epochs, trainsize=sizes[0],
                                           valsize=sizes[1], onBatchFinish=onBatch)
    else:
        net, history = multigpucifar10.train(nodeinfo, data, labels, epochs=epochs, valsize=sizes[1],
                                             onBatchFinish=onBatch)

    save(outdir, name, nodeinfo.index, history=np.array(history), losses=np.array(losses), **weights(net))
