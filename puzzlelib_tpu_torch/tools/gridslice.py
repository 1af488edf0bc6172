"""The data-parallel slice, as ``chip_smoke.py`` [grid] and the tests run it.

- ``mnistNode``: a node of ``testlib/multigpumnist.py``'s recipe
  (``multigpumnist.train``, one epoch) that records, into ``outdir``, each
  step's local loss, the time and K1's launch count at each step's end, the
  weights after step 1 and at the end, the grid's errors, and the time of
  ``sumTensor`` on a flat f32 buffer of LeNet's size.
- ``oracle``: the same training in one process: LeNet from the recipe's
  seed, the numpy draws of the nodes' trainers taken in the same order, and
  at each step the rows that the nodes take together at that step, as one
  batch of the global size.
- ``meshNode``: LeNet through ``FusedStep(mesh=...)`` over a one-rank data
  axis and through the step over no mesh, on the same batches: the weights
  of both, the recordings, K1's launches, and the kernels that a profiled
  replay of the mesh step ran.

The device is the node's ``Config.device`` (the grid sets it) or, for the
oracle, the caller's.
"""

import time
from pathlib import Path

import numpy as np
import torch

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.backend.device import synchronize
from puzzlelib_tpu_torch.cost import CrossEntropy
from puzzlelib_tpu_torch.handlers import Trainer
from puzzlelib_tpu_torch.models.nets.lenet import loadLeNet
from puzzlelib_tpu_torch.ops.hopper import matmul
from puzzlelib_tpu_torch.optimizers import MomentumSGD
from puzzlelib_tpu_torch.testlib import multigpumnist

# sumTensor timed over this many calls, after as many again to warm up
ALLREDUCE_CALLS = 20


def weights(net):
    """{variable name: its value as f32 numpy}."""
    return {name: gpuarray.get(var.data).astype(np.float32) for var, names in net.getVarTable().items()
            for name in names}


def save(outdir, tag, index, **arrays):
    np.savez(Path(outdir) / ("%s-%d.npz" % (tag, index)), **arrays)


def load(outdir, tag, size):
    return [dict(np.load(Path(outdir) / ("%s-%d.npz" % (tag, index)))) for index in range(size)]


class _Steps:
    """The Trainer's per-step callback: each step's loss, end time and K1
    count, and the weights after the first step."""

    def __init__(self):
        self.losses, self.stamps, self.launches, self.first = [], [], [], None

    def __call__(self, trainer):
        self.losses.append(trainer.cost.getError())
        self.stamps.append(time.perf_counter())
        self.launches.append(matmul.launches)

        if self.first is None:
            self.first = weights(trainer.module)


def mnistNode(nodeinfo, data, labels, trainsize, valsize, outdir, spawned):
    """``multigpumnist.train`` for one epoch over ``data[:trainsize]`` and
    ``valsize`` rows after it; ``spawned`` is the caller's ``time.time()``
    when it started the grid."""
    entered = time.time()
    steps = _Steps()

    matmul.launches = 0
    start = time.perf_counter()
    net, history = multigpumnist.train(nodeinfo, data, labels, epochs=1, trainsize=trainsize, valsize=valsize,
                                       onBatchFinish=steps)

    final = weights(net)
    flat = torch.zeros(sum(value.size for value in final.values()), dtype=torch.float32, device=nodeinfo.device)
    for _ in range(ALLREDUCE_CALLS):
        nodeinfo.sumTensor("grad", flat)

    synchronize(nodeinfo.device)
    timed = time.perf_counter()
    for _ in range(ALLREDUCE_CALLS):
        nodeinfo.sumTensor("grad", flat)
    synchronize(nodeinfo.device)

    save(outdir, "mnist", nodeinfo.index, losses=np.array(steps.losses), launches=np.array(steps.launches),
          stamps=np.array(steps.stamps) - start, history=np.array(history), spawnSecs=entered - spawned,
          allreduceMs=(time.perf_counter() - timed) / ALLREDUCE_CALLS * 1e3, params=flat.numel(),
          **{"first/" + key: value for key, value in steps.first.items()},
          **{"final/" + key: value for key, value in final.items()})


def oracle(data, labels, nodes, trainsize):
    """The single-process run of ``mnistNode``'s training on a grid of
    ``nodes``: (final weights, the steps' record: each step's loss, end time
    and K1 count, and the weights after step 1)."""
    np.random.seed(multigpumnist.SEED)
    net = loadLeNet(None, initscheme=None)

    part, batch = trainsize // nodes, multigpumnist.GLOBAL_BATCH // nodes
    count = part // batch

    # the nodes' trainers draw the order of their one macro-batch, then of
    # its batches: every node the same
    np.random.permutation(1)
    order = np.random.permutation(count)
    rows = np.concatenate([np.arange(node * part + n * batch, node * part + (n + 1) * batch)
                           for n in order for node in range(nodes)])

    optimizer = MomentumSGD(learnRate=multigpumnist.LEARN_RATE, momRate=multigpumnist.MOM_RATE)
    optimizer.setupOn(net, useGlobalState=True)

    steps = _Steps()
    trainer = Trainer(net, CrossEntropy(maxlabels=10), optimizer, onBatchFinish=steps,
                      batchsize=multigpumnist.GLOBAL_BATCH)

    matmul.launches = 0
    trainer.trainFromHost(data[rows], labels[rows], macroBatchSize=len(rows), random=False)
    return weights(net), steps


def meshNode(nodeinfo, data, labels, steps, outdir, gate=None):
    """LeNet trained ``steps`` steps of ``multigpumnist.GLOBAL_BATCH`` rows
    through ``FusedStep`` over a mesh of the grid's ranks, then from the
    same start over no mesh; the last mesh step is a profiled replay.  The
    seconds of the mesh's set-up and of each route are kept.  With a
    ``gate`` (a path), the node sets its mesh up, then waits for the file
    to exist before it trains: a caller starts the node's process early and
    lets it onto the card when the card is free."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile

    from puzzlelib_tpu_torch.fused import FusedStep

    started = time.perf_counter()
    device = torch.device(nodeinfo.device)
    mesh = init_device_mesh(device.type, (nodeinfo.gridsize, ), mesh_dim_names=("data", ))
    results = {"secs/setup": time.perf_counter() - started}

    while gate is not None and not Path(gate).exists():
        time.sleep(0.01)

    batch = multigpumnist.GLOBAL_BATCH
    x = torch.from_numpy(data[:steps * batch]).to(device).reshape((steps, batch) + data.shape[1:])
    y = torch.from_numpy(labels[:steps * batch]).to(device).reshape(steps, batch)

    for route in ("mesh", "single"):
        started = time.perf_counter()
        np.random.seed(multigpumnist.SEED)
        net = loadLeNet(None, initscheme=None)
        optimizer = MomentumSGD(learnRate=multigpumnist.LEARN_RATE, momRate=multigpumnist.MOM_RATE)
        optimizer.setupOn(net, useGlobalState=True)

        step = FusedStep(net, CrossEntropy(maxlabels=10), optimizer, mesh=mesh if route == "mesh" else None)
        matmul.launches = 0
        for i in range(steps - 1):
            step(x[i], y[i])

        synchronize(device)
        results["secs/" + route] = time.perf_counter() - started

        if route == "single":
            step(x[steps - 1], y[steps - 1])
        else:
            # NCCL's kernels: ncclDevKernel_* on several ranks, its one-rank
            # reduce (onerank.cu) on one
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
            started = time.perf_counter()
            with profile(activities=activities) as prof:
                step(x[steps - 1], y[steps - 1])
                synchronize(device)

            results["secs/profiled"] = time.perf_counter() - started
            results["kernels"] = np.array([event.key for event in prof.key_averages()
                                           if event.self_device_time_total > 0], dtype=str)

        results.update({"%s/%s" % (route, key): value for key, value in weights(net).items()})
        results.update({route + "/launches": matmul.launches, route + "/captures": step.captures,
                        route + "/error": step.cost.getError()})

    save(outdir, "mesh", nodeinfo.index, **results)
