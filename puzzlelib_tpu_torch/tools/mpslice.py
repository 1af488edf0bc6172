"""The model-parallel slice, as ``chip_smoke.py`` [model-parallel] and the
tests run it.

- ``pipeNode``: a rank of ``testlib/pipelinemoe.py``'s recipe
  (``pipelinemoe.train``) on the stage axis, on seeded rows of the digits'
  shape (``moeslice.data``): each step's loss, its end time and K1's
  launch count at its end, the K1 launches of the last epoch's validation
  forward (read around it), the weights after step 1 and at the end, the
  last validation output and the largest gap of the eager pipe's forward of
  each of its microbatches, the ms of a stage handoff; then expert and
  sequence parallelism on the same ranks (``expertPart``, ``seqPart``).
- ``oracle``: the same training in one process: the eager pipe run
  microbatch by microbatch (each 32-row microbatch's forward, the loss
  gradient of the whole batch's loss, the backwards in reverse order with
  the recomputed forwards, the parameter gradients summed), as the
  schedule runs it.  SwitchMoE routes each microbatch on its own, so the
  eager pipe at the whole batch would route differently.
- ``fusedNode``: LeNet through ``FusedStep`` with ``tensorParallelSpecs``
  (``MomentumSGD``) and with ``zeroOptimizerSpecs`` (``Adam``) over a
  (data, model) mesh of the grid's ranks, each beside the step over no
  mesh from the same start: the weights, the recordings, K1's launches,
  and the kernels that a profiled replay of each mesh step ran.

K1 counts: a stage's forward runs 5 products on K1 (its trunk Linear and
its 4 experts; the router's product is ``torch.matmul``), so a step of
``pipelinemoe.MICROBATCHES`` = M microbatches runs 5 * (2M - 1) on each
rank (M forwards, then M - 1 recomputed ones: ``Pipeline.distributedGrad``),
35 at M = 4, and a validation ``distributedForward`` 5 * M = 20
(``stepLaunches``, ``forwardLaunches``).

The device is the node's ``Config.device`` (the grid sets it) or, for the
oracle, the caller's.
"""

import time
from pathlib import Path

import numpy as np
import torch

from puzzlelib_tpu_torch.backend import collective, gpuarray
from puzzlelib_tpu_torch.backend.device import synchronize
from puzzlelib_tpu_torch.ops.hopper import matmul
from puzzlelib_tpu_torch.testlib import pipelinemoe
from puzzlelib_tpu_torch.tools.gridslice import save, weights

# K1 products in a stage's forward: the trunk Linear and the 4 experts
STAGE_PRODUCTS = 5
# stage handoffs timed after the training
HANDOFFS = 50
# seqParallelMLP's operands: x (tokens, width), w1 (width, hidden), w2 (hidden, width)
SEQ_TOKENS, SEQ_WIDTH, SEQ_HIDDEN = 2048, 512, 2048
FUSED_SEED = 1234
FUSED_BATCH = 128


def stepLaunches(microbatches=pipelinemoe.MICROBATCHES):
    """K1 launches of a ``distributedGrad`` step on each rank."""
    return STAGE_PRODUCTS * (2 * microbatches - 1)


def forwardLaunches(microbatches=pipelinemoe.MICROBATCHES):
    """K1 launches of a ``distributedForward`` on each rank."""
    return STAGE_PRODUCTS * microbatches


def _waitFor(gate):
    while gate is not None and not Path(gate).exists():
        time.sleep(0.01)


class _Steps:
    """``pipelinemoe.train``'s per-step callback: each step's loss, end time
    and K1 count, and the weights after the first step."""

    def __init__(self):
        self.losses, self.stamps, self.launches, self.first = [], [], [], None

    def __call__(self, pipe, loss):
        self.losses.append(float(loss))
        self.stamps.append(time.perf_counter())
        self.launches.append(matmul.launches)

        if self.first is None:
            self.first = weights(pipe)


def _handoffMs(nodeinfo, rows, group):
    """ms a microbatch's activation takes over one stage boundary: the last
    rank's time for ``HANDOFFS`` microbatches along the whole chain, over
    the boundaries."""
    stage, last = nodeinfo.index, nodeinfo.gridsize - 1
    x = torch.zeros(rows, pipelinemoe.DIM, device=nodeinfo.device)

    synchronize(nodeinfo.device)
    collective.sumInPlace(torch.zeros(1, device=nodeinfo.device), group)
    started = time.perf_counter()
    for _ in range(HANDOFFS):
        if stage > 0:
            collective.recv(x, stage - 1, group)
        if stage < last:
            collective.send(x, stage + 1, group)

    synchronize(nodeinfo.device)
    return (time.perf_counter() - started) / HANDOFFS / last * 1e3


def pipeNode(nodeinfo, data, epochs, outdir, spawned, gate=None):
    """``pipelinemoe.train`` for ``epochs`` epochs on ``data`` (train rows,
    labels, validation rows, labels); ``spawned`` is the caller's
    ``time.time()`` when it started the grid.  With a ``gate`` (a path) the
    rank sets its mesh up, then waits for the file before it trains."""
    entered = time.time()
    mesh = pipelinemoe.stageMesh(nodeinfo)
    _waitFor(gate)

    steps = _Steps()
    matmul.launches = 0
    started = time.perf_counter()
    pipe, history, out = pipelinemoe.train(nodeinfo, data, epochs, onStep=steps, verbose=False)
    trainLaunches = matmul.launches
    # after the last step's callback, train runs only the last validation forward
    validationLaunches = trainLaunches - steps.launches[-1]

    gap = pipelinemoe.eagerGap(pipe, data[2], out)
    results = {"losses": np.array(steps.losses), "launches": np.array(steps.launches), "trainLaunches": trainLaunches,
               "validationLaunches": validationLaunches,
               "stamps": np.array(steps.stamps) - started, "spawnSecs": entered - spawned, "eagerGap": gap,
               "history": np.array(history), "validation": out,
               "handoffMs": _handoffMs(nodeinfo, pipelinemoe.BATCH // pipelinemoe.MICROBATCHES,
                                       mesh.get_group("stage")),
               **{"first/" + key: value for key, value in steps.first.items()},
               **{"final/" + key: value for key, value in weights(pipe).items()}}

    results.update(expertPart(nodeinfo, data[2]))
    results.update(seqPart(nodeinfo))
    save(outdir, "pipe", nodeinfo.index, **results)


def expertPart(nodeinfo, rows):
    """``SwitchMoE(64, capacityFactor=2.0)`` of one expert a rank:
    ``distributedForward`` of ``rows`` over an "expert" axis of the grid's
    ranks beside the eager layer, with K1's launches and the ms of each."""
    from torch.distributed.device_mesh import init_device_mesh

    from puzzlelib_tpu_torch.modules import Linear, SwitchMoE

    np.random.seed(100)
    layer = SwitchMoE(pipelinemoe.DIM, capacityFactor=2.0, name="moe")
    for e in range(nodeinfo.gridsize):
        layer.append(Linear(pipelinemoe.DIM, pipelinemoe.DIM, wscale=0.3, initscheme="gaussian", name="expert%d" % e))

    mesh = init_device_mesh(torch.device(nodeinfo.device).type, (nodeinfo.gridsize, ), mesh_dim_names=("expert", ))
    x = gpuarray.to_gpu(rows)

    matmul.launches = 0
    synchronize(nodeinfo.device)
    started = time.perf_counter()
    out, aux = layer.distributedForward(x, mesh)
    synchronize(nodeinfo.device)
    distributedSecs, launches = time.perf_counter() - started, matmul.launches

    eager, eagerAux = gpuarray.get(layer(x)), gpuarray.get(layer.auxLoss)
    layer.reset()
    return {"expert/out": gpuarray.get(out), "expert/aux": gpuarray.get(aux), "expert/eager": eager,
            "expert/eagerAux": eagerAux, "expert/launches": launches, "expert/ms": distributedSecs * 1e3}


def seqPart(nodeinfo):
    """``seqParallelMLP`` of seeded f32 operands (``SEQ_*``) over a "model"
    axis of the grid's ranks, beside the dense MLP on the same device: the
    largest gap over max |dense| and the ms of each."""
    from torch.distributed.device_mesh import init_device_mesh

    from puzzlelib_tpu_torch.parallel.seqparallel import gelu, seqParallelMLP

    rng = np.random.RandomState(3)
    x = gpuarray.to_gpu(rng.randn(SEQ_TOKENS, SEQ_WIDTH).astype(np.float32))
    w1 = gpuarray.to_gpu((rng.randn(SEQ_WIDTH, SEQ_HIDDEN) / np.sqrt(SEQ_WIDTH)).astype(np.float32))
    w2 = gpuarray.to_gpu((rng.randn(SEQ_HIDDEN, SEQ_WIDTH) / np.sqrt(SEQ_HIDDEN)).astype(np.float32))
    mesh = init_device_mesh(torch.device(nodeinfo.device).type, (nodeinfo.gridsize, ), mesh_dim_names=("model", ))

    times = {}
    for route, fn in (("sharded", lambda: seqParallelMLP(x, w1, w2, mesh, axis="model")),
                      ("dense", lambda: gelu(x @ w1) @ w2)):
        synchronize(nodeinfo.device)
        started = time.perf_counter()
        with torch.no_grad():
            times[route] = fn()
        synchronize(nodeinfo.device)
        times[route + "Ms"] = (time.perf_counter() - started) * 1e3

    dense = times["dense"]
    return {"seq/gap": float((times["sharded"] - dense).abs().max() / dense.abs().max()),
            "seq/ms": times["shardedMs"], "seq/denseMs": times["denseMs"]}


def oracle(data, epochs):
    """The one-process run of ``pipeNode``'s training: (each step's loss,
    end time and K1 count, the weights after step 1, the final weights)."""
    from puzzlelib_tpu_torch.containers.pipeline import withoutAuxLoss
    from puzzlelib_tpu_torch.optimizers import MomentumSGD
    from puzzlelib_tpu_torch.parallel.pipeline import splitMicro

    trainData, trainLabels = data[0], data[1]
    pipe = pipelinemoe.buildPipe()
    optimizer = MomentumSGD(learnRate=pipelinemoe.LEARN_RATE, momRate=pipelinemoe.MOM_RATE)
    optimizer.setupOn(pipe, useGlobalState=False)

    x, t = gpuarray.to_gpu(trainData), gpuarray.to_gpu(trainLabels)
    steps = _Steps()
    matmul.launches = 0

    for _ in range(epochs):
        for i in range(0, len(trainData), pipelinemoe.BATCH):
            mb = splitMicro(x[i:i + pipelinemoe.BATCH], pipelinemoe.MICROBATCHES)
            rows, last = mb.shape[1], mb.shape[0] - 1

            with torch.no_grad(), withoutAuxLoss(pipe):
                with torch.enable_grad():
                    out = torch.cat([pipe(mb[m]).clone() for m in range(mb.shape[0])]).requires_grad_(True)
                    loss = pipelinemoe.lossFn(out, t[i:i + pipelinemoe.BATCH])
                    dOut, = torch.autograd.grad(loss, out)

                for m in reversed(range(mb.shape[0])):
                    if m != last:
                        pipe(mb[m])
                    pipe.backward(-dOut[m * rows:(m + 1) * rows], updGrad=False, scale=1.0,
                                  momentum=0.0 if m == last else 1.0)

            optimizer.update()
            pipe.reset()
            steps(pipe, loss.detach())

        optimizer.learnRate *= pipelinemoe.DECAY

    return steps, weights(pipe)


def fusedNode(nodeinfo, data, labels, steps, outdir, gate=None):
    """LeNet trained ``steps`` steps of ``FUSED_BATCH`` rows through
    ``FusedStep`` with tensor-parallel specs (``MomentumSGD``) and with ZeRO
    specs (``Adam``) over a (data, model) mesh of the grid's ranks, each
    then from the same start over no mesh; the last step of each mesh route
    is a profiled replay.  With a ``gate`` (a path) the node sets its mesh
    up, then waits for the file before it trains."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile

    from puzzlelib_tpu_torch.cost import CrossEntropy
    from puzzlelib_tpu_torch.fused import FusedStep, tensorParallelSpecs, zeroOptimizerSpecs
    from puzzlelib_tpu_torch.models.nets.lenet import loadLeNet
    from puzzlelib_tpu_torch.optimizers import Adam, MomentumSGD

    started = time.perf_counter()
    device = torch.device(nodeinfo.device)
    mesh = init_device_mesh(device.type, (1, nodeinfo.gridsize), mesh_dim_names=("data", "model"))
    results = {"secs/setup": time.perf_counter() - started}
    _waitFor(gate)

    x = torch.from_numpy(data[:steps * FUSED_BATCH]).to(device).reshape((steps, FUSED_BATCH) + data.shape[1:])
    y = torch.from_numpy(labels[:steps * FUSED_BATCH]).to(device).reshape(steps, FUSED_BATCH)
    routes = {"tp": (lambda: MomentumSGD(learnRate=0.01, momRate=0.9),
                     lambda net, cost, opt: tensorParallelSpecs(net, cost, opt, mesh, modelAxis="model")),
              "zero": (lambda: Adam(alpha=1e-3), lambda net, cost, opt: zeroOptimizerSpecs(net, cost, opt, mesh))}

    for kind, (makeOptimizer, specs) in routes.items():
        for route in ("mesh", "single"):
            started = time.perf_counter()
            np.random.seed(FUSED_SEED)
            net = loadLeNet(None, initscheme=None)
            optimizer = makeOptimizer()
            optimizer.setupOn(net, useGlobalState=False)
            cost = CrossEntropy(maxlabels=10)

            sharded = route == "mesh"
            step = FusedStep(net, cost, optimizer, mesh=mesh if sharded else None,
                             stateShardings=specs(net, cost, optimizer) if sharded else None)
            matmul.launches = 0
            for i in range(steps - 1):
                step(x[i], y[i])

            synchronize(device)
            tag = "%s/%s" % (kind, route)
            results["secs/" + tag] = time.perf_counter() - started

            if not sharded:
                step(x[steps - 1], y[steps - 1])
            else:
                activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
                with profile(activities=activities) as prof:
                    step(x[steps - 1], y[steps - 1])
                    synchronize(device)

                results[kind + "/kernels"] = np.array([event.key for event in prof.key_averages()
                                                      if event.self_device_time_total > 0], dtype=str)

            results.update({"%s/%s" % (tag, key): value for key, value in weights(net).items()})
            results.update({tag + "/launches": matmul.launches, tag + "/captures": step.captures,
                            tag + "/error": step.cost.getError()})

    save(outdir, "fused", nodeinfo.index, **results)
