"""Pipeline parallelism over a mesh "stage" axis (counterpart of
``puzzlelib_tpu/parallel/pipeline.py``): the GPipe microbatch schedule.

The JAX package expresses the schedule as one SPMD program (``shard_map``
over the stage axis, a ``lax.scan`` over the steps, ``lax.ppermute`` for the
handoff).  Here every rank is a process (a grid node) with a
``DeviceMesh``, and rank s of the stage axis runs stage s:

- the forward takes the microbatches in order; rank 0 reads them from the
  batch, every later rank receives them from the rank before it, runs its
  stage and sends the result on (``backend/collective.py`` ``send`` /
  ``recv``); the last rank's outputs are broadcast to every rank, which
  replaces the JAX package's ``psum`` of the stages' output slots;
- ``pipelineGrad`` runs every forward first, then the backwards in reverse
  microbatch order, each rank receiving its output gradient from the rank
  after it and sending its input gradient to the rank before: the order of
  JAX's autodiff through the scan.  The last rank differentiates the loss
  of the whole output; the loss is broadcast from it, and each rank's stage
  gradients are gathered over the stage axis into the stacked layout.

The API is the JAX package's, whose caller holds global arrays: ``x`` and
``target`` are whole and identical on every rank, and the output, the loss
and the stacked gradients come back whole and identical on every rank.
``blockFn(params, x) -> y`` is one stage's computation in torch operations
(stages share structure and shapes); ``params`` is a tree (dicts, lists and
tuples) of tensors, stacked along a new leading stage axis by
``stackStageParams``.  A stage's output must keep its input's shape and
type, checked on every rank before anything is sent, from a run of
``blockFn`` on meta tensors: shapes alone, nothing launched.

``pipelineForward`` is a forward (no autograd); ``pipelineGrad`` is the
gradient.  Module-built stages take the module protocol instead
(``containers.Pipeline.distributedForward`` / ``distributedGrad``).
Host arrays go to the configured device (``Config.device``).
"""

import torch

from puzzlelib_tpu_torch.backend import collective
from puzzlelib_tpu_torch.parallel._tree import asTensor, stackTrees, treeLeaves, treeMap, unflatten


def stackStageParams(paramsList):
    """Stack per-stage parameter trees along a new leading stage axis."""
    return stackTrees(paramsList)


def splitMicro(x, microbatches):
    batch = x.shape[0]
    if batch % microbatches != 0:
        raise ValueError("Batch %d not divisible into %d microbatches" % (batch, microbatches))

    return x.reshape((microbatches, batch // microbatches) + tuple(x.shape[1:]))


def checkStageShape(mbShape, dtype, outShape, outDtype):
    if tuple(outShape) != tuple(mbShape) or outDtype != dtype:
        raise ValueError("Pipeline stages must preserve activation shape/dtype (%s%s -> %s%s)" %
                         (tuple(mbShape), dtype, tuple(outShape), outDtype))


def _stageParams(stackedParams, stage, nStages):
    for leaf in treeLeaves(stackedParams):
        if leaf.shape[0] != nStages:
            raise ValueError("Stacked parameters hold %d stages, the stage axis has %d" % (leaf.shape[0], nStages))

    return treeMap(lambda leaf: leaf[stage], stackedParams)


def _checkBlock(blockFn, local, mb):
    """The shape check of ``_schedule`` (``pipeline.py:96-101`` of the JAX
    package), on meta tensors."""
    out = blockFn(treeMap(lambda leaf: leaf.detach().to("meta"), local),
                  torch.empty(mb.shape[1:], dtype=mb.dtype, device="meta"))
    checkStageShape(mb.shape[1:], mb.dtype, out.shape, out.dtype)


def forwardSchedule(run, mb, group, stage, nStages):
    """GPipe's forward on rank ``stage``: [(input, output)] of its stage on
    each microbatch of ``mb``, in order; ``run(x) -> y`` runs the stage."""
    pairs = []
    for m in range(mb.shape[0]):
        x = mb[m] if stage == 0 else collective.recv(torch.empty_like(mb[m]), stage - 1, group)
        y = run(x)

        if stage < nStages - 1:
            collective.send(y.detach(), stage + 1, group)

        pairs.append((x, y))

    return pairs


def gatherOutputs(ys, mb, group, stage, nStages):
    """The last stage's outputs, (microbatches * rows, ...), broadcast from
    it to every rank of the stage axis."""
    outs = torch.empty_like(mb)
    if stage == nStages - 1:
        for m, y in enumerate(ys):
            outs[m].copy_(y)

    collective.broadcastInPlace(outs, group, src=nStages - 1)
    return outs.reshape((mb.shape[0] * mb.shape[1], ) + tuple(mb.shape[2:]))


def lossAndGrad(lossFn, ys, target, group, stage, nStages):
    """(the loss, broadcast from the last stage as an f32 0-d tensor; on the
    last stage the loss gradient of its whole output, else None).  The last
    stage differentiates ``lossFn(out, target)`` on a leaf of its output."""
    loss = torch.zeros((), dtype=torch.float32, device=ys[0].device)
    dOut = None

    if stage == nStages - 1:
        with torch.enable_grad():
            out = torch.cat([y.detach() for y in ys]).requires_grad_(True)
            value = lossFn(out, target)
            dOut, = torch.autograd.grad(value, out)

        loss.copy_(value.detach())

    collective.broadcastInPlace(loss.reshape(1), group, src=nStages - 1)
    return loss, dOut


def gatherStacked(grads, group):
    """Each rank's gradients (one stage's, a list), gathered over the stage
    axis into the stacked layout (stages, ...): one all-gather for all."""
    flat = torch.cat([grad.reshape(-1) for grad in grads]).unsqueeze(0)
    whole = collective.allGather(flat, group)

    stacked, offset = [], 0
    for grad in grads:
        stacked.append(whole[:, offset:offset + grad.numel()].reshape((whole.shape[0], ) + tuple(grad.shape))
                       .to(grad.dtype))
        offset += grad.numel()

    return stacked


def pipelineForward(blockFn, stackedParams, x, mesh, stageAxis="stage", microbatches=4):
    """Forward through ``nStages`` pipelined stages; returns the (B, ...)
    output, whole on every rank.

    ``stackedParams`` leaves have leading dim nStages (rank s of the stage
    axis runs stage s); ``x`` is the full batch, split into
    ``microbatches``."""
    group, stage, nStages = collective.meshAxis(mesh, stageAxis)
    mb = splitMicro(asTensor(x), microbatches)
    local = _stageParams(stackedParams, stage, nStages)
    _checkBlock(blockFn, local, mb)

    with torch.no_grad():
        pairs = forwardSchedule(lambda inp: blockFn(local, inp), mb, group, stage, nStages)
        return gatherOutputs([y for _, y in pairs], mb, group, stage, nStages)


def pipelineGrad(blockFn, lossFn, stackedParams, x, target, mesh, stageAxis="stage", microbatches=4):
    """(loss, grads) of ``lossFn(pipelined output, target)``: the loss an f32
    0-d tensor and the gradients in ``stackedParams``' layout, whole and the
    same on every rank.  Autograd runs each stage's backward, the backwards
    in reverse microbatch order after all the forwards."""
    group, stage, nStages = collective.meshAxis(mesh, stageAxis)
    mb = splitMicro(asTensor(x), microbatches)
    local = treeMap(lambda leaf: leaf.detach().requires_grad_(True), _stageParams(stackedParams, stage, nStages))
    _checkBlock(blockFn, local, mb)

    inputs = []

    def run(inp):
        leaf = inp.detach().requires_grad_(stage > 0)
        inputs.append(leaf)
        with torch.enable_grad():
            return blockFn(local, leaf)

    ys = [y for _, y in forwardSchedule(run, mb, group, stage, nStages)]
    loss, dOut = lossAndGrad(lossFn, ys, asTensor(target), group, stage, nStages)

    rows = mb.shape[1]
    for m in reversed(range(len(ys))):
        dy = dOut[m * rows:(m + 1) * rows] if dOut is not None else \
            collective.recv(torch.empty_like(ys[m]), stage + 1, group)

        torch.autograd.backward(ys[m], dy)
        if stage > 0:
            collective.send(inputs[m].grad, stage - 1, group)

    leaves = treeLeaves(local)
    grads = gatherStacked([torch.zeros_like(leaf) if leaf.grad is None else leaf.grad for leaf in leaves], group)
    return loss, unflatten(local, grads)
