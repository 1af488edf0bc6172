"""Fused training and evaluation (counterpart of ``puzzlelib_tpu/fused.py``):
the eager step recorded once as a CUDA graph over buffers whose addresses
never move, then replayed.

The eager object layer (Modules -> backend -> ops) launches its kernels and
library calls one at a time from Python.  The whole train step

    grad = cost(module(data), target); zeroGrad; module.backward(grad);
    optimizer.update()

writes only into buffers that live across steps (the variables, their
gradients, the modules' attributes such as a batch norm's running stats, the
optimizer's state, the cost's error) and reads only those and its inputs.
So on CUDA tensors ``FusedStep`` records it once per input signature with
``torch.cuda.graph`` over static input tensors, and every
later call copies its batch into those tensors and replays the recording:
one graph launch a step, holding every hand kernel and library call of the
eager step.  The module tree is the program, as in the reference; no module
changes for it.  On CPU tensors the same step body runs eagerly under the
same ``fusedctx``, so the CPU tests run the code that the graph records.

How the recording stays true to the eager step:

- Python-side counters (``optimizer.t``, the cost's sample counts) advance in
  the wrapper, as in the reference.  The step count and the optimizer's
  numeric attributes (its hyper-parameters) reach the body as 0-d f32
  tensors on the device (``fusedctx``), written before a replay when their
  value changed, so a learning rate changed between calls acts without a
  new recording, and a batch norm blends its running stats with the factor
  of the step replayed (``initFactor / t``).
- Addresses: the batch is copied into static tensors, the step's
  intermediates live in the graph's private memory pool, and the state stays
  where it is.  The hand kernels' TMA descriptors, encoded on the host at
  each launch, keep the addresses of the recording.  Before each replay the
  step collects the addresses of its state again and records anew where one
  moved (a variable rebound, a new ``setupOn``).
- Each recording follows one eager step on the same stream, which builds
  the kernels, sets their attributes, looks up ``cuTensorMapEncodeTiled``
  and warms cuBLAS and cuDNN.  The state and the random generators are put back
  after the recording, so the first call takes one step, as every call does.
- Dropout draws from the ``torch.Generator`` of ``rng.py``, registered with
  each graph: every replay draws anew, and the draws repeat from a seed.
- The kernels' launch counters count Python calls, which a replay makes
  none of: a recording's counts are added to them at each replay
  (``COUNTERS``).

There is no fallback: on a CUDA tensor a failed recording or replay raises.
``Config.verifyData`` reads the labels back, which a graph cannot hold, and
is refused.  Not ported: ``FusedStep(mesh=...)`` and the sharding specs
(``tensorParallelSpecs``, ``zeroOptimizerSpecs``), ``functionalize``.
"""

import numpy as np
import torch

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch import fusedctx
from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.containers.container import Container
from puzzlelib_tpu_torch.handlers.calculator import Calculator
from puzzlelib_tpu_torch.handlers.trainer import Trainer
from puzzlelib_tpu_torch.handlers.validator import Validator
from puzzlelib_tpu_torch.ops.hopper import flash, matmul, winograd
from puzzlelib_tpu_torch.rng import RandomNumberGenerator


# the launch counters of the hand kernels that modules reach, as (holder,
# attribute): a replay adds its recording's counts to each
COUNTERS = [
    (matmul, "launches"), (matmul, "launchesWgmma"), (matmul, "launchesInt8"), (matmul, "launchesInt8Wgmma"),
    (flash, "launches"), (flash, "launchesWgmma"), (flash, "launchesDq"), (flash, "launchesDkv"),
    (winograd, "launches"), (winograd, "dataGradLaunches"), (winograd, "filterGradLaunches"),
]


def _moduleTree(module):
    """The module tree, depth first, in the reference's order."""
    yield module

    if isinstance(module, Container):
        for child in module.modules.values():
            yield from _moduleTree(child)


def _variables(module):
    for mod in _moduleTree(module):
        yield from mod.vars.values()


def _evalTensors(module):
    """Every tensor an eval-mode forward reads across calls: the variables'
    data and the modules' attributes (a batch norm's running stats)."""
    for mod in _moduleTree(module):
        for var in mod.vars.values():
            yield var.data

        yield from mod.attrs.values()


def _stateTensors(module, cost=None, optimizer=None):
    """Every tensor the train step writes, in a fixed order, with repeats:
    the variables' data and gradients and the modules' attributes (a batch
    norm's running stats), the optimizer's state and flat variables, the
    cost's errors."""
    for mod in _moduleTree(module):
        for var in mod.vars.values():
            yield var.data
            if var.grad is not None:
                yield var.grad

        yield from mod.attrs.values()

    if optimizer is not None:
        for state in optimizer.states.values():
            yield from state.values()

        for globalVar in optimizer.globalVar.values():
            yield globalVar.data
            yield globalVar.grad

    if cost is not None:
        yield cost.devErr
        yield cost.accumErr


def _rootBuffer(tensor):
    """The whole allocation ``tensor`` lies in, as a flat tensor of its type:
    for a view of an optimizer's flat buffer, that buffer."""
    storage = tensor.untyped_storage()
    return torch.empty(0, dtype=tensor.dtype, device=tensor.device).set_(
        storage, 0, (storage.nbytes() // tensor.element_size(), ))


def _roots(tensors):
    seen, roots = set(), []
    for tensor in tensors:
        key = (tensor.device, tensor.untyped_storage().data_ptr())
        if key not in seen:
            seen.add(key)
            roots.append(_rootBuffer(tensor))

    return roots


def collectStateBuffers(module, cost=None, optimizer=None):
    """The unique root buffers whose contents the train step writes."""
    return _roots(_stateTensors(module, cost, optimizer))


def collectParamBuffers(module):
    """The unique root buffers of the weights (the variables' data only)."""
    return _roots(var.data for var in _variables(module))


def collectEvalBuffers(module):
    """The unique root buffers an eval-mode forward reads: the weights and
    the modules' attributes (a batch norm's running stats), so that a
    program recorded over them reads their values at each replay."""
    return _roots(_evalTensors(module))


def _refuseVerifyData():
    if Config.verifyData:
        raise Config.ConfigError("Config.verifyData reads the labels back at every batch, which a fused step or "
                                 "program cannot do: turn Config.verifyData off to run it")


def _tree(fn, data):
    if isinstance(data, (list, tuple)):
        return [_tree(fn, item) for item in data]

    return fn(data)


def _leaves(data):
    if isinstance(data, (list, tuple)):
        return [leaf for item in data for leaf in _leaves(item)]

    return [data]


def _signature(data):
    return tuple((tuple(leaf.shape), leaf.dtype, leaf.stride()) for leaf in _leaves(data))


def _copyInto(statics, data):
    for dst, src in zip(_leaves(statics), _leaves(data)):
        dst.copy_(src)


def _asTensor(data):
    """A host array goes to the configured device as it is."""
    return _tree(lambda leaf: leaf if isinstance(leaf, torch.Tensor) else gpuarray.to_gpu(np.asarray(leaf)), data)


def _generators(module, device):
    """The generators of the random number generators that the tree's
    modules draw from (dropout's ``rng``), on ``device``."""
    gens = {}
    for mod in module.modules():
        rng = getattr(mod, "rng", None)
        if isinstance(rng, RandomNumberGenerator):
            gen = rng.generator(device)
            gens[id(gen)] = gen

    return list(gens.values())


class _Recording:
    """One CUDA graph of a body over static inputs: the inputs, the body's
    outputs and the launches the graph holds."""

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs, self.outputs, self.launches = graph, inputs, outputs, launches

    def replay(self, *data):
        _copyInto(self.inputs, data)

        self.graph.replay()
        for holder, name, count in self.launches:
            setattr(holder, name, getattr(holder, name) + count)

        return self.outputs


def _record(body, data, generators):
    """A ``_Recording`` of ``body(*static copies of data)``: one eager run
    of it on a side stream, then its recording there.  The counters keep the
    eager run's launches and not the recording's, which ran nothing."""
    device = _leaves(data)[0].device
    stream = torch.cuda.Stream(device)
    inputs = [_tree(torch.empty_like, item) for item in data]

    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        _copyInto(inputs, data)
        body(*inputs)

    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)

    before = [getattr(holder, name) for holder, name in COUNTERS]
    with torch.cuda.graph(graph, stream=stream):
        outputs = body(*inputs)

    launches = []
    for (holder, name), count in zip(COUNTERS, before):
        if getattr(holder, name) != count:
            launches.append((holder, name, getattr(holder, name) - count))
            setattr(holder, name, count)

    torch.cuda.current_stream(device).wait_stream(stream)
    return _Recording(graph, inputs, outputs, launches)


class _Recordings:
    """Recordings by key (the inputs' signature and the route), each made
    anew where an address it was recorded over moved; ``captures`` counts
    the recordings made."""

    def __init__(self):
        self.byKey, self.captures = {}, 0

    def get(self, key, addresses, record):
        held = self.byKey.get(key)
        if held is None or held[0] != addresses:
            self.byKey.pop(key, None)   # the old graph and its memory pool go first
            held = self.byKey[key] = (addresses, record())
            self.captures += 1

        return held[1]


def _routeKey():
    return Config.gemmAlgo, Config.convAlgo, Config.matmulPrecision


class _Scalars:
    """0-d f32 tensors on the device, by name, written with ``fill_`` only
    where the value changed: a graph reads them at every replay."""

    def __init__(self):
        self.tensors, self.values = {}, {}

    def get(self, name, value, device):
        key = (name, device)
        tensor = self.tensors.get(key)

        if tensor is None:
            tensor = self.tensors[key] = torch.zeros((), dtype=torch.float32, device=device)
            self.values[key] = 0.0

        if self.values[key] != value:
            tensor.fill_(value)
            self.values[key] = value

        return tensor


class FusedStep:
    """(module, cost, optimizer) as one train step per call: a CUDA graph on
    CUDA tensors, recorded once per input signature; the eager body on CPU
    tensors.  The state updates in place; ``buffers`` are its root buffers
    (``collectStateBuffers``).  Call it with tensors (or host arrays, which
    go to the configured device as they are)."""

    def __init__(self, module, cost, optimizer, mesh=None, stateShardings=None):
        if mesh is not None or stateShardings is not None:
            raise NotImplementedError("FusedStep over a mesh (data and tensor parallelism) is not ported yet")

        self.module, self.cost, self.optimizer = module, cost, optimizer
        self.buffers = collectStateBuffers(module, cost, optimizer)
        self._recordings = _Recordings()
        self._scalars = _Scalars()

        # the reference draws its step's random seed here: the port draws
        # from rng.py, but takes the draw all the same, so that numpy's
        # stream (the batch orders that follow) goes on as the reference's
        np.random.randint(1 << 31)

    @property
    def captures(self):
        """The CUDA graphs recorded so far."""
        return self._recordings.captures

    def _hyper(self):
        hyper = {}
        for name in sorted(self.optimizer.attrs):
            val = getattr(self.optimizer, name)
            if name != "t" and isinstance(val, (int, float)):
                hyper[name] = float(val)

        return hyper

    def _body(self, data, target, hyper, t):
        """The eager train step, with the hyper-parameters and t as tensors;
        the Python-side counters it advances are put back."""
        snapshot = {name: getattr(self.optimizer, name) for name in hyper}
        for name, val in hyper.items():
            setattr(self.optimizer, name, val)

        costCounters = (self.cost.batchsize, self.cost.numOfSamples)
        optT = self.optimizer.t

        try:
            with fusedctx.activate(hyper, t):
                grad = self.cost(self.module(data), target, queryError=False)

                self.optimizer.zeroGradParams()
                self.module.backward(grad, updGrad=False)
                self.optimizer.update()

        finally:
            for name, val in snapshot.items():
                setattr(self.optimizer, name, val)

            self.cost.batchsize, self.cost.numOfSamples = costCounters
            self.optimizer.t = optT

    def _run(self, data, target, t):
        device = data.device
        hyper = {name: self._scalars.get(name, val, device) for name, val in self._hyper().items()}
        tensorT = self._scalars.get("t", t, device)

        if device.type != "cuda":
            self._body(data, target, hyper, tensorT)
            return

        key = (_signature(data), _signature(target), device, tuple(hyper)) + _routeKey()
        addresses = tuple(tensor.data_ptr() for tensor in _stateTensors(self.module, self.cost, self.optimizer))

        recording = self._recordings.get(key, addresses, lambda: self._record(data, target, hyper, tensorT))
        recording.replay(data, target)

    def _record(self, data, target, hyper, t):
        """A recording of the step, with the state and the generators put
        back as they were before it (the body puts back the counters of the
        cost and the optimizer itself)."""
        self.buffers = collectStateBuffers(self.module, self.cost, self.optimizer)
        generators = _generators(self.module, data.device)

        saved = [buf.clone() for buf in self.buffers]
        genStates = [gen.get_state() for gen in generators]

        recording = _record(lambda d, tgt: self._body(d, tgt, hyper, t), [data, target], generators)
        self.module.reset()

        for buf, value in zip(self.buffers, saved):
            buf.copy_(value)

        for gen, state in zip(generators, genStates):
            gen.set_state(state)

        return recording

    def _begin(self, samples, steps):
        _refuseVerifyData()

        # Python-side counters advance exactly as in the eager path
        self.optimizer.t += steps
        self.cost.reset()
        self.cost.dirty = True
        self.cost.updateState(samples)

    def many(self, data, target, steps):
        """``steps`` consecutive train steps, step i at t0 + i.  ``data`` and
        ``target`` hold the minibatches stacked on the leading dim: (steps *
        b, ...) split evenly, or already (steps, b, ...).  The cost's last
        error is the sum over the steps, so ``getError()`` is the mean over
        all steps * b samples."""
        data, target = _asTensor(data), _asTensor(target)

        if data.shape[0] != steps:
            if data.shape[0] % steps != 0:
                raise ValueError("Leading dim %d not divisible into %d steps" % (data.shape[0], steps))

            b = data.shape[0] // steps
            data = data.reshape((steps, b) + tuple(data.shape[1:]))
            target = target.reshape((steps, b) + tuple(target.shape[1:]))

        t0 = self.optimizer.t + 1
        self._begin(int(data.shape[0] * data.shape[1]), steps)

        errSum = torch.zeros((), dtype=torch.float32, device=data.device)
        for i in range(steps):
            self._run(data[i], target[i], float(t0 + i))
            errSum.add_(self.cost.devErr)

        self.cost.devErr.copy_(errSum)
        self.module.reset()
        return self.cost

    def __call__(self, data, target):
        data, target = _asTensor(data), _asTensor(target)
        self._begin(int(data.shape[0]), 1)

        self._run(data, target, float(self.optimizer.t))

        self.module.reset()
        return self.cost


class _FusedEvalProgram:
    """One eval-mode forward of the module (and the cost's validation error,
    ``calcValDev``, where a cost is given) per call: a CUDA graph on CUDA
    tensors, recorded once per input signature; the eager forward on CPU
    tensors.  On CUDA the result is the graph's static output, which the
    next call overwrites: callers copy out of it first."""

    def __init__(self, module, cost=None):
        self.module, self.cost = module, cost
        self._recordings = _Recordings()

    @property
    def captures(self):
        """The CUDA graphs recorded so far."""
        return self._recordings.captures

    def _body(self, data, target=None):
        out = self.module(data)
        return out if self.cost is None else self.cost.validateDev(out, target)

    def _run(self, data, target):
        device = _leaves(data)[0].device
        if device.type != "cuda":
            return self._body(data, target)

        args = [data] if self.cost is None else [data, target]
        key = (tuple(_signature(arg) for arg in args), device) + _routeKey()
        addresses = tuple(tensor.data_ptr() for tensor in _evalTensors(self.module))

        recording = self._recordings.get(key, addresses,
                                         lambda: _record(self._body, args, _generators(self.module, device)))
        return recording.replay(*args)

    def __call__(self, data, target=None):
        _refuseVerifyData()

        try:
            return self._run(_asTensor(data), None if target is None else _asTensor(target))
        finally:
            self.module.reset()
            if self.cost is not None:
                self.cost.reset()


class FusedTrainer(Trainer):
    """A Trainer whose steps run through one ``FusedStep``.

    ``stepsPerDispatch > 1`` groups that many consecutive minibatches into
    one ``FusedStep.many`` call, as the reference does; it engages only where
    no per-batch callback is set, and the leftover and partial batches take
    single steps."""

    def __init__(self, mod, cost, optimizer, onBatchFinish=None, batchsize=128, stepsPerDispatch=1):
        super().__init__(mod, cost, optimizer, onBatchFinish, batchsize)
        self.step = None
        self.stepsPerDispatch = stepsPerDispatch

    def _ensureStep(self):
        if self.step is None:
            self.step = FusedStep(self.module, self.cost, self.optimizer)

    def handle(self, data, state=None, random=True):
        K = self.stepsPerDispatch

        if K <= 1 or self.onBatchFinish is not None:
            super().handle(data, state, random=random)
            return

        self._ensureStep()

        dat, target = data
        datasize = dat.shape[0]

        nFull = datasize // self.batchsize
        self.totalBatches = self._tileCount(datasize, self.batchsize)

        order = np.random.permutation(nFull) if random else np.arange(nFull)

        done = 0
        for start in range(0, nFull - nFull % K, K):
            idx = np.concatenate([np.arange(n * self.batchsize, (n + 1) * self.batchsize)
                                  for n in order[start:start + K]])
            index = torch.from_numpy(idx).to(dat.device)

            self.step.many(dat.index_select(0, index), target.index_select(0, index), steps=K)
            done += K
            self.currBatch = done

        # leftover full batches and the final partial batch through single steps
        for n in list(order[nFull - nFull % K:nFull]) + ([nFull] if datasize % self.batchsize else []):
            self.step(*self.sliceData(data, n, self.batchsize, postSlice=lambda view: view))
            done += 1
            self.currBatch = done

        self.module.reset()

    def handleBatch(self, batch, idx, state):
        data, target = batch

        self._ensureStep()
        self.step(data, target)


class FusedValidator(Validator):
    """A Validator whose forward and validation error run as one program per
    batch (``_FusedEvalProgram``), the errors summed on the device and read
    back once a call, as the Validator's.

    A cost without ``calcValDev`` takes the reference's eager path, one
    readback of ``cost.validate`` per batch, as the reference's does."""

    def __init__(self, mod, cost, onBatchFinish=None, batchsize=128):
        super().__init__(mod, cost, onBatchFinish, batchsize)
        self._program = None
        self._fallback = False

    def handleBatch(self, batch, idx, state):
        data, target = batch

        if not self._fallback:
            if self._program is None:
                self._program = _FusedEvalProgram(self.module, self.cost)

            try:
                self._addError(state, data, self._program(data, target))
                return

            except NotImplementedError:
                self._fallback, self._program = True, None

        error = self.cost.validate(self.module(data), target)
        self._addError(state, data, torch.tensor(error, dtype=torch.float64))


class FusedCalculator(Calculator):
    """A Calculator whose batched forward runs as one program per batch
    (``_FusedEvalProgram``); the outputs are assembled as the Calculator
    assembles them, copied out of the program's output before the next
    batch runs."""

    def __init__(self, mod, onBatchFinish=None, batchsize=128):
        super().__init__(mod, onBatchFinish, batchsize)
        self._program = None

    def handleBatch(self, batch, idx, state):
        if self._program is None:
            self._program = _FusedEvalProgram(self.module)

        self._storeBatch(self._program(batch), idx, state)
