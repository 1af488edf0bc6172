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
is refused.  ``functionalize`` gives a module tree as a function of a
weight list, as ``Pipeline`` and ``SwitchMoE`` use it.

Data parallelism (``FusedStep(mesh=...)``, the JAX package's GSPMD mesh
step): the mesh is a ``torch.distributed`` ``DeviceMesh`` with a data axis,
built by the caller in an initialised process group (a grid node, say), and
each rank of the axis runs its own step, on CUDA its own CUDA graph.  The
caller passes the global batch; each rank takes its contiguous 1 / size of
the rows.  Between the backward and the update every gradient root buffer is
replaced by its mean over the data group (an f32 sum times 1 / size,
``backend/collective.py``), and the cost's ``devErr`` is summed over it
(its running sum ``accumErr`` taken anew from it), so every rank's error is
the global batch's; a batch norm's statistics are
summed over the group too (``ops/norm.py``, through ``fusedctx``).  On
CUDA the collectives are NCCL calls that the graph records (a mesh over
gloo raises there); on the CPU the body runs eagerly over gloo.  A batch that
does not divide over the axis runs whole on every rank with no collective:
the single-device step's numerics, as the JAX package's ragged fallback.
The JAX package's ``_invoke``, which turns its Pallas kernels off under a
mesh for the partitioner's sake, has no counterpart: each rank runs its hand
kernels.  An optimizer built with a grid's ``nodeinfo`` is refused: its
collectives run eagerly over the grid's group (the JAX package's trace of
them fails too); ``mesh=`` is the fused form of that training.

Model parallelism (``FusedStep(mesh=..., stateShardings=...)``, over a 1-D
data mesh or a 2-D (data, model) mesh): ``stateShardings`` holds one
placement per state buffer, in ``collectStateBuffers`` order, as
``tensorParallelSpecs`` and ``zeroOptimizerSpecs`` give them (the JAX
package's ``NamedSharding`` list): a tuple of ``torch.distributed.tensor``
placements, ``Shard(dim)`` or ``Replicate()``, one for each mesh dim.

- Tensor parallelism: a Linear or ConvND whose weight is sharded over an
  axis computes with this rank's block of its output features; its
  forward gathers the features over the axis's group, its backward sums the
  partial input gradient over it and writes the rank's block of the
  parameter gradients (``fusedctx.ModelBlocks``, which the modules consult;
  nothing is wrapped or swapped).
- Sharded optimizer state: a variable whose optimizer slots are sharded
  (the tensor-parallel variables' slots, and every slot under ZeRO-1) keeps
  in its slots only this rank's block, 1 / N of them.  The update runs on
  the matching block of the parameter and of its (data-mean) gradient,
  then gathers the updated blocks over the axis into the whole parameter.
  Where a tensor-parallel variable's slots are placed otherwise than the
  variable (replicated, or on another dim or axis, as the rule "like the
  variable of its shape" gives a transposed and a plain Linear of one
  square shape), its gradient blocks are gathered whole before the update,
  so any placement gives the single-device numbers, as GSPMD does.  The
  cut slots stay on the caller's optimizer and belong to this step from
  then on: a second step's specs over them, the optimizer's own ``update``
  and its ``save`` raise ``ValueError``.
- The parameters and gradients stay whole between steps, and after every
  call each variable reads whole and the same on every rank.  The JAX
  package's GSPMD keeps them sharded in device memory; this is a
  divergence the port keeps (ROADMAP Queue 3).

The data axis does what it does without specs.  On CUDA every collective is
NCCL's, recorded in the step's CUDA graph (a group over gloo raises).  The
specs need the optimizer's local state: under global state every variable
is a view of one flat buffer, and a spec raises ``ValueError``.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.placement_types import Replicate, Shard

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch import fusedctx
from puzzlelib_tpu_torch.backend import collective, gpuarray
from puzzlelib_tpu_torch.containers.container import Container
from puzzlelib_tpu_torch.handlers.calculator import Calculator
from puzzlelib_tpu_torch.handlers.trainer import Trainer
from puzzlelib_tpu_torch.handlers.validator import Validator
from puzzlelib_tpu_torch.ops.hopper import flash, matmul, winograd
from puzzlelib_tpu_torch.rng import RandomNumberGenerator
from puzzlelib_tpu_torch.variable import Variable


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


def _stateProvenance(module, cost=None, optimizer=None):
    """Every tensor the train step writes, in a fixed order, with repeats,
    as (tensor, owner, name): the variables' data and gradients (owner the
    module, name the variable's) and the modules' attributes (a batch
    norm's running stats; the attribute's name), the optimizer's state
    (owner the variable it tracks under local state, else None; name the
    state's key) and flat variables, the cost's errors (owner None)."""
    for mod in _moduleTree(module):
        for name, var in mod.vars.items():
            yield var.data, mod, name
            if var.grad is not None:
                yield var.grad, mod, name

        for name, attr in mod.attrs.items():
            yield attr, mod, name

    if optimizer is not None:
        for key, state in optimizer.states.items():
            owner = optimizer.module.getVar(key) if isinstance(key, str) else None
            for entity in state.values():
                yield entity, owner, key

        for globalVar in optimizer.globalVar.values():
            yield globalVar.data, None, None
            yield globalVar.grad, None, None

    if cost is not None:
        yield cost.devErr, None, None
        yield cost.accumErr, None, None


def _stateTensors(module, cost=None, optimizer=None):
    """Every tensor the train step writes (``_stateProvenance``'s)."""
    return (tensor for tensor, _, _ in _stateProvenance(module, cost, optimizer))


def _rootBuffer(tensor):
    """The whole allocation ``tensor`` lies in, as a flat tensor of its type:
    for a view of an optimizer's flat buffer, that buffer."""
    storage = tensor.untyped_storage()
    return torch.empty(0, dtype=tensor.dtype, device=tensor.device).set_(
        storage, 0, (storage.nbytes() // tensor.element_size(), ))


def _firstOfEachRoot(entries):
    """The entries (tensor, ...) whose tensor is the first in its root
    buffer."""
    seen, firsts = set(), []
    for entry in entries:
        key = (entry[0].device, entry[0].untyped_storage().data_ptr())
        if key not in seen:
            seen.add(key)
            firsts.append(entry)

    return firsts


def _roots(tensors):
    return [_rootBuffer(tensor) for tensor, in _firstOfEachRoot((tensor, ) for tensor in tensors)]


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


def _paramSlots(module):
    """[(owner module, variable name, variable)] of the tree's weights, in
    the module-tree walk's order, a weight that several names share once:
    the order ``collectParamBuffers`` gives them under local state.  Unlike
    the root buffers, it names each variable also where the variables are
    views of an optimizer's flat buffer (global state)."""
    seen, slots = set(), []
    for mod in _moduleTree(module):
        for name, var in mod.vars.items():
            key = (var.data.device, var.data.data_ptr(), tuple(var.data.shape), var.data.dtype)
            if key not in seen:
                seen.add(key)
                slots.append((mod, name, var))

    return slots


def stageVars(module):
    """The variables of the tree in ``collectParamBuffers`` order (the
    JAX package's ``Pipeline._stageVars``): structurally equal trees give
    their variables in the same order."""
    return [var for _, _, var in _paramSlots(module)]


def paramList(module):
    """The weights of the tree, as ``stageVars`` orders them: the parameter
    list that ``functionalize``'s ``apply`` takes for this tree or for a
    tree of the same structure."""
    return [var.data for var in stageVars(module)]


def functionalize(module):
    """Pure-apply view of a module tree: returns ``(apply, params)``.

    ``apply(params, x)`` runs the live module on ``x`` with the tensors of
    ``params`` (``paramList`` order) in place of its weights, then puts its
    own weights back and calls ``reset()``; ``params`` is the current weight
    list.  A sibling tree of the same structure hands its weights over as
    ``paramList(sibling)``.  The tensor objects are swapped, not copied
    into: a copy would write the live weights, also from inside a CUDA
    graph.  The weights put back are those the module holds at the call,
    not at ``functionalize``: the module may have trained, or been set up by
    an optimizer, in between.

    ``apply`` is a forward only: the port's modules write their outputs in
    place (a Linear adds its bias into its product) and, on the card, a
    Linear's product is the custom operator ``puzzlelib::matmul``, which has
    no autograd formula.  A module's gradient is its own ``backward``
    (``SwitchMoE`` runs its experts so)."""
    slots = _paramSlots(module)

    def apply(params, x):
        if len(params) != len(slots):
            raise ValueError("%s takes %d parameters, %d were given" % (module, len(slots), len(params)))

        saved = [(mod._parameters[name], var.data) for mod, name, var in slots]
        try:
            for (mod, name, var), param in zip(slots, params):
                mod._parameters[name] = param
                var.data = param

            return module(x)
        finally:
            for (mod, name, var), (owned, data) in zip(slots, saved):
                mod._parameters[name] = owned
                var.data = data
            module.reset()

    return apply, [var.data for _, _, var in slots]


def _axisSize(mesh, axis):
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _placements(mesh, axis, dim):
    """The placement of a buffer sharded on ``dim`` over ``axis`` (replicated
    where ``dim`` is None): a placement for each mesh dim."""
    return tuple(Shard(dim) if name == axis and dim is not None else Replicate() for name in mesh.mesh_dim_names)


def _featureDims(owner):
    """{variable: its dim of the output features} of a Linear or a ConvND,
    the layers that tensor parallelism shards; None for another owner."""
    from puzzlelib_tpu_torch.modules.convnd import ConvND
    from puzzlelib_tpu_torch.modules.linear import Linear

    if isinstance(owner, Linear):
        return {"W": owner._featureDim, "b": 0}

    return {"W": 0, "b": 1} if isinstance(owner, ConvND) else None


def tensorParallelSpecs(module, cost, optimizer, mesh, modelAxis="model"):
    """A placement for each state buffer (``collectStateBuffers`` order) for
    Megatron-style tensor parallelism, by the JAX package's rules: a Linear's
    W shards on its output features (dim 1, dim 0 when ``transpose``) and
    its b on dim 0, a ConvND's W on its output maps (dim 0) and its b on
    dim 1, each only where the dim divides over ``modelAxis``; a gradient
    shards as its variable, an optimizer slot (and any other buffer) as the
    variable of its shape, the last such; everything else is
    replicated."""
    from puzzlelib_tpu_torch.modules.module import Module

    axisSize = _axisSize(mesh, modelAxis)
    shapeSpecs = {}

    def specFor(owner, name, shape):
        dim = (_featureDims(owner) or {}).get(name)
        if dim is None or shape[dim] % axisSize != 0:
            return None

        shapeSpecs[shape] = dim
        return dim

    dims = []
    for tensor, owner, name in _firstOfEachRoot(_stateProvenance(module, cost, optimizer)):
        shape = tuple(tensor.shape)
        dims.append(specFor(owner, name, shape) if isinstance(owner, Module) else shapeSpecs.get(shape))

    return [_placements(mesh, modelAxis, dim) for dim in dims]


def zeroOptimizerSpecs(module, cost, optimizer, mesh, dataAxis="data"):
    """ZeRO-1: a placement for each state buffer (``collectStateBuffers``
    order) that shards each optimizer slot over ``dataAxis`` on its first
    dim that divides evenly and is at least the axis's size; parameters,
    gradients and the rest stay replicated.  Needs the optimizer's local
    state, as the JAX package's does."""
    axisSize = _axisSize(mesh, dataAxis)

    dims = []
    for tensor, owner, _ in _firstOfEachRoot(_stateProvenance(module, cost, optimizer)):
        dim = None
        if isinstance(owner, Variable):               # an optimizer slot
            dim = next((d for d, size in enumerate(tensor.shape) if size % axisSize == 0 and size >= axisSize),
                       None)

        dims.append(dim)

    return [_placements(mesh, dataAxis, dim) for dim in dims]


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
    the recordings made.  A write into a measured dispatch table
    (``Config.dispatchEpoch``) may change what the step launches, so it
    drops every recording (``ops/conv.py:332-341`` drops the traces that
    pinned the old choice)."""

    def __init__(self):
        self.byKey, self.captures, self.epoch = {}, 0, Config.dispatchEpoch

    def get(self, key, addresses, record):
        if self.epoch != Config.dispatchEpoch:
            self.byKey.clear()
            self.epoch = Config.dispatchEpoch

        held = self.byKey.get(key)
        if held is None or held[0] != addresses:
            self.byKey.pop(key, None)   # the old graph and its memory pool go first
            held = self.byKey[key] = (addresses, record())
            self.captures += 1

        return held[1]


def _routeKey():
    return Config.gemmAlgo, Config.convAlgo, Config.matmulPrecision, Config.dispatchEpoch


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
    go to the configured device as they are).  With a ``mesh``, each rank
    of its ``dataAxis`` takes its share of the global batch that it is
    called with, and the gradients are averaged over the axis."""

    def __init__(self, module, cost, optimizer, mesh=None, dataAxis="data", stateShardings=None):
        if stateShardings is not None and optimizer.globalState:
            raise ValueError("FusedStep's stateShardings take an optimizer in local state "
                             "(setupOn(..., useGlobalState=False)): under global state every variable is a view "
                             "of one flat buffer, which is not sharded variable by variable")

        if getattr(optimizer, "nodeinfo", None) is not None:
            raise ValueError("FusedStep takes no optimizer built with a grid's nodeinfo: its collectives run "
                             "eagerly over the grid's process group, which a CUDA graph cannot record; "
                             "FusedStep(mesh=...) is the fused form of data-parallel training")

        if stateShardings is not None and mesh is None:
            raise ValueError("FusedStep's stateShardings place the state over a mesh: pass the mesh too")

        self.group = None if mesh is None else mesh.get_group(dataAxis)
        self.module, self.cost, self.optimizer = module, cost, optimizer
        self._blocks, self._sharded, self._wholeGrads = {}, [], []
        if stateShardings is not None:
            self._shardState(mesh, stateShardings)

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

    def _shardState(self, mesh, stateShardings):
        """From the placements: the tensor-parallel layers' ``ModelBlocks``
        (``_blocks``), [(variable, dim, group)] of the variables whose
        optimizer slots are sharded (``_sharded``), whose slots are cut to
        this rank's block here, and of the tensor-parallel variables whose
        slots are not placed as the variable is (``_wholeGrads``): the
        backward writes only this rank's block of their gradient, which the
        update gathers whole first."""
        from puzzlelib_tpu_torch.modules.module import Module

        entries = _firstOfEachRoot(_stateProvenance(self.module, self.cost, self.optimizer))
        if len(stateShardings) != len(entries):
            raise ValueError("stateShardings holds %d placements, the step has %d state buffers "
                             "(collectStateBuffers)" % (len(stateShardings), len(entries)))

        layers, slots = {}, {}
        for (tensor, owner, name), placements in zip(entries, stateShardings):
            sharded = [(axis, p.dim) for axis, p in enumerate(placements) if isinstance(p, Shard)]
            if len(sharded) > 1:
                raise ValueError("a buffer of %s is sharded over %d mesh dims: FusedStep shards each over one" %
                                 (name, len(sharded)))

            placed = sharded[0] if sharded else None
            if isinstance(owner, Variable):                          # an optimizer slot
                slots.setdefault(name, (owner, set()))[1].add(placed)
            elif placed is None:
                continue
            elif _featureDims(owner) and name in owner.vars and tensor is owner.vars[name].data:
                want = _featureDims(owner)[name]
                if placed[1] != want or getattr(owner, "groups", 1) != 1:
                    raise ValueError("%s shards its %s on dim %d: FusedStep shards an ungrouped layer's output "
                                     "features (dim %d)" % (owner, name, placed[1], want))

                layers.setdefault(owner, set()).add((name, placed[0]))
            elif not (isinstance(owner, Module) and name in owner.vars and tensor is owner.vars[name].grad):
                raise ValueError("FusedStep shards the weights of Linear and ConvND layers and optimizer slots; "
                                 "a buffer of %s (%s) is sharded" % (owner, name))

        blockwise = {}                                  # id(variable) -> (variable, axis, dim)
        for layer, placed in layers.items():
            if {name for name, _ in placed} != set(layer.vars) or len({axis for _, axis in placed}) != 1:
                raise ValueError("%s shards all its variables over one mesh dim, or none" % layer)

            axis = next(iter(placed))[1]
            self._blocks[id(layer)] = fusedctx.ModelBlocks(mesh.get_group(axis))
            blockwise.update((id(var), (var, axis, _featureDims(layer)[name])) for name, var in layer.vars.items())

        for name, (var, placed) in slots.items():
            if len(placed) != 1:
                raise ValueError("the optimizer slots of %s are placed %s: they shard alike" % (name, placed))

            state = self.optimizer.states[name]
            if any(value.shape != var.data.shape for value in state.values()):
                raise ValueError("the optimizer slots of %s hold one rank's block already: another FusedStep's "
                                 "stateShardings cut them; set the optimizer up anew for this step" % name)

            placed = placed.pop()
            layerVar = blockwise.pop(id(var), None)
            if layerVar is not None and placed != layerVar[1:]:
                self._wholeGrads.append((var, layerVar[2], mesh.get_group(layerVar[1])))

            if placed is None:
                continue

            axis, dim = placed
            group = mesh.get_group(axis)
            for slot, value in state.items():
                state[slot] = collective.blockOf(value, dim, group).clone(memory_format=torch.contiguous_format)

            self._sharded.append((var, dim, group))

        # a tensor-parallel variable with no optimizer slots (SGD's)
        self._wholeGrads.extend((var, dim, mesh.get_group(axis)) for var, axis, dim in blockwise.values())

    def _hyper(self):
        hyper = {}
        for name in sorted(self.optimizer.attrs):
            val = getattr(self.optimizer, name)
            if name != "t" and isinstance(val, (int, float)):
                hyper[name] = float(val)

        return hyper

    def _shard(self, data, target, axis):
        """(this rank's rows of ``data`` and ``target`` along ``axis``, the
        data group), or the whole batch and no group where there is no mesh
        or the batch does not divide over it."""
        if self.group is None:
            return data, target, None

        size, rank = dist.get_world_size(self.group), dist.get_rank(self.group)
        if data.shape[axis] % size:
            return data, target, None

        rows = data.shape[axis] // size
        return data.narrow(axis, rank * rows, rows), target.narrow(axis, rank * rows, rows), self.group

    def _reduce(self, group, accumErr):
        """Every gradient root buffer replaced by its mean over ``group``,
        and the cost's error summed over it: the step's ``devErr``, and its
        running sum taken anew from ``accumErr``, its value before the
        step."""
        for grad in _roots(var.grad for var in _variables(self.module) if var.grad is not None):
            collective.meanInPlace(grad, group)

        collective.sumInPlace(self.cost.devErr, group)
        torch.add(accumErr, self.cost.devErr, out=self.cost.accumErr)

    def _body(self, data, target, hyper, t, group):
        """The eager train step, with the hyper-parameters and t as tensors,
        over the data ``group`` (or None); the Python-side counters it
        advances are put back."""
        snapshot = {name: getattr(self.optimizer, name) for name in hyper}
        for name, val in hyper.items():
            setattr(self.optimizer, name, val)

        costCounters = (self.cost.batchsize, self.cost.numOfSamples)
        optT = self.optimizer.t

        try:
            with fusedctx.activate(hyper, t, group, self._blocks):
                accumErr = self.cost.accumErr.clone() if group is not None else None
                grad = self.cost(self.module(data), target, queryError=False)

                self.optimizer.zeroGradParams()
                self.module.backward(grad, updGrad=False)

                if group is not None:
                    self._reduce(group, accumErr)

                self._update()

        finally:
            for name, val in snapshot.items():
                setattr(self.optimizer, name, val)

            self.cost.batchsize, self.cost.numOfSamples = costCounters
            self.optimizer.t = optT

    def _update(self):
        """The optimizer's update; a variable with sharded slots takes it on
        its block of the parameter and of the gradient, and the updated
        blocks are gathered into the whole parameter.  A tensor-parallel
        variable whose slots are placed otherwise has its gradient blocks
        gathered whole first."""
        for var, dim, group in self._wholeGrads:
            var.grad.copy_(collective.allGather(collective.blockOf(var.grad, dim, group).contiguous(), group, dim))

        wholes = []
        for var, dim, group in self._sharded:
            wholes.append((var.data, var.grad))
            var.data = collective.blockOf(var.data, dim, group).contiguous()
            var.grad = collective.blockOf(var.grad, dim, group).contiguous()

        try:
            self.optimizer.update()
        finally:
            blocks = [var.data for var, _, _ in self._sharded]
            for (var, _, _), (data, grad) in zip(self._sharded, wholes):
                var.data, var.grad = data, grad

        for (var, dim, group), block in zip(self._sharded, blocks):
            var.data.copy_(collective.allGather(block, group, dim))

    def _groups(self):
        """The process groups the step's collectives run over."""
        return [self.group] + [blocks.group for blocks in self._blocks.values()] + \
            [group for _, _, group in self._sharded]

    def _run(self, data, target, t, group):
        device = data.device
        hyper = {name: self._scalars.get(name, val, device) for name, val in self._hyper().items()}
        tensorT = self._scalars.get("t", t, device)

        if device.type != "cuda":
            self._body(data, target, hyper, tensorT, group)
            return

        for meshGroup in self._groups():
            if meshGroup is not None and dist.get_backend(meshGroup) != dist.Backend.NCCL:
                raise ValueError("a mesh step on CUDA tensors records its collectives in a CUDA graph, which "
                                 "takes NCCL's; a group of the mesh runs %s" % dist.get_backend(meshGroup))

        key = (_signature(data), _signature(target), device, tuple(hyper), group is not None) + _routeKey()
        addresses = tuple(tensor.data_ptr() for tensor in _stateTensors(self.module, self.cost, self.optimizer))

        recording = self._recordings.get(key, addresses, lambda: self._record(data, target, hyper, tensorT, group))
        recording.replay(data, target)

    def _record(self, data, target, hyper, t, group):
        """A recording of the step, with the state and the generators put
        back as they were before it (the body puts back the counters of the
        cost and the optimizer itself)."""
        self.buffers = collectStateBuffers(self.module, self.cost, self.optimizer)
        generators = _generators(self.module, data.device)

        saved = [buf.clone() for buf in self.buffers]
        genStates = [gen.get_state() for gen in generators]

        recording = _record(lambda d, tgt: self._body(d, tgt, hyper, t, group), [data, target], generators)
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
        b, ...) split evenly, or already (steps, b, ...); over a mesh each
        rank takes its share of each step's b rows.  The cost's last error
        is the sum over the steps, so ``getError()`` is the mean over all
        steps * b samples."""
        data, target = _asTensor(data), _asTensor(target)

        if data.shape[0] != steps:
            if data.shape[0] % steps != 0:
                raise ValueError("Leading dim %d not divisible into %d steps" % (data.shape[0], steps))

            b = data.shape[0] // steps
            data = data.reshape((steps, b) + tuple(data.shape[1:]))
            target = target.reshape((steps, b) + tuple(target.shape[1:]))

        t0 = self.optimizer.t + 1
        self._begin(int(data.shape[0] * data.shape[1]), steps)
        data, target, group = self._shard(data, target, 1)

        errSum = torch.zeros((), dtype=torch.float32, device=data.device)
        for i in range(steps):
            self._run(data[i], target[i], float(t0 + i), group)
            errSum.add_(self.cost.devErr)

        self.cost.devErr.copy_(errSum)
        self.module.reset()
        return self.cost

    def __call__(self, data, target):
        data, target = _asTensor(data), _asTensor(target)
        self._begin(int(data.shape[0]), 1)

        data, target, group = self._shard(data, target, 0)
        self._run(data, target, float(self.optimizer.t), group)

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
        if self.cost is None:
            return out

        # the cost's predictions (``mostProb``), where it keeps them, leave
        # the program beside its error
        return self.cost.validateDev(out, target), getattr(self.cost, "mostProb", None)

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
        """The output; with a cost, its validation error, the cost's
        ``mostProb`` (where it keeps one) set to a copy of this batch's, as
        the eager ``validateDev`` leaves it."""
        _refuseVerifyData()

        try:
            result = self._run(_asTensor(data), None if target is None else _asTensor(target))
        finally:
            self.module.reset()
            if self.cost is not None:
                self.cost.reset()

        if self.cost is None:
            return result

        error, mostProb = result
        if mostProb is not None:
            self.cost.mostProb = mostProb.clone()   # the next replay writes over the recording's

        return error


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

    A cost without ``calcValDev`` (``Multi``) takes the reference's eager
    path, one readback of ``cost.validate`` per batch, as the reference's
    does.  A cost that keeps its predictions (``mostProb``) holds the last
    batch's after a call, as after the Validator's."""

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

        self._addHostError(state, data, self.cost.validate(self.module(data), target))


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
