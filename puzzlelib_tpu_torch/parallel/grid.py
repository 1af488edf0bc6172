"""Data-parallel grid (counterpart of ``puzzlelib_tpu/parallel/grid.py``), with
the reference's API: ``runGrid(target, size)`` runs ``target(nodeinfo)`` on
every node of a grid, and the node's ``NodeInfo`` averages the gradients
(``sumTensor``), broadcasts node 0's weights (``broadcastBuffer``) and
averages a number (``meanValue``) across the grid.  An optimizer built with
``nodeinfo=`` calls the first two itself.

One process a node, over ``torch.distributed``, as the reference's grid forks
one process a GPU (the JAX package runs one thread a node, JAX having a
single controller; the port's ``Config.device``, launch counters and dispatch
tables are process-wide, so threads could not give each node its device):

- the processes are spawned (``torch.multiprocessing``, ``spawn``), so the
  target and its arguments cross by pickling: the target is a function at the
  top level of a module that a fresh interpreter can import.  They are
  pickled once, into a file that every node reads, so that the nodes start
  together however large the arguments (a process's own arguments reach it
  only once it has started).  Each node starts with the parent's ``Config``
  flags (``INHERITED``), as a forked one would;
- each node meets the others through a ``FileStore`` in a temporary
  directory (no port to pick, also where several grids run at once), with
  the process-group ``timeout`` given, and sets ``Config.device`` to its
  device: "cpu" where the caller asked for the CPU (``Config.device =
  "cpu"``, with one intra-op thread), else ``cuda:<devices[i]>``
  (``torch.cuda.set_device``);
- nodes share a device only where ``devices`` names it more than once, or on
  the CPU; a device index the machine lacks raises ``GridError``;
- the backend is decided up front: NCCL where every node has a card of its
  own, gloo where nodes share a card and on the CPU;
- the first node that raises has its exception raised in the caller, with
  the node's traceback as a note; the other nodes are terminated.

The collectives have the arithmetic of the JAX package's reducer
(``backend/collective.py``): ``sumTensor`` writes the grid's mean, summed in
f32, and ``meanValue`` is ``sum(values) / gridsize`` in node order, the same
float on every node.
"""

import datetime
import multiprocessing.connection
import pickle
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from puzzlelib_tpu_torch import config as Config
from puzzlelib_tpu_torch.backend import collective


# the Config flags a node takes from its parent
INHERITED = ("matmulPrecision", "gemmAlgo", "convAlgo", "attentionAlgo", "globalEvalMode",
             "disableDtypeShapeChecks", "disableModuleCompatChecks", "verifyData", "showWarnings",
             "debugAllocator")

# seconds a collective may wait for its peers before it raises
TIMEOUT = 300


class GridError(Exception):
    pass


def _onCpu():
    return Config.device is not None and torch.device(Config.device).type == "cpu"


def _placement(size, devices):
    """(each node's device, the backend) for a grid of ``size``."""
    if size < 1:
        raise GridError("a grid needs at least one node, got %d" % size)

    devices = list(range(size)) if devices is None else list(devices)
    if len(devices) != size:
        raise GridError("%d devices given for a grid of %d nodes" % (len(devices), size))

    if _onCpu():
        return ["cpu"] * size, dist.Backend.GLOO

    count = torch.cuda.device_count()
    for index in devices:
        if not 0 <= index < count:
            raise GridError("device %s asked for, the machine has %d CUDA card(s) (set Config.device = \"cpu\" "
                            "to run the grid on the CPU)" % (index, count))

    backend = dist.Backend.NCCL if len(set(devices)) == size else dist.Backend.GLOO
    return ["cuda:%d" % index for index in devices], backend


def runGrid(target, size, *args, devices=None, timeout=TIMEOUT, **kwargs):
    """``target(nodeinfo, *args, **kwargs)`` on each of ``size`` nodes, one
    process each, node i on card ``devices[i]`` (by default card i), or all
    on the CPU where ``Config.device`` is "cpu".  ``timeout`` (seconds)
    bounds every collective's wait.  Returns when every node has returned;
    raises the first node's exception."""
    nodeDevices, backend = _placement(size, devices)

    try:
        work = pickle.dumps((target, args, kwargs, {name: getattr(Config, name) for name in INHERITED}))
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise GridError("the grid's target and arguments cross to the nodes by pickling: the target must be a "
                        "function at the top level of an importable module (%s)" % e) from e

    ctx = mp.get_context("spawn")
    storeDir = Path(tempfile.mkdtemp(prefix="grid-"))
    (storeDir / "work").write_bytes(work)

    procs, conns = [], []
    try:
        for index, device in enumerate(nodeDevices):
            mine, theirs = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=_nodeMain, name="grid-node-%d" % index,
                               args=(index, size, device, backend, str(storeDir), timeout, theirs))
            proc.start()
            theirs.close()

            procs.append(proc)
            conns.append(mine)

        error = _await(procs, conns)

    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()

        for proc in procs:
            proc.join(30)

        for conn in conns:
            conn.close()

        shutil.rmtree(storeDir, ignore_errors=True)

    if error is not None:
        raise error


def _await(procs, conns):
    """Wait for every node's report; at the first error, return the error
    that was raised first (a node's report carries the time it was made)
    without waiting for the rest."""
    pending = dict(zip(conns, range(len(conns))))

    while pending:
        errors = []
        for conn in multiprocessing.connection.wait(list(pending)):
            index = pending.pop(conn)

            try:
                kind, exc, tb, stamp = conn.recv()
            except EOFError:
                procs[index].join(5)
                kind, tb, stamp = "error", "", time.time()
                exc = GridError("grid node %d ended with exit code %s before it reported" %
                                (index, procs[index].exitcode))

            if kind == "error":
                errors.append((stamp, index, exc, tb))

        if errors:
            _, index, exc, tb = min(errors, key=lambda error: error[0])
            exc.add_note("raised in grid node %d:\n%s" % (index, tb))
            return exc

    return None


def _report(exc):
    """The report of ``exc`` to the parent: its kind, the exception (or a
    picklable stand-in), the traceback and the time."""
    tb = traceback.format_exc()
    try:
        pickle.dumps(exc)
    except Exception:
        exc = GridError("%s: %s" % (type(exc).__name__, exc))

    return "error", exc, tb, time.time()


def _nodeMain(index, size, device, backend, storeDir, timeout, conn):
    try:
        target, args, kwargs, flags = pickle.loads((Path(storeDir) / "work").read_bytes())
        for name, value in flags.items():
            setattr(Config, name, value)

        Config.device = device
        if device != "cpu":
            torch.cuda.set_device(device)
        else:
            # the nodes share the host's cores: one intra-op thread each
            # keeps them from oversubscribing it (the MoE trunk's pipeline
            # steps run ten times faster so on 8 cores)
            torch.set_num_threads(1)

        store = dist.FileStore(str(Path(storeDir) / "store"), size)
        dist.init_process_group(backend, store=store, rank=index, world_size=size,
                                timeout=datetime.timedelta(seconds=timeout),
                                device_id=torch.device(device) if backend == dist.Backend.NCCL else None)

        nodeinfo = NodeInfo(index, size, device)
        try:
            target(nodeinfo, *args, **kwargs)
        except BaseException as exc:
            # reported before the group closes: a peer that the closing
            # makes fail reports later, and the parent raises the first
            conn.send(_report(exc))
            nodeinfo.close()
            return

        nodeinfo.close()
        conn.send(("done", None, None, time.time()))

    except BaseException as exc:   # every failure goes to the parent, which raises it
        conn.send(_report(exc))

    finally:
        conn.close()


class NodeInfo:
    """A node of the grid: its ``index``, the ``gridsize`` and its
    ``device``, and the collectives over the grid's process group."""

    def __init__(self, index, gridsize, device):
        self.index = index
        self.gridsize = gridsize
        self.device = device

    def close(self):
        if dist.is_initialized():
            dist.destroy_process_group()

    def meanValue(self, value):
        """The mean of every node's ``value``: ``sum(values) / gridsize``,
        summed in node order, the same float on every node."""
        values = [None] * self.gridsize
        dist.all_gather_object(values, float(value))

        return sum(values) / self.gridsize

    def sumTensor(self, name, tensor):
        """``tensor`` replaced, in place, by the grid's mean of it (the sum in
        f32, times 1 / gridsize, back in its type)."""
        collective.meanInPlace(tensor, None)

    def broadcastBuffer(self, name, buffer):
        """Node 0's ``buffer`` copied into every node's, in place."""
        collective.broadcastInPlace(buffer, None)
