"""Context of the fused step (counterpart of ``puzzlelib_tpu/fusedctx.py``).

While ``fused.FusedStep`` runs the eager step body, the values that the
eager path keeps as Python scalars and that change from step to step are
0-d f32 tensors on the step's device instead, so that a CUDA graph recorded
once reads their new values at every replay:

  * the step counter (Adam's bias correction, a batch norm's blend factor
    of its running stats),
  * the optimizer's hyper-parameters (a learning rate changed between
    epochs).

``FusedStep`` writes these tensors with ``fill_`` before each replay,
outside the graph.  The reference's third value, the random key, has no
counterpart: the port's draws come from the ``torch.Generator`` of
``rng.py``, which the graph advances at each replay.

A step over a mesh (``FusedStep(mesh=...)``) also names its data group: the
process group of the ranks that share the global batch.  A batch norm sums
its statistics over that group (``ops/norm.py``), as the JAX mesh step's
``jnp.mean`` over the sharded batch does; outside a mesh step there is none.
Under tensor parallelism (``FusedStep(stateShardings=...)``) it names each
sharded Linear's and ConvND's ``ModelBlocks``: the layer computes with this
rank's block of its output features and the collectives of its group
(``modules/linear.py``, ``modules/convnd.py``); every other layer gets
``WHOLE``, whose blocks are the tensors themselves.

Code consults these helpers; outside a fused step they pass values through.
"""

from puzzlelib_tpu_torch.backend import collective

_ctx = None


class _Ctx:
    __slots__ = ("hyper", "t", "group", "blocks")

    def __init__(self, hyper, t, group, blocks):
        self.hyper = hyper
        self.t = t
        self.group = group
        self.blocks = blocks


class activate:
    def __init__(self, hyper, t, group=None, blocks=None):
        self.ctx = _Ctx(hyper, t, group, blocks or {})

    def __enter__(self):
        global _ctx
        self.prev, _ctx = _ctx, self.ctx
        return self.ctx

    def __exit__(self, *exc):
        global _ctx
        _ctx = self.prev


def active():
    return _ctx is not None


def stepOr(val):
    return _ctx.t if _ctx is not None else val


def dataGroup():
    """The data group of the mesh step running, or None."""
    return _ctx.group if _ctx is not None else None


class ModelBlocks:
    """A tensor-parallel layer on this rank: its blocks of the output
    features over the ranks of ``group`` (the mesh's model axis)."""

    def __init__(self, group):
        self.group = group

    def take(self, tensor, dim):
        """This rank's block of an operand, dense in the operand's memory
        format."""
        return collective.blockOf(tensor, dim, self.group).contiguous(memory_format=collective.memoryFormat(tensor))

    def view(self, tensor, dim):
        """This rank's block of a gradient buffer, a view to write into."""
        return collective.blockOf(tensor, dim, self.group)

    def gather(self, tensor, dim):
        """The whole output from every rank's block along ``dim``."""
        return collective.allGather(tensor, self.group, dim)

    def sum(self, tensor):
        """A partial input gradient summed over the group, in place."""
        dense = tensor.contiguous()
        collective.sumInPlace(dense, self.group)
        return tensor if dense is tensor else tensor.copy_(dense)


class _Whole:
    """A layer that is not sharded: every block is the tensor itself."""

    def take(self, tensor, dim):
        return tensor

    view = take

    def gather(self, tensor, dim):
        return tensor

    def sum(self, tensor):
        return tensor


WHOLE = _Whole()


def modelBlocks(module):
    """``module``'s ``ModelBlocks`` in the tensor-parallel step running, or
    ``WHOLE``."""
    return _ctx.blocks.get(id(module), WHOLE) if _ctx is not None else WHOLE


def hyperOr(name, val):
    if _ctx is not None and name in _ctx.hyper:
        return _ctx.hyper[name]

    return val
