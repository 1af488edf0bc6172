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

Code consults these helpers; outside a fused step they pass values through.
"""

_ctx = None


class _Ctx:
    __slots__ = ("hyper", "t")

    def __init__(self, hyper, t):
        self.hyper = hyper
        self.t = t


class activate:
    def __init__(self, hyper, t):
        self.ctx = _Ctx(hyper, t)

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


def hyperOr(name, val):
    if _ctx is not None and name in _ctx.hyper:
        return _ctx.hyper[name]

    return val
