"""Container exports; ``SwitchMoE`` and ``MoEGate`` lazily, as the JAX
package exports them."""

from puzzlelib_tpu_torch.containers.container import Container, ContainerError
from puzzlelib_tpu_torch.containers.graph import Graph
from puzzlelib_tpu_torch.containers.node import Node, NodeError
from puzzlelib_tpu_torch.containers.parallel import Parallel
from puzzlelib_tpu_torch.containers.pipeline import Pipeline
from puzzlelib_tpu_torch.containers.sequential import Sequential


def __getattr__(name):
    # lazy re-export: switchmoe imports containers.container, so an eager
    # import here would be circular
    if name in ("SwitchMoE", "MoEGate"):
        from puzzlelib_tpu_torch.modules import switchmoe
        return getattr(switchmoe, name)

    raise AttributeError("module %r has no attribute %r" % (__name__, name))
