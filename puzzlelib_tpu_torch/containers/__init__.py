"""Container exports."""

from puzzlelib_tpu_torch.containers.container import Container, ContainerError
from puzzlelib_tpu_torch.containers.graph import Graph
from puzzlelib_tpu_torch.containers.node import Node, NodeError
from puzzlelib_tpu_torch.containers.sequential import Sequential
