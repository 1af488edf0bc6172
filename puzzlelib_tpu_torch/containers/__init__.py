"""Container exports."""

from puzzlelib_tpu_torch.containers.container import Container, ContainerError
from puzzlelib_tpu_torch.containers.sequential import Sequential
