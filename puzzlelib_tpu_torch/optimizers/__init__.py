"""Optimizer exports."""

from puzzlelib_tpu_torch.optimizers.optimizer import Optimizer
from puzzlelib_tpu_torch.optimizers.sgd import SGD
from puzzlelib_tpu_torch.optimizers.momentumsgd import MomentumSGD
from puzzlelib_tpu_torch.optimizers.adam import Adam
