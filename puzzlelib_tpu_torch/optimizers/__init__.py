"""Optimizer exports."""

from puzzlelib_tpu_torch.optimizers.adadelta import AdaDelta
from puzzlelib_tpu_torch.optimizers.adagrad import AdaGrad
from puzzlelib_tpu_torch.optimizers.adam import Adam
from puzzlelib_tpu_torch.optimizers.momentumsgd import MomentumSGD
from puzzlelib_tpu_torch.optimizers.nesterovsgd import NesterovSGD
from puzzlelib_tpu_torch.optimizers.rmsprop import RMSProp
from puzzlelib_tpu_torch.optimizers.rmspropgraves import RMSPropGraves
from puzzlelib_tpu_torch.optimizers.sgd import SGD
from puzzlelib_tpu_torch.optimizers.smorms3 import SMORMS3
from puzzlelib_tpu_torch.optimizers.optimizer import Optimizer
from puzzlelib_tpu_torch.optimizers.hooks import Hook, WeightDecay, GradClip
