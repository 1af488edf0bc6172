"""Handler exports."""

from puzzlelib_tpu_torch.handlers.calculator import Calculator
from puzzlelib_tpu_torch.handlers.handler import Handler
from puzzlelib_tpu_torch.handlers.trainer import Trainer
from puzzlelib_tpu_torch.handlers.validator import Validator
