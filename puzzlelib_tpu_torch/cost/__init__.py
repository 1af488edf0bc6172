"""Cost exports."""

from puzzlelib_tpu_torch.cost.cost import Cost, CostError
from puzzlelib_tpu_torch.cost.crossentropy import CrossEntropy
