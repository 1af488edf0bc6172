"""Cost exports."""

from puzzlelib_tpu_torch.cost.bce import BCE
from puzzlelib_tpu_torch.cost.cost import Cost, CostError
from puzzlelib_tpu_torch.cost.crossentropy import CrossEntropy
from puzzlelib_tpu_torch.cost.ctc import CTC
from puzzlelib_tpu_torch.cost.mse import MSE
