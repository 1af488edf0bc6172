"""Cost exports."""

from puzzlelib_tpu_torch.cost.abs import Abs
from puzzlelib_tpu_torch.cost.bce import BCE
from puzzlelib_tpu_torch.cost.crossentropy import CrossEntropy
from puzzlelib_tpu_torch.cost.ctc import CTC
from puzzlelib_tpu_torch.cost.hinge import Hinge
from puzzlelib_tpu_torch.cost.kldivergence import KLDivergence
from puzzlelib_tpu_torch.cost.l1hinge import L1Hinge
from puzzlelib_tpu_torch.cost.mse import MSE
from puzzlelib_tpu_torch.cost.multi import Multi
from puzzlelib_tpu_torch.cost.smoothl1 import SmoothL1
from puzzlelib_tpu_torch.cost.svm import SVM
from puzzlelib_tpu_torch.cost.cost import Cost, CostError
