"""Model zoo builders ported so far."""

from puzzlelib_tpu_torch.models.nets.lenet import loadLeNet
from puzzlelib_tpu_torch.models.nets.nin import loadNiNImageNet
from puzzlelib_tpu_torch.models.nets.transformer import buildTransformerClassifier
from puzzlelib_tpu_torch.models.nets.vgg import loadVGG
