"""Model zoo builders ported so far."""

from puzzlelib_tpu_torch.models.nets.vgg import loadVGG
