"""Model zoo builders ported so far."""

from puzzlelib_tpu_torch.models.nets.inception import loadInceptionBN, loadInceptionV3
from puzzlelib_tpu_torch.models.nets.lenet import loadLeNet
from puzzlelib_tpu_torch.models.nets.nin import loadNiNImageNet
from puzzlelib_tpu_torch.models.nets.resnet import loadResNet, residBlock, residMiniBlock
from puzzlelib_tpu_torch.models.nets.transformer import buildTransformerClassifier
from puzzlelib_tpu_torch.models.nets.unet import loadUNet
from puzzlelib_tpu_torch.models.nets.vgg import loadVGG
from puzzlelib_tpu_torch.models.nets.wavetoletter import loadW2L
