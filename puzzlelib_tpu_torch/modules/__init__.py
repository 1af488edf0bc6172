"""Module exports, in the JAX package's order: the layers of the VGG,
transformer, CNN training, ResNet, U-Net, Inception, sequence, SegNet,
AlexNet and C3D slices, the glue, upsampling and unpooling layers, and the
LRN family, the spatial transformer, ``GroupLinear``, the noise and
penalty layers and the 1-d and 3-d modules."""

from puzzlelib_tpu_torch.modules.activation import (
    Activation, ActivationType, sigmoid, tanh, relu, leakyRelu, elu, softPlus, clip
)
from puzzlelib_tpu_torch.modules.add import Add
from puzzlelib_tpu_torch.modules.avgpool1d import AvgPool1D
from puzzlelib_tpu_torch.modules.avgpool2d import AvgPool2D
from puzzlelib_tpu_torch.modules.avgpool3d import AvgPool3D
from puzzlelib_tpu_torch.modules.attention import MultiHeadAttention
from puzzlelib_tpu_torch.modules.batchnorm import BatchNorm
from puzzlelib_tpu_torch.modules.batchnorm1d import BatchNorm1D
from puzzlelib_tpu_torch.modules.batchnorm2d import BatchNorm2D
from puzzlelib_tpu_torch.modules.batchnorm3d import BatchNorm3D
from puzzlelib_tpu_torch.modules.batchnormnd import BatchNormND
from puzzlelib_tpu_torch.modules.cast import Cast, DataType
from puzzlelib_tpu_torch.modules.concat import Concat
from puzzlelib_tpu_torch.modules.conv1d import Conv1D
from puzzlelib_tpu_torch.modules.conv2d import Conv2D
from puzzlelib_tpu_torch.modules.conv3d import Conv3D
from puzzlelib_tpu_torch.modules.convnd import ConvND
from puzzlelib_tpu_torch.modules.crossmaplrn import CrossMapLRN
from puzzlelib_tpu_torch.modules.deconv1d import Deconv1D
from puzzlelib_tpu_torch.modules.deconv2d import Deconv2D
from puzzlelib_tpu_torch.modules.deconv3d import Deconv3D
from puzzlelib_tpu_torch.modules.deconvnd import DeconvND
from puzzlelib_tpu_torch.modules.depthconcat import DepthConcat
from puzzlelib_tpu_torch.modules.dropout import Dropout
from puzzlelib_tpu_torch.modules.dropout2d import Dropout2D
from puzzlelib_tpu_torch.modules.embedder import Embedder
from puzzlelib_tpu_torch.modules.flatten import Flatten
from puzzlelib_tpu_torch.modules.gelu import Gelu
from puzzlelib_tpu_torch.modules.glue import Glue
from puzzlelib_tpu_torch.modules.grouplinear import GroupLinear, GroupMode
from puzzlelib_tpu_torch.modules.identity import Identity
from puzzlelib_tpu_torch.modules.instancenorm2d import InstanceNorm2D
from puzzlelib_tpu_torch.modules.kmaxpool import KMaxPool
from puzzlelib_tpu_torch.modules.lcn import LCN
from puzzlelib_tpu_torch.modules.layernorm import LayerNorm
from puzzlelib_tpu_torch.modules.linear import Linear
from puzzlelib_tpu_torch.modules.lrn import LRN
from puzzlelib_tpu_torch.modules.maplrn import MapLRN
from puzzlelib_tpu_torch.modules.maxpool1d import MaxPool1D
from puzzlelib_tpu_torch.modules.maxpool2d import MaxPool2D
from puzzlelib_tpu_torch.modules.maxpool3d import MaxPool3D
from puzzlelib_tpu_torch.modules.maxunpool2d import MaxUnpool2D
from puzzlelib_tpu_torch.modules.module import InitScheme, Module, ModuleError
from puzzlelib_tpu_torch.modules.moveaxis import MoveAxis
from puzzlelib_tpu_torch.modules.mul import Mul
from puzzlelib_tpu_torch.modules.muladdconst import MulAddConst
from puzzlelib_tpu_torch.modules.noiseinjector import NoiseInjector, InjectMode, NoiseType
from puzzlelib_tpu_torch.modules.pad1d import Pad1D
from puzzlelib_tpu_torch.modules.pad2d import Pad2D
from puzzlelib_tpu_torch.modules.penalty import Penalty, PenaltyMode
from puzzlelib_tpu_torch.modules.pool1d import Pool1D
from puzzlelib_tpu_torch.modules.pool2d import Pool2D
from puzzlelib_tpu_torch.modules.pool3d import Pool3D
from puzzlelib_tpu_torch.modules.prelu import PRelu
from puzzlelib_tpu_torch.modules.replicate import Replicate
from puzzlelib_tpu_torch.modules.reshape import Reshape
from puzzlelib_tpu_torch.modules.rnn import RNN
from puzzlelib_tpu_torch.modules.slice import Slice
from puzzlelib_tpu_torch.modules.softmax import SoftMax
from puzzlelib_tpu_torch.modules.spatialtf import SpatialTf
from puzzlelib_tpu_torch.modules.split import Split
from puzzlelib_tpu_torch.modules.subtractmean import SubtractMean
from puzzlelib_tpu_torch.modules.sum import Sum
from puzzlelib_tpu_torch.modules.swapaxes import SwapAxes
from puzzlelib_tpu_torch.modules.tile import Tile
from puzzlelib_tpu_torch.modules.tolist import ToList
from puzzlelib_tpu_torch.modules.transpose import Transpose
from puzzlelib_tpu_torch.modules.upsample2d import Upsample2D
from puzzlelib_tpu_torch.modules.upsample3d import Upsample3D
