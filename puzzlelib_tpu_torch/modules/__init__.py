"""Module exports: the layers of the VGG, transformer and CNN training slices."""

from puzzlelib_tpu_torch.modules.activation import (
    Activation, ActivationType, sigmoid, tanh, relu, leakyRelu, elu, softPlus, clip
)
from puzzlelib_tpu_torch.modules.add import Add
from puzzlelib_tpu_torch.modules.avgpool2d import AvgPool2D
from puzzlelib_tpu_torch.modules.attention import MultiHeadAttention
from puzzlelib_tpu_torch.modules.conv2d import Conv2D
from puzzlelib_tpu_torch.modules.convnd import ConvND
from puzzlelib_tpu_torch.modules.dropout import Dropout
from puzzlelib_tpu_torch.modules.dropout2d import Dropout2D
from puzzlelib_tpu_torch.modules.embedder import Embedder
from puzzlelib_tpu_torch.modules.flatten import Flatten
from puzzlelib_tpu_torch.modules.gelu import Gelu
from puzzlelib_tpu_torch.modules.layernorm import LayerNorm
from puzzlelib_tpu_torch.modules.linear import Linear
from puzzlelib_tpu_torch.modules.maxpool2d import MaxPool2D
from puzzlelib_tpu_torch.modules.module import InitScheme, Module, ModuleError
from puzzlelib_tpu_torch.modules.muladdconst import MulAddConst
from puzzlelib_tpu_torch.modules.pool2d import Pool2D
from puzzlelib_tpu_torch.modules.reshape import Reshape
from puzzlelib_tpu_torch.modules.softmax import SoftMax
from puzzlelib_tpu_torch.modules.sum import Sum
