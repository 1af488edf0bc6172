"""LeNet-5-like MNIST net (counterpart of ``puzzlelib_tpu/models/nets/lenet.py``).
Weights come from the init scheme or, through
``puzzlelib_tpu_torch.convert.paramsFromNumpy``, from a table of arrays,
or from the HDF5 checkpoint at ``modelpath``."""

from puzzlelib_tpu_torch.containers import Sequential
from puzzlelib_tpu_torch.modules import Conv2D, MaxPool2D, Activation, relu, Flatten, Linear


def loadLeNet(modelpath, initscheme="none", name="lenet-5-like"):
    net = Sequential(name=name)

    net.append(Conv2D(1, 16, 3, initscheme=initscheme))
    net.append(MaxPool2D())
    net.append(Activation(relu))

    net.append(Conv2D(16, 32, 4, initscheme=initscheme))
    net.append(MaxPool2D())
    net.append(Activation(relu))

    net.append(Flatten())
    net.append(Linear(32 * 5 * 5, 1024, initscheme=initscheme))
    net.append(Activation(relu))

    net.append(Linear(1024, 10, initscheme=initscheme))

    if modelpath is not None:
        net.load(modelpath)

    return net
