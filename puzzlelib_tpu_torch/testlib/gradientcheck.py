"""Finite-difference gradient check (the counterpart of
``testlib/gradientcheck.py``): central differences on every parameter of a
small conv / batch-norm net against the port's analytic gradients.  Its
convs (1 -> 2 and 2 -> 1 maps) are off ``winograd.applicable``, so the
library runs them on the card."""

import numpy as np
import torch

from puzzlelib_tpu_torch.backend import gpuarray
from puzzlelib_tpu_torch.containers import Sequential
from puzzlelib_tpu_torch.cost import BCE
from puzzlelib_tpu_torch.modules import Activation, AvgPool2D, BatchNorm2D, Conv2D, Flatten, relu


def buildNet():
    net = Sequential(name="test-net")

    net.append(Conv2D(1, 2, 3, wscale=1.0, initscheme="gaussian"))
    net.append(AvgPool2D(2, 2))

    net.append(BatchNorm2D(2))
    net.append(Activation(relu))

    net.append(Conv2D(2, 1, 2, wscale=1.0, initscheme="gaussian"))
    net.append(Flatten())

    return net


def gradientCheck(mod, data, target, cost, h=1e-3, log=True):
    """Per-parameter relative central-difference errors, parameter by
    parameter in the net's order and entry by entry in each."""
    def lossAt(var, flatIndex, value, keep):
        perturbed = keep.copy()
        perturbed.ravel()[flatIndex] = value
        var.data.copy_(torch.from_numpy(perturbed))

        loss, _ = cost(mod(data), target)
        return loss

    error, grad = cost(mod(data), target)
    mod.backward(grad, updGrad=False)

    relerrors = []

    for var in mod.getVarTable():
        theta = gpuarray.get(var.data).copy()
        analytic = -gpuarray.get(var.grad).ravel()

        for i, w in enumerate(theta.ravel()):
            numeric = (lossAt(var, i, w + h, theta) - lossAt(var, i, w - h, theta)) / (2.0 * h)
            var.data.copy_(torch.from_numpy(theta))

            rel = abs((numeric - analytic[i]) / (analytic[i] + h))
            relerrors.append(rel)

            if log:
                print(rel)

    return relerrors


def main():
    net = buildNet()
    cost = BCE()

    data = gpuarray.to_gpu(np.random.randn(1, 1, 6, 6).astype(np.float32))
    target = gpuarray.to_gpu(np.random.randint(0, 2, size=(1, )).astype(np.int32))

    return gradientCheck(net, data, target, cost)


if __name__ == "__main__":
    main()
