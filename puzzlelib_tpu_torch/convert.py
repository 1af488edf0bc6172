"""Parameter tables: moving weights between a net and numpy arrays.

A table maps variable names, as ``getVarTable`` names them (``"conv1_1.W"``
in a named net, ``"c1.W"`` in a ``Sequential`` of a module named ``c1``), to
arrays.  The names are those of the JAX package's nets, so a table filled
from a JAX net (``var.data.get()``) loads into the same net built here.
"""

import numpy as np
import torch

from puzzlelib_tpu_torch.backend import gpuarray


def _names(net):
    return {name: var for var, names in net.getVarTable().items() for name in names}


def paramsFromNumpy(net, table):
    """Copy ``table``'s arrays into ``net``'s variables, cast to each
    variable's type and device.  Every variable of the net must be in the
    table and every name of the table in the net, with the same shape.
    Arrays of a type numpy cannot hand to torch (bfloat16 from ``ml_dtypes``)
    go through float32."""
    variables = _names(net)

    missing, unknown = set(variables) - set(table), set(table) - set(variables)
    if missing or unknown:
        raise KeyError("parameter table does not match the net: missing %s, unknown %s" %
                       (sorted(missing), sorted(unknown)))

    for name, ary in table.items():
        var = variables[name]
        host = np.asarray(ary)

        if tuple(host.shape) != tuple(var.data.shape):
            raise ValueError("%s: table shape %s, net shape %s" % (name, host.shape, tuple(var.data.shape)))

        # a private copy: tables from JAX arrays are read-only
        host = host.astype(np.float32 if host.dtype.kind not in "biuf" else host.dtype)

        with torch.no_grad():
            var.data.copy_(torch.from_numpy(host))


def paramsToNumpy(net):
    """``net``'s variables as a table of host arrays (bf16 comes back as
    float32)."""
    return {name: gpuarray.get(var.data) for name, var in _names(net).items()}
