"""Parameter and optimizer-state tables: moving weights and optimizer
state between the port and numpy arrays.

A parameter table maps variable names, as ``getVarTable`` names them
(``"conv1_1.W"`` in a named net, ``"c1.W"`` in a ``Sequential`` of a module
named ``c1``), to arrays.  The names are those of the JAX package's nets, so
a table filled from a JAX net (``var.data.get()``) loads into the same net
built here.

An attribute table maps module attributes (a batch norm's running
``mean`` and ``var``) to arrays, under the names the reference's ``save``
gives them, ``"<module>.<attr>"`` with the module's path as
``getVarTable`` names it (``"bn_conv1.mean"``, ``"1.0.bn2a_branch2a.var"``
in a ResNet); ``getAttrTable`` lists them.

An optimizer-state table maps ``"<state>.<entity>"`` to arrays, as the
reference's ``Optimizer.save`` names its datasets: ``<state>`` is a
variable's first name under local state (``"conv1_1.W.mom"``) and the numpy
type of a flat buffer under global state (``"<class 'numpy.float32'>.mom"``).
Every write goes in place, so variables and states that are views of an
optimizer's flat buffers stay views.
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
    _copyTable({name: var.data for name, var in _names(net).items()}, table, "parameter")


def _copyTable(tensors, table, what):
    """Copy ``table``'s arrays into the tensors of the same names, in place,
    cast to each tensor's type: the names must match both ways and the
    shapes be equal."""
    missing, unknown = set(tensors) - set(table), set(table) - set(tensors)
    if missing or unknown:
        raise KeyError("%s table does not match the net: missing %s, unknown %s" %
                       (what, sorted(missing), sorted(unknown)))

    for name, ary in table.items():
        tensor = tensors[name]
        host = np.asarray(ary)

        if tuple(host.shape) != tuple(tensor.shape):
            raise ValueError("%s: table shape %s, net shape %s" % (name, host.shape, tuple(tensor.shape)))

        with torch.no_grad():
            tensor.copy_(_fromHost(ary))


def attrsFromNumpy(net, table):
    """Copy ``table``'s arrays into ``net``'s module attributes in place,
    strictly as ``paramsFromNumpy`` does: every attribute of the net in the
    table and every name of the table in the net, with the same shape."""
    _copyTable(net.getAttrTable(), table, "attribute")


def attrsToNumpy(net):
    """``net``'s module attributes as a table of host arrays, copies also on
    the CPU (the attributes change in place)."""
    return {name: gpuarray.get(attr).copy() for name, attr in net.getAttrTable().items()}


def _fromHost(ary):
    """A private CPU tensor of a host array (tables from JAX arrays are
    read-only); types numpy cannot hand to torch (bfloat16 from
    ``ml_dtypes``) go through float32."""
    host = np.asarray(ary)
    return torch.from_numpy(host.astype(np.float32 if host.dtype.kind not in "biuf" else host.dtype))


def _stateName(key):
    """The reference's name of an optimizer state: a variable's name, or for
    a global state the numpy scalar type of its flat buffer."""
    if not isinstance(key, torch.dtype):
        return key

    if key == torch.bfloat16:
        return "<class 'ml_dtypes.bfloat16'>"

    return str(np.dtype(gpuarray.toNumpyDtype(key)).type)


def optimizerStateToNumpy(optimizer):
    """``optimizer``'s state as a table of host arrays (bf16 comes back as
    float32)."""
    return {"%s.%s" % (_stateName(key), entity): gpuarray.get(tensor)
            for key, state in optimizer.states.items() for entity, tensor in state.items()}


def optimizerStateFromNumpy(optimizer, table):
    """Copy ``table``'s arrays into ``optimizer``'s state tensors in place,
    cast to each tensor's type.  The table must hold every state tensor of the
    optimizer and nothing else, with the same sizes."""
    tensors = {"%s.%s" % (_stateName(key), entity): tensor
               for key, state in optimizer.states.items() for entity, tensor in state.items()}

    missing, unknown = set(tensors) - set(table), set(table) - set(tensors)
    if missing or unknown:
        raise KeyError("optimizer state table does not match the optimizer: missing %s, unknown %s" %
                       (sorted(missing), sorted(unknown)))

    for name, ary in table.items():
        tensor = tensors[name]
        if np.size(ary) != tensor.numel():
            raise ValueError("%s: table size %d, state size %d" % (name, np.size(ary), tensor.numel()))

        with torch.no_grad():
            tensor.copy_(_fromHost(ary).reshape(tensor.shape))


def paramsToNumpy(net):
    """``net``'s variables as a table of host arrays (bf16 comes back as
    float32)."""
    return {name: gpuarray.get(var.data) for name, var in _names(net).items()}
