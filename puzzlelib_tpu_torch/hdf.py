"""HDF5 checkpoint codec (counterpart of ``puzzlelib_tpu/hdf.py``).

The file layout is the JAX package's, so a checkpoint written by either
package loads into the other:

    params/<idx>   deduplicated parameter tensors (gzip by default)
    links/<path>   dotted module path + param name -> params index
    attrs/<path>   leaf-module attribute tensors ("<path>.<attr>")
    attrs.<name>/  container-level attribute group
    blueprint      JSON architecture description (optional)

The module layer decides what to persist; this codec owns how: opening
stores from paths, in-memory images or open handles, deduplicating shared
variables by identity, and moving tensors to and from host arrays.

HDF5 has no bfloat16.  A bf16 tensor is written as its raw 16 bits, an
opaque 2-byte dataset tagged with the attribute ``dtype="bfloat16"`` (the
JAX package's ``ml_dtypes`` arrays are stored the same way), and read back
through those bits into a ``torch.bfloat16`` tensor: never through float32.

``h5py`` is imported only where a store is opened from a path or an image,
or a string dataset is written.  An open handle (any object answering the
calls an ``h5py`` group answers: ``require_group``, ``create_dataset``, item
get and set, ``in``, ``items()``, ``attrs`` and ``[()]``) needs no ``h5py``.
"""

import io
import json
import os

import numpy as np
import torch


# extension types the JAX package tags by name (ml_dtypes), as the port holds them
_TAGGED = {"bfloat16": torch.bfloat16}


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("HDF5 checkpoints need h5py, which is not installed: open a store through an "
                          "object of your own instead of a path or an image (%s)" % e) from e

    return h5py


def openStore(target, mode):
    """Open an HDF5 store from a path, an in-memory image, an already-open
    handle, or nothing (fresh in-memory store).  Returns (file, owned):
    ``owned`` says whether the caller is responsible for closing it."""
    if target is None:
        return _h5py().File(io.BytesIO(), mode), True

    if isinstance(target, (bytes, bytearray)):
        return _h5py().File(io.BytesIO(target), "r"), True

    if isinstance(target, (str, os.PathLike)):
        h5py = _h5py()

        parent = os.path.dirname(os.path.abspath(target))
        os.makedirs(parent, exist_ok=True)

        return h5py.File(target, mode, libver="earliest"), True

    return target, False


def snapshot(hdf):
    """Serialize an open store to bytes: ``save()`` with no target returns
    this file image, a ``load()`` source."""
    hdf.flush()
    return bytes(hdf.id.get_file_image())


def toHost(value):
    """(host array, dtype tag or None) of a tensor, array or scalar: a bf16
    tensor as its raw bits in an opaque 2-byte array, tagged "bfloat16".  A
    tensor's array is a copy, also on the CPU: a store may keep it while
    the tensor trains on."""
    if isinstance(value, torch.Tensor):
        value = value.detach()

        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).to("cpu", copy=True).numpy().view("V2"), "bfloat16"

        return value.to("cpu", copy=True).numpy(), None

    return np.asarray(value), None


def writeDataset(grp, name, value, compress=None):
    """Create a dataset of ``value`` (a tensor, array or scalar), tagging
    bf16 with its ``dtype`` attribute; an array of words (dtype object)
    becomes a variable-length string dataset, as the JAX package writes
    an embedder's vocabulary."""
    host, tag = toHost(value)

    if host.dtype == object:
        ds = grp.create_dataset(name, data=host, dtype=_h5py().special_dtype(vlen=str), compression=compress)
    else:
        ds = grp.create_dataset(name, data=host, compression=compress)

    if tag is not None:
        ds.attrs["dtype"] = tag

    return ds


def readDataset(ds):
    """A dataset's value: a host array, or a CPU tensor for a tagged
    extension type (bf16 from its raw bits).  A tag the port has no type
    for raises, naming it."""
    value = np.asarray(ds)
    tag = ds.attrs.get("dtype")

    if tag is None or value.dtype.kind != "V":
        return value

    tag = str(tag)
    if tag not in _TAGGED:
        raise TypeError("dataset of extension type '%s', which the port has no type for" % tag)

    return torch.from_numpy(np.ascontiguousarray(value).view(np.int16)).view(_TAGGED[tag])


def dtypeName(value):
    """The numpy name of a host array's or a tensor's type ("bfloat16" for
    bf16), on which the safe-cast rule is decided."""
    if isinstance(value, torch.Tensor):
        dtype = value.dtype
        if dtype == torch.bfloat16:
            return "bfloat16"

        return torch.empty(0, dtype=dtype).numpy().dtype.name

    return value.dtype.name


def canCastSafely(src, dst):
    """numpy's ``casting="safe"`` between two type names, bf16 included: bf16
    goes wherever float32 goes safely, and only bool, int8 and uint8 go
    into bf16 (``ml_dtypes``' rules)."""
    if dst == "bfloat16":
        return src in ("bfloat16", "bool", "int8", "uint8")

    return np.can_cast(np.float32 if src == "bfloat16" else np.dtype(src), np.dtype(dst), "safe")


def storeParam(hdf, path, var, varlinks, compress="gzip"):
    """Write one variable under ``links/<path>``, deduplicating shared
    variables (tied weights) by object identity through ``varlinks``."""
    slot = varlinks.get(var)

    if slot is None:
        slot = len(varlinks)
        varlinks[var] = slot
        writeDataset(hdf.require_group("params"), str(slot), var.data, compress)

    hdf.require_group("links")[path] = slot


def fetchParam(hdf, path):
    """Resolve ``links/<path>`` to its parameter's value."""
    slot = hdf["links"][path][()]
    return readDataset(hdf["params"][str(slot)])


def storeAttrs(hdf, entries, compress="gzip", group="attrs"):
    """Write attribute values into ``group`` as {name: value} datasets."""
    if not entries:
        return

    grp = hdf.require_group(group)
    for name, value in entries.items():
        writeDataset(grp, name, value, compress)


def fetchAttr(hdf, name):
    return readDataset(hdf["attrs"][name])


def storeBlueprint(hdf, blueprint):
    hdf.create_dataset("blueprint", (), dtype=_h5py().special_dtype(vlen=str),
                       data=json.dumps(blueprint, indent=4, sort_keys=True))


def fetchBlueprint(hdf):
    raw = hdf["blueprint"][()]
    return json.loads(raw.decode() if isinstance(raw, bytes) else str(raw))


class MemoryStore:
    """An in-memory checkpoint store: numpy arrays, answering only the calls
    this codec and the Caffe and MXNet importers make on an ``h5py`` group,
    which ``save``, ``load``, ``js2hdf`` and ``buildHdf`` take as an open
    handle, without ``h5py``.  It refuses a second group or dataset of a
    name, as ``h5py`` does.  ``buildEngine``'s half-precision clone carries
    the net's variables through one."""

    def __init__(self):
        self.children, self.attrs, self.value = {}, {}, None

    def require_group(self, name):
        return self.children.setdefault(name, MemoryStore())

    def create_group(self, name):
        if name in self.children:
            raise ValueError("Unable to create group (name already exists): %s" % name)

        group = self.children[name] = MemoryStore()
        return group

    def create_dataset(self, name, data=None, compression=None):
        if name in self.children:
            raise ValueError("Unable to create dataset (name already exists): %s" % name)

        dataset = self.children[name] = MemoryStore()
        dataset.value = np.asarray(data)
        return dataset

    def __getitem__(self, key):
        return self.value[key] if key == () else self.children[key]

    def __setitem__(self, key, value):
        self.create_dataset(key, data=value)

    def __contains__(self, key):
        return key in self.children

    def items(self):
        return self.children.items()

    def __array__(self, dtype=None, copy=None):
        return self.value if dtype is None else self.value.astype(dtype)

    def nbytes(self):
        own = 0 if self.value is None else self.value.nbytes
        return own + sum(child.nbytes() for child in self.children.values())
