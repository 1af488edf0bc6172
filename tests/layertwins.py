"""Shared pieces of the twins that hold ``tools/layerslice.py``'s cases of
the port against the JAX package: the JAX package's run of a case, and the
comparison at the reference's tiers (f32 within 1e-5 of max(1, max |want|),
bf16 within 5e-2 of it)."""

import numpy as np
import pytest
import torch

from puzzlelib_tpu_torch.tools import layerslice


BOUNDS = layerslice.BOUNDS


def jaxPackage():
    """The JAX package's modules, containers, gpuarray and types; the twins
    skip where it does not import, as on the card's machine."""
    pytest.importorskip("puzzlelib_tpu.modules", reason="the twins need the JAX package")
    import ml_dtypes
    from puzzlelib_tpu import containers, modules
    from puzzlelib_tpu.backend import gpuarray

    return modules, containers, gpuarray, {"f32": np.float32, "bf16": ml_dtypes.bfloat16}


def host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().float().cpu().numpy()

    return np.asarray(value.get() if hasattr(value, "get") else value, dtype=np.float32)


def close(got, want, bound=BOUNDS["f32"]):
    got, want = host(got), host(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


def _listed(value):
    return list(value) if isinstance(value, (list, tuple)) else [value]


def jaxRun(name, shapes, dtype, jaxTakes):
    """``layerslice.run`` on the JAX package's module: in ``dtype`` where
    ``jaxTakes`` it, else in f32 on the same (bf16-rounded) values."""
    J, JC, jgpu, types = jaxPackage()
    case = layerslice.CASES[name]
    jtype = types[dtype if jaxTakes else "f32"]

    np.random.seed(1)
    mod = case.build(J, JC, dtype)
    if jtype != np.float32 and case.calcMode:
        mod.calcMode(jtype)

    xs = [jgpu.to_gpu(ary.astype(jtype)) for ary in layerslice.inputs(name, shapes, dtype)]

    out = mod(xs if case.many else xs[0])
    outs = _listed(out)
    grads = [jgpu.to_gpu(g.astype(outs[0].dtype)) for g in layerslice.outGrads([o.shape for o in outs], dtype)]
    mod.backward(grads if isinstance(out, list) else grads[0])

    params = {pname: var.grad for pname, var in mod.vars.items()}
    for inner, child in (getattr(mod, "modules", None) or {}).items():
        params.update({"%s.%s" % (inner, pname): var.grad for pname, var in child.vars.items()})

    return {"out": outs, "grad": _listed(mod.grad), "params": params}


def caseTwin(name, shapes, dtype, jaxTakes):
    """The case forward and backward on the port (CPU) against the JAX
    package: the outputs, the input gradients and every parameter
    gradient."""
    want = jaxRun(name, shapes, dtype, jaxTakes)
    got = layerslice.run(name, shapes, dtype, "cpu")

    assert len(got["out"]) == len(want["out"]) and len(got["grad"]) == len(want["grad"])
    assert sorted(got["params"]) == sorted(want["params"])
    for _, g, w in layerslice._pairs(got, want):
        close(g, w, BOUNDS[dtype])

    return got, want


def cardAgainstCpu(name, shapes):
    """The case on CUDA tensors against its CPU run in each type it takes,
    within the tiers (bit for bit where it only moves data), and a second
    card run the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    for dtype in layerslice.CASES[name].dtypes:
        cpu = layerslice.run(name, shapes, dtype, "cpu")
        card = layerslice.run(name, shapes, dtype, "cuda")
        again = layerslice.run(name, shapes, dtype, "cuda")

        rows, ok = layerslice.held(name, card, cpu, dtype)
        assert ok, rows
        assert all(same for _, same, _ in layerslice.held(name, again, card, dtype)[0])
