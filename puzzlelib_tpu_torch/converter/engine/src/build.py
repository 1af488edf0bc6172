"""Build the native serving driver (``engine_driver.cpp``) with ``g++``.

The driver is a libtorch program: it compiles with ``g++ -std=c++20 -O2``
against the installed torch's headers and links its libraries, with their
directory as the run path.  Where torch has CUDA it also links the CUDA
libraries of torch, the CUDA runtime that torch loads, and the three
kernel libraries its operators launch
(``build/kernels/{matmul,winograd,flash}-<hash>.so``, built here while
the driver compiles if they are missing), with CUDA's headers from the toolkit beside ``nvcc``; a
missing toolkit raises ``KernelBuildError``.  Against a CPU-only torch it
builds the CPU registrations alone, and that binary refuses a CUDA program.

The binary goes to ``build/driver/engine_driver-<hash>``, the hash taken
over its sources, the command lines, the torch version and the kernel
libraries' names (which carry their own sources' hashes): a change to a ``.cu``
rebuilds the driver too.  ``python -m
puzzlelib_tpu_torch.converter.engine.src.build`` builds it and prints its
path.
"""

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from puzzlelib_tpu_torch.ops.hopper import build as kernels


SOURCE_DIR = Path(__file__).resolve().parent
SOURCES = ("engine_driver.cpp", "routes.h")
BUILD_DIR = kernels.PACKAGE.parent / "build" / "driver"

# the kernel libraries whose C entries the CUDA registrations call
KERNELS = ("matmul", "winograd", "flash")


def _torchPaths():
    import torch

    root = Path(torch.__file__).resolve().parent
    return torch, [root / "include", root / "include" / "torch" / "csrc" / "api" / "include"], root / "lib"


def _cudaInclude():
    nvcc = Path(kernels.findNvcc()).resolve()
    include = nvcc.parent.parent / "include"
    if not (include / "cuda_runtime_api.h").is_file():
        raise kernels.KernelBuildError("CUDA's headers are not in %s, beside %s" % (include, nvcc))
    return include


def _cudart(libdir):
    """The CUDA runtime library that torch's ``libc10_cuda.so`` loads (the
    driver's own calls into it, inlined from torch's CUDA headers, must
    reach the same one), else the toolkit's."""
    listing = subprocess.run(["ldd", str(libdir / "libc10_cuda.so")], capture_output=True, text=True).stdout
    for line in listing.splitlines():
        name, _, where = line.strip().partition(" => ")
        if name.startswith("libcudart.so") and where and not where.startswith("not found"):
            return Path(where.split()[0])

    toolkit = _cudaInclude().parent / "lib64" / "libcudart.so"
    if not toolkit.exists():
        raise kernels.KernelBuildError("no CUDA runtime library beside torch's libc10_cuda.so nor at %s" % toolkit)
    return toolkit


def commands(objpath, outpath):
    """The ``g++`` command lines that compile the driver into ``objpath`` and
    link it into ``outpath``, and the kernel libraries the link takes (none
    against a CPU-only torch).  The compile needs no kernel library, so it
    runs while they build."""
    torch, includes, libdir = _torchPaths()
    cuda = torch.version.cuda is not None

    compile = ["g++", "-std=c++20", "-O2", "-Wall", "-fPIE",
               "-D_GLIBCXX_USE_CXX11_ABI=%d" % int(torch._C._GLIBCXX_USE_CXX11_ABI), "-I", str(SOURCE_DIR)]
    for include in includes:
        compile += ["-isystem", str(include)]

    libs = {}
    if cuda:
        libs = {name: kernels.libraryPath(name) for name in KERNELS}
        compile += ["-DPL_WITH_CUDA", "-isystem", str(_cudaInclude())]
    compile += ["-c", str(SOURCE_DIR / "engine_driver.cpp"), "-o", str(objpath)]

    link = ["g++", str(objpath), "-L", str(libdir), "-Wl,-rpath," + str(libdir), "-Wl,--no-as-needed"]
    if cuda:
        link += ["-L", str(kernels.BUILD_DIR), "-Wl,-rpath," + str(kernels.BUILD_DIR)]
        link += ["-l:" + path.name for path in libs.values()]
        cudart = _cudart(libdir)
        link += ["-ltorch_cuda", "-lc10_cuda", "-L", str(cudart.parent), "-Wl,-rpath," + str(cudart.parent),
                 "-l:" + cudart.name]
    link += ["-ltorch", "-ltorch_cpu", "-lc10", "-o", str(outpath)]

    return compile, link, libs


def driverPath():
    """Where the driver of these sources, this torch and these kernel
    libraries lives once built."""
    torch, _, _ = _torchPaths()
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((SOURCE_DIR / name).read_bytes())

    compile, link, libs = commands("engine_driver.o", "engine_driver")
    digest.update(" ".join([torch.__version__] + compile + link).encode())
    return BUILD_DIR / ("engine_driver-%s" % digest.hexdigest()[:16])


def _check(proc, what, log):
    log.write(proc.args if isinstance(proc.args, str) else " ".join(proc.args))
    log.write("\n" + proc.stdout + proc.stderr + "\n")
    if proc.returncode != 0:
        raise kernels.KernelBuildError("g++ failed to %s the engine driver (exit %d):\n%s" %
                                       (what, proc.returncode, proc.stderr[-4000:]))


def buildDriver(outpath=None, log=True):
    """Compile and link the driver unless its hashed binary exists; returns
    its path.  The kernel libraries it links are built, where they are
    missing, while it compiles.  ``outpath`` names the binary instead (built
    anew).  The compiler's output is kept beside it as ``.log``."""
    target = Path(outpath) if outpath is not None else driverPath()
    if outpath is None and target.exists():
        return target

    target.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=target.parent, prefix=".engine_driver-"))
    compile, link, libs = commands(work / "engine_driver.o", work / "engine_driver")

    if log:
        print("[engine] " + " ".join(compile), flush=True)

    try:
        job = subprocess.Popen(compile, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            for name in libs:
                kernels.build(name)
        finally:
            out, err = job.communicate()

        with open(target.with_suffix(".log"), "w") as record:
            _check(subprocess.CompletedProcess(compile, job.returncode, out, err), "compile", record)
            _check(subprocess.run(link, capture_output=True, text=True), "link", record)

        os.replace(work / "engine_driver", target)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    return target


if __name__ == "__main__":
    print(buildDriver(sys.argv[1] if len(sys.argv) > 1 else None))
