"""Build and load the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  The library's
file name carries a hash of its source and flags, so a build is reused until
the source changes.  Builds go to ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``) and happen at the first CUDA call of a
kernel, or up front, all in parallel, through ``buildAll``.

Nothing here falls back: a missing ``nvcc``, a failed build or a missing entry
point raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


PACKAGE = Path(__file__).resolve().parents[2]
SOURCES = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "kernels"

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

KERNELS = ("matmul", "winograd", "winograd_fg", "flash", "flash_bwd", "probe", "streamcopy", "phasesplit",
           "tapdot")

_loaded = {}


class KernelBuildError(RuntimeError):
    pass


def findNvcc():
    for candidate in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if candidate and os.path.isfile(candidate):
            return candidate

    raise KernelBuildError("nvcc not found on PATH or in /usr/local/cuda/bin: the Hopper kernels "
                           "are built from source at their first CUDA call")


def libraryPath(name):
    source = (SOURCES / ("%s.cu" % name)).read_bytes()
    digest = hashlib.sha256(source + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / ("%s-%s.so" % (name, digest))


def build(name):
    """Compile ``csrc/<name>.cu`` unless its hashed library exists; returns
    the library path.  The compiler's report (registers, shared memory,
    spills from ``-Xptxas -v``) is kept beside it as ``.log``."""
    target = libraryPath(name)
    if target.exists():
        return target

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = findNvcc()

    # compile to a private name and rename: concurrent builders never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)

    cmd = [nvcc, *FLAGS, "-o", tmp, str(SOURCES / ("%s.cu" % name))]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        target.with_suffix(".log").write_text(proc.stdout + proc.stderr)

        if proc.returncode != 0:
            raise KernelBuildError("nvcc failed on %s.cu (exit %d):\n%s" %
                                   (name, proc.returncode, proc.stderr[-4000:]))

        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)

    return target


def buildAll():
    """Build every kernel, one ``nvcc`` per source, all started together."""
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(build, KERNELS)))


def load(name):
    """The ctypes handle of kernel library ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib

    return lib


def compilerReport(name):
    """The ``ptxas`` lines of the last build of ``name``: registers, shared
    memory and spill stores of each kernel."""
    log = libraryPath(name).with_suffix(".log")
    if not log.exists():
        return []

    return [line.strip() for line in log.read_text().splitlines()
            if any(word in line for word in ("entry function", "registers", "spill"))]
