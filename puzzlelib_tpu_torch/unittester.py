"""Test runner (counterpart of ``puzzlelib_tpu/unittester.py``).

Runs the port's tests, ``tests/test_torch_*.py``, under the debug tiers of
the JAX package's runner:

  * ``Config.debugAllocator`` poisons what ``gpuarray.empty`` allocates
    (NaN for floats, the largest value for integers), so a read of memory
    nobody wrote shows;
  * a retry threshold reruns the failed tests (a stochastic init can miss
    a tolerance once without the op being wrong), and a test that passed
    only on a rerun is reported, since it may hide an intermittent fault;
  * gc's uncollectable objects are reported.

``--device cpu`` (the default) runs the tests as they are: the card-only
cases skip and the twins hold the port against the JAX package.  ``--device
cuda`` runs the card-only cases (``-m cuda``), without ``tests/conftest.py``,
which imports the JAX package (the card's machine has none).  Arguments that
name existing test files or node ids replace the default files; the rest go
to pytest as they are.

Usage: ``python -m puzzlelib_tpu_torch.unittester [--device cpu|cuda]
[--threshold N] [tests...] [pytest args...]``
"""

import gc
import glob
import os
import sys


THRESHOLD = 3   # runs of failed tests before declaring failure


class _Failures:
    """A pytest plugin that records the failed tests as arguments a rerun
    takes: each test's file by its absolute path, then its name (a node id
    names the file relative to the rootdir, which a test outside it does
    not lie under)."""

    def __init__(self):
        self.targets = {}
        self.failed = []

    def pytest_collection_modifyitems(self, items):
        for item in items:
            self.targets[item.nodeid] = "%s::%s" % (item.path, item.nodeid.partition("::")[2])

    def pytest_runtest_logreport(self, report):
        target = self.targets.get(report.nodeid, report.nodeid)

        if report.failed and target not in self.failed:
            self.failed.append(target)


def _isTestTarget(arg):
    return not arg.startswith("-") and os.path.exists(arg.split("::")[0])


def main(extraArgs=None):
    args = list(extraArgs) if extraArgs is not None else sys.argv[1:]

    device, threshold = "cpu", THRESHOLD
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    if "--threshold" in args:
        i = args.index("--threshold")
        threshold = int(args[i + 1])
        del args[i:i + 2]

    if device not in ("cpu", "cuda"):
        raise ValueError("--device must be cpu or cuda (got %r)" % device)

    from puzzlelib_tpu_torch import config as Config
    Config.device = device
    Config.debugAllocator = True

    gc.set_debug(gc.DEBUG_UNCOLLECTABLE)

    import pytest

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    targets = [arg for arg in args if _isTestTarget(arg)]
    options = [arg for arg in args if arg not in targets]
    if not targets:
        targets = sorted(glob.glob(os.path.join(root, "tests", "test_torch_*.py")))

    # the repository's pytest settings (the cuda marker) wherever the tests
    # lie; the failures are recorded here, so pytest's cache is not needed
    common = ["-q", "-c", os.path.join(root, "pytest.ini"), "-p", "no:cacheprovider"]
    if device == "cuda":
        common += ["--noconftest", "-m", "cuda"]

    failures = _Failures()
    code = pytest.main(targets + common + options, plugins=[failures])

    retried = set()
    attempt = 1
    while code not in (0, 5) and attempt < threshold and failures.failed:
        attempt += 1
        rerun, failures = failures.failed, _Failures()
        retried |= set(rerun)

        print("unittester: rerunning %d failed test(s) (attempt %d/%d)" % (len(rerun), attempt, threshold))
        code = pytest.main(rerun + common + options, plugins=[failures])

    if code in (0, 5) and retried:
        print("unittester: WARNING - %d test(s) passed only on retry:" % len(retried))
        for name in sorted(retried):
            print("  retried: %s" % name)

    if gc.garbage:
        print("Uncollectable objects: %d" % len(gc.garbage))

    return code


if __name__ == "__main__":
    sys.exit(main())
