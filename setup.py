"""Package installer (reference: /root/reference/setup.py).

The reference's setup.py stages CUDA/HIP/Intel native builds at install time;
the TPU-native framework has no install-time compile step — the compute path
is jitted by XLA at runtime, and the optional native serving driver is built
on demand via ``puzzlelib_tpu/converter/engine/src/build.py``.

Install:    pip install -e .
Extras:     none required beyond the baked-in scientific stack.
"""

import os

from setuptools import setup, find_packages


def readme():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "README.md")
    with open(path, encoding="utf-8") as f:
        return f.read()


setup(
    name="puzzlelib-tpu",
    version="1.0.0",
    description="TPU-native deep learning framework with the PuzzleLib API",
    long_description=readme(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=["puzzlelib_tpu", "puzzlelib_tpu.*",
                                    "puzzlelib_tpu_torch", "puzzlelib_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "h5py",
        "Pillow",
        "graphviz",
        "ml_dtypes",
        "torch",
    ],
    extras_require={
        "test": ["pytest"],
    },
    include_package_data=True,
    zip_safe=False,
)
