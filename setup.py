"""Packaging for cymf-tpu (analogue of `/root/reference/setup.py`).

The native extension is optional: the package is fully functional without it
(pure-python fallbacks); `python setup.py build_ext --inplace` or
`make native` builds the C++ host-side kernels.
"""

import re
from pathlib import Path

from setuptools import Extension, find_packages, setup

init = Path(__file__).parent.joinpath("cymf_tpu/__init__.py").read_text()
version = re.search(r'__version__ = "([^"]+)"', init).group(1)

setup(
    name="cymf-tpu",
    version=version,
    description="JAX matrix-factorization framework (BPR, WMF, ExpoMF, "
                "RelMF, GloVe) for the GPU",
    packages=find_packages(exclude=("tests",)),
    ext_modules=[
        Extension(
            "cymf_tpu.native._native",
            sources=["cymf_tpu/native/_native.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
            optional=True,
        ),
    ],
    install_requires=["jax", "numpy", "scipy"],
    extras_require={
        # file-based dataset loaders (MovieLens, Yahoo R3) and the
        # progress bar; the trainers and synthetic data need neither
        "datasets": ["scikit-learn", "pandas"],
        "progress": ["tqdm"],
    },
    python_requires=">=3.10",
)
