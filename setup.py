"""Package build for tensorflow-nufft-tpu.

Pure-Python wheel; the native CPU engine (cc/nufft_cpu.cc) is compiled
on demand at first use (see tensorflow_nufft_tpu/native/engine.py), so
no build-time toolchain is required for installation.
"""

import pathlib

from setuptools import find_packages, setup

HERE = pathlib.Path(__file__).parent
ABOUT = {}
exec((HERE / "tensorflow_nufft_tpu" / "__about__.py").read_text(),
     ABOUT)

setup(
    name=ABOUT["__title__"],
    version=ABOUT["__version__"],
    description=ABOUT["__summary__"],
    long_description=(HERE / "README.md").read_text(),
    long_description_content_type="text/markdown",
    author=ABOUT["__author__"],
    license=ABOUT["__license__"],
    url=ABOUT["__uri__"],
    packages=find_packages(include=["tensorflow_nufft_tpu*"]),
    package_data={"tensorflow_nufft_tpu": ["proto/*.proto"]},
    data_files=[("cc", ["cc/nufft_cpu.cc"])],
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "numpy",
    ],
    # Options.to_proto/from_proto only.
    extras_require={"proto": ["protobuf"]},
    classifiers=[
        "Development Status :: 4 - Beta",
        "Intended Audience :: Science/Research",
        "License :: OSI Approved :: Apache Software License",
        "Programming Language :: Python :: 3",
        "Topic :: Scientific/Engineering :: Mathematics",
    ],
)
