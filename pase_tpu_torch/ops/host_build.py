"""Build and load this package's host C++ libraries.

A source under ``csrc/`` with a plain C interface (``codec2_lite.cc``,
the vocoder of the host distortion stage) is compiled with the C++
compiler (``$CXX``, else ``g++``, else ``c++``) and ``native/Makefile``'s
flags into a shared library at first use, cached under
``build/pase_tpu_torch/`` by a hash of the source and the flags (as the
CUDA kernels are, ``cuda_build``), and loaded with ``ctypes``. A missing
compiler and a failed build raise: there is no fallback.
"""

import ctypes
import os
import shutil

from pase_tpu_torch.ops.cuda_build import (BUILD_DIR, PACKAGE_DIR,
                                           compile_library, library_path)

CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]


def source_path(name):
    """``csrc/<name>.cc`` of this package."""
    return os.path.join(PACKAGE_DIR, "csrc", f"{name}.cc")


def find_cxx():
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no C++ compiler ($CXX, g++, c++ on PATH): the host "
                       "libraries cannot be built")


def load(source, signatures, build_dir=BUILD_DIR):
    """Compile ``source`` unless its library is built, load it, declare
    each entry point of ``signatures`` ({name: (restype, [argtypes])}),
    and return the ``ctypes`` handle. Raises on any failure."""
    so = library_path(source, build_dir, CXX_FLAGS)
    if not os.path.isfile(so):
        cxx = find_cxx()
        compile_library(lambda out: [cxx, *CXX_FLAGS, "-o", out, source], so)
    lib = ctypes.CDLL(so)
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
