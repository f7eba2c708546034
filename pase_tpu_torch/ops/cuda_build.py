"""Build and load this package's CUDA kernels.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with plain C entry points, at first use, cached under
``build/pase_tpu_torch/`` by a hash of the source and the flags, and
loaded with ``ctypes``. Every C entry point returns
``cudaGetLastError()`` after its launch; ``launch`` raises when that is
not 0. A missing ``nvcc`` and a failed build raise too: there is no
fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build",
                         "pase_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

PTR = ctypes.c_void_p
SIZE = ctypes.c_longlong
INT = ctypes.c_int


def source_path(name):
    """``csrc/<name>.cu`` of this package."""
    return os.path.join(PACKAGE_DIR, "csrc", f"{name}.cu")


def find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.isfile(cand) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built")
    return nvcc


def library_path(source, build_dir=BUILD_DIR, flags=NVCC_FLAGS):
    """Where the library built from ``source`` with ``flags`` lives."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(flags).encode()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(build_dir, f"lib{name}_{digest}.so")


def compile_library(cmd, so, verbose=False):
    """Build a library into a private name beside ``so`` (``cmd(out)``
    is the compiler's command line that writes ``out``), then rename it to
    ``so``: a concurrent process never loads a half-written library.
    Raises with the compiler's output when it fails."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    full = cmd(tmp)
    proc = subprocess.run(full, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{os.path.basename(full[0])} failed ({proc.returncode}): "
            f"{' '.join(full)}\n{proc.stdout}{proc.stderr}")
    if verbose:
        print(" ".join(full) + "\n" + (proc.stdout + proc.stderr).strip(),
              flush=True)
    os.replace(tmp, so)


def load(source, argtypes, build_dir=BUILD_DIR, verbose=False):
    """Compile ``source`` unless its library is built, load it, declare
    each entry point of ``argtypes`` ({name: [ctypes types]}, returning
    int), and return the ``ctypes`` handle. Raises on any failure."""
    so = library_path(source, build_dir)
    if not os.path.isfile(so):
        nvcc = find_nvcc()
        compile_library(lambda out: [nvcc, *NVCC_FLAGS, "-Xptxas", "-v",
                                     "-o", out, source], so, verbose)
    lib = ctypes.CDLL(so)
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = types
    return lib


def launch(lib, name, launches, *args):
    """Call entry point ``name``; raise if its launch was refused, else
    count it in ``launches[name]``."""
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1
