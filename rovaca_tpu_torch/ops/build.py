"""On-demand CUDA build: compiles csrc/<name>.cu into a shared library.

The counterpart of rovaca_tpu/native/build.py for nvcc. A library exposes a
plain C interface and is loaded with ctypes, so no PyTorch header is compiled
and a build takes seconds. The first use compiles into ``build/kernels/`` at
the repository root; later uses load the cached library, rebuilt when any
file in csrc/ is newer than it (a .cu includes the shared headers there). A
failed build raises with nvcc's output. Different libraries build in
parallel from separate threads; one library builds once.
"""

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_BUILD_LOCKS = {}
_LIBS = {}


def nvcc():
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "build only on a host with the CUDA toolkit")


def is_stale(out, src_dir=CSRC):
    """True when ``out`` is missing or older than any file in ``src_dir``."""
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(e.path) > built
               for e in os.scandir(src_dir) if e.is_file())


def shared_lib(name):
    """Compile csrc/<name>.cu -> build/kernels/lib<name>.so if stale; return
    its path. nvcc's messages (ptxas register/shared-memory report included)
    are kept beside it in lib<name>.log."""
    src = os.path.join(CSRC, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    with _LOCK:
        lock = _BUILD_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if not is_stale(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, src, "-o", tmp]
        res = subprocess.run(cmd, capture_output=True, text=True)
        with open(os.path.join(BUILD_DIR, f"lib{name}.log"), "w") as f:
            f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    return out


def load(name):
    """ctypes handle of csrc/<name>.cu's library, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(shared_lib(name))
        _LIBS[name] = lib
    return lib


def build_log(name):
    """nvcc's output from the last build of csrc/<name>.cu ('' if none)."""
    try:
        with open(os.path.join(BUILD_DIR, f"lib{name}.log")) as f:
            return f.read()
    except OSError:
        return ""
