"""On-demand native build: compiles .cpp sources into shared libs with g++.

Serves the role of the reference's CMake build for its native libs
(reference: CMakeLists.txt, build.sh) in a form that works from a pure
checkout: first use compiles, later uses hit the cached .so (rebuilt when the
source mtime changes).

Libraries build into ``build/native/`` at the repository root, never beside
the sources. Processes that build the same library at once do not race: each
compiles into a temporary file of its own name, under an exclusive
``fcntl.flock`` on a lock file in the build directory, and the result is moved
into place with ``os.replace``; a process that finds the library fresh once
it holds the lock loads it as it is.
"""

import fcntl
import os
import subprocess
import threading

# OpenMP defaults for the native batch libs, applied before libgomp loads.
# Active spin-waiting after each short parallel region starves the host
# pipeline threads (measured 8x end-to-end slowdown on a 2-core host);
# passive waiting + half the cores leaves the other half for the pipeline
# and IO.
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
os.environ.setdefault(
    "OMP_NUM_THREADS",
    os.environ.get("ROVACA_NATIVE_THREADS")
    or str(max(1, (os.cpu_count() or 2) // 2)))

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
_LOCK = threading.Lock()


def shared_lib(name, extra_flags=()):
    """Compile <name>.cpp -> build/native/_<name>.so if stale; return path or
    None."""
    src = os.path.join(_DIR, f"{name}.cpp")
    out = os.path.join(BUILD_DIR, f"_{name}.so")
    with _LOCK:
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            with open(os.path.join(BUILD_DIR, f"_{name}.lock"), "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                if (not os.path.exists(out)
                        or os.path.getmtime(out) < os.path.getmtime(src)):
                    tmp = f"{out}.{os.getpid()}.tmp"
                    cmd = ["g++", "-O3", "-march=native", "-std=c++17",
                           "-shared", "-fPIC", *extra_flags, src, "-o", tmp]
                    try:
                        subprocess.run(cmd, check=True, capture_output=True)
                        os.replace(tmp, out)
                    finally:
                        if os.path.exists(tmp):
                            os.remove(tmp)
        except (subprocess.CalledProcessError, OSError):
            return None
    return out
