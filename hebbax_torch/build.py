"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each library in :data:`LIBRARIES` is one ``nvcc -shared`` of sources under
``hebbax_torch/csrc`` with a plain C interface (no PyTorch headers, so a
build takes seconds).  Output goes to ``build/hebbax_torch/`` beside the
package, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused.  Several libraries build in
parallel: one nvcc process each, all started together.

Nothing is built at import; the first kernel launch (or an explicit
:func:`build`) does it.  nvcc is looked up in ``$CUDA_HOME/bin``,
``/usr/local/cuda/bin`` and ``$PATH``.  :class:`Kernel` is the part every
kernel's ctypes wrapper shares: load, launch, check the return, count.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "hebbax_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> sources, relative to the package
LIBRARIES = {
    "swta_delta": ("csrc/swta_delta.cu",),
    "subpixel_max3": ("csrc/subpixel_max3.cu",),
}

_loaded = {}


def nvcc_path():
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the hebbax_torch kernels")
    return found


def library_path(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in LIBRARIES[name]:
        h.update(src.encode())
        h.update((PACKAGE_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None):
    """Build the named libraries (all by default) that are not built yet,
    in parallel.  Returns {name: {"path", "seconds", "log"}} for the ones
    it compiled; raises with nvcc's output if any build fails."""
    names = list(LIBRARIES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(PACKAGE_DIR / s) for s in LIBRARIES[name]]]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, out, tmp, time.perf_counter())
    results, failed = {}, []
    for name, (proc, out, tmp, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = {"path": str(out), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return results


def load(name):
    """The loaded ctypes library, building it first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


class Kernel:
    """Base of a kernel's ctypes wrapper.  ``library`` names an entry of
    :data:`LIBRARIES`, ``symbol`` its plain C entry, which takes
    ``argtypes`` and then the CUDA stream and returns a CUDA error code.
    :meth:`launch` loads (and builds) the library at the first launch,
    runs the entry on the device's current stream without synchronising,
    raises on a nonzero return and counts the launch in ``launches``."""

    library = symbol = None
    argtypes = ()

    def __init__(self):
        self.launches = 0
        self._fn = None

    def launch(self, device, *args):
        import torch
        if self._fn is None:
            fn = getattr(load(self.library), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.library} kernel launch failed: CUDA "
                               f"error {rc}")
        self.launches += 1
