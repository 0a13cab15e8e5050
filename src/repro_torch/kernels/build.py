"""Build the CUDA sources under `csrc/` and bind them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (`extern "C"`
functions taking raw device pointers, sizes and a stream, returning the
`cudaError_t` of the launch). It is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

into a git-ignored build directory (`REPRO_TORCH_BUILD` overrides it)
and loaded with `ctypes`. The file name carries a hash of the source and
the flags, so an edited source never loads a stale library. Nothing is
built at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def check_indices() -> bool:
    """Whether the kernel wrappers check the indices they pass on (probe
    bucket ids, candidate ids) before a launch: set REPRO_TORCH_CHECK_INDICES=1
    (the tests do). The CUDA kernels trust their inputs, and the check
    reads a device flag back, a host sync, so it is off by default and
    never on the serve path."""
    return os.environ.get("REPRO_TORCH_CHECK_INDICES") == "1"


def build_dir() -> Path:
    """Where the shared libraries go: `REPRO_TORCH_BUILD`, else
    `build/kernels/` at the root of the checkout."""
    env = os.environ.get("REPRO_TORCH_BUILD")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are compiled at first use")


def library_path(name: str) -> Path:
    """The content-addressed shared library for `csrc/<name>.cu`."""
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{h}.so"


def build(*names: str) -> dict:
    """Compile every named source that is not built yet, all nvcc
    processes started together, and wait for each. Returns
    {name: {"path", "seconds", "ptxas"}}; raises RuntimeError with the
    compiler's output if any build fails."""
    out, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"path": str(path), "seconds": 0.0, "ptxas": ""}
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       path, tmp)
    failed = []
    for name, (proc, path, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": str(path), "ptxas": log,
                     "seconds": time.perf_counter() - t0}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


class CudaKernel:
    """One `csrc/<name>.cu` library: built and loaded on first use, with
    the integer `launches` count that its wrapper bumps once per launch.

    `signatures` maps each exported C function to (restype, argtypes);
    every pointer and the stream are `ctypes.c_void_p`, or ctypes would
    pass them as 32-bit ints."""

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.launches = 0
        self._signatures = signatures
        self._lib = None

    def lib(self) -> ctypes.CDLL:
        """The loaded library (built first if needed)."""
        if self._lib is None:
            lib = ctypes.CDLL(build(self.name)[self.name]["path"])
            for fn, (restype, argtypes) in self._signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            self._lib = lib
        return self._lib

    def check(self, code: int) -> None:
        """Raise on a non-zero `cudaError_t` returned by a launch."""
        if code != 0:
            msg = self.lib().kernel_error_string(code).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"cudaError {code} ({msg})")
