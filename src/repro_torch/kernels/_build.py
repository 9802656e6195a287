"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded through ``ctypes``; no
PyTorch header is compiled, so a build takes seconds. Libraries go to
``build/kernels/`` at the repository root (listed in ``.gitignore``), named by
a digest of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing is built when this module is
imported: the first launch builds its kernel, and ``build()`` builds several
at once, one ``nvcc`` process each, all started together.

``LAUNCHES`` counts kernel launches by name. A wrapper adds one where it
launches its kernel and nowhere else; ``repro_torch.kernels.ops`` re-exports
it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NAMES = ("sliced_matmul", "coschedule", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh

LAUNCHES = dict.fromkeys(NAMES, 0)
_LIBS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=NAMES) -> dict:
    """Compile every library in ``names`` that is not built yet, all in
    parallel. Returns {name: path}; raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each exported function to (argtypes, restype)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        strerror = getattr(lib, f"{name}_strerror")
        strerror.argtypes = [ctypes.c_int]
        strerror.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise if the launch returned a CUDA error; else count the launch."""
    if err != 0:
        msg = getattr(_LIBS[name], f"{name}_strerror")(err)
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} ({msg.decode() if msg else '?'})")
    LAUNCHES[name] += 1


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernel takes only contiguous CUDA tensors of one supported dtype
    on one device; raise on anything else."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if t.dtype not in DTYPE_CODES or t.dtype != tensors[0].dtype:
            raise ValueError(f"{name}: dtypes must be one of float32 or "
                             f"bfloat16, got {[x.dtype for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
