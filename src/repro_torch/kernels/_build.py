"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use with ``nvcc`` for ``sm_90a`` into its own shared library, which is loaded
with :mod:`ctypes`.  Libraries live under ``build/repro_torch/`` at the root
of the checkout (git-ignored), keyed by a hash of the source, every shared
header ``csrc/*.cuh`` and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.  Each build's ``nvcc`` output, with
the registers and spills ``ptxas`` reports (``-Xptxas -v``), is kept beside
its library (:func:`build_log`).
:func:`build` starts one ``nvcc`` per source it is given, all at once;
:func:`library` builds its one source that way on first use.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0 and counts
the launch in :data:`LAUNCHES`, the only place a launch is counted.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset (chip_smoke.py zeroes these
# before it drives the main path and reads them after).
LAUNCHES: dict[str, int] = {}

_libs: dict[str, ctypes.CDLL] = {}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The H100's shared memory per block after opting in, for planning on hosts
# without the card.
H100_SMEM_PER_BLOCK = 232_448


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for c in (shutil.which("nvcc"), str(Path(cuda_home) / "bin" / "nvcc")):
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        f"nvcc not found on PATH or in {cuda_home}/bin: the repro_torch CUDA "
        f"kernels are compiled from {CSRC} at first use and need the CUDA "
        "toolkit (set CUDA_HOME to its root)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # any source may include any
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Compile each ``csrc/<name>.cu`` not yet built, one ``nvcc`` each, all
    started at once; raises with ``nvcc``'s output if any fails.

    Each process writes its library and ``nvcc``'s output to temp files of
    its own (named by pid) and moves both into place on success, so a
    library and the log beside it come from one build, whatever other
    processes build the same source at the same time."""
    jobs = []
    try:
        for name in names:
            out = _lib_path(name)
            if out.is_file():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = out.with_suffix(f".{os.getpid()}.log.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            with open(log, "w") as fh:
                proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
            jobs.append((name, proc, tmp, log, out))
        for name, proc, tmp, log, out in jobs:
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu (exit "
                                   f"{proc.returncode}):\n" + log.read_text())
            os.replace(log, out.with_suffix(".log"))
            os.replace(tmp, out)
    finally:
        for _, proc, tmp, log, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
            log.unlink(missing_ok=True)


def build_log(name: str) -> str:
    """The ``nvcc`` output of the build of ``csrc/<name>.cu`` whose library
    is in place, built first if needed."""
    build(name)
    return _lib_path(name).with_suffix(".log").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def launch(kernel: str, lib_name: str, argtypes: list, *args,
           entry: str | None = None) -> None:
    """Call ``<entry>_launch`` of ``csrc/<lib_name>.cu`` (``entry`` defaults
    to ``lib_name``; the function launches its kernel on the stream it is
    given and returns ``cudaGetLastError()``), raise on a non-zero code, and
    count the launch under ``kernel``."""
    lib = library(lib_name)
    fn = getattr(lib, f"{entry or lib_name}_launch")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        what = getattr(lib, f"{lib_name}_error_string")
        what.argtypes = [ctypes.c_int]
        what.restype = ctypes.c_char_p
        raise RuntimeError(f"{kernel} failed to launch: CUDA error {err} "
                           f"({what(err).decode()})")
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_backend(backend: str, x: torch.Tensor) -> None:
    """Validate an op's ``backend``: ``"auto"`` hands the tensor to the
    kernel wrapper, which launches on a CUDA tensor and runs the plain
    version only on a CPU one; ``"cuda"`` also demands a CUDA tensor."""
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r} (auto or cuda)")
    if backend == "cuda" and x.device.type != "cuda":
        raise ValueError(f"backend='cuda' needs a CUDA tensor, got one on "
                         f"{x.device}")


def check_grid(x: torch.Tensor, ndim: int, name: str, *,
               strided: bool = False) -> int:
    """Validate a kernel wrapper's input; returns the kernel's dtype code.
    A CUDA tensor must be contiguous unless the kernel takes ``strided``
    input."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16 (the kernel sums in "
                        f"float32), got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} takes a {ndim}-d tensor, got shape "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device.type == "cuda" and not strided and not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    return DTYPE_CODES[x.dtype]


def radius(coeffs, name: str) -> int:
    """The radius of a tap list, which must have odd length 2r+1."""
    if len(coeffs) % 2 != 1:
        raise ValueError(f"{name} takes 2r+1 taps per axis, got {len(coeffs)}")
    return (len(coeffs) - 1) // 2


@functools.lru_cache(maxsize=64)
def device_coeffs(coeffs: tuple[float, ...], device: torch.device) -> torch.Tensor:
    """The taps as a float32 tensor on ``device``, built once per device."""
    return torch.tensor(coeffs, dtype=torch.float32, device=device)


def smem_per_block(device: torch.device) -> int:
    """Shared memory one block may use on ``device`` after opting in."""
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def require_smem(what: str, smem: int, device: torch.device) -> None:
    """Refuse a tile whose shared memory the card cannot give one block."""
    limit = smem_per_block(device)
    if smem > limit:
        raise ValueError(f"{what} needs {smem} B of shared memory; the card "
                         f"allows {limit} B per block")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
