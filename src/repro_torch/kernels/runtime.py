"""Device resolution and the nvcc build of the port's hand-written kernels.

Two jobs, both small:

* ``resolve_device`` is the one place a ``device=`` argument becomes a
  ``torch.device``.  ``"cuda"`` on a host without a usable card raises
  ``RuntimeError`` — a run that asked for the card never carries on
  quietly on the CPU.  ``"cpu"`` routes every kernel wrapper to its plain
  PyTorch version (the wrappers dispatch on the tensor's device).
* ``library(name)`` returns the ctypes handle of ``csrc/<name>.cu`` built
  for Hopper.  The first call builds every source in ``csrc/`` at once
  (one ``nvcc`` process per source, all started together) into
  ``build/repro_torch_kernels/`` at the repository root; each shared
  library's file name carries a hash of its source and the compiler
  flags, so an edited kernel rebuilds and an unchanged one is reused.  A
  failed build raises with nvcc's stderr.

Each library exposes a plain C interface: ``<name>_launch(...)`` enqueues
the kernel on the caller's stream and returns the ``cudaError_t`` of the
launch, and ``<name>_error_string(code)`` names it.  Nothing here runs at
import: this module imports on a CPU-only host, where no kernel is built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: gitignored build output, at the root of the checkout
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: one shared library per source: sm_90a (Hopper, with wgmma/setmaxnreg),
#: -Xptxas -v so every build records registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_P, _I = ctypes.c_void_p, ctypes.c_int
#: every kernel library and the C signature of its ``<name>_launch``:
#: device pointers, then int sizes/knobs, then the cudaStream_t
SIGNATURES = {
    # conf, thresholds, routes, slots, counts; rows, n, capacity; stream
    "triage": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # scores, truths, params, counts; rows, n, iters, min_count; stream
    "calibrate": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # f0, f1, f2, mask; pixels, threshold, maxval; stream
    "framediff": (_P, _P, _P, _P, _I, _I, _I, _P),
    # x, out; batch, h, w, op (0 max, 1 min), fill; stream
    "morphology": (_P, _P, _I, _I, _I, _I, _I, _P),
    # f0, f1, f2, mask, counts; batch, h, w, threshold, maxval; stream
    "pixel_cascade": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # conf, th0, mask, drain, gains, routes, slots, ths; steps, rows, n,
    # capacity; stream
    "superstep": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # emb, trk, crop_q, trk_q, thr, assign, sim; m, k, d; stream
    "associate": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
}
#: the kernels a run of the query pipeline (either frontend) can launch
KERNELS = tuple(SIGNATURES)

_LIBS: Dict[str, ctypes.CDLL] = {}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``cuda`` must really be there."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was asked for but torch finds no "
                f"CUDA device (torch {torch.__version__}); pass "
                f"device='cpu' to run the plain PyTorch versions")
    elif dev.type != "cpu":
        raise ValueError(f"device={str(device)!r}: expected 'cuda' or 'cpu'")
    return dev


def nvcc() -> str:
    """Path of the CUDA compiler: ``$PATH``, then ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels are built from source at first "
                       "use and need the CUDA toolkit")


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (hashed over its source, the
    shared ``csrc/*.cuh`` headers and the flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Dict[str, object]]:
    """Build every listed kernel library that is not built yet.

    All nvcc processes start together and are waited on together.  Returns
    ``{name: {"path", "seconds", "log"}}`` for the sources compiled by this
    call (``log`` is nvcc's stderr: the ptxas register/shared-memory
    report).  Raises ``RuntimeError`` with the compiler's stderr for any
    source that does not build."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out: Dict[str, Dict[str, object]] = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, lib_path(name))
        out[name] = {"path": str(lib_path(name)),
                     "seconds": time.perf_counter() - t0, "log": stderr}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (building all kernels on first
    use), with its two C entry points' signatures declared."""
    lib = _LIBS.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build(KERNELS)
        lib = ctypes.CDLL(str(lib_path(name)))
        launch = getattr(lib, f"{name}_launch")
        launch.restype = ctypes.c_int
        launch.argtypes = list(SIGNATURES[name])
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check_launch(name: str, rc: int) -> None:
    """Raise if ``<name>_launch`` reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = getattr(library(name), f"{name}_error_string")(rc)
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} "
                           f"({msg.decode()})")


def stream(device: Optional[torch.device] = None) -> int:
    """PyTorch's current CUDA stream on ``device`` as a raw handle: the
    kernels launch on it and never synchronise."""
    return torch.cuda.current_stream(device).cuda_stream
