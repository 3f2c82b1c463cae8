"""Build a CUDA source of this package into a shared library and load it.

Kernels are compiled from the sources under ``kernels/csrc`` at first use,
with ``nvcc`` for ``sm_90a`` (Hopper), into ``build/torch_ext/`` at the
root of the checkout (``REPRO_TORCH_BUILD_DIR`` overrides it).  Each library
exposes a plain C interface and is bound with ``ctypes``: no PyTorch
headers are compiled, which keeps a build to seconds.  The library name
carries a hash of the source, the shared headers it names
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and never
served stale.  A failed build raises; there is no fallback.

It is also the one seam between the kernel modules and their callers:
``dispatch`` holds the device rule of every kernel-layout entry point,
``refuse`` the refusals every ``_launch_cuda`` makes first, and ``launch``
the call of a C entry point, its error check and its count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from repro_torch import spans

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]

# Flags are per library.  None of them takes --use_fast_math (it would bring
# flush-to-zero, approximate exp and approximate division).
#
# EXACT_FLAGS (renewal_scan): -fmad=false, no multiply-add contraction, so
# every product and sum rounds as its own float32 operation — as in the
# plain PyTorch version, and as the Kahan ledger needs.  Its 25 kernels are
# assembled on every core (ptxas -split-compile=0: the same registers and
# code per kernel, a shorter build).
EXACT_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-Xptxas", "-split-compile=0",
    "-shared", "-Xcompiler", "-fPIC",
)
# FMA_FLAGS (flash_attention, ssd_scan): nvcc's default contraction into
# fused multiply-adds.  Their dot products are written as fmaf anyway, and
# their bar against the plain version is a tolerance, not bit-equality.
FMA_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict = {}
build_log: dict = {}      # name -> {"seconds": float, "ptxas": str, "cached": bool}


def build_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(
        "REPRO_TORCH_BUILD_DIR", REPO_ROOT / "build" / "torch_ext"))


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, $PATH and $CUDA_HOME/bin); the "
        "CUDA kernels of repro_torch are built from source at first use")


def load_library(name: str, source: str, flags: tuple,
                 csrc: pathlib.Path = CSRC) -> ctypes.CDLL:
    """Compile ``<csrc>/<source>`` with ``flags`` (once per process and
    content) and load it.  ``csrc`` is this package's ``csrc`` unless a
    caller builds another checkout's kernel beside it (under another
    ``name``) to compare the two."""
    if name in _loaded:
        return _loaded[name]
    src = pathlib.Path(csrc) / source
    # the shared headers the source names count too
    text = src.read_bytes()
    parts = [text] + [h.read_bytes() for h in sorted(src.parent.glob("*.cuh"))
                      if h.name.encode() in text]
    digest = hashlib.sha256(
        b"".join(parts) + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{name}_{digest}.so"
    t0 = time.perf_counter()
    ptxas = ""
    cached = lib_path.exists()
    if not cached:
        tmp = out_dir / f".lib{name}_{digest}.{os.getpid()}.so"
        cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        ptxas = proc.stdout + proc.stderr
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": ptxas,
                       "cached": cached, "path": str(lib_path)}
    _loaded[name] = lib
    return lib


def load_libraries(specs) -> list:
    """Build several libraries at once, one ``nvcc`` each, all started
    together; ``specs`` are ``(name, source, flags)`` triples (each kernel
    module's ``LIBRARY``).  Returns the loaded libraries in order."""
    from concurrent.futures import ThreadPoolExecutor

    specs = list(specs)
    with ThreadPoolExecutor(max_workers=len(specs)) as pool:
        return list(pool.map(lambda s: load_library(*s), specs))


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch function of library ``name`` returned a CUDA
    error (``<name>_error_string`` gives its text)."""
    if err == 0:
        return
    fn = getattr(lib, f"{name}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    raise RuntimeError(f"{name} CUDA launch failed: cudaError {err}: "
                       f"{fn(err).decode()}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and an operand requires grad.  The CUDA
    kernels have no backward (nor have the reference's Pallas kernels), and
    a ctypes launch is invisible to autograd: its output would carry no
    gradient, silently.  Train on the plain paths (``use_flash_kernel=False``,
    the reference's default) or launch under ``torch.no_grad()``; a backward
    kernel waits in ROADMAP.md, Queue 1."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {name} CUDA kernel has no backward: its operands require "
            "grad under grad mode, and the gradient would be dropped.  Train "
            "with use_flash_kernel=False or call it under torch.no_grad() "
            "(backward kernels wait in ROADMAP.md, Queue 1)")


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise for a DTensor operand (a tensor on a ``DeviceMesh``): a launch
    on its local shard would compute on a piece of the tensor, silently.
    Under a mesh the model runs its plain path (``use_flash_kernel=False``),
    as the reference never lowers a kernel there."""
    from repro_torch.parallel.dtensor_ops import is_dtensor

    if any(is_dtensor(t) for t in tensors):
        raise TypeError(
            f"the {name} kernel takes no DTensor (a tensor on a DeviceMesh): "
            "its local shard is a piece of the operand.  Run the model's plain "
            "path under a mesh (use_flash_kernel=False)")


def refuse(name: str, *tensors) -> None:
    """The refusals every ``_launch_cuda`` makes before it touches a card:
    no DTensor (``refuse_dtensor``), no operand that requires grad under
    grad mode (``refuse_grad``), and every operand on one device."""
    refuse_dtensor(name, *tensors)
    refuse_grad(name, *tensors)
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name} operands must lie on one device")


def dispatch(name: str, operands, plain, launch):
    """The device rule of a kernel-layout entry point ``name``: every operand
    a ``torch.Tensor``; CPU operands run ``plain()``, CUDA operands
    ``launch()``; any other device, or a mix, raises: a CUDA call never
    falls back."""
    if not all(isinstance(t, torch.Tensor) for t in operands):
        raise TypeError(f"{name} takes torch tensors")
    kinds = {t.device.type for t in operands}
    if kinds == {"cpu"}:
        return plain()
    if kinds == {"cuda"}:
        return launch()
    raise ValueError(f"{name} operands on unsupported devices {kinds}")


def launch(lib: ctypes.CDLL, name: str, entry: str, argtypes, device,
           *args, after=()) -> None:
    """Call the C entry point ``entry`` of library ``name``: bind its
    ``argtypes`` (the stream's included) and an int return on the first
    call, pass ``args``, the current stream of ``device``, then ``after``;
    raise on a returned CUDA error and count one launch under ``name``
    (``spans.counts()``).  Nothing is synchronised."""
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream, *after)
    check_launch(lib, name, err)
    spans.counter(name)[name] += 1
