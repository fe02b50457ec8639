"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one source under ``src/repro_torch/csrc/`` with a plain C
interface (sources may share a ``.cuh`` header there, and one source may
hold several C entries: kernel 1's three addressings).  At first use it is compiled with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` at the root of the checkout, under a name keyed by
a hash of the source and the flags, and loaded with ``ctypes``.  Pointers
and the stream go in as ``c_void_p`` (kernels 6 and 8, whose host call
is their cost at the path's sizes, take their values packed into one
int64 block);
each C entry returns ``cudaGetLastError()`` and ``CudaKernel.launch``
raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` or the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the toolkit is")


def _target(name: str) -> Path:
    """The library path, keyed by the source, the shared headers of
    ``csrc/`` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build_libraries(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes at once; returns name -> library path.  The
    compiler's ``-Xptxas -v`` report lands beside each library as
    ``<lib>.log``."""
    names = list(names)
    todo: List = []
    out: Dict[str, Path] = {}
    for name in names:
        so = _target(name)
        out[name] = so
        if not so.exists():
            todo.append((name, so))
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, so in todo:
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        log = open(so.with_suffix(".so.log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, so, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (rc {rc}): "
                          f"{so.with_suffix('.so.log').read_text()[-2000:]}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the library built for ``name``."""
    return _target(name).with_suffix(".so.log").read_text()


class CudaKernel:
    """One kernel's C entry point, loaded at first launch, with a count of
    its launches (a plain integer the wrapper bumps after each launch).
    ``stem`` names the source, ``csrc/<stem>.cu``; it defaults to the
    entry's name."""

    def __init__(self, name: str, argtypes: Sequence, stem: str = ""):
        self.name = name            # the C entry point
        self.stem = stem or name    # the source stem
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.stem}.cu"

    def load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build_libraries([self.stem])[self.stem]))
            fn = getattr(lib, self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        err = self.load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA error {err} at launch")
        self.launches += 1

    def launch_on(self, device, *args) -> None:
        """``launch``, or nothing on PyTorch's meta device: there the
        entry has allocated its outputs and scratch on ``meta`` (shape
        propagation for a counted trace; there is no card to launch
        on)."""
        if device.type != "meta":
            self.launch(*args)

    def ready(self, *tensors) -> None:
        """Build and load the kernel, and check that ``tensors`` lie on
        one CUDA device (``require_cuda``); on ``meta`` inputs nothing is
        built."""
        if tensors[0].is_meta and all(t.is_meta for t in tensors):
            return
        self.load()
        require_cuda(*tensors)


def stream_handle(device) -> int:
    """The raw handle of the current stream on the CUDA ``device``, for a
    kernel's ``c_void_p`` stream argument.  Read without building a
    ``torch.cuda.Stream`` object, which costs microseconds a launch."""
    import torch
    if device.type == "meta":
        return 0
    idx = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if idx is None else idx)


def require_cuda(*tensors) -> None:
    """The kernel path takes CUDA tensors on one device, and nothing else."""
    dev = tensors[0].device
    if not tensors[0].is_cuda or any(t.device != dev for t in tensors[1:]):
        raise ValueError(f"kernel inputs must all lie on one CUDA device, "
                         f"got {sorted({str(t.device) for t in tensors})}")
