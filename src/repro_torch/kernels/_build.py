"""Build and load the port's CUDA kernels, and pick kernel or plain path.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``. The
build happens at first use, into ``build/kernels`` at the root of the
checkout (or the directory that ``REPRO_TORCH_BUILD_DIR`` names), and is
cached by a hash of the sources and flags. ``build_all`` starts one ``nvcc`` per source at once.
Each build keeps ptxas's report beside its library; ``resource_usage``
reads each kernel's registers and spill bytes from it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("rmsnorm", "flash_attention", "decode_attention", "ssd_scan",
           "rglru_scan", "mla_decode", "ssd_step")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.is_cuda:
        return True
    if t.is_cpu:
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def refuse_grad(name: str, pallas: Optional[str],
                *tensors: torch.Tensor) -> None:
    """Raise where autograd records and an input of the wrapper ``name``
    requires grad: its kernel has no backward, as ``pallas``, the Pallas
    kernel it replaces, has none (JAX refuses to differentiate it), so its
    output would silently carry no gradient. ``pallas`` None names a
    decode kernel that replaces none: training never runs it. Every
    wrapper calls it before it picks the kernel or the plain version, so
    the CPU refuses too."""
    if not (torch.is_grad_enabled() and any(t.requires_grad
                                            for t in tensors)):
        return
    if pallas is None:
        raise RuntimeError(
            f"{name} has no gradient: the decode kernel has no backward, "
            "and training never runs it; call it under torch.no_grad()")
    raise RuntimeError(
        f"{name} has no gradient: {pallas}, the Pallas kernel it "
        "replaces, has none; train with use_pallas=False, or call it "
        "under torch.no_grad()")


def build_dir() -> Path:
    """Where the libraries go: ``REPRO_TORCH_BUILD_DIR`` when it is set,
    else ``build/kernels`` at the root of the checkout that holds this
    package as ``src/repro_torch``. Outside such a checkout (an installed
    package) it raises rather than write beside site-packages."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env).resolve()
    pkg = Path(__file__).resolve().parents[1]
    root = pkg.parents[1]
    if not (pkg.parent.name == "src" and pkg.name == "repro_torch"
            and (root / "pyproject.toml").is_file()):
        raise RuntimeError(
            f"{pkg} is not src/repro_torch of a checkout; set "
            "REPRO_TORCH_BUILD_DIR to the directory for the kernel builds")
    return root / "build" / "kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None when the cached library exists."""
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all(names: Sequence[str] = SOURCES) -> None:
    """Compile every CUDA source not yet cached, all nvcc runs at once."""
    with _LOCK:
        started = {n: _start(n) for n in names if n not in _LIBS}
        errors = []
        for n, s in started.items():
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                lib.repro_error_string.restype = ctypes.c_char_p
                lib.repro_error_string.argtypes = [ctypes.c_int]
                _LIBS[name] = lib
    return lib


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_PROPS = re.compile(r"Function properties for (\w+)")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def resource_usage(name: str) -> Dict[str, Dict[str, int]]:
    """Registers, stack-frame and spill bytes of each kernel (by mangled
    name) of ``csrc/<name>.cu``, from ptxas's report of its build."""
    log = _lib_path(name).with_suffix(".log")
    usage: Dict[str, Dict[str, int]] = {}
    kernel = props = None
    for line in log.read_text().splitlines():
        if m := _PTXAS_ENTRY.search(line):
            kernel = m.group(1)
            usage[kernel] = {}
        elif m := _PTXAS_PROPS.search(line):
            props = m.group(1)
        elif props in usage and (m := _PTXAS_SPILL.search(line)):
            usage[props].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        elif kernel and (m := _PTXAS_REGS.search(line)):
            usage[kernel]["registers"] = int(m.group(1))
    return usage


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {rc})")


def stream_ptr(t: torch.Tensor) -> int:
    """The current stream of t's card, as the launch takes it (the raw
    handle PyTorch's own launchers read: no Stream object is made)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
