"""Build and load the package's CUDA sources with ``nvcc`` and ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled for Hopper (``sm_90a``) into ``build/vrdone_tpu_torch/`` at the
root of the checkout, under a name that carries a hash of the source, the
shared ``csrc/*.cuh`` headers and the flags, so an edited source is rebuilt
and an unchanged one is loaded.
Nothing here runs at import time: the CPU-only tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vrdone_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what each load did, for chip_smoke.py's report: name -> (seconds spent
# compiling, 0.0 when the library was already built; nvcc's stderr)
BUILD_LOG: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, then
    load it. Raises ``RuntimeError`` with nvcc's output if the build fails.
    Callers keep the returned library (each kernel module loads once)."""
    src = CSRC / f"{name}.cu"
    # the shared headers count too: a source includes them by name
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build into a private file and rename it into place, so a
        # process building the same source never loads a half-written one
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    BUILD_LOG[name] = (seconds, log)
    return ctypes.CDLL(str(lib_path))


def check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch function of ``csrc/<name>.cu`` returned a CUDA
    error code (the kernel was refused and never ran)."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through a kernel launch that
    has no backward: its output would carry no ``grad_fn`` and every
    tensor in front of it would silently get no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: an input requires grad. Call it under "
            "torch.no_grad(), or take the differentiable form "
            "(ops.masked.band_attention / full_attention(allow_kernel=False))")


def check_attention_inputs(q, k, v, kv_mask) -> None:
    """The checks both attention kernels need before their pointers are
    passed: one CUDA device, (B, T, C) streams all fp32 or all bf16, a
    (B, Tk) bool key mask, all contiguous."""
    tensors = {"q": q, "k": k, "v": v, "kv_mask": kv_mask}
    for n, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{n} must lie on q's CUDA device, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k and v must share one dtype, got {q.dtype}, "
                        f"{k.dtype} and {v.dtype}")
    for n in ("q", "k", "v"):
        if tensors[n].dim() != 3:
            raise ValueError(f"{n} must be (B, T, C), got {tuple(tensors[n].shape)}")
    if kv_mask.dtype != torch.bool:
        raise TypeError(f"kv_mask must be bool, got {kv_mask.dtype}")
    b, tk, c = k.shape
    if v.shape != k.shape or q.shape[0] != b or q.shape[2] != c:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kv_mask.shape != (b, tk):
        raise ValueError(f"kv_mask must be {(b, tk)}, got "
                         f"{tuple(kv_mask.shape)}")
