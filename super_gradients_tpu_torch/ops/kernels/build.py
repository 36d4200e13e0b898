"""Builds the port's CUDA sources (``super_gradients_tpu_torch/csrc``) at first use.

Each ``.cu`` file has a plain C interface. It is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``<repo>/build/kernels`` (listed in
``.gitignore``), named by a hash of the source and the flags, and loaded with
``ctypes``. A checkout therefore builds its kernels on its first call and reuses
them after. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# No --use_fast_math, and no FMA contraction: the NMS kernel must be bit-equal to
# its plain PyTorch version where an IoU equals the threshold.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH): cannot build CUDA kernels")
    return nvcc


def library_path(source_name: str) -> Path:
    """Where the library built from ``csrc/<source_name>`` lives."""
    src = CSRC_DIR / source_name
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source_name: str) -> Path:
    """Compile ``csrc/<source_name>`` unless a library of the same hash exists."""
    out = library_path(source_name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source_name)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {source_name}:\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a half-written file
    return out


def load_library(source_name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source_name>``."""
    return ctypes.CDLL(str(build(source_name)))
