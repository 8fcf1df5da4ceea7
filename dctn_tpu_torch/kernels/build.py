"""Build a CUDA source of ``dctn_tpu_torch/csrc`` into a shared library with
a plain C interface and load it with ``ctypes``.

``nvcc`` compiles each source at first use into ``build/dctn_tpu_torch/``
at the root of the checkout (listed in ``.gitignore``), named by a hash of
the source, the headers beside it and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Sources include only the CUDA runtime's headers, so
a build takes seconds; nothing is fetched or taken prebuilt.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dctn_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# every source of csrc/ that the wrappers load
SOURCES = ("eps_fwd", "eps_dcore", "eps_dviews_t", "eps_fwd_q8", "sbs_fwd", "sbs_bwd",
           "logmatmulexp")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives, keyed by its content, the
    content of the headers beside it (``*.cuh``) and the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` unless its build is current, then load it.
    The compiler's report (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside the library as ``.log``."""
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def build_all(names=SOURCES) -> None:
    """Builds every source of ``names`` that is not current, one ``nvcc``
    each, all started together (a rank of a multi-card job calls this once
    per host before the others load the libraries)."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for fut in [pool.submit(load_library, name) for name in names]:
            fut.result()
