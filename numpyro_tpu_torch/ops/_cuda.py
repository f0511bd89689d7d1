"""Build and load the package's CUDA kernels (``numpyro_tpu_torch/csrc``).

The sources have a plain C interface: ``nvcc`` compiles them into one shared
library on first use (a few seconds, no PyTorch headers), and ``ctypes``
loads it.  The library is cached in ``numpyro_tpu_torch/_build`` (or in
``$NUMPYRO_TPU_TORCH_BUILD_DIR``) under a name derived from the sources and
flags, so an edited source is rebuilt.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("glm.cu",)
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_info = {}  # {"seconds": ..., "ptxas": ..., "path": ...} of the last load


def _build_dir():
    env = os.environ.get("NUMPYRO_TPU_TORCH_BUILD_DIR")
    return Path(env) if env else _CSRC.parent / "_build"


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of numpyro_tpu_torch are built from "
        "source on first use and need the CUDA toolkit"
    )


def load():
    """Build (if needed) and load the kernel library; returns the ctypes
    handle with argument types set."""
    global _lib
    if _lib is not None:
        return _lib
    sources = [_CSRC / s for s in _SOURCES]
    digest = hashlib.sha256()
    for s in sources:
        digest.update(s.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"libnumpyro_tpu_torch_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    ptxas = ""
    if not target.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        ptxas = proc.stdout + proc.stderr
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    p, i = ctypes.c_void_p, ctypes.c_int
    # (w, b, d, d_pad, tensor map, [x_is_bf16,] y, n_pad, n, plan, pe_part,
    #  g_part, ll, grad, stream)
    lib.glm_split_launch.argtypes = [p, i, i, i, p, p, i, i, p, p, p, p, p, p]
    lib.glm_split_launch.restype = i
    lib.glm_fused_launch.argtypes = [p, i, i, i, p, i, p, i, i, p, p, p, p, p, p]
    lib.glm_fused_launch.restype = i
    # (out, x, x_is_bf16, d_pad, n_pad, box_rows)
    lib.glm_make_tensor_map.argtypes = [p, p, i, i, i, i]
    lib.glm_make_tensor_map.restype = i
    for fn in (lib.glm_tile_columns, lib.glm_segment_tiles):
        fn.argtypes = []
        fn.restype = i
    build_info.update(
        seconds=time.perf_counter() - t0, ptxas=ptxas, path=str(target)
    )
    _lib = lib
    return lib


def ptxas_summary():
    """One line per kernel of the last build: the end of its mangled name
    (for ``glm_partials_kernel`` the template arguments mode, d-blocks and
    chain groups per warpgroup), registers and spills, from ``-Xptxas -v``."""
    lines = build_info.get("ptxas", "").splitlines()
    names = [ln.split("'")[1] for ln in lines if "Compiling entry" in ln]
    used = [ln.split(":")[-1].strip() for ln in lines if "registers" in ln]
    spills = [ln.strip() for ln in lines if "spill" in ln]
    return [
        f"{name.split('kernel')[-1][:16]}: {u}; {sp}"
        for name, u, sp in zip(names, used, spills)
    ]
