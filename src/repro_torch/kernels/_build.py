"""Build the CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for `sm_90a`,
into `build/repro_torch_kernels/` at the repository root. The library name
carries a digest of the source and the flags, so an edited source is
rebuilt and a current one is reused. All stale sources compile at once,
one nvcc process each. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from .. import tracing
from . import autotune

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# The fused K-hash engine's C signature; order is null, or the int32
# scratch of the row order (`autotune.engine_order_words`); stats is null,
# or the u64 pairs of lane and live column counts the kernels add to
# (`tracing.engine_counts`):
# int repro_<name>(tokens, keys, lens, out, part, B, N, W, K, ldk, pairwise,
#                  split, mod_m, order, stats, stream)
_ENGINE = ([_P] * 5 + [_I] * 4
           + [ctypes.c_longlong, _I, _I, ctypes.c_ulonglong, _P, _P, _P])
# The integer single-hash kernel's C signature:
# int repro_multilinear(tokens, keys, part, out, B, N, pairwise, stream)
_SINGLE = [_P] * 4 + [_I] * 3 + [_P]
# The carry-less one's: with `finish`, keys hold m1 first and out gets the
# finished (B,) hashes (csrc/gf_single.cuh)
# int repro_gf_multilinear(tokens, keys, part, out, B, N, pairwise, finish,
#                          split, stream)
_GF_SINGLE = [_P] * 4 + [_I] * 5 + [_P]
#: kernel name -> argument types of its C function `repro_<name>`, which
#: returns cudaGetLastError() after its launches. The stream comes last.
SIGNATURES = {"multihash": _ENGINE, "gf_multihash": _ENGINE,
              "multilinear": _SINGLE, "gf_multilinear": _GF_SINGLE}
KERNELS = tuple(SIGNATURES)

_LIBS: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": wall time of its nvcc run, "ptxas": nvcc's -v output}
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _flags() -> list[str]:
    return NVCC_FLAGS + autotune.nvcc_defines() + [f"-I{CSRC}"]


def library_path(name: str) -> Path:
    """Where `name`'s library for the current sources and flags lives."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):  # headers are shared
        h.update(src.name.encode() + src.read_bytes())
    h.update(name.encode() + " ".join(_flags()).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, dict]:
    """Compile every kernel whose library is missing, all in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNELS:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, f"repro_{name}")
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def engine_smem(name: str, K: int, pairwise: bool) -> int:
    """Dynamic shared memory (bytes) of one block of engine kernel `name`
    for K functions, as its C side `repro_<name>_smem` computes it."""
    fn = c_function(name, f"repro_{name}_smem", [_I, _I], ctypes.c_longlong)
    return int(fn(K, int(pairwise)))


def c_function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """Another C function `symbol` of kernel `name`'s library (a probe or a
    size query beside the launcher)."""
    fn = getattr(load(name), symbol)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def launch(name: str, device, *args) -> None:
    """Launch kernel `name` on the current stream of `device`. `args` are
    its C arguments before the stream: a tensor passes its data pointer.
    While tracing is on the C call alone is a span `launch.c`."""
    import torch

    fn = getattr(load(name), f"repro_{name}")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        sp = tracing.begin("launch.c") if tracing.ON else None
        try:
            err = fn(*ptrs, stream)
        finally:
            if sp is not None:
                tracing.end(sp)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
