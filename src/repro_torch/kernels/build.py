"""Build the CUDA kernels into one shared library and load it with ctypes.

The sources in ``csrc/`` have a plain C interface and include no PyTorch
header, so ``nvcc`` compiles each in seconds.  The build runs at first use,
never at import: every source is compiled to an object by its own ``nvcc``
process, all started together, and the objects are linked into one
``.so`` for ``sm_90a`` under ``<repo>/build/repro_torch/``.  The library's
name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Processes that reach the
build together (several processes on one card) take a file lock beside
the library: the first builds, the others then load what it built.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
``ops`` wrappers raise on a non-zero code.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fedavg_agg.cu", "kld_greedy.cu", "kld_score.cu", "affine_warp.cu",
           "flash_attention.cu", "flash_attention_bwd.cu", "ssd_chunk.cu",
           "ssd_chunk_bwd.cu")
# headers the sources include (hashed into the library's name with them)
HEADERS = ("flash_common.cuh", "kld_common.cuh", "mbarrier.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float
# entry point -> argument types (every one returns an int error code)
SIGNATURES = {
    "fedavg_agg_f32": (_P, _P, _P, _I64, _I64, _P),
    "fedavg_agg_bf16": (_P, _P, _P, _I64, _I64, _P),
    "kld_greedy_picks": (_P, _P, _P, _I, _I, _I, _P),
    "kld_score_f32": (_P, _P, _P, _I, _I, _P),
    "kld_score_matrix_f32": (_P, _P, _P, _I, _I, _I, _P),
    "affine_warp_f32": (_P, _P, _P, _P, _I64, _I, _I, _I, _P),
    "flash_attention_f32": (*(_P,) * 5, *(_I,) * 9, _F, _P),
    "flash_attention_bf16": (*(_P,) * 5, *(_I,) * 9, _F, _P),
    "flash_attention_bwd_f32": (*(_P,) * 11, *(_I,) * 10, _F, _P),
    "flash_attention_bwd_bf16": (*(_P,) * 11, *(_I,) * 10, _F, _P),
    "ssd_chunk_f32": (*(_P,) * 8, *(_I,) * 6, _P),
    "ssd_chunk_bf16": (*(_P,) * 8, *(_I,) * 6, _P),
    "ssd_chunk_bwd_f32": (*(_P,) * 15, _I64, *(_I,) * 6, _P),
}

# nvcc builds this process ran (0 in a process that loaded a built library)
NUM_BUILDS = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libreprotorch_{_digest()}.so"


def build(log: list[str] | None = None, build_dir: Path = BUILD_DIR) -> Path:
    """Compile and link the kernels into ``build_dir`` unless the current
    library is there.  Appends the compiler's output (``-Xptxas=-v``
    register/smem report) and the build seconds to ``log`` when given."""
    out = Path(build_dir) / library_path().name
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # another process may be building
        if not out.exists():
            _compile(out, log)
    return out


def _compile(out: Path, log: list[str] | None) -> None:
    global NUM_BUILDS
    NUM_BUILDS += 1
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(str(obj))
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, proc in procs:
            text, _ = proc.communicate()
            if log is not None:
                log.append(f"[nvcc {name}]\n{text}")
            if proc.returncode:
                failed.append(f"{name}:\n{text}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *objs, "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    if log is not None:
        log.append(f"build seconds: {time.perf_counter() - t0:.2f}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    # launch-plan queries (no launch)
    lib.kld_greedy_plan.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 7 \
        + [ctypes.POINTER(_I64)]
    lib.kld_greedy_plan.restype = ctypes.c_int
    lib.affine_warp_stages.argtypes = [_P, _P, _I, _I, _I]
    lib.affine_warp_stages.restype = ctypes.c_int
    lib.kld_score_plan.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 5
    lib.kld_score_plan.restype = ctypes.c_int
    lib.kld_score_matrix_plan.argtypes = [_I, _I, _I, _P, _P] + [ctypes.POINTER(_I)] * 4 \
        + [ctypes.POINTER(_I64)] + [ctypes.POINTER(_I)] * 2
    lib.kld_score_matrix_plan.restype = ctypes.c_int
    lib.ssd_chunk_plan.argtypes = [_I] * 5 + [ctypes.POINTER(_I)] * 3 \
        + [ctypes.POINTER(_I64)]
    lib.ssd_chunk_plan.restype = ctypes.c_int
    lib.ssd_chunk_bwd_plan.argtypes = [_I] * 6 + [ctypes.POINTER(_I)] * 3 \
        + [ctypes.POINTER(_I64)] * 2 + [ctypes.POINTER(_I)] * 2 + [ctypes.POINTER(_I64)]
    lib.ssd_chunk_bwd_plan.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.repro_bind_device.argtypes = [ctypes.c_int]
    lib.repro_bind_device.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")
