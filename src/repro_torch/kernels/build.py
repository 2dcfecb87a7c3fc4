"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``.cu`` file compiles to an object in its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper); the objects link into one
shared library with a plain C interface.  The library is named by a
hash of the flags and of every source and header in ``csrc/``
(``.cu``, ``.cuh``, ``.h``) and kept in ``build/`` beside this file,
so a process builds at first use and later processes of the same
checkout load it.  Nothing here runs at import: the CPU tests import
every module on machines without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Files whose bytes name the library; only the .cu files compile.
HASHED_SUFFIXES = (".cu", ".cuh", ".h")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_U32 = ctypes.c_uint32
# name -> (argtypes, restype) of every function the library exports.
_EXPORTS = {
    "fused_ingest_launch": ([_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P],
                            _I),
    "pair_counts_launch": ([_P, _I64, _I, _P, _P, _I64, _P, _P], _I),
    "masked_indexed_pair_counts_launch": ([_P, _I64, _I, _P, _P, _P, _I64, _P,
                                           _P], _I),
    "masked_pair_counts_launch": ([_P, _P, _I, _P, _I64, _P, _P], _I),
    "pair_counts_schedule": ([_I, _P, _P], _I),
    "fused_ingest_schedule": ([_I, _I, _P], _I),
    "byte_token_hashes_schedule": ([_P, _P, _P], _I),
    "ngram_hashes_launch": ([_P, _P, _P, _P, _I64, _I, _I, _P], _I),
    "ngram_hashes_schedule": ([_P, _P, _P, _I], _I),
    "minhash_launch": ([_P, _P, _P, _P, _I64, _I, _I, _P], _I),
    "minhash_schedule": ([_I, _I, _P], _I),
    "minhash_path": ([_P, _P, _I], _I),
    "band_values_launch": ([_P, _P, _I64, _I, _I, _P], _I),
    "byte_token_hashes_launch": ([_P, _P, _P, _P, _I64, _I, _U32, _P], _I),
    "flash_attention_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, ctypes.c_float, _I, _P], _I),
    "flash_attention_f32_smem_bytes": ([_I], _I),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lib: ctypes.CDLL | None = None


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    found = shutil.which(name)
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if cand.is_file():
        return str(cand)
    raise RuntimeError(f"{name} not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels cannot be built or read")


def _sources() -> list[Path]:
    """The translation units: every ``.cu`` file in ``csrc/``."""
    return sorted(CSRC.glob("*.cu"))


def _library_path(csrc: Path = CSRC) -> Path:
    """``build/`` path of the library built from ``csrc`` as it is now.

    A change to any source or header gives a new name, so a stale
    library is never loaded.
    """
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(csrc.iterdir()):
        if f.suffix in HASHED_SUFFIXES:
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile and link the kernels unless this checkout already has them.

    Returns the library path and nvcc's messages (``-Xptxas -v``:
    registers, shared memory and spills per kernel), each source's under a
    line ``== name (seconds s)`` with its own compile time.  Raises
    ``RuntimeError`` with nvcc's output if a step fails.
    """
    lib_path = _library_path()
    log_path = lib_path.with_suffix(".log")
    if lib_path.is_file():
        return lib_path, log_path.read_text() if log_path.is_file() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_tool()

    def compile_one(src: Path, obj: Path):
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        return proc, time.perf_counter() - t0

    sources = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp, \
            ThreadPoolExecutor(len(sources)) as pool:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, pool.submit(compile_one, src, obj)))
        log = []
        failed = []
        for src, _, job in procs:
            proc, seconds = job.result()
            log.append(f"== {src.name} ({seconds:.2f} s)\n{proc.stdout}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               + "\n".join(log))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the CUDA kernels failed:\n{link.stdout}")
        log_path.write_text("\n".join(log))
        os.replace(tmp_lib, lib_path)
    return lib_path, log_path.read_text()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call of the process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        for name, (argtypes, restype) in _EXPORTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def launch(name: str, device, *args) -> None:
    """Call the library's launcher ``name`` with ``args`` and the current
    stream of ``device`` (a CUDA ``torch.device``); raise on a CUDA error.
    The device is made current only when it is not already."""
    import torch

    fn = getattr(library(), name)
    if device.index == torch.cuda.current_device():
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            code = fn(*args, torch.cuda.current_stream().cuda_stream)
    check_launch(code, name.removesuffix("_launch"))


def check_launch(code: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        text = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{code} ({text})")
