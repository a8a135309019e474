"""Lazy nvcc build of the hand-written CUDA kernels, bound with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, ints and the
CUDA stream as ``void*``) and compiles on its own into
``_build/<name>-<hash>.so`` (the directory is git-ignored), where the hash
covers the source bytes and the compiler flags — an edited source builds
anew, an unchanged one loads from the cache. Nothing builds at import
time: the first CUDA call of a kernel wrapper builds (or loads) its
library. ``build()`` starts one nvcc per source, all at once.

There is no fallback. A missing nvcc or a failed compile raises
``KernelBuildError``; a refused or failed launch raises
``KernelLaunchError`` with the CUDA error string.

``miss_counts`` reads what a warm fleet admission must not add to: the
nvcc builds and library loads of this process, and the distinct launch
signatures (the shape arguments a kernel is launched with, and the
device it runs on) every kernel wrapper has recorded through
``note_signature``. A wrapper records its signature before it
dispatches, so the CPU twins count too, and a kernel's first launch on a
card it has not run on counts as a new signature: a bucket that moves
to another card shows as a miss once.

Every wrapper launches under ``torch.cuda.device`` of its tensors'
card: the ctypes launch, and the ``cudaFuncSetAttribute`` before it, act
on the host thread's current device, which need not be the tensors'.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Set, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# source name -> {each C launch function: the ctypes argument types in
# the order of its C signature (pointers and the stream as void*)}
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
PROTOTYPES = {
    "yprofile": {"yprofile_launch": (_P, _P, _P, _LL, _F, _P)},
    "bitsliced": {"eval_words_voted_launch": (_P,) * 7 + (_I,) * 8 + (_P,),
                  "eval_words_split_launch": (_P,) * 9 + (_I,) * 8 + (_P,),
                  "eval_words_streamed_launch":
                      (_P,) * 8 + (_I,) * 8 + (_P,)},
    "lut_eval": {"lut_eval_launch": (_P,) * 8 + (_I,) * 9 + (_P,)},
    "bdt_infer": {"bdt_infer_launch": (_P,) * 10 + (_I,) * 5 + (_P,)},
    "sparse_pack": {
        "sparse_pack_launch": (_P,) * 12 + (_I,) * 5 + (_LL, _P),
        "decode_dense_launch": (_P,) * 9 + (_I,) * 5 + (_LL, _P)},
    "feature_encode": {
        "feature_encode_launch": (_P, _I, _LL, _I, _P) + (_I,) * 5
                                 + (_P,) * 2},
}
KERNELS = tuple(PROTOTYPES)

# the device limit on dynamic shared memory per block (H100: 227 KB)
SMEM_LIMIT_BYTES = 232448

_LIBS: Dict[str, ctypes.CDLL] = {}
# kernel name -> the distinct launch signatures its wrapper has recorded
_SIGNATURES: Dict[str, Set[Tuple]] = {}
# nvcc compiles and library loads of this process
_EVENTS = {"compiles": 0, "loads": 0}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or a kernel source failed to compile."""


class KernelLaunchError(RuntimeError):
    """A kernel launch was refused or failed (cudaGetLastError != 0)."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels build from source on first use and have no "
        "fallback")


def lib_path(name: str) -> Path:
    """Where ``name``'s library lands: keyed by source and flag hash."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, Dict[str, object]]:
    """Compile the named kernels (default: all) in parallel, one nvcc per
    source. Returns {name: {"seconds": wall time, "cached": bool,
    "ptxas": the compiler's register/shared-memory report}}."""
    names = names or KERNELS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, Dict[str, object]] = {}
    t0 = time.monotonic()
    for name in names:
        dst = lib_path(name)
        if dst.is_file():
            out[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, dst)
    for name, (proc, tmp, dst) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                f"{log[-4000:]}")
        os.replace(tmp, dst)        # atomic: concurrent builders agree
        _EVENTS["compiles"] += 1
        out[name] = {"seconds": time.monotonic() - t0, "cached": False,
                     "ptxas": log.strip()}
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use and cached, with
    its launch functions' prototypes set from PROTOTYPES."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.is_file():
            build(name)
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        for fn_name, argtypes in PROTOTYPES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
        _EVENTS["loads"] += 1
    return lib


def note_signature(kernel: str, signature: Tuple, device) -> None:
    """Record one launch signature of ``kernel`` on ``device`` (its
    wrapper calls this before it dispatches, to the kernel or to its CPU
    twin)."""
    _SIGNATURES.setdefault(kernel, set()).add(
        tuple(signature) + (str(device),))


def miss_counts() -> Tuple[int, int]:
    """(nvcc compiles + library loads, distinct launch signatures over
    every kernel wrapper) so far in this process: both stay put across a
    warm fleet admission."""
    return (_EVENTS["compiles"] + _EVENTS["loads"],
            sum(len(v) for v in _SIGNATURES.values()))


def aligned(x):
    """``x`` contiguous and 16-byte aligned, as the kernels' vector loads
    need (a copy only when it is not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise KernelLaunchError when a launch returned a CUDA error."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode(errors="replace")
        raise KernelLaunchError(f"{what}: CUDA error {code} ({msg})")
