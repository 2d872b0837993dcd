"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

The sources under ``tpusort_torch/csrc/`` have a plain C interface, so they
compile in seconds without PyTorch's headers.  Each ``.cu`` compiles in its
own nvcc process, all started together, and one link makes a shared library
under ``build/tpusort_torch/`` at the repository root, named by a hash of
the sources and flags, so an edit rebuilds and an unchanged tree reuses the
library.  The compiler's output (``-Xptxas -v``: registers,
shared memory, spills per kernel) is kept in ``build/tpusort_torch/build.log``.

Nothing here runs at import time: the first kernel launch calls
:func:`library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpusort_torch"
# -fno-gnu-unique: a static inside a template (each entry point's "shared
# memory attribute set" flags) would otherwise be one object for every copy
# of the library in the process, so a second build loaded beside the first
# (another tree's, to compare the two) would skip setting its own kernels'
# attribute and fail their launches.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xcompiler", "-fno-gnu-unique", "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
# C entry points and their argument types; each returns a cudaError_t
_SIGNATURES = {
    # keys_in, keys_out, n_planes, vals_in, vals_out, n_vals, counts_in,
    # q_in, n, T, K, R, S, lo_bit, width, t_seg, sorted_run, merge_run,
    # warp_run, threads, slots, smem, counts_out, stream
    "tpusort_partition_raw": [_PP, _PP, _I, _PP, _PP, _I, _P, _I, _LL, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P, _P],
    # keys_in, keys_out, n_planes, vals_in, vals_out, n_vals, counts_in,
    # q_in, n, T, K, R, S, t_seg, sorted_run, merge_run, warp_run,
    # splitters, fracs, threads, slots, smem, counts_out, stream
    "tpusort_partition_splitter": [_PP, _PP, _I, _PP, _PP, _I, _P, _I, _LL,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _PP, _P,
                                   _I, _I, _I, _P, _P],
    # keys_in, keys_out, n_planes, vals_in, vals_out, n_vals, counts, q,
    # offsets, n_out, T, K, P, sorted_run, merge_run, threads, slots, smem,
    # stream
    "tpusort_leaf_collapse": [_PP, _PP, _I, _PP, _PP, _I, _P, _I, _P, _LL,
                              _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # keys_in, keys_out, vals_in, vals_out, n_vals, T, K, P, threads,
    # slots, smem, stream
    "tpusort_sort_tiles": [_P, _P, _PP, _PP, _I, _I, _I, _I, _I, _I, _I, _P],
    # ops_in, ops_out, n_ops, n_planes, digit, counts_in, q_in, n, T, K, R,
    # S, lo_bit, width, t_seg, counts_out, stream
    "tpusort_partition_general": [_PP, _PP, _I, _I, _P, _P, _I, _LL, _I, _I,
                                  _I, _I, _I, _I, _I, _P, _P],
    # ops_in, ops_out, n_ops, counts, counts_64, offsets, n_out, nseg, seg,
    # stream
    "tpusort_collapse": [_PP, _PP, _I, _P, _I, _P, _LL, _I, _I, _P],
    # counts, counts_64, offsets, nseg, seg, stream
    "tpusort_collapse_offsets": [_P, _I, _P, _I, _I, _P],
    # ops_in, ops_out, n_ops, n_planes, counts, q, offsets, n_out, nseg, K,
    # rem_lo, rem_width, warp_run, threads, smem, stream
    "tpusort_sort_leaf_runs": [_PP, _PP, _I, _I, _P, _I, _P, _LL, _I, _I, _I,
                               _I, _I, _I, _I, _P],
    # in, out, scratch (tile aggregates, group anchors, the tile counter),
    # n, is_float, exclusive, stream
    "tpusort_prefix_sum": [_P, _P, _P, _LL, _I, _I, _P],
    # in, n, shift, bits, out, stream
    "tpusort_digit_histogram": [_P, _LL, _I, _I, _P, _P],
    # sends, d, rank, window, out, stream
    "tpusort_ring_pull": [_PP, _I, _I, _LL, _P, _P],
    # keys_in, keys_out, n_planes, vals_in, vals_out, n_vals, counts, q,
    # mask, T, K, P, sorted_run, threads, slots, smem, stream
    "tpusort_sort_tiles_valid": [_PP, _PP, _I, _PP, _PP, _I, _P, _I, _P, _I,
                                 _I, _I, _I, _I, _I, _I, _P],
    # sortkey, vals_in, vals_out, n_vals, starts, T, K, R, S, stream
    "tpusort_partition_tiles": [_P, _PP, _PP, _I, _P, _I, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
# the global sort's in-process shards are threads: one builds, and the
# counters are not lost to a thread switch between a read and its write
_LOCK = threading.Lock()


def _nvcc() -> str:
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(Path(os.environ[env]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        candidates.append(Path(shutil.which("nvcc")))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from "
        f"{CSRC} with the CUDA toolkit (set CUDA_HOME)"
    )


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link
    them into one shared library (cached by content hash); return its
    path.  Raises if nvcc fails."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    tag = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"libtpusort_torch-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{src.stem}-{tag}.{os.getpid()}.o" for src in sources]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for src, obj in zip(sources, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    failed = [(s.name, p.returncode) for s, p in zip(sources, procs)
              if p.returncode]
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(link.stdout)
        if link.returncode:
            failed.append(("link", link.returncode))
    (BUILD_DIR / "build.log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed {failed}:\n"
                           f"{''.join(logs)[-4000:]}")
    os.replace(tmp, lib)     # atomic: no process loads a half-written file
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.tpusort_error_string.argtypes = [ctypes.c_int]
            lib.tpusort_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def pointers(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (for ``void* const*``)."""
    return (ctypes.c_void_p * max(len(tensors), 1))(
        *[t.data_ptr() for t in tensors])


def count_launch(wrapper, n_planes: int, n_vals: int, *tag: str) -> None:
    """Count one kernel launch on its Python wrapper: in all
    (``wrapper.launches``) and by mode (``wrapper.modes[(key planes,
    payload words, *tag)]``; a tag names a variant of the mode)."""
    with _LOCK:
        wrapper.launches += 1
        wrapper.modes[(n_planes, n_vals, *tag)] += 1


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = library().tpusort_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
