"""ctypes bindings for the port's native host-IO library
(``csrc/pd_io.cpp``; port of ``pd_fusion/imaging/native.py``).

The library is built with ``g++`` at first use into ``build/host/``,
keyed on a hash of the source, the flags and the compiler's view of the
host CPU (``-march=native`` code built on one machine must not be loaded
on another). The build tries libdeflate for gzip first and zlib second,
as ``native/build.sh`` does; ``build_info()`` says which one was linked.

There is no silent fallback: when the build or the load fails, or a call
returns an error code, these functions raise. The numpy mirrors in
``imaging/pipeline.py`` run only on explicit request, through
``PD_FUSION_NO_NATIVE=1`` (the JAX package's switch; ``disabled()``).
"""
import ctypes
import hashlib
import json
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from pd_fusion_torch.paths import HOST_BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "pd_io.cpp"
NO_NATIVE_ENV = "PD_FUSION_NO_NATIVE"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
# (name, extra flags before the source, libraries after it), tried in order
INFLATE_VARIANTS = (
    ("libdeflate", ("-DPD_HAVE_LIBDEFLATE",), ("-lz", "-ldeflate")),
    ("zlib", (), ("-lz",)),
)
ERRORS = {
    1: "cannot open or inflate the file", 2: "truncated header", 3: "not NIfTI-1",
    4: "bad NIfTI magic", 5: "bad ndim", 6: "too many voxels or a true 4-D volume",
    7: "unsupported datatype", 8: "truncated voxel data", 9: "bad vox_offset",
    10: "allocation failed", 11: "the file changed between two reads",
}

_lock = threading.Lock()
_loaded: Dict[str, object] = {}


class NativeError(RuntimeError):
    """A build, load or call of the native library failed."""


def disabled() -> bool:
    """``PD_FUSION_NO_NATIVE`` is set: callers take the numpy mirrors."""
    return bool(os.environ.get(NO_NATIVE_ENV))


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _target_key() -> str:
    """The compiler's predefined macros under ``-march=native``: its
    version and the host's instruction sets, which decide the code."""
    proc = subprocess.run([_cxx(), "-march=native", "-E", "-dM", "-x", "c++", "-"],
                          input="", capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeError(f"{_cxx()} cannot compile for this host:\n{proc.stderr}")
    return "".join(sorted(proc.stdout.splitlines(keepends=True)))


def build_library(source: Path = SOURCE) -> Path:
    """Compile ``source`` into ``build/host/`` unless a library built from
    the same source, flags and host target is there. Writes ``<lib>.json``
    beside it: the inflate library linked and the build's seconds."""
    key = source.read_bytes() + " ".join(CXX_FLAGS).encode() + _target_key().encode()
    out = HOST_BUILD_DIR / f"{source.stem}_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if out.exists():
        return out
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    failures = []
    t0 = time.perf_counter()
    for name, defines, libs in INFLATE_VARIANTS:
        cmd = [_cxx(), *CXX_FLAGS, *defines, str(source), *libs, "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            info = {"inflate": name, "build_s": time.perf_counter() - t0, "command": cmd}
            # both renames are atomic: a concurrent builder never reads a partial file
            tmp.with_suffix(".json").write_text(json.dumps(info))
            os.replace(tmp.with_suffix(".json"), out.with_suffix(".json"))
            os.replace(tmp, out)
            return out
        failures.append(f"{' '.join(cmd)}\n{proc.stderr[-2000:]}")
    raise NativeError("building the native IO library failed with every inflate "
                      "library:\n" + "\n".join(failures))


def build_info() -> dict:
    """Where the loaded library is, which inflate it linked, the seconds
    its build took (when it was built, maybe by another process) and the
    seconds this process took to get it loaded."""
    library()
    return dict(_loaded["info"])


def library() -> ctypes.CDLL:
    """The loaded library with its argument types (built at first use)."""
    with _lock:
        if "lib" in _loaded:
            return _loaded["lib"]
        t0 = time.perf_counter()
        path = build_library()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeError(f"loading {path} failed: {e}") from e
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.pd_read_nifti.restype = ctypes.c_int
        lib.pd_read_nifti.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64), ptr]
        lib.pd_resize3d.restype = None
        lib.pd_resize3d.argtypes = [ptr, i64, i64, i64, ptr, i64, i64, i64, ctypes.c_int]
        lib.pd_read_resize_nifti.restype = ctypes.c_int
        lib.pd_read_resize_nifti.argtypes = [ctypes.c_char_p, i64, i64, i64, ptr, ctypes.c_int]
        for fn in (lib.pd_prep_slices, lib.pd_prep_slices_f16):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, i64, i64, i64, ctypes.POINTER(i64),
                           ctypes.POINTER(i64), ctypes.c_int, ptr, ctypes.c_int]
        info = json.loads(path.with_suffix(".json").read_text())
        _loaded["info"] = {"path": str(path), "inflate": info["inflate"],
                           "build_s": info["build_s"],
                           "load_s": time.perf_counter() - t0}
        _loaded["lib"] = lib
        return lib


def _check(rc: int, what: str, path) -> None:
    if rc != 0:
        raise NativeError(f"{what}({path}): error {rc} ({ERRORS.get(rc, 'unknown')})")


def read_nifti_native(path) -> np.ndarray:
    """Native NIfTI read -> float32 [x, y, z] (scaled, NaN/Inf -> 0)."""
    lib = library()
    dims = (ctypes.c_int64 * 3)()
    _check(lib.pd_read_nifti(str(path).encode(), dims, None), "pd_read_nifti", path)
    shape = (dims[0], dims[1], dims[2])
    buf = np.empty(int(np.prod(shape)), np.float32)
    _check(lib.pd_read_nifti(str(path).encode(), dims, buf.ctypes.data), "pd_read_nifti", path)
    # the Fortran voxel buffer is the C-order array of reversed dims
    return buf.reshape(shape, order="F")


def read_resize_nifti_native(path, target_shape: Tuple[int, int, int],
                             n_threads: int = 4) -> np.ndarray:
    """Fused native read + align-corners trilinear resize -> [t0, t1, t2]."""
    t0, t1, t2 = (int(t) for t in target_shape)
    out = np.empty(t0 * t1 * t2, np.float32)
    rc = library().pd_read_resize_nifti(str(path).encode(), t0, t1, t2, out.ctypes.data,
                                        n_threads)
    _check(rc, "pd_read_resize_nifti", path)
    return out.reshape((t0, t1, t2), order="F")


def resize3d_native(vol: np.ndarray, target_shape: Tuple[int, int, int],
                    n_threads: int = 4) -> np.ndarray:
    """Align-corners trilinear resize of a C-order float32 volume."""
    vol = np.ascontiguousarray(vol, np.float32)
    t0, t1, t2 = (int(t) for t in target_shape)
    out = np.empty((t0, t1, t2), np.float32)
    library().pd_resize3d(vol.ctypes.data, *vol.shape, out.ctypes.data, t0, t1, t2, n_threads)
    return out


def prep_slices_native(path, target_shape, axes, counts, n_threads: int = 2,
                       out_dtype=np.float32) -> np.ndarray:
    """The whole host prep of the embed path in one call: read + resize +
    1-99% percentile normalize + multi-axis slice gather -> [sum(counts),
    h, w]. float32 mirrors ``pipeline.normalize_volume_host`` and
    ``select_slices_host``; float16 is binary16 written by the gather
    itself, bitwise equal to the float32 output's ``astype(np.float16)``.
    Several axes need a cubic target."""
    t0, t1, t2 = (int(t) for t in target_shape)
    if len(axes) > 1 and not t0 == t1 == t2:
        raise ValueError(f"multi-axis slice selection needs a cubic target, got {target_shape}")
    f16 = np.dtype(out_dtype) == np.float16
    if not f16 and np.dtype(out_dtype) != np.float32:
        raise ValueError(f"prep_slices_native writes float32 or float16, not {out_dtype}")
    axes_arr = (ctypes.c_int64 * len(axes))(*[int(a) for a in axes])
    counts_arr = (ctypes.c_int64 * len(counts))(*[int(c) for c in counts])
    h, w = {0: (t1, t2), 1: (t0, t2), 2: (t0, t1)}[int(axes[0])]
    total = sum(int(c) for c in counts)
    out = np.empty((total, h, w), np.float16 if f16 else np.float32)
    lib = library()
    fn = lib.pd_prep_slices_f16 if f16 else lib.pd_prep_slices
    rc = fn(str(path).encode(), t0, t1, t2, axes_arr, counts_arr, len(axes), out.ctypes.data,
            n_threads)
    _check(rc, fn.__name__, path)
    return out
