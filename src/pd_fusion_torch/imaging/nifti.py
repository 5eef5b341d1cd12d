"""Minimal NIfTI-1 reader/writer in numpy (own copy of
``pd_fusion/imaging/nifti.py``).

Scope: uncompressed ``.nii`` and gzipped ``.nii.gz`` single-file NIfTI-1,
the common datatypes, with ``scl_slope``/``scl_inter`` scaling: the T1w
brain volumes the embed path reads. Data returns in Fortran (x-fastest)
axis order as float32, NaN/Inf set to 0, as the JAX package's reader
gives it. Unlike that reader, this one never tries ``nibabel``.

``write_nifti`` takes ``scl_slope``/``scl_inter`` and a gzip
``compresslevel`` beyond the JAX package's writer, so that scaled int16
volumes (as scanners write them) can be made for tests and smoke runs.
"""
import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}

_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open_maybe_gz(path: Path):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_nifti(path) -> np.ndarray:
    """Read a NIfTI-1 volume -> float32 array (scaled, NaN/Inf -> 0)."""
    path = Path(path)
    with _open_maybe_gz(path) as f:
        header = f.read(348)
        if len(header) < 348:
            raise ValueError(f"Truncated NIfTI header in {path}")
        sizeof_hdr = struct.unpack("<i", header[0:4])[0]
        endian = "<"
        if sizeof_hdr != 348:
            sizeof_hdr_be = struct.unpack(">i", header[0:4])[0]
            if sizeof_hdr_be == 348:
                endian = ">"
            else:
                raise ValueError(f"Not a NIfTI-1 file: {path}")

        magic = header[344:348]
        if magic[:3] not in (b"n+1", b"ni1"):
            raise ValueError(f"Bad NIfTI magic in {path}: {magic!r}")

        dim = struct.unpack(endian + "8h", header[40:56])
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1 : 1 + max(ndim, 1)])
        datatype = struct.unpack(endian + "h", header[70:72])[0]
        vox_offset = struct.unpack(endian + "f", header[108:112])[0]
        scl_slope = struct.unpack(endian + "f", header[112:116])[0]
        scl_inter = struct.unpack(endian + "f", header[116:120])[0]

        if datatype not in _DTYPES:
            raise ValueError(f"Unsupported NIfTI datatype {datatype} in {path}")
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

        # skip to the data (vox_offset counts from file start)
        to_skip = int(vox_offset) - 348
        if to_skip > 0:
            f.read(to_skip)
        count = int(np.prod(shape))
        raw = f.read(count * dtype.itemsize)
        data = np.frombuffer(raw, dtype=dtype, count=count)

    data = data.reshape(shape, order="F").astype(np.float32)
    if scl_slope not in (0.0, 1.0) and np.isfinite(scl_slope):
        data = data * scl_slope + scl_inter
    elif scl_inter not in (0.0,) and np.isfinite(scl_inter) and scl_slope == 1.0:
        data = data + scl_inter
    return np.nan_to_num(data, nan=0.0, posinf=0.0, neginf=0.0)


def write_nifti(path, data: np.ndarray, gzipped=None, scl_slope: float = 1.0,
                scl_inter: float = 0.0, compresslevel: int = 9):
    """Write a minimal single-file NIfTI-1. ``gzipped`` defaults to the
    path ending in ``.gz``; readers scale the stored values as
    ``stored * scl_slope + scl_inter``."""
    path = Path(path)
    data = np.asarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[data.dtype]

    header = bytearray(348)
    struct.pack_into("<i", header, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, code)
    struct.pack_into("<h", header, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, scl_slope)
    struct.pack_into("<f", header, 116, scl_inter)
    # pixdim must be nonzero for some tools
    struct.pack_into("<8f", header, 76, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    header[344:348] = b"n+1\x00"

    payload = bytes(header) + b"\x00\x00\x00\x00" + data.tobytes(order="F")
    if gzipped is None:
        gzipped = str(path).endswith(".gz")
    if gzipped:
        with gzip.open(path, "wb", compresslevel=compresslevel) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
