# -*- coding: utf-8 -*-
"""Minimal NIfTI-1 reader and writer on numpy and the standard library's
gzip: a copy of ``smsut_tpu/preprocess/niftio.py``.  The preparation needs
axis-aligned volumes with their spacing only.

Convention: ``Volume.data`` is a [z, y, x] array (the layout SimpleITK's
``GetArrayFromImage`` returns); ``Volume.spacing`` is (sx, sy, sz) in mm.
"""
from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class Volume:
    data: np.ndarray                    # [z, y, x]
    spacing: Tuple[float, float, float]  # (sx, sy, sz)

    @property
    def size(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) — sitk-style size ordering."""
        nz, ny, nx = self.data.shape
        return nx, ny, nz


def read_nifti(path: str) -> Volume:
    raw = _read_bytes(path)
    if len(raw) < 352:
        raise ValueError(f"not a NIfTI-1 file: {path}")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != 348:
        raise ValueError(f"unsupported NIfTI header (sizeof_hdr={sizeof_hdr})")
    dim = struct.unpack_from("<8h", raw, 40)
    datatype = struct.unpack_from("<h", raw, 70)[0]
    pixdim = struct.unpack_from("<8f", raw, 76)
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0])
    scl_slope = struct.unpack_from("<f", raw, 112)[0]
    scl_inter = struct.unpack_from("<f", raw, 116)[0]
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"bad NIfTI magic {magic!r}")

    ndim = dim[0]
    if ndim < 3:
        nx, ny, nz = dim[1], dim[2] if ndim > 1 else 1, 1
    else:
        nx, ny, nz = dim[1], dim[2], dim[3]
    dtype = _DTYPES.get(datatype)
    if dtype is None:
        raise ValueError(f"unsupported NIfTI datatype {datatype}")
    count = nx * ny * nz
    data = np.frombuffer(raw, dtype=dtype, count=count,
                         offset=vox_offset).reshape(nz, ny, nx).copy()
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        data = data.astype(np.float32) * (scl_slope or 1.0) + scl_inter
    return Volume(data, (float(pixdim[1]), float(pixdim[2]), float(pixdim[3])))


def write_nifti(vol: Volume, path: str) -> None:
    data = np.ascontiguousarray(vol.data)
    code = _CODES.get(data.dtype)
    if code is None:
        data = data.astype(np.float32)
        code = 16
    nz, ny, nx = data.shape
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)   # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, vol.spacing[0], vol.spacing[1],
                     vol.spacing[2], 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)                    # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                      # scl_slope
    struct.pack_into("<h", hdr, 252, 1)                        # sform_code
    # srow: axis-aligned affine from spacing
    struct.pack_into("<4f", hdr, 280, -vol.spacing[0], 0, 0, 0)
    struct.pack_into("<4f", hdr, 296, 0, -vol.spacing[1], 0, 0)
    struct.pack_into("<4f", hdr, 312, 0, 0, vol.spacing[2], 0)
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + data.tobytes()
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=6) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            return gzip.decompress(f.read())
        return f.read()
