# -*- coding: utf-8 -*-
"""Minimal DICOM reader (numpy and the standard library) for uncompressed
CT and MR series: a copy of ``smsut_tpu/preprocess/dicom_lite.py``, in
place of SimpleITK's ``ImageSeriesReader`` in the CHAOS preparation.  It
reads the transfer syntaxes the challenge data uses: Implicit VR Little
Endian (1.2.840.10008.1.2) and Explicit VR Little Endian
(1.2.840.10008.1.2.1).  A compressed syntax raises.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from smsut_tpu_torch.preprocess.niftio import Volume

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC",
                      b"UR", b"UT", b"UN"}

TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_PIXEL_SPACING = (0x0028, 0x0030)
TAG_SLICE_THICKNESS = (0x0018, 0x0050)
TAG_IPP = (0x0020, 0x0032)
TAG_INSTANCE = (0x0020, 0x0013)
TAG_BITS_ALLOC = (0x0028, 0x0100)
TAG_PIXEL_REP = (0x0028, 0x0103)
TAG_RESCALE_INTERCEPT = (0x0028, 0x1052)
TAG_RESCALE_SLOPE = (0x0028, 0x1053)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)

_SUPPORTED_TS = ("1.2.840.10008.1.2", "1.2.840.10008.1.2.1")


def _parse_elements(buf: bytes, start: int, explicit: bool,
                    wanted: set) -> Dict[Tuple[int, int], bytes]:
    """Single linear pass; stops after PixelData."""
    out: Dict[Tuple[int, int], bytes] = {}
    pos, n = start, len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        tag = (group, elem)
        pos += 4
        if explicit and group != 0xFFFE:
            vr = buf[pos:pos + 2]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", buf, pos + 2)[0]
                pos += 4
        else:
            vr = b"??"
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4

        if length == 0xFFFFFFFF:
            # undefined length (sequence) — skip by scanning for the matching
            # sequence delimiter (FFFE,E0DD)
            depth = 1
            while pos + 8 <= n and depth:
                g, e = struct.unpack_from("<HH", buf, pos)
                ln = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
                if (g, e) == (0xFFFE, 0xE0DD):
                    depth -= 1
                elif ln != 0xFFFFFFFF and (g, e) != (0xFFFE, 0xE000):
                    pos += ln
            continue

        if tag in wanted:
            out[tag] = buf[pos:pos + length]
        pos += length
        if tag == TAG_PIXEL_DATA:
            break
    return out


def read_dicom(path: str) -> Dict:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[128:132] != b"DICM":
        raise ValueError(f"not a part-10 DICOM file: {path}")
    # file meta group: always explicit VR little endian
    meta = _parse_elements(buf, 132, True, {TAG_TRANSFER_SYNTAX})
    ts = meta.get(TAG_TRANSFER_SYNTAX, b"1.2.840.10008.1.2.1")
    ts = ts.decode("ascii", "ignore").strip("\x00 ")
    if ts not in _SUPPORTED_TS:
        raise NotImplementedError(f"unsupported transfer syntax {ts} ({path})")
    explicit = ts == "1.2.840.10008.1.2.1"

    # skip remaining meta elements (group 0002) to find dataset start
    pos = 132
    while pos + 8 <= len(buf):
        group = struct.unpack_from("<H", buf, pos)[0]
        if group != 0x0002:
            break
        vr = buf[pos + 4:pos + 6]
        if vr in _EXPLICIT_LONG_VRS:
            length = struct.unpack_from("<I", buf, pos + 8)[0]
            pos += 12 + length
        else:
            length = struct.unpack_from("<H", buf, pos + 6)[0]
            pos += 8 + length

    wanted = {TAG_ROWS, TAG_COLS, TAG_PIXEL_SPACING, TAG_SLICE_THICKNESS,
              TAG_IPP, TAG_INSTANCE, TAG_BITS_ALLOC, TAG_PIXEL_REP,
              TAG_RESCALE_INTERCEPT, TAG_RESCALE_SLOPE, TAG_PIXEL_DATA}
    el = _parse_elements(buf, pos, explicit, wanted)

    rows = struct.unpack("<H", el[TAG_ROWS])[0]
    cols = struct.unpack("<H", el[TAG_COLS])[0]
    bits = struct.unpack("<H", el.get(TAG_BITS_ALLOC, b"\x10\x00"))[0]
    signed = struct.unpack("<H", el.get(TAG_PIXEL_REP, b"\x00\x00"))[0] == 1
    dtype = {8: np.int8 if signed else np.uint8,
             16: np.int16 if signed else np.uint16}[bits]
    pixels = np.frombuffer(el[TAG_PIXEL_DATA], dtype=dtype,
                           count=rows * cols).reshape(rows, cols)

    def _floats(tag, default):
        if tag not in el:
            return default
        return [float(x) for x in el[tag].decode("ascii", "ignore")
                .strip("\x00 ").split("\\") if x]

    slope = _floats(TAG_RESCALE_SLOPE, [1.0])[0]
    inter = _floats(TAG_RESCALE_INTERCEPT, [0.0])[0]
    data = pixels.astype(np.float32) * slope + inter

    return {
        "pixels": data,
        "spacing_rc": _floats(TAG_PIXEL_SPACING, [1.0, 1.0]),  # row, col
        "thickness": _floats(TAG_SLICE_THICKNESS, [1.0])[0],
        "ipp": _floats(TAG_IPP, [0.0, 0.0, 0.0]),
        "instance": int(el.get(TAG_INSTANCE, b"0").decode("ascii", "ignore")
                        .strip("\x00 ") or 0),
    }


def read_dicom_series(directory: str) -> Volume:
    """Read an uncompressed single-frame series, sorted along the normal
    (ImagePositionPatient z, falling back to InstanceNumber)."""
    files = sorted(os.path.join(directory, f) for f in os.listdir(directory)
                   if not f.startswith("."))
    slices = [read_dicom(f) for f in files if os.path.isfile(f)]
    if not slices:
        raise FileNotFoundError(f"no DICOM slices in {directory}")
    if len({s["ipp"][2] for s in slices}) == len(slices):
        slices.sort(key=lambda s: s["ipp"][2])
    else:
        slices.sort(key=lambda s: s["instance"])
    data = np.stack([s["pixels"] for s in slices])
    rc = slices[0]["spacing_rc"]
    if len(slices) > 1:
        dz = abs(slices[1]["ipp"][2] - slices[0]["ipp"][2]) or slices[0]["thickness"]
    else:
        dz = slices[0]["thickness"]
    # spacing is (x, y, z) = (col spacing, row spacing, slice gap)
    return Volume(data, (rc[1], rc[0], dz))
