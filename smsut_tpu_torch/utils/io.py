# -*- coding: utf-8 -*-
"""Filesystem helpers, the split-file YAML subset and the slices' PNG codec.

Port of ``smsut_tpu/utils/io.py`` on the standard library and numpy only:
the JAX package reads and writes these files through PyYAML and OpenCV.

- YAML: the block style that ``yaml.dump`` writes for split files --
  nested mappings with sorted keys, ``- `` and ``- - `` sequences, empty
  ``[]``/``{}``, plain or single-quoted strings and plain ints::

      ct:
        test:
        - '003'
        train:
        - - '001'

  Anything else raises ``ValueError``.
- PNG: 8-bit greyscale (colour type 0), non-interlaced, as ``cv2.imwrite``
  writes a 2-D uint8 array; all five row filters on read, the Sub filter on
  write (as OpenCV writes them).  Any other kind of PNG raises
  ``ValueError``.  :func:`imwrite_rgb` writes 8-bit RGB (colour type 2),
  for the pseudo phase's colour dumps, where the JAX package writes JPEGs
  through PIL.
- :func:`colorize`: a copy of the JAX package's overlay palette.
"""
from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np


def maybe_mkdir(*paths: str) -> None:
    for p in paths:
        os.makedirs(p, exist_ok=True)


def count_param_number(params: Mapping[str, Any]) -> int:
    """Number of elements over a mapping of tensors or arrays."""
    return sum(int(np.prod(tuple(v.shape))) for v in params.values())


# ---------------------------------------------------------------------------
# YAML subset
# ---------------------------------------------------------------------------

_PLAIN = re.compile(r"[A-Za-z_][A-Za-z0-9_.-]*\Z")
_DIGITS = re.compile(r"[0-9]+\Z")
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)\Z")
# the runs of digits PyYAML reads as an int (decimal, or octal after a 0)
_YAML_INT = re.compile(r"(0[0-7]*|[1-9][0-9]*)\Z")
# the words PyYAML resolves to a bool or null, so quotes as strings
_RESERVED = {w for b in ("yes", "no", "true", "false", "on", "off", "null")
             for w in (b, b.capitalize(), b.upper())}


def _scalar(v: Any) -> str:
    """An int, or a string PyYAML writes plain (a name, or digits it would
    not read as an int) or single-quoted (a name it would read as a bool or
    null, or digits it would read as an int)."""
    if isinstance(v, int) and not isinstance(v, bool):
        return str(v)
    if isinstance(v, str) and (_PLAIN.match(v) and v not in _RESERVED
                               or _DIGITS.match(v) and not _YAML_INT.match(v)):
        return v
    if isinstance(v, str) and (_PLAIN.match(v) or _DIGITS.match(v)):
        return f"'{v}'"
    raise ValueError(f"yaml subset: unsupported scalar {v!r}")


def _flow(v: Any) -> str:
    """A value written on its key's or its dash's line."""
    if isinstance(v, (dict, list)):
        if v:
            raise ValueError("yaml subset: a non-empty collection in flow")
        return "{}" if isinstance(v, dict) else "[]"
    return _scalar(v)


def _nested(v: Any) -> bool:
    return isinstance(v, (dict, list)) and bool(v)


def _block(v: Any, col: int) -> List[str]:
    """The lines of a non-empty collection whose entries start at column
    ``col``.  As ``yaml.dump`` writes them: a mapping's sequence value at
    the key's column, its mapping value two columns in; a collection item
    of a sequence starts on the dash's line."""
    pad = " " * col
    out: List[str] = []
    if isinstance(v, dict):
        for k in sorted(v):
            head = f"{pad}{_scalar(k)}:"
            if _nested(v[k]):
                out.append(head)
                out += _block(v[k], col + 2 if isinstance(v[k], dict)
                              else col)
            else:
                out.append(f"{head} {_flow(v[k])}")
    elif isinstance(v, list):
        for item in v:
            if _nested(item):
                sub = _block(item, col + 2)
                out.append(f"{pad}- {sub[0][col + 2:]}")
                out += sub[1:]
            else:
                out.append(f"{pad}- {_flow(item)}")
    else:
        raise ValueError(f"yaml subset: unsupported value {v!r}")
    return out


def dump_yaml(data: Any) -> str:
    """``data`` as ``yaml.dump(data)`` writes it, for the subset."""
    lines = _block(data, 0) if _nested(data) else [_flow(data)]
    return "\n".join(lines) + "\n"


def _parse_scalar(text: str) -> Any:
    if text == "[]":
        return []
    if text == "{}":
        return {}
    if len(text) >= 2 and text[0] == "'" and text[-1] == "'":
        body = text[1:-1]
        if _PLAIN.match(body) or _DIGITS.match(body):
            return body
        raise ValueError(f"yaml subset: unsupported quoted scalar {text!r}")
    if _INT.match(text):
        return int(text)
    if (_PLAIN.match(text) and text not in _RESERVED
            or _DIGITS.match(text) and not _YAML_INT.match(text)):
        return text
    raise ValueError(f"yaml subset: unsupported scalar {text!r}")


def _split_key(text: str) -> Tuple[str, str]:
    """``key: rest`` or ``key:`` -> (key text, rest)."""
    if text.endswith(":") and ": " not in text:
        return text[:-1], ""
    key, sep, rest = text.partition(": ")
    if not sep:
        raise ValueError(f"yaml subset: bad line {text!r}")
    return key, rest.strip()


def _tokens(text: str) -> List[Tuple[int, int, str, str, str]]:
    """(line, col, kind, key, value) per dash, key or scalar; a line's
    ``- `` markers become tokens of their own."""
    toks = []
    for n, line in enumerate(text.split("\n")):
        if not line.strip():
            continue
        body = line.lstrip(" ")
        col = len(line) - len(body)
        if "\t" in line or body.startswith(("#", "---", "...")):
            raise ValueError(f"yaml subset: unsupported line {line!r}")
        while body == "-" or body.startswith("- "):
            toks.append((n, col, "-", "", ""))
            body = body[2:].lstrip(" ")
            col = len(line) - len(body)
            if not body:
                raise ValueError(f"yaml subset: empty item in {line!r}")
        if body.endswith(":") or ": " in body:
            key, rest = _split_key(body)
            toks.append((n, col, "key", key, rest))
        else:
            toks.append((n, col, "scalar", "", body))
    return toks


def _parse(toks, p: int, line: int = -1) -> Tuple[Any, int]:
    """The node at token ``p`` -> (value, next token).  ``line`` is the
    line of the dash that owns the node, if any."""
    if p >= len(toks):
        raise ValueError("yaml subset: missing value")
    n, col, kind, _, value = toks[p]
    if kind == "scalar":
        if line >= 0 and n != line:
            raise ValueError("yaml subset: an item below its dash")
        return _parse_scalar(value), p + 1
    if kind == "-":
        out = []
        while p < len(toks) and toks[p][2] == "-" and toks[p][1] == col:
            item, p = _parse(toks, p + 1, toks[p][0])
            out.append(item)
        if p < len(toks) and toks[p][1] > col and toks[p][0] != toks[p - 1][0]:
            raise ValueError(f"yaml subset: bad indent at line {toks[p][0]}")
        return out, p
    out: Dict[Any, Any] = {}
    while p < len(toks) and toks[p][2] == "key" and toks[p][1] == col:
        _, _, _, key, rest = toks[p]
        k = _parse_scalar(key)
        if k in out or isinstance(k, (list, dict)):
            raise ValueError(f"yaml subset: bad or repeated key {key!r}")
        if rest:
            out[k], p = _parse_scalar(rest), p + 1
            continue
        nxt = toks[p + 1] if p + 1 < len(toks) else None
        if nxt is None or not (nxt[1] > col or nxt[2] == "-" and nxt[1] == col):
            raise ValueError(f"yaml subset: key {key!r} has no value")
        out[k], p = _parse(toks, p + 1)
    return out, p


def load_yaml(text: str) -> Any:
    """The value of a document of the subset."""
    toks = _tokens(text)
    value, p = _parse(toks, 0)
    if p != len(toks):
        raise ValueError(f"yaml subset: unparsed text at line {toks[p][0]}")
    return value


def read_yaml(path: str) -> Any:
    with open(path, "r") as f:
        return load_yaml(f.read())


def write_yaml(data: Any, path: str) -> None:
    text = dump_yaml(data)
    with open(path, "w") as f:
        f.write(text)


# ---------------------------------------------------------------------------
# PNG, 8-bit greyscale
# ---------------------------------------------------------------------------

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def imwrite_gray(path: str, img: np.ndarray) -> bool:
    """Write a 2-D uint8 array as an 8-bit greyscale PNG (Sub filter on
    every row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2 or 0 in img.shape:
        raise ValueError(f"imwrite_gray: expected a 2-D uint8 image, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape
    rows = np.empty((h, w + 1), np.uint8)
    rows[:, 0] = 1
    rows[:, 1] = img[:, 0]
    rows[:, 2:] = img[:, 1:] - img[:, :-1]      # wraps mod 256
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    data = (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
    return True


def imwrite_rgb(path: str, img: np.ndarray) -> bool:
    """Write an [H, W, 3] uint8 array as an 8-bit RGB PNG (Sub filter on
    every row, over the pixel to the left)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 \
            or 0 in img.shape:
        raise ValueError(f"imwrite_rgb: expected an [H, W, 3] uint8 image, "
                         f"got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    flat = img.reshape(h, 3 * w)
    rows = np.empty((h, 3 * w + 1), np.uint8)
    rows[:, 0] = 1
    rows[:, 1:4] = flat[:, :3]
    rows[:, 4:] = flat[:, 3:] - flat[:, :-3]      # wraps mod 256
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    data = (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
    return True


def colorize(mask: np.ndarray) -> np.ndarray:
    """The overlay palette of label maps: float64 [H, W, 3], red, green,
    blue and yellow for labels 1-4, black elsewhere."""
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0)]
    h, w = mask.shape
    color_img = np.zeros((h, w, 3))
    for i in range(1, 5):
        color_img[mask == i, :] = colors[i - 1][:]
    return color_img


def _unfilter_loop(kind: int, filt: np.ndarray, prior: np.ndarray
                   ) -> np.ndarray:
    """Average (3) and Paeth (4): each byte depends on the one before it."""
    f, up = filt.tolist(), prior.tolist()
    out = [0] * len(f)
    left = upleft = 0
    for x, (v, b) in enumerate(zip(f, up)):
        if kind == 3:
            r = (v + ((left + b) >> 1)) & 255
        else:
            p = left + b - upleft
            pa, pb, pc = abs(p - left), abs(p - b), abs(p - upleft)
            pred = left if pa <= pb and pa <= pc else (b if pb <= pc
                                                       else upleft)
            r = (v + pred) & 255
        out[x] = r
        left, upleft = r, b
    return np.asarray(out, np.uint8)


def imread_gray(path: str) -> np.ndarray:
    """Read an 8-bit greyscale, non-interlaced PNG as a 2-D uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated PNG")
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad PNG chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif not kind[:1].islower():   # an unknown critical chunk (PLTE ...)
            raise ValueError(f"{path}: unsupported PNG chunk {kind!r}")
    if header is None or header[2:] != (8, 0, 0, 0, 0):
        raise ValueError(f"{path}: only 8-bit greyscale non-interlaced PNGs "
                         f"are supported (IHDR {header})")
    w, h = header[:2]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{h}x{w}")
    rows = raw.reshape(h, w + 1)
    img = np.empty((h, w), np.uint8)
    prior = np.zeros(w, np.uint8)
    for y in range(h):
        kind, filt = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            img[y] = filt
        elif kind == 1:
            img[y] = np.cumsum(filt, dtype=np.uint8)
        elif kind == 2:
            img[y] = filt + prior
        elif kind in (3, 4):
            img[y] = _unfilter_loop(kind, filt, prior)
        else:
            raise ValueError(f"{path}: bad PNG row filter {kind}")
        prior = img[y]
    return img
