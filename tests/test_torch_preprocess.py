# -*- coding: utf-8 -*-
"""The port's preparation (smsut_tpu_torch/preprocess/,
smsut_tpu_torch/data_pprocess/) against the JAX package's on the same
synthetic NIfTI and DICOM files, written here (the DICOM writer of
tests/test_preprocess.py): the NIfTI round trip and header fields, the
DICOM series' order and spacing (explicit and implicit VR), the resample
and crop of images and labels, the label maps, the PNG slice tree
(decoded pixels: the two PNG encoders compress differently) with its label
``.npy`` files, and the split YAML, all bit for bit; each CLI through a
subprocess on a tree of 3 patients x 8 slices of 64x64 against the JAX
package's CLI; and the port's PNG reader on OpenCV-written PNGs of every
row filter, and its refusal of palette and RGB PNGs."""
import gzip
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml

from smsut_tpu.config import Config as JConfig
from smsut_tpu.preprocess import atlas as jatlas
from smsut_tpu.preprocess import chaos as jchaos
from smsut_tpu.preprocess import dicom_lite as jdicom
from smsut_tpu.preprocess import niftio as jnifti
from smsut_tpu.preprocess import resample as jresample
from smsut_tpu.preprocess import to_png_and_split as jpng
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.preprocess import atlas, chaos, dicom_lite, niftio
from smsut_tpu_torch.preprocess import resample, to_png_and_split
from smsut_tpu_torch.utils.io import imread_gray
from test_preprocess import _write_fake_dicom

REPO = Path(__file__).resolve().parents[1]
N_PATIENTS, N_SLICE, SIZE, CROP = 3, 8, 64, 48
# in-plane spacing 1.2 mm -> int(64 * 1.2 / 1.5) = 51 pixels, cropped to
# 48; slice gap 4 mm -> int(8 * 4 / 5) = 6 slices
SPACING = (1.2, 1.2, 4.0)
# CHAOS's ground-truth grey levels of liver, kidneys and spleen
GROUND = (63, 126, 189, 252)
FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
           "sub": cv2.IMWRITE_PNG_FILTER_SUB,
           "up": cv2.IMWRITE_PNG_FILTER_UP,
           "avg": cv2.IMWRITE_PNG_FILTER_AVG,
           "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
           "all": cv2.IMWRITE_PNG_ALL_FILTERS}


def organs(rng, n: int, size: int, values) -> np.ndarray:
    """[n, size, size] uint8: four discs of ``values`` in each of the
    middle slices, background 0 in the first and last."""
    yy, xx = np.mgrid[0:size, 0:size]
    out = np.zeros((n, size, size), np.uint8)
    for z in range(1, n - 1):
        for v in values:
            cy, cx = rng.uniform(0.25, 0.75, 2) * size
            r = rng.uniform(0.06, 0.15) * size
            out[z][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = v
    return out


def write_btcv(root: Path, rng) -> None:
    """BTCV's layout: Training/img/img000{p}.nii.gz and
    Training/label/label000{p}.nii.gz, int16 CT and BTCV label ids."""
    for sub in ("img", "label"):
        (root / "Training" / sub).mkdir(parents=True)
    for p in range(1, N_PATIENTS + 1):
        lab = organs(rng, N_SLICE, SIZE, (6, 2, 3, 1))
        img = (lab * 40.0 - 900 + rng.normal(0, 60, lab.shape)).astype(
            np.int16)
        jnifti.write_nifti(jnifti.Volume(img, SPACING),
                           str(root / "Training" / "img" /
                               f"img000{p}.nii.gz"))
        jnifti.write_nifti(jnifti.Volume(lab, SPACING),
                           str(root / "Training" / "label" /
                               f"label000{p}.nii.gz"))


def write_chaos(root: Path, rng, filt: int, explicit: bool = True) -> None:
    """CHAOS's layout: MR/{pid}/T1DUAL/DICOM_anon/{InPhase,OutPhase} and
    MR/{pid}/T2SPIR/DICOM_anon DICOM series (files named against their
    slice order), each study's Ground PNGs written by OpenCV with the row
    filter ``filt``."""
    for p in (1, 2, 5)[:N_PATIENTS]:
        pid = root / "MR" / str(p)
        for study, series in (("T1DUAL", ("InPhase", "OutPhase")),
                              ("T2SPIR", ("",))):
            lab = organs(rng, N_SLICE, SIZE, GROUND)
            (pid / study / "Ground").mkdir(parents=True)
            for z in range(N_SLICE):
                cv2.imwrite(str(pid / study / "Ground" /
                                f"IMG-0001-{z + 1:05d}.png"), lab[z],
                            [cv2.IMWRITE_PNG_FILTER, filt])
            for s in series:
                d = pid / study / "DICOM_anon" / s
                d.mkdir(parents=True)
                for z in range(N_SLICE):
                    px = (lab[z] * 3.0 + rng.normal(200, 30, lab[z].shape)
                          ).astype(np.int16)
                    _write_fake_dicom(str(d / f"IMG-{N_SLICE - z:05d}.dcm"),
                                      px, ipp_z=z * SPACING[2],
                                      instance=z + 1, spacing=SPACING[:2],
                                      explicit=explicit)


def payload(path: str) -> bytes:
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw) if raw[:2] == b"\x1f\x8b" else raw


def same_tree(a: Path, b: Path) -> int:
    """Both trees hold the same files: nii.gz payloads and .npy bytes
    equal, PNGs equal in decoded pixels, YAML equal parsed; the number of
    files compared."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for rel in fa:
        x, y = a / rel, b / rel
        if rel.suffix == ".png":
            px, py = (cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
                      for p in (x, y))
            assert px.dtype == py.dtype == np.uint8 and px.ndim == 2, rel
            np.testing.assert_array_equal(px, py, err_msg=str(rel))
        elif rel.suffix == ".yaml":
            assert yaml.safe_load(x.read_text()) == \
                yaml.safe_load(y.read_text()), rel
        elif rel.suffix == ".gz":
            assert payload(str(x)) == payload(str(y)), rel
        else:
            assert x.read_bytes() == y.read_bytes(), rel
    return len(fa)


# ------------------------------------------------------------------ modules

@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16,
                                   np.int8, np.float64])
@pytest.mark.parametrize("gz", [False, True])
def test_nifti_round_trip_and_header(tmp_path, dtype, gz):
    """The port writes what the JAX package writes (payload, header
    included) and reads back what either wrote: data, spacing, size."""
    rng = np.random.default_rng(1)
    vol = niftio.Volume((rng.random((5, 12, 10)) * 100).astype(dtype),
                        (1.5, 2.0, 5.0))
    ext = ".nii.gz" if gz else ".nii"
    mine, theirs = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
    niftio.write_nifti(vol, mine)
    jnifti.write_nifti(jnifti.Volume(vol.data, vol.spacing), theirs)
    assert payload(mine) == payload(theirs)
    hdr = payload(mine)[:352]
    assert struct.unpack_from("<i", hdr, 0)[0] == 348
    assert struct.unpack_from("<8h", hdr, 40)[:4] == (3, 10, 12, 5)
    for path in (mine, theirs):
        back = niftio.read_nifti(path)
        assert back.data.dtype == dtype
        np.testing.assert_array_equal(back.data, vol.data)
        assert back.spacing == pytest.approx((1.5, 2.0, 5.0))
        assert back.size == (10, 12, 5)


@pytest.mark.parametrize("explicit", [True, False])
def test_dicom_series_order_and_spacing(tmp_path, explicit):
    """A series whose file names run against its slice positions: the
    port's volume (sorted by ImagePositionPatient z) and spacing equal the
    JAX package's, bit for bit; one file's fields too."""
    rng = np.random.default_rng(2)
    for z in range(4):
        _write_fake_dicom(str(tmp_path / f"s{3 - z}.dcm"),
                          (rng.random((6, 8)) * 1000).astype(np.int16),
                          ipp_z=z * 5.0, instance=z + 1, explicit=explicit,
                          slope=2.0, inter=-10.0)
    got = dicom_lite.read_dicom_series(str(tmp_path))
    want = jdicom.read_dicom_series(str(tmp_path))
    assert got.data.dtype == want.data.dtype
    np.testing.assert_array_equal(got.data, want.data)
    assert got.spacing == want.spacing == pytest.approx((0.8, 1.2, 5.0))
    one = str(tmp_path / "s0.dcm")
    a, b = dicom_lite.read_dicom(one), jdicom.read_dicom(one)
    np.testing.assert_array_equal(a.pop("pixels"), b.pop("pixels"))
    assert a == b


@pytest.mark.parametrize("is_label", [False, True])
@pytest.mark.parametrize("spacing, crop", [((2.0, 2.0, 5.0), 32),
                                           ((1.2, 0.9, 3.0), 40),
                                           ((1.0, 1.0, 5.0), 32)])
def test_resample_and_crop_bit_equal(is_label, spacing, crop):
    rng = np.random.default_rng(3)
    data = (rng.integers(0, 5, (4, 40, 30)).astype(np.uint8) if is_label
            else rng.random((4, 40, 30)).astype(np.float32) * 500)
    got = resample.resample_and_crop(niftio.Volume(data, spacing),
                                     (1.5, 1.5, 5.0), crop, is_label)
    want = jresample.resample_and_crop(jnifti.Volume(data, spacing),
                                       (1.5, 1.5, 5.0), crop, is_label)
    assert got.data.dtype == want.data.dtype
    assert got.data.shape[1:] == (crop, crop)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.spacing == want.spacing


def test_label_maps_match_jax():
    """``remap_labels`` (BTCV ids) and ``decode_label_png`` (CHAOS grey
    windows) over every uint8 value."""
    v = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for mine, theirs in ((atlas.remap_labels, jatlas.remap_labels),
                         (chaos.decode_label_png, jchaos.decode_label_png)):
        got, want = mine(v), theirs(v)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_to_png_and_split_match_jax(tmp_path):
    """``to_png`` on a CT and an MR tree of 4 patients: the PNG pixels and
    label ``.npy`` bytes equal the JAX package's (OpenCV-written) ones; the
    split YAML parses equal and the port reads the JAX package's."""
    from smsut_tpu_torch.data.split import load_split

    rng = np.random.default_rng(4)
    src = tmp_path / "nii"
    for modality, lo, hi in (("ct", -1200, 600), ("t2", 0, 900)):
        for sub in ("images", "labels"):
            (src / modality / sub).mkdir(parents=True)
        for p in range(4):
            pid = f"{p + 1:03d}"
            img = (rng.random((3, 16, 16)) * (hi - lo) + lo).astype(
                np.float32)
            lbl = rng.integers(0, 5, (3, 16, 16)).astype(np.uint8)
            for sub, a in (("images", img), ("labels", lbl)):
                niftio.write_nifti(niftio.Volume(a, (1.5, 1.5, 5.0)), str(
                    src / modality / sub / f"{modality}_{pid}.nii.gz"))
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    to_png_and_split.to_png(str(src), str(mine))
    jpng.to_png(str(src), str(theirs))
    got = to_png_and_split.split_train_val_test(str(mine), str(mine),
                                                Config())
    want = jpng.split_train_val_test(str(theirs), str(theirs), JConfig())
    assert got == want
    assert same_tree(mine, theirs) == 2 * 4 * (1 + 2 * 3) + 1
    assert load_split(str(theirs / Config().split_yaml)) == want


@pytest.mark.parametrize("name", list(FILTERS))
def test_imread_gray_reads_opencv_pngs(tmp_path, name):
    """OpenCV-written 8-bit greyscale PNGs of each row filter (and
    libpng's adaptive choice among all five) decode to the pixels
    written, as OpenCV reads them."""
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:37, 0:53]
    img = (np.sin(yy / 5.0) * np.cos(xx / 7.0) * 100 + 128
           + rng.integers(0, 9, yy.shape)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, FILTERS[name]])
    got = imread_gray(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, cv2.imread(path,
                                                  cv2.IMREAD_GRAYSCALE))


def _palette_png(path: Path) -> None:
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = b"".join(b"\x00" + bytes([i % 4] * 8) for i in range(8))
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 8, 8, 3, 0,
                                                  0, 0))
                     + chunk(b"PLTE", bytes(range(12)))
                     + chunk(b"IDAT", zlib.compress(rows))
                     + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["palette", "rgb", "grey16"])
def test_imread_gray_refuses_other_pngs(tmp_path, kind):
    """A palette, RGB or 16-bit PNG raises with its file's name, where
    OpenCV's IMREAD_GRAYSCALE would convert it; so does the CHAOS
    preparation that meets one among its ground-truth PNGs."""
    path = tmp_path / f"{kind}.png"
    if kind == "palette":
        _palette_png(path)
    elif kind == "rgb":
        cv2.imwrite(str(path), np.zeros((8, 8, 3), np.uint8))
    else:
        cv2.imwrite(str(path), np.zeros((8, 8), np.uint16))
    with pytest.raises(ValueError, match=str(path)):
        imread_gray(str(path))
    assert cv2.imread(str(path), cv2.IMREAD_GRAYSCALE).shape == (8, 8)


def test_chaos_preparation_names_a_bad_ground_png(tmp_path):
    root = tmp_path / "chaos"
    write_chaos(root, np.random.default_rng(7), FILTERS["sub"])
    bad = root / "MR" / "2" / "T2SPIR" / "Ground" / "IMG-0001-00003.png"
    cv2.imwrite(str(bad), np.zeros((SIZE, SIZE, 3), np.uint8))
    with pytest.raises(ValueError, match=str(bad)):
        chaos.ChaosPreparation(str(root), "t2").collect((1.5, 1.5, 5.0),
                                                        CROP)


# --------------------------------------------------------------------- CLIs

def _cli(args, jax_script=None) -> float:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cmd = ([sys.executable, str(REPO / "data_pprocess" / jax_script)]
           if jax_script else [sys.executable, "-m"]) + args
    subprocess.run(cmd, cwd=str(REPO), env=env, check=True, timeout=300,
                   capture_output=True)


@pytest.fixture(scope="module")
def cli_trees(tmp_path_factory):
    """The three CLIs of each package on the same BTCV and CHAOS trees
    (3 patients x 8 slices of 64x64, the CHAOS ground PNGs written with
    libpng's choice among all five row filters): their nii.gz trees and
    PNG trees."""
    base = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(8)
    write_btcv(base / "btcv", rng)
    write_chaos(base / "chaos", rng, FILTERS["all"])
    flags = ["--spacing", "1.5", "1.5", "5", "--size", str(CROP)]
    for who in ("port", "jax"):
        out = base / who
        for name, root in (("atlasPreparation", "--atlas_root"),
                           ("chaosPreparation", "--chaos_root")):
            src = str(base / ("btcv" if name.startswith("atlas")
                              else "chaos"))
            args = [root, src, "--out", str(out / "nii")] + flags
            if who == "port":
                _cli([f"smsut_tpu_torch.data_pprocess.{name}"] + args)
            else:
                _cli(args, f"{name}.py")
        args = ["--src", str(out / "nii"), "--dst", str(out / "png")]
        if who == "port":
            _cli(["smsut_tpu_torch.data_pprocess.toPngAndSplit"] + args)
        else:
            _cli(args, "toPngAndSplit.py")
    return base


def test_preparation_clis_match_jax(cli_trees):
    """atlasPreparation and chaosPreparation: the same nii.gz volumes,
    payloads bit for bit, for 3 patients of each of ct, t1in, t1out, t2,
    each cropped to 48x48."""
    n = same_tree(cli_trees / "port" / "nii", cli_trees / "jax" / "nii")
    assert n == 4 * N_PATIENTS * 2
    vol = niftio.read_nifti(str(cli_trees / "port" / "nii" / "t2" /
                                "images" / "t2_005.nii.gz"))
    assert vol.data.shape == (6, CROP, CROP)
    lab = niftio.read_nifti(str(cli_trees / "port" / "nii" / "ct" /
                                "labels" / "ct_001.nii.gz"))
    assert set(np.unique(lab.data)) == {0, 1, 2, 3, 4}


def test_to_png_and_split_cli_matches_jax(cli_trees):
    """toPngAndSplit: the same PNG pixels, label ``.npy`` files and split
    YAML; the tree is the one the trainers read."""
    from smsut_tpu_torch.data.dataset import get_label_npys

    port, theirs = cli_trees / "port" / "png", cli_trees / "jax" / "png"
    # per patient its .npy and two PNGs a slice: CT 4 slices (the labelled
    # 6, resampled), MR 6; and the YAML
    assert same_tree(port, theirs) == N_PATIENTS * (9 + 3 * 13) + 1
    split = yaml.safe_load((port / Config().split_yaml).read_text())
    assert sorted(split) == ["ct", "t1in", "t1out", "t2"]
    names, npys = get_label_npys(str(port), "test")
    # half of each modality's 3 patients, rounded to even: 2 test volumes
    assert len(npys) == 4 * 2 and all(v.ndim == 3 for v in npys.values())
