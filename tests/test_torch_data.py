# -*- coding: utf-8 -*-
"""The port's data layer against the JAX package's: the PNG codec and the
YAML subset against OpenCV and PyYAML (bit for bit, byte for byte), the
samplers, split generation, meter, synthetic dataset and loaders (equal),
and the host augmentations (elastic exact; rotate and resize against
OpenCV within the bounds stated at each test)."""
import os
import random
import struct
import zlib
from os.path import join as pjoin

import cv2
import numpy as np
import pytest
import yaml

from smsut_tpu.data import augment as jaug
from smsut_tpu.data import dataset as jds
from smsut_tpu.data import samplers as jsamplers
from smsut_tpu.data.split import make_semi_split as j_make_semi_split
from smsut_tpu.data.synthetic import _make_volume
from smsut_tpu.data.synthetic import make_synthetic_dataset as j_make_synthetic
from smsut_tpu.config import Config as JConfig
from smsut_tpu.utils.meter import Meter as JMeter
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.data import augment as paug
from smsut_tpu_torch.data import dataset as pds
from smsut_tpu_torch.data import samplers as psamplers
from smsut_tpu_torch.data.split import load_split, make_semi_split, save_split
from smsut_tpu_torch.data.synthetic import make_synthetic_dataset
from smsut_tpu_torch.utils import io as pio
from smsut_tpu_torch.utils.meter import Meter


@pytest.fixture(scope="module")
def jax_data(tmp_path_factory):
    """The JAX package's synthetic dataset (written by cv2 and PyYAML)."""
    root = str(tmp_path_factory.mktemp("jax_synth"))
    j_make_synthetic(root, n_patients_per_modality=3, n_slice=4, size=32)
    return root


@pytest.fixture(scope="module")
def port_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_synth"))
    make_synthetic_dataset(root, n_patients_per_modality=3, n_slice=4, size=32)
    return root


def _files(root, suffix):
    return sorted(os.path.relpath(pjoin(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(suffix))


# ------------------------------------------------------------------- PNG

def test_png_codec_against_cv2_both_ways(jax_data, tmp_path):
    """Every PNG that cv2 wrote reads the same through the port's codec,
    and each image the port writes reads the same through cv2: bit for
    bit, on the JAX package's synthetic tree and a full-range image."""
    pngs = _files(jax_data, ".png")
    assert len(pngs) == 4 * 3 * 4 * 2
    rng = np.random.default_rng(0)
    extra = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "full.png"), extra)
    for rel in pngs + ["full.png"]:
        src = str(tmp_path / rel) if rel == "full.png" else pjoin(jax_data, rel)
        want = cv2.imread(src, cv2.IMREAD_GRAYSCALE)
        got = pio.imread_gray(src)
        assert got.dtype == np.uint8 and np.array_equal(got, want), rel
        out = str(tmp_path / "port.png")
        assert pio.imwrite_gray(out, want)
        assert np.array_equal(cv2.imread(out, cv2.IMREAD_UNCHANGED), want), rel


def _png_with_filters(img, kinds):
    """An 8-bit greyscale PNG whose row y is filtered with kinds[y]."""
    h, w = img.shape
    x = img.astype(np.int64)
    rows = []
    for y in range(h):
        cur = x[y]
        up = x[y - 1] if y else np.zeros(w, np.int64)
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], up[:-1]])
        k = kinds[y]
        if k == 0:
            pred = np.zeros(w, np.int64)
        elif k == 1:
            pred = left
        elif k == 2:
            pred = up
        elif k == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        rows.append(bytes([k]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(t, d):
        return (struct.pack(">I", len(d)) + t + d
                + struct.pack(">I", zlib.crc32(t + d) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_reads_all_five_row_filters(tmp_path):
    """Rows filtered None, Sub, Up, Average and Paeth, in turn: the port's
    reader and cv2 both give back the image."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (20, 17)).astype(np.uint8)
    img[5:9] = 250                                     # runs and wraps
    path = str(tmp_path / "filters.png")
    with open(path, "wb") as f:
        f.write(_png_with_filters(img, [y % 5 for y in range(20)]))
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE), img)
    assert np.array_equal(pio.imread_gray(path), img)


def test_png_refuses_other_kinds(tmp_path):
    colour = np.zeros((4, 5, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "rgb.png"), colour)
    deep = np.zeros((4, 5), np.uint16)
    cv2.imwrite(str(tmp_path / "deep.png"), deep)
    for name in ("rgb.png", "deep.png"):
        with pytest.raises(ValueError):
            pio.imread_gray(str(tmp_path / name))
    with pytest.raises(ValueError):
        pio.imwrite_gray(str(tmp_path / "x.png"), deep)


# ------------------------------------------------------------------ YAML

def _semi_split():
    pids = {m: [str(i).rjust(3, "0") for i in range(1, n + 1)]
            for m, n in zip(("ct", "t1in", "t1out", "t2"), (20, 20, 20, 13))}
    return make_semi_split(pids)


@pytest.mark.parametrize("which", ["synthetic", "semi"])
def test_yaml_subset_against_pyyaml(which, jax_data, tmp_path):
    """The port writes split files byte for byte as yaml.dump does, and
    reads what yaml.dump writes as yaml.load does."""
    if which == "synthetic":
        with open(pjoin(jax_data, "semi-1910.yaml")) as f:
            text = f.read()
        data = yaml.load(text, Loader=yaml.FullLoader)
    else:
        data = _semi_split()
        text = yaml.dump(data)
    assert pio.dump_yaml(data) == text
    assert pio.load_yaml(text) == data
    path = str(tmp_path / "split.yaml")
    save_split(data, path)
    with open(path) as f:
        assert f.read() == text
    assert load_split(path) == data


@pytest.mark.parametrize("doc", [
    "a: 1.5\n", "a: [1]\n", "a:\n", "a: b\n  c: d\n", "# note\na: 1\n",
    "a: 1\na: 2\n", "a: 007\n", "a: yes\n", "a: \"x\"\n", "- a\n b: c\n"])
def test_yaml_subset_refuses_other_yaml(doc):
    with pytest.raises(ValueError):
        pio.load_yaml(doc)


def test_semi_split_matches_jax():
    pids = {m: [str(i).rjust(3, "0") for i in range(1, n + 1)]
            for m, n in zip(("ct", "t1in", "t1out", "t2"), (20, 20, 20, 13))}
    assert make_semi_split(pids, seed=7) == j_make_semi_split(pids, seed=7)


# -------------------------------------------------------------- samplers

@pytest.mark.parametrize("seed", [0, 1, 2020])
@pytest.mark.parametrize("kind", ["in_turn", "in_turn_shuffle", "balance",
                                  "test"])
def test_samplers_match_jax(kind, seed):
    """The same seed gives the same index stream over three passes, and
    leaves the random.Random in the same state."""
    pools = [list(range(0, 11)), list(range(11, 20)), list(range(20, 34)),
             list(range(34, 40))]
    rj, rp = random.Random(seed), random.Random(seed)
    if kind.startswith("in_turn"):
        sh = kind.endswith("shuffle")
        js = jsamplers.InTurnTrainBatchSampler(pools, 4, shuffle=sh, rng=rj)
        ps = psamplers.InTurnTrainBatchSampler(pools, 4, shuffle=sh, rng=rp)
    elif kind == "balance":
        js = jsamplers.ModalityBalanceBatchSampler(pools, 4, rng=rj)
        ps = psamplers.ModalityBalanceBatchSampler(pools, 4, rng=rp)
    else:
        js = jsamplers.InTurnTestBatchSampler(pools, 4)
        ps = psamplers.InTurnTestBatchSampler(pools, 4)
    assert len(ps) == len(js)
    for _ in range(3):
        assert list(ps) == list(js)
    assert rp.getstate() == rj.getstate()


def test_meter_matches_jax():
    keys = [f"loss_{i}" for i in range(4)] + ["loss"]
    dkeys = [f"dice_{i}" for i in range(4)] + ["dice"]
    rng = np.random.default_rng(3)
    jm, pm = JMeter(keys, dkeys, alpha=0.7), Meter(keys, dkeys, alpha=0.7)
    for epoch in range(4):
        for m in (jm, pm):
            m.reset_cur()
        for _ in range(6):
            loss, mod, n = float(rng.random()), int(rng.integers(4)), 4
            for m in (jm, pm):
                m.accumulate(*m.collect_loss_by(loss, mod, n))
        sd, mi = rng.random(8).tolist(), rng.integers(0, 4, 8).tolist()
        for m in (jm, pm):
            m.accumulate(*m.collect_dice_by(sd, mi, 4))
            m.update_cur(reset_best=epoch == 2)
        assert pm.cur_values == jm.cur_values
        assert pm.best_values == jm.best_values
        assert repr(pm) == repr(jm)


# ---------------------------------------------------------- dataset tree

def test_synthetic_dataset_matches_jax(jax_data, port_data):
    """Same seed, same tree: every PNG's pixels, every label volume and
    the split file (byte for byte)."""
    assert _files(port_data, "") == _files(jax_data, "")
    for rel in _files(jax_data, ".png"):
        assert np.array_equal(
            pio.imread_gray(pjoin(port_data, rel)),
            cv2.imread(pjoin(jax_data, rel), cv2.IMREAD_GRAYSCALE)), rel
    for rel in _files(jax_data, ".npy"):
        assert np.array_equal(np.load(pjoin(port_data, rel)),
                              np.load(pjoin(jax_data, rel))), rel
    with open(pjoin(port_data, "semi-1910.yaml")) as a, \
            open(pjoin(jax_data, "semi-1910.yaml")) as b:
        assert a.read() == b.read()


def _stream(loader, n):
    it = loader.iter_cycle() if n else iter(loader)
    out = []
    for k, b in enumerate(it):
        out.append((b.img, b.msk, b.mdl, b.names))
        if n and k + 1 == n:
            break
    return out


@pytest.mark.parametrize("phase,raw", [("train", False), ("train", True),
                                       ("val", False), ("test", False)])
def test_loader_batches_match_jax(jax_data, phase, raw):
    """get_loader without augmentation (raw uint8, or normalised): the
    port's batches equal the JAX package's, on its cv2-written tree."""
    n = 7 if phase != "test" else 0
    kw = dict(cfg=JConfig(num_workers=2), rng=random.Random(5), raw=raw)
    jl = jds.get_loader(jax_data, phase, 0, 4, None, **kw)
    pl = pds.get_loader(jax_data, phase, 0, 4, None,
                        cfg=Config(num_workers=2), rng=random.Random(5),
                        raw=raw)
    want, got = _stream(jl, n), _stream(pl, n)
    assert len(got) == len(want) > 0
    for (gi, gm, gd, gn), (wi, wm, wd, wn) in zip(got, want):
        assert gi.dtype == wi.dtype and np.array_equal(gi, wi)
        assert gm.dtype == wm.dtype and np.array_equal(gm, wm)
        assert np.array_equal(gd, wd) and gn == wn
    assert pds.get_label_npys(jax_data, phase if phase == "test" else
                              "test")[0] == jds.get_label_npys(jax_data,
                                                               "test")[0]


def test_label_npys_and_disk_mode_match_jax(jax_data):
    n_p, p = pds.get_label_npys(jax_data, "test")
    n_j, j = jds.get_label_npys(jax_data, "test")
    assert n_p == n_j and p.keys() == j.keys()
    for k in j:
        assert np.array_equal(p[k], j[k])
    ram = pds.SliceDataset(jax_data, "train", 0, load_in_ram=True)
    disk = pds.SliceDataset(jax_data, "train", 0, load_in_ram=False)
    assert disk.gather_batch_u8([0]) is None
    idx = [3, 0, 5]
    gi, gm = ram.gather_batch_u8(idx)
    for k, i in enumerate(idx):
        a, b = disk.get_raw(i)[:2], ram.get_raw(i)[:2]
        assert np.array_equal(a[0], gi[k]) and np.array_equal(a[1], gm[k])
        assert np.array_equal(b[0], gi[k]) and np.array_equal(b[1], gm[k])


# ---------------------------------------------------------- augmentation

def _volume(size=256, n=4, seed=1):
    return _make_volume(np.random.default_rng(seed), n, size, 4)


def test_elastic_deform_pair_exact():
    imgs, lbls = _volume(64)
    for k in range(4):
        j = jaug.elastic_deform_pair(imgs[k], lbls[k], 11.0, 3,
                                     random.Random(k))
        p = paug.elastic_deform_pair(imgs[k], lbls[k], 11.0, 3,
                                     random.Random(k))
        assert np.array_equal(j[0], p[0]) and np.array_equal(j[1], p[1])


def test_rotate_pair_against_cv2():
    """cv2.warpAffine (OpenCV 5, uint8, bilinear image, nearest mask)
    against the port's numpy version, 60 rotations of 256^2 organ slices
    and 64x48 noise, within and beyond the training's +-15 degrees.
    Measured: 1 image pixel of 2058240 off, by 1 grey level; masks equal.
    Bound: image at most 1 grey level and 1e-5 of the pixels; masks
    equal."""
    imgs, lbls = _volume()
    rng = np.random.default_rng(0)
    off = total = 0
    for k in range(60):
        if k % 2:
            img, msk = imgs[k % 4], lbls[k % 4]
        else:
            img = rng.integers(0, 256, (64, 48)).astype(np.uint8)
            msk = rng.integers(0, 5, img.shape).astype(np.uint8)
        ang = rng.uniform(-15, 15) if k < 40 else rng.uniform(-180, 180)
        wi, wm = jaug.rotate_pair(img, msk, ang)
        gi, gm = paug.rotate_pair(img, msk, ang)
        d = np.abs(gi.astype(np.int64) - wi)
        assert d.max() <= 1, (k, ang)
        off += int((d > 0).sum())
        total += d.size
        assert np.array_equal(gm, wm), (k, ang)
    assert off <= 1e-5 * total, off


def test_resized_crop_pair_against_cv2():
    """cv2.resize, bilinear image and nearest mask, at the crops the
    sampler draws, up to 256 and 160 and down to 32.  Measured: equal
    everywhere (the port follows OpenCV's fixed-point arithmetic).  Bound:
    equal."""
    imgs, lbls = _volume()
    r = random.Random(0)
    for k in range(40):
        i, j, ch, cw = jaug.resized_crop_params(256, 256, (0.6, 1.0),
                                                (3 / 4, 4 / 3), r)
        for size in (256, 160, 32):
            want = jaug.resized_crop_pair(imgs[k % 4], lbls[k % 4], i, j, ch,
                                          cw, size)
            got = paug.resized_crop_pair(imgs[k % 4], lbls[k % 4], i, j, ch,
                                         cw, size)
            assert np.array_equal(got[0], want[0]), (k, size)
            assert np.array_equal(got[1], want[1]), (k, size)


def test_joint_augment_matches_jax():
    """The full host pipeline (rotate, elastic, crop, colour jitter,
    gamma): the same calls leave the random.Random in the same state and
    give the same pairs, within rotate's bound above (the later stages
    carry an off pixel on)."""
    imgs, lbls = _volume(64)
    cfg = dict(JConfig().data_aug, resizeCrop_size=48, colorJitter=True,
               gammaCorrect=True)
    ja, pa = (jaug.JointAugment(cfg, random.Random(9)),
              paug.JointAugment(cfg, random.Random(9)))
    for k in range(16):
        wi, wm = ja(imgs[k % 4], lbls[k % 4])
        gi, gm = pa(imgs[k % 4], lbls[k % 4])
        assert ja.rng.getstate() == pa.rng.getstate()
        assert gi.shape == wi.shape == (48, 48)
        assert np.abs(gi.astype(np.int64) - wi).max() <= 1
        assert (gi != wi).mean() <= 1e-3 and np.array_equal(gm, wm)
    assert np.array_equal(paug.normalize_img(imgs[0]),
                          jaug.normalize_img(imgs[0]))
