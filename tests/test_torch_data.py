"""The port's host data path (data/feeder.py, data/preprocess.py,
data/folder.py, utils/obj_io.py) against the JAX package's on the same
inputs, plus the reference's own cases on the port
(tests/test_aux.py:13-64, tests/test_folder_dataset.py:50-95,
tests/test_io_and_losses.py:16).

Bars: the folder dataset's images and landmarks EQUAL the reference's
(the same numpy or cv2 arithmetic on the same decoded pixels), for every
align mode and both warp paths; the reference's own cases keep their
tolerances (similarity 1e-3, template 1e-2, identity warp 1e-3, obj
1e-5).
"""

import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from facerecon_tpu.data import folder as ref_folder
from facerecon_tpu.data import preprocess as ref_pre

from facerecon_tpu_torch.data import preprocess as pre
from facerecon_tpu_torch.data.feeder import prefetch
from facerecon_tpu_torch.data.folder import (FolderDataset,
                                             canonical_template68,
                                             five_from_68)
from facerecon_tpu_torch.data.synthetic import render_batch, sample_coeffs
from facerecon_tpu_torch.ops.geometry import device_bfm
from facerecon_tpu_torch.utils.obj_io import load_obj, save_obj

torch.set_num_threads(2)


def write_photo_folder(root, cfg, assets, n=4, seed=5, canvas=2):
    """Rendered faces (the port's render, on the CPU) placed on a larger
    canvas by random similarity warps, saved as PNG with 68-point
    side-cars (tests/test_folder_dataset.py's photo shoot)."""
    images, lmk = (t.numpy() for t in render_batch(
        sample_coeffs(np.random.default_rng(seed), cfg, n),
        device_bfm(assets, "cpu"), cfg))
    rng = np.random.default_rng(seed)
    size = cfg.image_size
    os.makedirs(root)
    for i in range(n):
        ang = rng.uniform(-0.3, 0.3)
        sc = rng.uniform(0.8, 1.2)
        tx, ty = rng.uniform(size * 0.3, size * 0.7, 2) * (canvas - 1)
        rot = sc * np.array([[np.cos(ang), -np.sin(ang)],
                             [np.sin(ang), np.cos(ang)]], np.float32)
        m = np.concatenate([rot, [[tx], [ty]]], axis=1).astype(np.float32)
        photo = pre.warp_affine(np.clip(images[i], 0, 1), m, size * canvas)
        ones = np.ones((68, 1), np.float32)
        Image.fromarray((photo * 255).astype(np.uint8)).save(
            os.path.join(root, f"face_{i:03d}.png"))
        np.savetxt(os.path.join(root, f"face_{i:03d}.txt"),
                   np.concatenate([lmk[i], ones], 1) @ m.T, fmt="%.4f")
    return str(root), images, lmk


@pytest.fixture(scope="module")
def photos(tmp_path_factory, cfg, assets):
    return write_photo_folder(tmp_path_factory.mktemp("data") / "photos",
                              cfg, assets)


# --- tests/test_aux.py:13-64 on the port ---

def test_prefetch_preserves_order_and_completes():
    src = (np.full((2, 2), i) for i in range(10))
    out = list(prefetch(src, depth=3))
    assert len(out) == 10
    for i, a in enumerate(out):
        assert (a == i).all()


def test_prefetch_propagates_errors():
    def bad():
        yield 1
        raise ValueError("boom")
    it = prefetch(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)
    # exhausted: the error again, not a hang
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_prefetch_close_returns_promptly():
    """An endless producer blocked on a full queue stops within the
    close's join, and the consumer then sees the end."""
    made = []

    def endless():
        i = 0
        while True:
            made.append(i)
            yield i
            i += 1
    it = prefetch(endless(), depth=2)
    assert next(it) == 0
    time.sleep(0.2)                  # the producer fills the queue
    t0 = time.perf_counter()
    it.close()
    assert time.perf_counter() - t0 < 1.5
    assert not it._thread.is_alive()
    assert len(made) <= 5
    with pytest.raises(StopIteration):
        next(it)


def test_similarity_transform_recovers_known():
    rng = np.random.default_rng(0)
    src = rng.random((5, 2)).astype(np.float32) * 100
    ang, s, t = 0.3, 1.7, np.array([5.0, -3.0])
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    dst = (src @ (s * rot).T) + t
    m = pre.similarity_transform(src, dst)
    back = np.concatenate([src, np.ones((5, 1))], 1) @ m.T
    np.testing.assert_allclose(back, dst, atol=1e-3)
    np.testing.assert_array_equal(m, ref_pre.similarity_transform(src, dst))


def test_align_face_lands_on_template():
    rng = np.random.default_rng(1)
    img = rng.random((256, 256, 3)).astype(np.float32)
    tpl = pre.canonical_template(224)
    np.testing.assert_array_equal(tpl, ref_pre.canonical_template(224))
    lm5 = tpl * 0.9 + 20.0
    aligned, lm68 = pre.align_face(img, lm5, 224, landmarks68=lm5)
    assert aligned.shape == (224, 224, 3)
    assert aligned.min() >= 0 and aligned.max() <= 1
    np.testing.assert_allclose(lm68, tpl, atol=1e-2)
    ref_aligned, ref_lm = ref_pre.align_face(img, lm5, 224, landmarks68=lm5)
    np.testing.assert_array_equal(aligned, ref_aligned)
    np.testing.assert_array_equal(lm68, ref_lm)


@pytest.mark.parametrize("cv2_path", [True, False], ids=["cv2", "numpy"])
def test_warp_affine_identity(monkeypatch, cv2_path):
    if cv2_path and not pre._HAS_CV2:
        pytest.fail("cv2 is expected on this host")
    monkeypatch.setattr(pre, "_HAS_CV2", cv2_path)
    img = np.arange(16 * 16 * 3, dtype=np.float32).reshape(16, 16, 3)
    ident = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
    np.testing.assert_allclose(pre.warp_affine(img, ident, 16), img,
                               atol=1e-3)


# --- tests/test_folder_dataset.py:50-95 on the port ---

def test_folder_68pt_alignment_recovers_canonical(photos, cfg, assets):
    root, _, _ = photos
    ds = FolderDataset(root, cfg, align="68pt", assets=assets)
    assert len(ds) == 4
    tpl = canonical_template68(assets, cfg)
    np.testing.assert_array_equal(
        tpl, ref_folder.canonical_template68(assets, cfg))
    for i in range(len(ds)):
        img, lmk_out = ds.load(i)
        assert img.shape == (cfg.image_size, cfg.image_size, 3)
        rmse = float(np.sqrt(((lmk_out - tpl) ** 2).sum(-1).mean()))
        assert rmse < cfg.image_size * 0.12, f"item {i}: rmse {rmse}"


def test_folder_5pt_alignment_and_batching(photos, cfg):
    root, _, _ = photos
    ds = FolderDataset(root, cfg, align="5pt")
    img, _ = ds.load(0)
    assert img.shape == (cfg.image_size, cfg.image_size, 3)
    assert img.min() >= 0.0 and img.max() <= 1.0
    batches = list(ds.batches(batch=2, seed=0, epochs=2))
    assert len(batches) == 4          # 4 items / batch 2 x 2 epochs
    bi, bl, bc = batches[0]
    assert bi.shape == (2, cfg.image_size, cfg.image_size, 3)
    assert bl.shape == (2, 68, 2)
    assert bc is None
    # the reference's shuffle: the same batches in the same order
    ref = ref_folder.FolderDataset(root, cfg, align="5pt")
    for (a, la, _), (b, lb, _) in zip(batches,
                                      ref.batches(batch=2, seed=0,
                                                  epochs=2)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_five_from_68_layout():
    lmk = np.arange(68 * 2, dtype=np.float32).reshape(68, 2)
    five = five_from_68(lmk)
    assert five.shape == (5, 2)
    np.testing.assert_allclose(five[0], lmk[36:42].mean(0))
    np.testing.assert_allclose(five[2], lmk[30])
    np.testing.assert_array_equal(five, ref_folder.five_from_68(lmk))


# --- the port's dataset against the reference's ---

@pytest.mark.parametrize("cv2_path", [True, False], ids=["cv2", "numpy"])
@pytest.mark.parametrize("align", ["68pt", "5pt", "none"])
def test_folder_equals_reference(photos, cfg, assets, monkeypatch, align,
                                 cv2_path):
    monkeypatch.setattr(pre, "_HAS_CV2", cv2_path)
    monkeypatch.setattr(ref_pre, "_HAS_CV2", cv2_path)
    root, _, _ = photos
    ds = FolderDataset(root, cfg, align=align, assets=assets)
    ref = ref_folder.FolderDataset(root, cfg, align=align, assets=assets)
    assert ds.stems() == ref.stems() == [f"face_{i:03d}" for i in range(4)]
    img, lmk = ds.load(1)
    ref_img, ref_lmk = ref.load(1)
    assert img.dtype == ref_img.dtype == np.float32
    np.testing.assert_array_equal(img, ref_img)
    np.testing.assert_array_equal(lmk, ref_lmk)
    imgs, lmks = ds.load_all()
    ref_imgs, ref_lmks = ref.load_all()
    assert imgs.shape == (4, cfg.image_size, cfg.image_size, 3)
    np.testing.assert_array_equal(imgs, ref_imgs)
    np.testing.assert_array_equal(lmks, ref_lmks)


def test_folder_errors_match_reference(tmp_path, photos, cfg, assets):
    root, _, _ = photos
    for kw in ({"align": "3pt"}, {"align": "68pt"}):
        with pytest.raises(ValueError) as got:
            FolderDataset(root, cfg, **kw)
        with pytest.raises(ValueError) as want:
            ref_folder.FolderDataset(root, cfg, **kw)
        assert str(got.value) == str(want.value)
    bare = tmp_path / "bare"
    os.makedirs(bare)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(str(bare / "a.png"))
    with pytest.raises(FileNotFoundError) as got:
        FolderDataset(str(bare), cfg, align="5pt")
    with pytest.raises(FileNotFoundError) as want:
        ref_folder.FolderDataset(str(bare), cfg, align="5pt")
    assert str(got.value) == str(want.value)
    # bare pre-aligned crops: NaN landmarks, as in the reference
    img, lmk = FolderDataset(str(bare), cfg, align="none").load(0)
    assert img.shape == (cfg.image_size, cfg.image_size, 3)
    assert np.isnan(lmk).all()
    empty = tmp_path / "empty"
    os.makedirs(empty)
    with pytest.raises(FileNotFoundError, match="no images under"):
        FolderDataset(str(empty), cfg, align="none")
    with pytest.raises(ValueError, match="< batch size 8"):
        next(FolderDataset(root, cfg, align="5pt").batches(8))


# --- tests/test_io_and_losses.py:16 on the port ---

def test_obj_roundtrip(tmp_path, assets):
    verts = assets.mean_shape.reshape(-1, 3)[:100]
    cols = np.linspace(0, 1, 300, dtype=np.float32).reshape(100, 3)
    faces = assets.faces[:50] % 100
    p = str(tmp_path / "mesh.obj")
    save_obj(p, verts, cols, faces)
    v, c, f = load_obj(p)
    np.testing.assert_allclose(v, verts, atol=1e-5)
    np.testing.assert_allclose(c, cols, atol=1e-5)
    np.testing.assert_array_equal(f, faces)
    from facerecon_tpu.utils.obj_io import save_obj as ref_save_obj
    q = str(tmp_path / "ref.obj")
    ref_save_obj(q, verts, cols, faces)
    assert open(p).read() == open(q).read()
