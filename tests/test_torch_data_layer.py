"""The port's data layer against the JAX package's (`ullava_tpu/data/`), on
files the test writes (numpy seeds; PNG and JPEG; no download).

- `image_io`: PNGs of colour types 0, 2, 3, 4 and 6 with every scanline
  filter (`chip_smoke.png_bytes`, row y filtered with filter y % 5), PNGs
  PIL writes and a JPEG, read as the JAX line reads them: `cv2.imread` +
  BGR -> RGB and `.convert("RGB")` (`read_rgb`), `np.array(PIL.Image.open)`
  (`read_label`): exact. A missing library raises ImportError naming it.
- `rle`: decode, encode, `fr_poly`, `merge`, `area`, `to_bbox` on the native
  library and on numpy against the JAX `rle`: exact.
- `__getitem__` of every dataset kind after seeding `random` and
  `np.random` alike in both packages: `input_ids`, labels, masks, boxes,
  `raw_size`, `resize` exact; the CLIP and SAM images within 1 uint8 LSB
  on at least 99% of values (the bound `tests/test_torch_image_ops.py`
  holds the host resizes to: torch resizes in place of PIL's).
- Each collator's batch: integer, boolean and mask arrays exact, the
  images at that bound; `resample_mask_to_frame` exact with and without
  the native library (the port's nearest resize in place of PIL's).
- `ConcatDatasetWithShuffle`'s order, the loader's batches, `iter_from`
  without fetching the skipped batches, `device=`, and the `tgif`
  builder's dataset class.
"""

import json
import os
import random
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from toy_tokenizer import ToyLlamaTokenizer
from ullava_tpu.data.collators import collators as jcollators_mod
from ullava_tpu.data.datasets import ConcatDatasetWithShuffle as JConcat
from ullava_tpu.data.loader import DataLoader as JDataLoader
from ullava_tpu.data.tools import native as jnative
from ullava_tpu.data.tools import rle as jrle
from ullava_tpu.registry import registry as jregistry
from ullava_tpu.tasks import setup_task as jsetup_task
from ullava_tpu.config import ConfigNode as JConfigNode
import ullava_tpu_torch.data  # noqa: F401  (registers builders and collators)
from ullava_tpu_torch.config import ConfigNode
from ullava_tpu_torch.constants import CLIP_STD, MM_TOKENS, SAM_STD, STAGE2_TOKENS
from ullava_tpu_torch.data.collators import collators as collators_mod
from ullava_tpu_torch.data.datasets import ConcatDatasetWithShuffle
from ullava_tpu_torch.data.loader import DataLoader
from ullava_tpu_torch.data.tools import image_io, native, rle
from ullava_tpu_torch.registry import registry
from ullava_tpu_torch.tasks import setup_task

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLOURS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> channels


def _cv2_rgb(path):
    import cv2

    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _pil_label(path):
    with Image.open(path) as im:
        return np.array(im)


def _pngs(tmp_path, colour):
    """Files of one colour type: two of `png_bytes` (noise and smooth, all
    five filters) and two PIL writes (default and optimized filtering)."""
    rng = np.random.default_rng(colour)
    c = COLOURS[colour]
    yy, xx = np.mgrid[0:23, 0:37]
    smooth = np.stack([(xx * 5 + yy * (k + 1)) % 256 for k in range(c)], -1).astype(np.uint8)
    palette = rng.integers(0, 256, (40, 3), np.uint8) if colour == 3 else None
    out = []
    for name, px in (("noise", rng.integers(0, 256, (23, 37, c), np.uint8)), ("smooth", smooth)):
        if colour == 3:
            px = px % 40
        path = tmp_path / f"c{colour}_{name}.png"
        path.write_bytes(chip_smoke.png_bytes(px, colour, palette))
        out.append(str(path))
    mode = {0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}.get(colour)
    if mode is None:
        im = Image.fromarray(smooth[..., 0] % 40, "P")
        im.putpalette(palette.reshape(-1).tolist())
    else:
        im = Image.fromarray(smooth if c > 1 else smooth[..., 0], mode)
    for opt in (False, True):
        path = tmp_path / f"c{colour}_pil_{opt}.png"
        im.save(path, optimize=opt)
        out.append(str(path))
    return out


@pytest.mark.parametrize("colour", sorted(COLOURS))
def test_image_reads_match_the_jax_line(tmp_path, colour):
    for path in _pngs(tmp_path, colour):
        if "pil" not in path:  # the writer's rows carry every filter type
            data = open(path, "rb").read()
            raw = zlib.decompress(data[data.index(b"IDAT") + 4:-16])
            stride = 37 * COLOURS[colour] + 1
            assert {raw[y * stride] for y in range(23)} == {0, 1, 2, 3, 4}
        got = image_io.read_rgb(path)
        assert got.dtype == np.uint8 and got.shape == (23, 37, 3)
        np.testing.assert_array_equal(got, _cv2_rgb(path))
        np.testing.assert_array_equal(image_io.read_rgb(path, library="pil"), _pil_rgb(path))
        label = image_io.read_label(path)
        ref = _pil_label(path)
        assert label.dtype == ref.dtype and label.shape == ref.shape
        np.testing.assert_array_equal(label, ref)
        if colour == 3:  # a palette label image reads as its indices
            assert label.ndim == 2 and int(label.max()) < 40
        label[0, 0] = 1  # writable, as np.array's copy is


def test_image_reads_name_a_missing_library(tmp_path, monkeypatch):
    path = str(tmp_path / "x.jpg")
    Image.fromarray(np.random.default_rng(4).integers(0, 256, (30, 41, 3), np.uint8)).save(path)
    np.testing.assert_array_equal(image_io.read_rgb(path), _cv2_rgb(path))
    np.testing.assert_array_equal(image_io.read_rgb(path, library="pil"), _pil_rgb(path))
    np.testing.assert_array_equal(image_io.read_label(path), _pil_label(path))
    with pytest.raises(ValueError, match="missing.png"):
        image_io.read_rgb(str(tmp_path / "missing.png"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        image_io.read_rgb(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        image_io.read_rgb(path, library="pil")
    with pytest.raises(ImportError, match="PIL"):
        image_io.read_label(path)


# ---------------------------------------------------------------------------
# RLE
# ---------------------------------------------------------------------------

POLYS = [
    [[5.2, 3.1, 30.7, 4.4, 28.0, 25.9, 6.3, 22.0]],
    [[2, 2, 12, 2, 12, 9, 2, 9], [20, 5, 35, 5, 35, 20, 27, 28, 20, 20]],
    [[1, 1, 1, 1, 1, 1]],
    [[2, 2, 6, 2, 6, 2, 6, 6]],
    [[-3, -3, 50, -3, 50, 40, -3, 40]],
    [[0.5, 10.25, 17.75, 0.5, 36.5, 19.0, 18.0, 29.5]],
]


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_rle_matches_jax(monkeypatch, path):
    if path == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    else:
        assert native.available() and jnative.available()
    h, w = 31, 40
    for polys in POLYS:
        got, ref = rle.fr_poly(polys, h, w), jrle.fr_poly(polys, h, w)
        assert got == ref
        np.testing.assert_array_equal(rle.decode(got), jrle.decode(ref))
        np.testing.assert_array_equal(rle.merge(got), jrle.merge(ref))
        for r in got:
            assert rle.area(r) == jrle.area(r)
            np.testing.assert_array_equal(rle.to_bbox(r), jrle.to_bbox(r))
    rng = np.random.default_rng(8)
    for m in (rng.random((h, w)) > 0.6, np.ones((h, w)), np.zeros((h, w)), np.eye(h, w)):
        m = m.astype(np.uint8)
        enc = rle.encode(m)
        assert enc == jrle.encode(m)
        np.testing.assert_array_equal(rle.decode(enc), m)
        np.testing.assert_array_equal(rle.decode({"size": enc["size"], "counts": enc["counts"].decode()}),
                                      jrle.decode({"size": enc["size"], "counts": enc["counts"].decode()}))
    counts = [3, 10, 5, 200, 20, 0, 1002]  # uncompressed counts
    unc = {"size": [h, w], "counts": counts}
    np.testing.assert_array_equal(rle.decode(unc), jrle.decode(unc))


# ---------------------------------------------------------------------------
# Datasets, builders, collators
# ---------------------------------------------------------------------------

H, W = 40, 60


def _image(path, rng):
    px = rng.integers(0, 256, (H, W, 3), np.uint8)
    if path.suffix == ".png":
        path.write_bytes(chip_smoke.png_bytes(px))
    else:
        Image.fromarray(px).save(path)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    img = root / "images"
    img.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        _image(img / f"i{i}.{'png' if i % 2 else 'jpg'}", rng)
    names = [f"i{i}.{'png' if i % 2 else 'jpg'}" for i in range(6)]

    rect = np.zeros((H, W), np.uint8)
    rect[8:30, 10:50] = 1
    rle_seg = rle.encode(rect)
    rle_seg = {"size": rle_seg["size"], "counts": rle_seg["counts"].decode()}
    segs = [[[5, 5, 30, 5, 30, 25, 5, 25]],  # one polygon
            [[2, 2, 20, 2, 20, 12, 2, 12], [30, 10, 58, 10, 58, 38, 30, 38]],  # two parts
            [rle_seg],  # an RLE list
            []]  # empty: the all-zero mask
    res = [{"image_path": names[i], "segmentation": segs[i % 4], "category": "Widget Box",
            "bbox": [5 + i, 5, 25, 20], "height": H, "width": W,
            "sentences": [f"widget {i} number {k}" for k in range(2 + 3 * i)]} for i in range(6)]
    with open(root / "res.jsonl", "w") as f:
        f.writelines(json.dumps(a) + "\n" for a in res)

    chat = [{"image": names[i], "conversations": [
        {"from": "human", "value": "<image>\nWhat is shown ?"},
        {"from": "gpt", "value": f"A thing {i} ."},
        {"from": "human", "value": "And the color ?"},
        {"from": "gpt", "value": "Noise ."}]} for i in range(4)]
    chat.append({"conversations": [{"from": "human", "value": "Say hi ."},
                                   {"from": "gpt", "value": "Hi ."}]})
    (root / "chat.json").write_text(json.dumps(chat))

    sal = []
    for i in range(3):
        lab = np.zeros((H, W), np.uint8)
        lab[5 + i:25, 10:40 + i] = 255
        lab[0, 0] = 128
        (root / f"sal{i}.png").write_bytes(chip_smoke.png_bytes(lab, 0))
        sal.append({"image_path": f"images/{names[i]}", "label_path": f"sal{i}.png",
                    "gpt": {"reason": "It Stands Out.", "tag": "Kite"}})
    (root / "sal.json").write_text(json.dumps(sal))

    ade, coco = [], []
    palette = rng.integers(0, 256, (256, 3), np.uint8)
    for i in range(3):
        lab = rng.integers(0, 6, (H, W)).astype(np.uint8)
        (root / f"ade{i}.png").write_bytes(chip_smoke.png_bytes(lab, 0))
        # COCO-Stuff labels as a palette image: read as indices, not RGB.
        (root / f"coco{i}.png").write_bytes(chip_smoke.png_bytes(lab, 3, palette))
        classes = [{"class": n, "class_id": k} for k, n in
                   enumerate(["Wall", "Floor", "Sky-other", "Tree", "Road"])][: 2 + i]
        ade.append({"image_path": f"images/{names[i]}", "label_path": f"ade{i}.png",
                    "classes": classes})
        coco.append({"image_path": f"images/{names[i]}", "label_path": f"coco{i}.png",
                     "classes": classes})
    (root / "ade.json").write_text(json.dumps(ade))
    (root / "coco.json").write_text(json.dumps(coco))
    (root / "cocostuff_classes.txt").write_text(
        "0: unlabeled\n1: wall\n2: floor\n3: sky-other\n4: tree\n5: road\n")

    paco = [{"image_path": names[i], "classes": ["Mug", "Mug:Handle", "Cup", "Lid"][: 2 + i],
             "annotations": [{"segmentation": s, "bbox": [2, 2, 30, 20], "height": H, "width": W}
                             for s in (segs[0], segs[1], rle_seg, segs[1])][: 2 + i]}
            for i in range(3)]
    (root / "paco.json").write_text(json.dumps(paco))
    return root


def _tokenizer():
    tok = ToyLlamaTokenizer(model_max_length=256)
    tok.add_tokens(MM_TOKENS)
    tok.add_tokens(STAGE2_TOKENS)
    return tok


def _dataset_cfg(root, name, templates):
    info = {"image_dir": str(root / "images"), "template_root": str(templates / "SEG.json")}
    anno = {"llava_cc3m": "chat.json", "llava_seg": "chat.json", "refcoco": "res.jsonl",
            "refcoco_val": "res.jsonl", "msra_10k": "sal.json", "dut_omron": "sal.json",
            "ade20k": "ade.json", "cocostuff": "coco.json", "paco_lvis": "paco.json"}[name]
    info["anno_dir"] = str(root / anno)
    if name in ("msra_10k", "dut_omron", "ade20k", "cocostuff"):
        info["image_dir"] = str(root)
    if name in ("msra_10k", "dut_omron"):
        info["template_root"] = str(templates / "SS.json")
    if name == "cocostuff":
        info["class_file"] = str(root / "cocostuff_classes.txt")
    return {"data_type": "image", "image_token_len": 4, "sam_image_size": 64,
            "vis_processor": "clip_image", "build_info": info}


PROCESSOR = {"clip_image": {"image_size": 28, "aspect_ratio": "pad"}}
DATASETS = ["llava_cc3m", "llava_seg", "refcoco", "refcoco_val", "msra_10k", "dut_omron",
            "ade20k", "cocostuff", "paco_lvis"]
TEMPLATES = {"jax": os.path.join(REPO, "ullava_tpu", "data", "templates"),
             "port": os.path.join(REPO, "ullava_tpu_torch", "data", "templates")}


def test_template_banks_are_the_jax_packages():
    for name in ("SEG.json", "SS.json", "README.md"):
        with open(os.path.join(TEMPLATES["jax"], name), "rb") as a, \
                open(os.path.join(TEMPLATES["port"], name), "rb") as b:
            assert a.read() == b.read(), name


def _build(pkg, root, name):
    cfg = _dataset_cfg(root, name, Path(TEMPLATES[pkg]))
    if pkg == "jax":
        b = jregistry.get_builder_class(name)(JConfigNode(cfg), _tokenizer(), "conv_sep2")
        return b.build(JConfigNode(PROCESSOR))
    b = registry.get_builder_class(name)(ConfigNode(cfg), _tokenizer(), "conv_sep2")
    return b.build(ConfigNode(PROCESSOR))


def _samples(pkg, root, name, seed=7):
    ds = _build(pkg, root, name)
    random.seed(seed)
    np.random.seed(seed)
    return [ds[i] for i in range(len(ds))]


def _assert_images_close(got, ref, lsb_units):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    lsb = np.abs(got - ref) * lsb_units
    assert (lsb <= 1.0 + 1e-3).mean() >= 0.99, float((lsb <= 1.0 + 1e-3).mean())


CLIP_LSB = 255.0 * np.asarray(CLIP_STD, np.float32)
SAM_LSB = np.asarray(SAM_STD, np.float32)


def _assert_sample_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if k == "image":
            _assert_images_close(got[k], ref[k], CLIP_LSB)
        elif k == "image_sam":
            _assert_images_close(got[k], ref[k], SAM_LSB)
        elif isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            assert tuple(got[k]) == tuple(ref[k]), k


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_items_match_jax(root, name):
    ref, got = _samples("jax", root, name), _samples("port", root, name)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        _assert_sample_equal(g, r)
    if name == "refcoco":  # the RES answer, the marker only in round one, a mask a round
        sample = _build("port", root, name).build_sample(1)
        conv = sample["conversations"]
        assert len(conv) == 2 * 3 and all("<image>" not in c["value"] for c in conv[2:])
        assert conv[1]["value"] == "Sure. Mask: [SEG]; Location: [LOC]; [tag]widget box[/tag]."
        assert got[1]["seg_mask"].shape == (3, H, W) and got[1]["boxes"].shape == (3, 4)
        assert not got[3]["seg_mask"].any()  # the empty segmentation
        union = got[1]["seg_mask"][0]
        assert union[5, 10] == 1 and union[20, 40] == 1 and union[30, 5] == 0
    if name == "refcoco_val":
        assert max(len(s["seg_mask"]) for s in got) == 10
    if name == "cocostuff":  # palette indices, the '-' class dropped to 255
        assert {255} <= set(np.unique(_build("port", root, name).get_label(str(root / "coco0.png"))))


def test_dataset_without_its_image_library_raises(root, monkeypatch):
    ds = _build("port", root, "llava_cc3m")
    monkeypatch.setitem(sys.modules, "PIL", None)
    for i in (0, 1):  # i0.jpg, i1.png: no silent resample, no blank image
        with pytest.raises(ImportError, match="PIL"):
            ds[i]
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        _build("port", root, "refcoco")[0]


COLLATORS = {"base_collator": "llava_cc3m", "image_collator": "llava_cc3m",
             "image_video_collator": "llava_cc3m", "segmentation_collator": "refcoco",
             "grounding_collator": "refcoco"}


@pytest.mark.parametrize("name", sorted(COLLATORS))
def test_collators_match_jax(root, name):
    kw = {} if name in ("base_collator", "image_collator", "image_video_collator") else \
        {"max_masks": 3, "mask_frame": 32}
    ref_samples = _samples("jax", root, COLLATORS[name])
    got_samples = _samples("port", root, COLLATORS[name])
    if name == "grounding_collator":  # VQA rows mixed in: no masks, no boxes
        ref_samples += _samples("jax", root, "llava_seg")[:2]
        got_samples += _samples("port", root, "llava_seg")[:2]
        for s in ref_samples + got_samples:
            # Their zero SAM image is 1024 square (the builder passes no
            # sam_size, in both packages): cut to the RES rows' 64.
            s["image_sam"] = s["image_sam"][:64, :64]
    ref = jregistry.get_collator_class(name)(0, pad_multiple=16, model_max_length=40, **kw)(
        ref_samples)
    got = registry.get_collator_class(name)(0, pad_multiple=16, model_max_length=40, **kw)(
        got_samples)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        if k == "images":
            _assert_images_close(got[k], ref[k], CLIP_LSB)
        elif k == "images_sam":
            _assert_images_close(got[k], ref[k], SAM_LSB)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["input_ids"].shape[1] == 40  # cut at model_max_length
    lens = got["attn_lens"]
    for b, n in enumerate(lens):
        assert (got["labels"][b, n:] == -100).all() and (got["input_ids"][b, n:] == 0).all()


def test_video_collators_match_jax():
    rng = np.random.default_rng(5)
    inst = [{"input_ids": rng.integers(5, 50, n), "labels": rng.integers(5, 50, n),
             **({"video": rng.standard_normal((2, 8, 8, 3)).astype(np.float32)} if n % 2 else {}),
             **({"image": rng.standard_normal((8, 8, 3)).astype(np.float32)} if n % 3 else {})}
            for n in (5, 9, 12)]
    for name in ("video_collator", "image_video_collator"):
        ref = jregistry.get_collator_class(name)(1, pad_multiple=8)(inst)
        got = registry.get_collator_class(name)(1, pad_multiple=8)(inst)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("with_native", [True, False])
def test_resample_mask_to_frame_matches_jax(monkeypatch, with_native):
    if not with_native:
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jnative, "_load", lambda: None)
    rng = np.random.default_rng(6)
    for hw in ((40, 60), (37, 53), (480, 640), (1100, 1500)):
        m = (rng.random(hw) > 0.5).astype(np.float32)
        for frame in (1024, 256, 64):
            np.testing.assert_array_equal(collators_mod.resample_mask_to_frame(m, hw, frame),
                                          jcollators_mod.resample_mask_to_frame(m, hw, frame))


# ---------------------------------------------------------------------------
# Mixing, the loader, the builders' names
# ---------------------------------------------------------------------------


def test_concat_with_shuffle_order_matches_jax(root):
    for portion in (1, 0.5, 2.5):
        ref = JConcat([list(range(5)), list(range(7))], seed=42, portion=portion)
        got = ConcatDatasetWithShuffle([list(range(5)), list(range(7))], seed=42, portion=portion)
        assert got.indices == ref.indices and [got[i] for i in range(len(got))] == \
            [ref[i] for i in range(len(ref))]
    # The pretrain task mixes with the fixed seed 42.
    cfg = {name: _dataset_cfg(root, name, Path(TEMPLATES["port"]))
           for name in ("refcoco", "llava_cc3m")}
    got = setup_task(ConfigNode({"type": "image_text_pretrain"})).build_datasets(
        ConfigNode(cfg), _tokenizer(), ConfigNode(PROCESSOR), "conv_sep2")
    ref = jsetup_task(JConfigNode({"type": "image_text_pretrain"})).build_datasets(
        JConfigNode(cfg), _tokenizer(), JConfigNode(PROCESSOR), "conv_sep2")
    assert got.seed == 42 and got.indices == ref.indices


class _Counting:
    def __init__(self, n=22):
        self.n, self.fetched = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.fetched.append(int(i))
        return {"x": np.full((2,), i, np.int32), "f": np.float32(i)}


def _collate(samples):
    return {"x": np.stack([s["x"] for s in samples]),
            "m": np.asarray([s["f"] > 5 for s in samples])}


def test_loader_batches_and_iter_from_match_jax():
    kw = dict(batch_size=4, collate_fn=_collate, shuffle=True, seed=3, num_workers=2)
    for epoch in (0, 1):
        ref_loader = JDataLoader(_Counting(), process_index=0, process_count=1, **kw)
        loader = DataLoader(_Counting(), **kw)
        ref_loader.set_epoch(epoch)
        loader.set_epoch(epoch)
        assert (loader.process_index, loader.process_count) == (0, 1)
        ref, got = list(ref_loader), list(loader)
        assert len(got) == len(ref) == len(loader) == 5  # drop-last
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g["x"], r["x"])
        # iter_from(3) yields the full run's batches 3 on and never fetches 0-2.
        ds = _Counting()
        loader = DataLoader(ds, **kw)
        loader.set_epoch(epoch)
        tail = list(loader.iter_from(3))
        assert len(tail) == 2
        for g, r in zip(tail, got[3:]):
            np.testing.assert_array_equal(g["x"], r["x"])
        skipped = {int(v) for b in got[:3] for v in b["x"][:, 0]}
        assert not set(ds.fetched) & skipped


def test_loader_device_and_failures():
    kw = dict(batch_size=4, collate_fn=_collate, shuffle=False, num_workers=2)
    ref = list(DataLoader(_Counting(), **kw))
    got = list(DataLoader(_Counting(), device="cpu", **kw))
    for g, r in zip(got, ref):
        assert isinstance(g["x"], torch.Tensor) and g["x"].dtype == torch.int32
        assert g["m"].dtype == torch.bool
        np.testing.assert_array_equal(g["x"].numpy(), r["x"])

    class Broken(_Counting):
        def __getitem__(self, i):
            if i == 9:
                raise OSError("corrupt sample 9")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="corrupt sample 9"):
        list(DataLoader(Broken(), **kw))


def test_builders_and_the_video_path(tmp_path):
    jax_names = set(jregistry.list_names("builder"))
    assert set(registry.list_names("builder")) == jax_names
    assert set(registry.list_names("collator")) == set(jregistry.list_names("collator"))
    # `tgif` builds a TgifDataset (`tests/test_torch_video.py` holds it to
    # the JAX line).
    from ullava_tpu_torch.data.datasets import TgifDataset
    from ullava_tpu_torch.data.builders.plain_type_builder import PlainBuilder

    builder = registry.get_builder_class("tgif")
    assert issubclass(builder, PlainBuilder) and builder.dataset_cls is TgifDataset
    assert jregistry.get_builder_class("tgif").dataset_cls.__name__ == "TgifDataset"
    (tmp_path / "tgif.json").write_text(json.dumps([{"gif": "a.gif", "conversations": []}]))
    ds = builder(ConfigNode({"data_type": "gif", "vis_processor": "gif_train",
                             "build_info": {"anno_dir": str(tmp_path / "tgif.json"),
                                            "image_dir": str(tmp_path)}}),
                 _tokenizer(), "conv_simple").build(ConfigNode({"gif_train": {"n_frm": 8}}))
    assert isinstance(ds, TgifDataset) and len(ds) == 1 and ds.image_token_len == 8 + 256


def test_loader_stripes_by_torch_distributed(monkeypatch):
    """The process index and count come from an initialised
    `torch.distributed` group: each process reads its stripe of the one
    seeded permutation, as the JAX loader with that index and count."""
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    kw = dict(batch_size=3, collate_fn=_collate, seed=5, num_workers=1)
    for rank in (0, 1):
        monkeypatch.setattr(dist, "get_rank", lambda: rank)
        loader = DataLoader(_Counting(), **kw)
        assert (loader.process_index, loader.process_count) == (rank, 2) and len(loader) == 3
        ref = JDataLoader(_Counting(), process_index=rank, process_count=2, **kw)
        for g, r in zip(loader, ref):
            np.testing.assert_array_equal(g["x"], r["x"])


def test_native_build_without_gxx_and_on_failure(tmp_path, monkeypatch, caplog):
    """No g++: no library, the numpy paths, and a warning. A failed build:
    the compiler's message logged and RuntimeError, never a quiet numpy
    path."""
    import logging
    import shutil

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    which = shutil.which
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert native.build() is None
    assert "g++ not found" in caplog.text
    monkeypatch.setattr(shutil, "which", which)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    with caplog.at_level(logging.ERROR, logger=native.__name__):
        with pytest.raises(RuntimeError, match="native host library build failed"):
            native.build()
    assert "bad.cpp" in caplog.text
    assert not list(tmp_path.glob("*.so"))
