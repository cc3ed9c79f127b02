"""The port's video path against the JAX package's, on the CPU, on GIFs
and a video the test writes (numpy seeds; no download).

- `data/tools/video_transforms`: every function on uint8 and float clips
  (the float resize in PIL's "F" mode) and the random classes after one
  `random.seed`: bit-equal.
- `data/processors/video_processor`: `sample_indices` in both modes, the
  GIF read (the port's Pillow reader against `imageio.mimread` on RGB,
  palette, grey and transparent GIFs and on one with fewer frames than
  n_frm), `load_video_frames` (cv2), the crops and the three registered
  processors after one `random.seed`: bit-equal.
- `TgifDataset`: a sample's `input_ids`, `labels` and `video`, and the
  retry path on a corrupt GIF, bit-equal; the builder, the collators and
  the loader as `tests/test_video_pipeline.py` drives the JAX line.
- `generate(videos=)` and `make_generate_fn`: greedy tokens equal to JAX
  `generate(videos=)` on bridged weights, with the bf16 LLM and with the
  int8 LLM (W8A8 prefill, int8 KV cache).
- Three stage-1 steps on a batch of GIF and image rows against the jitted
  JAX step, at `tests/test_torch_train.py`'s tolerances.
- The stage-1 CLI on a YAML with `llava_cc3m` and `tgif` (as
  `configs/train/ullava_core.yaml` mixes them) against the JAX CLI from one
  fp32 starting tree: each step's loss and gradient norm within 1e-5.
"""

import functools
import json
import random

import imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import train_ullava_core as jcore_cli
from toy_tokenizer import ToyLlamaTokenizer
from torch_port_helpers import random_params
from ullava_tpu import parallel as jparallel
from ullava_tpu.config import Config as JConfig
from ullava_tpu.config import ConfigNode as JConfigNode
from ullava_tpu.data.datasets.tgif_dataset import TgifDataset as JTgifDataset
from ullava_tpu.data.processors import video_processor as jvp
from ullava_tpu.data.tools import video_transforms as jvt
from ullava_tpu.models import build as jbuild
from ullava_tpu.models import generate as jgen
from ullava_tpu.models import llama as jllama
from ullava_tpu.models import ullava_core as jcore
from ullava_tpu.ops import quant as jquant
from ullava_tpu.registry import registry as jregistry
from ullava_tpu.training import checkpoint as jckpt
from ullava_tpu.training import optim as joptim
from ullava_tpu.training import train_step as jstep
from ullava_tpu.training import trainer as jtrainer
import ullava_tpu_torch.data  # noqa: F401  (registers builders, processors, collators)
from ullava_tpu_torch import train_ullava_core
from ullava_tpu_torch.bridge import params_from_jax
from ullava_tpu_torch.config import Config, ConfigNode
from ullava_tpu_torch.constants import CLIP_MEAN, CLIP_STD, MM_TOKENS
from ullava_tpu_torch.data.collators import collators
from ullava_tpu_torch.data.datasets import TgifDataset
from ullava_tpu_torch.data.loader import DataLoader
from ullava_tpu_torch.data.processors import video_processor as vp
from ullava_tpu_torch.data.tools import video_transforms as vt
from ullava_tpu_torch.models import build, generate, llama, ullava_core
from ullava_tpu_torch.registry import registry
from ullava_tpu_torch.training import checkpoint, optim, trainer
from ullava_tpu_torch.training.train_step import make_stage1_step, make_train_state

N_FRM = 4
SIDE = 28  # the tiny CLIP's image size


def setup_module():
    torch.set_num_threads(1)


def _tok():
    tok = ToyLlamaTokenizer(model_max_length=128)
    tok.add_tokens(MM_TOKENS)
    return tok


def _frames(rng, n, h=32, w=40):
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(n)]


def _save_pil(path, images, **kw):
    images[0].save(path, save_all=True, append_images=images[1:], duration=80, loop=0, **kw)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """GIFs of each kind, a corrupt one, an AVI, PNGs and the annotation
    files of a `tgif` set and a chat set."""
    root = tmp_path_factory.mktemp("video")
    rng = np.random.default_rng(0)
    gifs = {}
    for i in range(4):
        gifs[f"rgb{i}"] = root / f"rgb{i}.gif"
        imageio.mimsave(gifs[f"rgb{i}"], _frames(rng, 6 + i))
    palette = rng.integers(0, 256, 768, dtype=np.uint8).tolist()
    pal = []
    for _ in range(5):
        im = Image.fromarray(rng.integers(0, 256, (30, 36), np.uint8), "P")
        im.putpalette(palette)
        pal.append(im)
    gifs["palette"] = root / "palette.gif"
    _save_pil(gifs["palette"], pal)
    gifs["transparent"] = root / "transparent.gif"
    _save_pil(gifs["transparent"], pal, transparency=7)
    gifs["grey"] = root / "grey.gif"
    _save_pil(gifs["grey"], [Image.fromarray(rng.integers(0, 256, (26, 30), np.uint8), "L")
                             for _ in range(5)])
    gifs["grey_one"] = root / "grey_one.gif"
    Image.fromarray(rng.integers(0, 256, (26, 30), np.uint8), "L").save(gifs["grey_one"])
    gifs["short"] = root / "short.gif"  # fewer frames than N_FRM
    imageio.mimsave(gifs["short"], _frames(rng, 3, 30, 30))
    (root / "corrupt.gif").write_bytes(b"GIF89a" + bytes(rng.integers(0, 256, 64, np.uint8)))

    import cv2

    video = root / "clip.avi"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"MJPG"), 10, (40, 32))
    for f in _frames(rng, 9):
        writer.write(f)
    writer.release()

    # Every clip of the set has N_FRM frames or more, so that its batches stack.
    names = ["rgb0", "palette", "rgb1", "grey", "rgb2", "rgb1", "rgb3", "transparent"]
    anno = [{"gif": f"{n}.gif", "conversations": [
        {"from": "human", "value": "What happens ?"},
        {"from": "gpt", "value": f"Motion {i} here ."}]} for i, n in enumerate(names)]
    anno.insert(1, {"gif": "corrupt.gif", "conversations": anno[0]["conversations"]})
    anno.append({"conversations": [{"from": "human", "value": "Say hi ."},
                                   {"from": "gpt", "value": "Hi ."}]})  # no GIF
    (root / "tgif.json").write_text(json.dumps(anno))
    images = root / "images"
    images.mkdir()
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (SIDE, 64, 3), np.uint8)).save(images / f"c{i}.png")
    chat = [{"image": f"c{i}.png", "conversations": [
        {"from": "human", "value": "<image>\nDescribe ."},
        {"from": "gpt", "value": f"Thing {i} is here ."}]} for i in range(4)]
    (root / "chat.json").write_text(json.dumps(chat))
    return {"root": root, "gifs": gifs, "video": str(video)}


def _both(fn_port, fn_jax, seed=0):
    random.seed(seed)
    got = fn_port()
    random.seed(seed)
    ref = fn_jax()
    return got, ref


def _equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------ transforms


def test_video_transforms_bit_equal():
    rng = np.random.default_rng(1)
    clip8 = rng.integers(0, 256, (3, 20, 24, 3), np.uint8)
    clipf = rng.standard_normal((3, 20, 24, 3)).astype(np.float32)
    for clip in (clip8, clipf):
        _equal(vt.crop(clip, 2, 3, 10, 12), jvt.crop(clip, 2, 3, 10, 12))
        for size in ((16, 14), (33, 29)):
            _equal(vt.resize(clip, size), jvt.resize(clip, size))
            _equal(vt.resize(clip, size, vt.BICUBIC), jvt.resize(clip, size, Image.BICUBIC))
        _equal(vt.resized_crop(clip, 1, 2, 15, 17, (12, 12)),
               jvt.resized_crop(clip, 1, 2, 15, 17, (12, 12)))
        _equal(vt.center_crop(clip, (11, 13)), jvt.center_crop(clip, (11, 13)))
        _equal(vt.normalize(clip, CLIP_MEAN, CLIP_STD), jvt.normalize(clip, CLIP_MEAN, CLIP_STD))
        _equal(vt.hflip(clip), jvt.hflip(clip))
        _equal(vt.to_float(clip), jvt.to_float(clip))
        for make in (lambda m: m.RandomCropVideo((9, 10)), lambda m: m.CenterCropVideo((9, 10)),
                     lambda m: m.NormalizeVideo(CLIP_MEAN, CLIP_STD),
                     lambda m: m.RandomHorizontalFlipVideo(0.5)):
            for seed in range(4):
                got, ref = _both(lambda: make(vt)(clip), lambda: make(jvt)(clip), seed)
                _equal(got, ref)
    assert vt.BILINEAR == Image.BILINEAR and vt.BICUBIC == Image.BICUBIC


# ------------------------------------------------------------ processors


def test_sample_indices_both_modes():
    for vlen in (1, 2, 3, 7, 8, 9, 30):
        for n_frm in (1, 4, 8):
            for sampling in ("uniform", "headtail"):
                for seed in range(3):
                    got, ref = _both(lambda: vp.sample_indices(vlen, n_frm, sampling),
                                     lambda: jvp.sample_indices(vlen, n_frm, sampling), seed)
                    assert got == ref
    with pytest.raises(NotImplementedError):
        vp.sample_indices(4, 2, "rand")


def test_gif_read_matches_imageio(media):
    """The Pillow reader gives `imageio.mimread`'s frames: palette frames
    converted to their palette's mode, grey frames as they are."""
    for name, path in media["gifs"].items():
        got, ref = vp.read_gif(str(path)), imageio.mimread(str(path), memtest=False)
        assert len(got) == len(ref), name
        for g, r in zip(got, ref):
            _equal(g, r)
        for sampling in ("uniform", "headtail"):
            if len(ref) == 1 and sampling == "headtail":  # no frame drawn: both fail
                for mod in (vp, jvp):
                    with pytest.raises(ValueError, match="at least one array"):
                        mod.load_gif_frames(str(path), N_FRM, sampling)
                continue
            out, jout = _both(lambda: vp.load_gif_frames(str(path), N_FRM, sampling),
                              lambda: jvp.load_gif_frames(str(path), N_FRM, sampling))
            _equal(out, jout)
            assert out.ndim == 4 and out.shape[-1] == 3 and out.shape[0] <= N_FRM
    assert vp.load_gif_frames(str(media["gifs"]["short"]), N_FRM).shape[0] == 3


def test_processors_bit_equal(media):
    gifs = [p for name, p in media["gifs"].items() if name != "grey_one"]  # one frame: none drawn
    kinds = {"gif_train": gifs, "video_train": [media["video"]],
             "video_eval": [media["video"]]}
    cfg = {"image_size": SIDE, "n_frm": N_FRM, "min_scale": 0.3}
    for name, paths in kinds.items():
        proc = registry.get_processor_class(name).from_config(cfg)
        jproc = jregistry.get_processor_class(name).from_config(cfg)
        assert (proc.sampling, proc.train, proc.min_scale) == (jproc.sampling, jproc.train, 0.3)
        for path in paths:
            for seed in range(3):
                got, ref = _both(lambda: proc(str(path)), lambda: jproc(str(path)), seed)
                _equal(got, ref)
                assert got.shape[1:] == (SIDE, SIDE, 3) and got.dtype == np.float32
    frames = vp.load_video_frames(media["video"], N_FRM)
    _equal(frames, jvp.load_video_frames(media["video"], N_FRM))
    # The crop's fallback after 10 draws: a window larger than the frame.
    got, ref = _both(lambda: vp.random_resized_crop(frames, 12, 1.5, 2.0),
                     lambda: jvp.random_resized_crop(frames, 12, 1.5, 2.0))
    _equal(got, ref)
    _equal(vp._center_crop(frames, 12), jvp._center_crop(frames, 12))
    _equal(vp._normalize(frames), jvp._normalize(frames))
    with pytest.raises(IOError):
        vp.load_video_frames(str(media["root"] / "missing.avi"), N_FRM)


# ------------------------------------------------------------ dataset and loader


def _tgif(cls, proc_mod, media, tok):
    proc = proc_mod.GIFTrainProcessor(image_size=SIDE, n_frm=N_FRM)
    return cls(proc, tok, str(media["root"]), str(media["root"] / "tgif.json"), image_token_len=4)


def test_tgif_dataset_bit_equal_with_the_retry(media, capsys):
    ds, jds = _tgif(TgifDataset, vp, media, _tok()), _tgif(JTgifDataset, jvp, media, _tok())
    assert ds.image_token_len == jds.image_token_len == N_FRM + 4
    assert len(ds) == len(jds) == 10
    for index in range(len(ds)):
        got, ref = _both(lambda: ds[index], lambda: jds[index], seed=index)
        assert set(got) == set(ref)
        for k in ref:
            _equal(got[k], ref[k])
    out = capsys.readouterr().out
    n = out.count("Failed to load video corrupt.gif")  # as often in each package
    assert n >= 2 and n % 2 == 0
    vid = _tok().convert_tokens_to_ids("<video_patch>")
    assert (np.asarray(ds[0]["input_ids"]) == vid).sum() == N_FRM + 4
    assert "video" not in ds[9]

    class Broken(TgifDataset):
        def __init__(self):
            self.annotation = [{"gif": "corrupt.gif", "conversations": []}]
            self.vis_root = str(media["root"])
            self.vis_processor = vp.GIFTrainProcessor(image_size=SIDE, n_frm=N_FRM)

    with pytest.raises(RuntimeError, match="after 10 retries"):
        Broken()[0]


def test_builder_collators_and_loader(media):
    """`tests/test_video_pipeline.py`'s chain: the `tgif` builder, the
    video collator and the loader, the batch equal to the JAX line's."""
    def cfg(node):
        return node({"data_type": "gif", "image_token_len": 4, "vis_processor": "gif_train",
                     "build_info": {"anno_dir": str(media["root"] / "tgif.json"),
                                    "image_dir": str(media["root"])}})

    proc_cfg = {"gif_train": {"image_size": SIDE, "n_frm": N_FRM}}
    ds = registry.get_builder_class("tgif")(cfg(ConfigNode), _tok(), "conv_simple").build(
        ConfigNode(proc_cfg))
    jds = jregistry.get_builder_class("tgif")(cfg(JConfigNode), _tok(), "conv_simple").build(
        JConfigNode(proc_cfg))
    assert isinstance(ds, TgifDataset)
    kw = dict(batch_size=4, shuffle=True, seed=3, num_workers=1)
    for name in ("video_collator", "image_video_collator"):
        col = registry.get_collator_class(name)(0, pad_multiple=8)
        jcol = jregistry.get_collator_class(name)(0, pad_multiple=8)
        got, ref = _both(lambda: list(DataLoader(ds, collate_fn=col, **kw)),
                         lambda: list(DataLoader(jds, collate_fn=jcol, **kw)))
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            assert set(g) == set(r) and g["videos"].shape == (4, N_FRM, SIDE, SIDE, 3)
            for k in r:
                _equal(g[k], r[k])
    batch = collators.VideoCollator(0)([ds[0], ds[9]])  # a row without a video gets zeros
    assert not batch["videos"][1].any() and batch["videos"][0].any()
    tensors = next(iter(DataLoader(ds, collate_fn=collators.VideoCollator(0), device="cpu",
                                   batch_size=2, num_workers=1)))
    assert tensors["videos"].dtype == torch.float32 and tensors["videos"].shape[0] == 2


# ------------------------------------------------------------ generate


def _video_batch(cfg, rng, lens, T=3):
    """Right-padded prompts with a video span after `<vid_beg>` (T
    temporal + P spatial tokens) and the videos; row 1 also has an image."""
    P = cfg.vision.num_patches
    ids = rng.integers(10, 140, size=(len(lens), max(lens)))
    for b, n in enumerate(lens):
        ids[b, 1], ids[b, 2:2 + T + P], ids[b, 2 + T + P] = cfg.vid_start_id, 4, cfg.vid_end_id
        ids[b, n:] = 0
    s = 3 + T + P
    ids[1, s], ids[1, s + 1:s + 1 + P], ids[1, s + 1 + P] = cfg.img_start_id, 3, cfg.img_end_id
    side = cfg.vision.image_size
    return {"input_ids": ids, "prompt_lens": np.asarray(lens, np.int32),
            "images": rng.standard_normal((len(lens), side, side, 3)).astype(np.float32),
            "videos": rng.standard_normal((len(lens), T, side, side, 3)).astype(np.float32)}


@pytest.mark.parametrize("int8", [False, True], ids=["plain_llm", "int8_llm"])
def test_generate_videos_matches_jax(int8):
    """Greedy tokens of `generate(videos=)` (and with an image beside the
    video in row 1) equal JAX's; `make_generate_fn` gives `generate`'s.
    The tiny configs' fp32: in bf16 the two frameworks' roundings part
    greedy decoding at near-ties (5 of 84 tokens on this draw)."""
    kw = dict(vocab_size=160)
    tkw = dict(vocab_size=160)
    if int8:
        kw.update(a8_prefill=True, kv_quant=True)
        tkw.update(a8_prefill=True, kv_quant=True)
    jcfg = jcore.UllavaCoreConfig.tiny(llm=jllama.LlamaConfig.tiny(**kw))
    cfg = ullava_core.UllavaCoreConfig.tiny(llm=llama.LlamaConfig.tiny(**tkw))
    jparams = jax.tree_util.tree_map(jnp.asarray, random_params(jcore.init_params, jcfg, seed=7))
    if int8:
        jparams["llm"] = jquant.quantize_tree(jparams["llm"], jquant.LLAMA_QUANT_KEYS)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    batch = _video_batch(cfg, np.random.default_rng(7), [26, 34])
    new = 8
    ref = jax.jit(jgen.generate, static_argnums=(1, 2))(
        jparams, jcfg, jgen.GenerateConfig(max_new_tokens=new, temperature=0.0),
        **{k: jnp.asarray(v) for k, v in batch.items()})
    gc = generate.GenerateConfig(max_new_tokens=new, temperature=0.0)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = generate.generate(params, cfg, gc, **tb)
    np.testing.assert_array_equal(out["sequences"].numpy(), np.asarray(ref["sequences"]))
    np.testing.assert_array_equal(out["lengths"].numpy(), np.asarray(ref["lengths"]))
    fn_out = generate.make_generate_fn(cfg, gc)(params, tb["input_ids"], tb["prompt_lens"],
                                               images=tb["images"], videos=tb["videos"])
    assert torch.equal(fn_out["sequences"], out["sequences"])
    # The video changes the answer: it is spliced.
    no_video = generate.generate(params, cfg, gc, input_ids=tb["input_ids"],
                                 prompt_lens=tb["prompt_lens"], images=tb["images"])
    assert not torch.equal(no_video["hidden_last"], out["hidden_last"])


# ------------------------------------------------------------ stage-1 steps


def test_stage1_steps_on_a_video_batch_match_jax(media):
    """Three stage-1 steps (pretraining, remat on) on two GIF rows and two
    image rows through `image_video_collator` (each row's missing medium
    zero), against the jitted JAX step: loss and gradient norm within
    1e-5 a step, the trainable leaves as `tests/test_torch_train.py` holds
    them, the frozen ones bit-unchanged."""
    tok = _tok()
    ds = _tgif(TgifDataset, vp, media, tok)
    proc_img = registry.get_processor_class("clip_image").from_config({"image_size": SIDE})
    from ullava_tpu_torch.data.datasets import LLaVADataset

    chat = LLaVADataset(proc_img, tok, str(media["root"] / "images"),
                        str(media["root"] / "chat.json"), image_token_len=4)
    random.seed(0)
    rows = [ds[0], chat[0], ds[2], chat[1]]
    batch = collators.ImageVideoCollator(tok.pad_token_id, pad_multiple=8)(rows)
    assert not batch["images"][0].any() and not batch["videos"][1].any()
    ids = {t: tok.convert_tokens_to_ids(t) for t in MM_TOKENS}
    marks = dict(img_start_id=ids["<img_beg>"], img_end_id=ids["</img_end>"],
                 vid_start_id=ids["<vid_beg>"], vid_end_id=ids["</vid_end>"])
    jcfg = jcore.UllavaCoreConfig.tiny(llm=jllama.LlamaConfig.tiny(vocab_size=160, remat=True),
                                       **marks)
    cfg = ullava_core.UllavaCoreConfig.tiny(llm=llama.LlamaConfig.tiny(vocab_size=160, remat=True),
                                            **marks)
    jparams = {"core": random_params(jcore.init_params, jcfg, seed=3)}
    lr = 1e-3
    tx = joptim.make_optimizer(lr)
    jstate, jlabels = jstep.make_train_state(
        jax.tree_util.tree_map(jnp.asarray, jparams), tx, joptim.STAGE1_PRETRAIN)
    jfn = jstep.jit_step(jstep.make_stage1_step(jcfg, tx, jlabels))
    params = params_from_jax(jparams, device="cpu")
    # A video's B x T frames go through the images' CLIP readout: its
    # temporal tokens are each frame's patch mean, its spatial ones the
    # frames' mean.
    videos = torch.as_tensor(batch["videos"][:1])
    feats = ullava_core.encode_image(params["core"], cfg, videos[0])
    np.testing.assert_array_equal(
        ullava_core.encode_video(params["core"], cfg, videos)[0].numpy(),
        torch.cat([feats.mean(1), feats.mean(0)]).numpy())
    before = [(n, t.clone()) for n, t in optim.named_leaves(params)]
    state, labels = make_train_state(params, optim.make_optimizer(lr), optim.STAGE1_PRETRAIN)
    fn = make_stage1_step(cfg, optim.make_optimizer(lr), labels)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = fn(state, tbatch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   atol=1e-5, rtol=1e-5)
    after = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), device="cpu")
    n_train = 0
    for (name, t0), (_, t), (_, r), (_, lab) in zip(
            before, optim.named_leaves(state.params), optim.named_leaves(after),
            optim.named_leaves(labels)):
        if lab == "train":
            n_train += 1
            assert not torch.equal(t, t0), name
            diff = (t - r).abs()
            assert (diff <= 1e-4 * lr + 1e-5 * r.abs()).float().mean() >= 0.999, name
            assert diff.max() <= 3 * 2 * lr, name
        else:
            assert torch.equal(t, t0), name
    assert n_train == 3


# ------------------------------------------------------------ the stage-1 CLI


def _default_dtype(fn, dtype):
    @functools.wraps(fn)
    def wrapped(model_cfg, tokenizer, dt=dtype, *args, **kw):
        return fn(model_cfg, tokenizer, kw.pop("dtype", dt), *args, **kw)
    return wrapped


def _cli_dict(media, ckpt, out):
    root = media["root"]
    return {
        "model": {"arch": "ullava_core", "conv_type": "conv_simple",
                  "projector_from_scratch": True, "pretrained_core": str(ckpt)},
        "task": {"type": "image_text_pretrain", "collator_type": "image_video_collator"},
        "processor": {"clip_image": {"image_size": SIDE},
                      "gif_train": {"n_frm": N_FRM, "image_size": SIDE}},
        "dataset": {
            "llava_cc3m": {"data_type": "image", "image_token_len": 4,
                           "vis_processor": "clip_image",
                           "build_info": {"anno_dir": str(root / "chat.json"),
                                          "image_dir": str(root / "images"), "portion": 1.0}},
            "tgif": {"data_type": "gif", "image_token_len": 4, "vis_processor": "gif_train",
                     "build_info": {"anno_dir": str(root / "tgif.json"),
                                    "image_dir": str(root), "portion": 1.0}}},
        "training": {"output_dir": str(out), "learning_rate": 1e-3, "model_max_length": 128,
                     "per_device_train_batch_size": 4, "num_train_epochs": 1,
                     "logging_steps": 1, "save_steps": 100, "dataloader_num_workers": 1,
                     "warmup_ratio": 0.0, "seed": 42},
    }


def test_stage1_cli_on_images_and_gifs_matches_jax(media, tmp_path, monkeypatch):
    """`train_ullava_core.train` on `configs/train/ullava_core.yaml`'s mix
    (14 rows: 4 chat images, 10 tgif rows, one corrupt and one without a
    GIF) at B=4, from one fp32 tree in both layouts: three steps, each
    loss and gradient norm within 1e-5 of the JAX CLI's."""
    _, core = jbuild.build_ullava_core({}, _tok(), dtype=jnp.float32, rng=jax.random.PRNGKey(5))
    core = jax.tree_util.tree_map(np.asarray, core)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, core)
    checkpoint.save_checkpoint(str(tmp_path / "port"), 1, params_from_jax(core, device="cpu"))
    for module, dtype in ((jbuild, jnp.float32), (build, torch.float32)):
        monkeypatch.setattr(module, "build_ullava_core",
                            _default_dtype(module.build_ullava_core, dtype))
    monkeypatch.setattr(jparallel, "make_mesh",
                        functools.partial(jparallel.make_mesh, devices=jax.devices()[:1]))
    logs = {"jax": [], "port": []}

    def recording(base, log):
        class Recording(base):
            def __init__(self, *, step_fn, **kw):
                def step(state, batch):
                    assert batch["videos"].shape[1:] == (N_FRM, SIDE, SIDE, 3)
                    state, m = step_fn(state, batch)
                    log.append((float(np.asarray(m["loss"])), float(np.asarray(m["grad_norm"]))))
                    return state, m
                super().__init__(step_fn=step, **kw)
        return Recording

    monkeypatch.setattr(jtrainer, "Trainer", recording(jtrainer.Trainer, logs["jax"]))
    monkeypatch.setattr(trainer, "Trainer", recording(trainer.Trainer, logs["port"]))
    random.seed(0)
    jstate = jcore_cli.train(JConfig(cfg_dict=_cli_dict(media, tmp_path / "jax/checkpoint-1",
                                                        tmp_path / "j")), tokenizer=_tok())
    random.seed(0)
    state = train_ullava_core.train(Config(cfg_dict=_cli_dict(media, tmp_path / "port/checkpoint-1",
                                                              tmp_path / "p")),
                                    tokenizer=_tok(), device="cpu")
    assert int(jstate.step) == state.step == 3
    np.testing.assert_allclose(np.asarray(logs["port"]), np.asarray(logs["jax"]),
                               rtol=1e-5, atol=1e-5)
    assert all(np.isfinite(logs["port"]).ravel())
