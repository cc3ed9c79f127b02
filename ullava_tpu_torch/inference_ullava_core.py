"""Stage-1 chat CLI of the port: captioning / VQA (counterpart of the
root `inference_ullava_core.py`).

    python -m ullava_tpu_torch.inference_ullava_core --cfg_path <yaml> \
        --image <path> [--query "Describe the image."] [--temperature 0.2] \
        [--top_p 0.9] [--device cpu]

Prompt templating, CLIP preprocessing and `generate` with keyword
stopping, on the card unless `--device` (or `device=`) says otherwise.
Without --query the script drops into a REPL. The image is a path
(decoded with PIL) or, from Python, a uint8 HWC RGB array.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger("inference_ullava_core")


def load_image(image) -> np.ndarray:
    """A path (decoded with PIL, imported only here) or a uint8 HWC RGB
    array -> uint8 HWC RGB array."""
    if isinstance(image, np.ndarray):
        if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"expected a uint8 HWC RGB array, got {image.dtype} {image.shape}")
        return image
    from PIL import Image

    with Image.open(image) as img:
        return np.asarray(img.convert("RGB"))


def build_prompt(conv_type: str, query: str, image_token_len: int):
    from ullava_tpu_torch.conversation import conversation_lib
    from ullava_tpu_torch.tokenization import preprocess_image_text

    src = [{"from": "human", "value": f"<image>\n{query}"}]
    preprocess_image_text(src, cur_token_len=image_token_len)
    conv = conversation_lib[conv_type].copy()
    conv.append_message(conv.roles[0], src[0]["value"])
    conv.append_message(conv.roles[1], None)
    return conv


def strip_stops(text: str, conv) -> str:
    for stop_str in ("###", conv.sep2 or ""):
        if stop_str and text.endswith(stop_str):
            text = text[: -len(stop_str)].strip()
    return text


class CoreChat:
    """Stage-1 chat session: the model loads ONCE on `device` (the card
    when None); each query re-runs only the prompt build and `generate`."""

    def __init__(self, cfg, tokenizer=None, device=None):
        from ullava_tpu_torch import resolve_device
        from ullava_tpu_torch.data.processors import CLIPProcessor
        from ullava_tpu_torch.models import build as model_build

        self.device = resolve_device(device)
        model_cfg = cfg.model_cfg
        self.tokenizer = tokenizer or model_build.build_tokenizer(model_cfg.get("llm_path"))
        self.core_cfg, self.params = model_build.build_ullava_core(
            model_cfg, self.tokenizer, device=self.device
        )
        self.conv_type = model_cfg.get("conv_type", "conv_simple")
        self.proc = CLIPProcessor(image_size=self.core_cfg.vision.image_size, aspect_ratio="pad")

    def ask(self, image, query, temperature=0.2, top_p=None, max_new_tokens=128,
            generator: Optional[torch.Generator] = None):
        from ullava_tpu_torch.models import generate as gen_mod
        from ullava_tpu_torch.models.tools import keyword_stop_ids

        conv = build_prompt(self.conv_type, query, self.core_cfg.vision.num_patches)
        ids = np.asarray(self.tokenizer(conv.get_prompt())["input_ids"], np.int64)
        pixels = self.proc(load_image(image))

        stops = keyword_stop_ids(self.tokenizer, [conv.sep2 or conv.sep])
        gen = gen_mod.GenerateConfig(
            max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
            stop_token_ids=stops, vocab_size=len(self.tokenizer),
        )
        out = gen_mod.generate(
            self.params, self.core_cfg, gen,
            input_ids=torch.as_tensor(ids[None], device=self.device),
            prompt_lens=torch.tensor([len(ids)], dtype=torch.int32, device=self.device),
            images=torch.as_tensor(pixels[None], device=self.device),
            generator=generator,
        )
        T = int(out["lengths"][0])
        answer_ids = out["sequences"][0, len(ids):T].cpu().numpy()
        text = self.tokenizer.decode(answer_ids, skip_special_tokens=True).strip()
        return strip_stops(text, conv)


def eval_model(cfg, image, query, temperature=0.2, top_p=None, max_new_tokens=128,
               tokenizer=None, device=None, generator: Optional[torch.Generator] = None):
    """One-shot wrapper (builds the model; use CoreChat for a session)."""
    return CoreChat(cfg, tokenizer=tokenizer, device=device).ask(
        image, query, temperature, top_p, max_new_tokens, generator
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_path", required=True)
    parser.add_argument("--image", required=True)
    parser.add_argument("--query", default=None)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--max_new_tokens", type=int, default=128)
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)

    from ullava_tpu_torch.config import Config
    import ullava_tpu_torch.models.build  # noqa: F401  (registers the archs)

    chat = CoreChat(Config(args.cfg_path), device=args.device)
    if args.query:
        print(chat.ask(args.image, args.query, args.temperature, args.top_p,
                       args.max_new_tokens))
        return
    while True:
        try:
            query = input("USER: ").strip()
        except EOFError:
            break
        if not query or query in ("exit", "quit"):
            break
        print("ASSISTANT:", chat.ask(args.image, query, args.temperature, args.top_p,
                                     args.max_new_tokens))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
