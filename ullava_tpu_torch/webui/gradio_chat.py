"""Chat backend of the web demo (counterpart of `webui/gradio_chat.py`).

`Chat.seg` answers one query about one image through
`inference_ullava.answer`, the path `run_once` takes (the prompt, either
preprocess, `ullava.evaluate`: generation, [SEG]/[LOC] readout, SAM
decode, then the host post-processing), on a model built once. It needs
no gradio, so it is also the programmatic serving API. The model runs on the card unless
`device` says otherwise.
"""

from __future__ import annotations

import numpy as np


class Chat:
    def __init__(self, cfg, tokenizer=None, device=None):
        from ullava_tpu_torch import resolve_device
        from ullava_tpu_torch.models import build as model_build

        self.cfg = cfg
        self.device = resolve_device(device)
        model_cfg = cfg.model_cfg
        self.tokenizer = tokenizer or model_build.build_tokenizer(model_cfg.get("llm_path"))
        self.u_cfg, self.params = model_build.build_ullava(
            model_cfg, self.tokenizer, device=self.device)
        self.conv_type = model_cfg.get("conv_type", "conv_sep2")

    def seg(self, image: np.ndarray, query: str, temperature: float = 0.2,
            top_p=None, max_new_tokens: int = 64,
            device_preprocess: bool = False):
        """image: uint8 HWC RGB array. Returns {"text", "masks" (uint8
        [H, W] each), "boxes" (xyxy in the image's pixels)}:
        `inference_ullava.answer` on the model built once.
        `device_preprocess` is `inference_ullava.prepare_query`'s."""
        from ullava_tpu_torch.inference_ullava import answer

        return answer(self.u_cfg, self.params, self.tokenizer, image, query,
                      self.conv_type, temperature, top_p, max_new_tokens,
                      self.device, device_preprocess=device_preprocess)
