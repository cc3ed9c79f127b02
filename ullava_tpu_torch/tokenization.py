"""Host-side conversation tokenization and label masking (counterpart of
`ullava_tpu/tokenization.py`).

- ``preprocess_sep1``: stage-1 ``###``-signal conversations; human turns
  masked to IGNORE_INDEX (after a 2-token speaker-prefix skip).
- ``preprocess_sep2``: stage-2 TWO/LLAMA_2 style; per-round instruction
  masking with the ``-2`` LLaMA-tokenizer offset and the
  tokenization-mismatch guard that nulls a sample's labels with a
  warning.
- ``preprocess_image_text`` / ``preprocess_video_text``: replace/append
  ``<image>`` / video spans with ``<img_beg> <image_patch>*N </img_end>``
  (resp. ``<vid_beg> ... </vid_end>``) token runs.

Everything here is host-side Python/NumPy: outputs are ``np.int32``
arrays; the tokenizer is the caller's.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence

import numpy as np

from ullava_tpu_torch.constants import (
    DEFAULT_IMAGE_PATCH_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_IMG_END_TOKEN,
    DEFAULT_IMG_START_TOKEN,
    DEFAULT_VID_END_TOKEN,
    DEFAULT_VID_START_TOKEN,
    DEFAULT_VIDEO_PATCH_TOKEN,
    IGNORE_INDEX,
)
from ullava_tpu_torch.conversation import SeparatorStyle, conversation_lib

logger = logging.getLogger(__name__)

_BEGIN_SIGNAL = "###"
_END_SIGNAL = "\n"


def _encode(tokenizer, text: str, truncation: bool = True) -> np.ndarray:
    """Tokenize one string -> 1-D int32 ids (includes BOS, like HF llama)."""
    ids = tokenizer(
        text,
        max_length=getattr(tokenizer, "model_max_length", None),
        truncation=truncation,
    )["input_ids"]
    return np.asarray(ids, dtype=np.int32)


def _encode_len(tokenizer, text: str) -> int:
    """Non-pad token count of one tokenized string."""
    ids = _encode(tokenizer, text)
    pad_id = getattr(tokenizer, "pad_token_id", None)
    if pad_id is None:
        return len(ids)
    return int((ids != pad_id).sum())


def add_speaker_signal(header: str, source: Sequence[dict], roles) -> str:
    """Wrap each turn as ``###Role: text\\n``, mutating the source values
    in place (the label masking reads them back)."""
    conversation = header
    for sentence in source:
        from_str = sentence["from"].lower()
        if from_str == "human":
            role = roles[0]
        elif from_str == "gpt":
            role = roles[1]
        else:
            role = "unknown"
        sentence["value"] = _BEGIN_SIGNAL + role + ": " + sentence["value"] + _END_SIGNAL
        conversation += sentence["value"]
    conversation += _BEGIN_SIGNAL
    return conversation


def preprocess_sep1(
    sources: Sequence[Sequence[dict]],
    tokenizer,
    conv_type: str = "conv_simple",
) -> Dict[str, List[np.ndarray]]:
    """Stage-1 tokenization: ### signals, human turns masked."""
    conv = conversation_lib[conv_type].copy()
    header = f"{conv.system}\n\n"
    conversations = [add_speaker_signal(header, src, conv.roles) for src in sources]

    input_ids = [_encode(tokenizer, c) for c in conversations]
    labels = []
    for ids, source in zip(input_ids, sources):
        target = ids.copy()
        seg_lens = [_encode_len(tokenizer, header)] + [
            _encode_len(tokenizer, s["value"]) for s in source
        ]
        speakers = [s["from"] for s in source]
        # Mask the header, then every human turn but its 2-token speaker
        # prefix.
        cur = seg_lens[0]
        target[:cur] = IGNORE_INDEX
        for seg_len, speaker in zip(seg_lens[1:], speakers):
            if speaker == "human":
                target[cur + 2 : cur + seg_len] = IGNORE_INDEX
            cur += seg_len
        labels.append(target)

    return {"input_ids": input_ids, "labels": labels}


def preprocess_sep2(
    sources: Sequence[Sequence[dict]],
    tokenizer,
    conv_type: str = "conv_sep2",
) -> Dict[str, List[np.ndarray]]:
    """Stage-2 tokenization for TWO / LLAMA_2 styles with per-round
    instruction masking (the ``-2`` llama offset is load-bearing)."""
    conv = conversation_lib[conv_type].copy()
    if conv.sep_style not in (SeparatorStyle.TWO, SeparatorStyle.LLAMA_2):
        raise ValueError(f"preprocess_sep2 needs TWO/LLAMA_2 style, got {conv.sep_style}")
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}

    conversations = []
    for source in sources:
        if roles.get(source[0]["from"]) != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            if role != conv.roles[j % 2]:
                raise ValueError("conversation roles must alternate human/gpt")
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())

    input_ids = [_encode(tokenizer, c) for c in conversations]

    sep = "[/INST] " if conv_type == "conv_llama2" else conv.sep + conv.roles[1] + ": "
    pad_id = getattr(tokenizer, "pad_token_id", None)
    model_max_length = getattr(tokenizer, "model_max_length", int(1e9))

    labels = []
    for conversation, ids in zip(conversations, input_ids):
        target = ids.copy()
        total_len = len(ids) if pad_id is None else int((ids != pad_id).sum())

        rounds = conversation.split(conv.sep2)
        cur_len = 1  # BOS stays masked
        target[:cur_len] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                raise ValueError(f"round does not split into (instruction, answer): {rou!r}")
            instruction = parts[0] + sep

            round_len = len(_encode(tokenizer, rou, truncation=False))
            # "-2": llama's tokenizer emits BOS + a leading space token for
            # the round remainder, compensated by a fixed offset.
            instruction_len = len(_encode(tokenizer, instruction, truncation=False)) - 2

            target[cur_len : cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX

        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            logger.warning("tokenization mismatch: %d vs. %d (sample ignored)", cur_len, total_len)
        labels.append(target)

    return {"input_ids": input_ids, "labels": labels}


def preprocess(sources, tokenizer, conv_type: str = "conv_simple"):
    """Dispatch on the conversation's separator style."""
    style = conversation_lib[conv_type].sep_style
    if style is SeparatorStyle.SINGLE:
        return preprocess_sep1(sources, tokenizer, conv_type)
    return preprocess_sep2(sources, tokenizer, conv_type)


def preprocess_image_text(conversation_list: Sequence[dict], cur_token_len: int):
    """Replace ``<image>`` with the patch-token run, forcing the image
    marker to the front of the sentence."""
    replace_token = (
        DEFAULT_IMG_START_TOKEN
        + DEFAULT_IMAGE_PATCH_TOKEN * cur_token_len
        + DEFAULT_IMG_END_TOKEN
    )
    for sentence in conversation_list:
        if DEFAULT_IMAGE_TOKEN in sentence["value"]:
            stripped = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
            sentence["value"] = (DEFAULT_IMAGE_TOKEN + "\n" + stripped).strip()
        sentence["value"] = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, replace_token)
    return [conversation_list]


def preprocess_video_text(conversation_list: Sequence[dict], cur_token_len: int):
    """Append the video patch-token run to the first turn."""
    replace_token = (
        DEFAULT_VID_START_TOKEN
        + DEFAULT_VIDEO_PATCH_TOKEN * cur_token_len
        + DEFAULT_VID_END_TOKEN
    )
    conversation_list[0]["value"] += replace_token
    return [conversation_list]
