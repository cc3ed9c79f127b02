"""Conversation prompt templating (counterpart of
`ullava_tpu/conversation.py`).

Three separator styles (SINGLE ``###``, TWO ``' '``/``</s>``, LLAMA_2
``[INST]``-wrapped), three library templates (``conv_simple`` /
``conv_sep2`` / ``conv_llama2``) and the same rendered strings from
``get_prompt()``: prompt bytes fix the token ids.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    LLAMA_2 = enum.auto()


def _as_text(message) -> str:
    # Rich messages may arrive as (text, image, meta) tuples; only the text
    # participates in the prompt.
    if isinstance(message, tuple):
        return message[0]
    return message


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"
    skip_next: bool = False

    def get_prompt(self) -> str:
        if self.sep_style is SeparatorStyle.SINGLE:
            parts = [self.system, self.sep]
            for role, message in self.messages:
                if message:
                    parts += [role, ": ", _as_text(message), self.sep]
                else:
                    parts += [role, ":"]
            return "".join(parts)

        if self.sep_style is SeparatorStyle.TWO:
            seps = (self.sep, self.sep2)
            parts = [self.system, seps[0]]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    parts += [role, ": ", _as_text(message), seps[i % 2]]
                else:
                    parts += [role, ":"]
            return "".join(parts)

        if self.sep_style is SeparatorStyle.LLAMA_2:
            parts: List[str] = []
            for i, (role, message) in enumerate(self.messages):
                if i == 0:
                    if not message:
                        raise ValueError("first message should not be empty")
                    if role != self.roles[0]:
                        raise ValueError("first message must come from the user role")
                if message:
                    text = _as_text(message)
                    if i == 0:
                        text = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" + text
                    if i % 2 == 0:
                        parts.append(f"[INST] {text} [/INST]")
                    else:
                        parts.append(" " + text + self.sep2)
            # A leading bos separator is stripped from the rendered string.
            return "".join(parts).lstrip(self.sep)

        raise ValueError(f"Invalid separator style: {self.sep_style}")

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def dict(self):
        return {
            "system": self.system,
            "roles": self.roles,
            "messages": self.messages,
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


_VICUNA_SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions."
)

conv_simple = Conversation(
    system="",
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_sep2 = Conversation(
    system=_VICUNA_SYSTEM,
    roles=("USER", "ASSISTANT"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_llama2 = Conversation(
    system=(
        "You are a helpful language and vision assistant. "
        "You are able to understand the visual content that the user provides, "
        "and assist the user with a variety of tasks using natural language."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conversation_lib = {
    "conv_simple": conv_simple,
    "conv_sep2": conv_sep2,
    "conv_llama2": conv_llama2,
}

default_conversation = conv_sep2
