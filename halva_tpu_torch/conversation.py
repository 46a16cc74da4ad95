"""Prompt-template assembly.

A functional re-design of the reference's conversation state machine
(llava/conversation.py:6-377).  The reference mutates a
dataclass and renders with a 5-way separator-style switch; here each style is
a pure render function over an immutable template + message list, which keeps
prompt construction trivially testable and host-side only (no device code).

Byte-exactness of the rendered prompt matters: the DPA loss and all eval
metrics depend on token alignment (see reference llava/train/train_halva.py:426
sanity check), so renderers reproduce the reference's output strings exactly,
including separators and trailing role colons for generation prompts.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import Optional, Sequence, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()


Message = Tuple[str, Optional[str]]  # (role, text or None for generation slot)


@dataclasses.dataclass(frozen=True)
class ConvTemplate:
    """Immutable prompt template. `messages` holds few-shot seed turns."""

    system: str
    roles: Tuple[str, str]
    sep_style: SeparatorStyle
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "unknown"
    messages: Tuple[Message, ...] = ()
    offset: int = 0

    def render(self, messages: Sequence[Message]) -> str:
        all_msgs = list(self.messages) + list(messages)
        return _RENDERERS[self.sep_style](self, all_msgs)

    def prompt(self, user: str, assistant: Optional[str] = None) -> str:
        """Single-turn convenience: user message + assistant slot/answer."""
        return self.render(
            [(self.roles[0], user), (self.roles[1], assistant)]
        )

    def stop_str(self) -> str:
        """The string at which generation should stop."""
        if self.sep_style == SeparatorStyle.TWO:
            return self.sep2 or self.sep
        return self.sep


def _render_single(t: ConvTemplate, msgs: Sequence[Message]) -> str:
    out = t.system + t.sep
    for role, text in msgs:
        if text:
            out += role + ": " + text + t.sep
        else:
            out += role + ":"
    return out


def _render_two(t: ConvTemplate, msgs: Sequence[Message]) -> str:
    seps = (t.sep, t.sep2)
    out = t.system + seps[0]
    for i, (role, text) in enumerate(msgs):
        if text:
            out += role + ": " + text + seps[i % 2]
        else:
            out += role + ":"
    return out


def _render_mpt(t: ConvTemplate, msgs: Sequence[Message]) -> str:
    out = t.system + t.sep
    for role, text in msgs:
        if text:
            out += role + text + t.sep
        else:
            out += role
    return out


def _render_plain(t: ConvTemplate, msgs: Sequence[Message]) -> str:
    seps = (t.sep, t.sep2)
    out = t.system
    for i, (_, text) in enumerate(msgs):
        if text:
            out += text + seps[i % 2]
    return out


def _render_llama2(t: ConvTemplate, msgs: Sequence[Message]) -> str:
    wrap_sys = lambda m: f"<<SYS>>\n{m}\n<</SYS>>\n\n" if m else ""
    out = ""
    for i, (role, text) in enumerate(msgs):
        if i == 0 and not text:
            raise ValueError("first llama2 message must be the user turn")
        if text:
            if i == 0:
                text = wrap_sys(t.system) + text
            if i % 2 == 0:
                out += t.sep + f"[INST] {text} [/INST]"
            else:
                out += " " + text + " " + (t.sep2 or "")
    return out.lstrip(t.sep)


_RENDERERS = {
    SeparatorStyle.SINGLE: _render_single,
    SeparatorStyle.TWO: _render_two,
    SeparatorStyle.MPT: _render_mpt,
    SeparatorStyle.PLAIN: _render_plain,
    SeparatorStyle.LLAMA_2: _render_llama2,
}


# --- registry (mirrors reference conv_templates keys; HALVA uses v1) ------

conv_vicuna_v1 = ConvTemplate(
    system=(
        "A chat between a curious user and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    version="v1",
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_v1 = ConvTemplate(
    system=(
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions."
    ),
    roles=("USER", "ASSISTANT"),
    version="v1",
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

# v0 ships a canned few-shot turn (verbatim behavioral contract,
# llava/conversation.py:224-252) rendered before real messages
_V0_SEED: Tuple[Message, ...] = (
    (
        "Human",
        "What are the key differences between renewable and "
        "non-renewable energy sources?",
    ),
    (
        "Assistant",
        "Renewable energy sources are those that can be replenished "
        "naturally in a relatively short amount of time, such as solar, "
        "wind, hydro, geothermal, and biomass. Non-renewable energy "
        "sources, on the other hand, are finite and will eventually be "
        "depleted, such as coal, oil, and natural gas. Here are some key "
        "differences between renewable and non-renewable energy "
        "sources:\n"
        "1. Availability: Renewable energy sources are virtually "
        "inexhaustible, while non-renewable energy sources are finite "
        "and will eventually run out.\n"
        "2. Environmental impact: Renewable energy sources have a much "
        "lower environmental impact than non-renewable sources, which "
        "can lead to air and water pollution, greenhouse gas emissions, "
        "and other negative effects.\n"
        "3. Cost: Renewable energy sources can be more expensive to "
        "initially set up, but they typically have lower operational "
        "costs than non-renewable sources.\n"
        "4. Reliability: Renewable energy sources are often more "
        "reliable and can be used in more remote locations than "
        "non-renewable sources.\n"
        "5. Flexibility: Renewable energy sources are often more "
        "flexible and can be adapted to different situations and needs, "
        "while non-renewable sources are more rigid and inflexible.\n"
        "6. Sustainability: Renewable energy sources are more "
        "sustainable over the long term, while non-renewable sources "
        "are not, and their depletion can lead to economic and social "
        "instability.\n",
    ),
)

conv_vicuna_v0 = ConvTemplate(
    system=(
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    version="v0",
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    messages=_V0_SEED,
    offset=2,
)

conv_llava_plain = ConvTemplate(
    system="",
    roles=("", ""),
    version="plain",
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
    sep2="\n",
)

conv_llama_2 = ConvTemplate(
    system=(
        "You are a helpful, respectful and honest assistant. Always answer "
        "as helpfully as possible, while being safe.  Your answers should "
        "not include any harmful, unethical, racist, sexist, toxic, "
        "dangerous, or illegal content. Please ensure that your responses "
        "are socially unbiased and positive in nature.\n\nIf a question "
        "does not make any sense, or is not factually coherent, explain why "
        "instead of answering something not correct. If you don't know the "
        "answer to a question, please don't share false information."
    ),
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

# system strings below are behavioral contracts kept verbatim from the
# reference registry (llava/conversation.py:277-358) — prompts must be
# byte-identical for tokenization parity
_MMTAG_SYSTEM = (
    "A chat between a curious user and an artificial intelligence "
    "assistant. The assistant is able to understand the visual content "
    "that the user provides, and assist the user with a variety of tasks "
    "using natural language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>."
)

conv_llava_v0 = ConvTemplate(
    system=(
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v0_mmtag = ConvTemplate(
    system=_MMTAG_SYSTEM,
    roles=("Human", "Assistant"),
    version="v0_mmtag",
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v1_mmtag = ConvTemplate(
    system=_MMTAG_SYSTEM,
    roles=("USER", "ASSISTANT"),
    version="v1_mmtag",
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_llama_2 = ConvTemplate(
    system=(
        "You are a helpful language and vision assistant. "
        "You are able to understand the visual content that the user "
        "provides, and assist the user with a variety of tasks using "
        "natural language."
    ),
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_mpt = ConvTemplate(
    system=(
        "<|im_start|>system\nA conversation between a user and an LLM-based "
        "AI assistant. The assistant gives helpful and honest answers."
    ),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

# all 13 reference registry keys (llava/conversation.py:361-377)
conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}

default_conversation = conv_vicuna_v1


def get_template(name: str) -> ConvTemplate:
    if name not in conv_templates:
        raise KeyError(f"unknown conversation template: {name!r}")
    return conv_templates[name]
