"""HALVA contrastive data pipeline (host-side, numpy).

Reimplements the reference's HallDataset contract
(llava/train/train_halva.py:236-1008) with one key redesign: the reference
assigns phrase signs by re-tokenizing string fragments around <MASK> tags
with sentencepiece-specific skip/punctuation hacks
(split_string_by_mask_and_tokenize, :263-335, self-described "a bit hacky")
and validates by re-tokenizing the unmasked text (:376-430, dropping
samples on mismatch). Here the unmasked prompt is tokenized *directly* —
so the reference's invariant (masked ids == unmasked ids) holds by
construction — and signs are assigned by mapping each token's character
interval against the phrase spans. Punctuation/possessive normalization at
span borders matches the reference rules (trailing ". ", ", ", "'s" are
outside the phrase, sign 0).

Sample fields (9-tensor contract of DataCollatorForHallDataset, :896-993):
  input_ids/labels/pos_signs (positive), neg_* (hallucinated),
  ref_input_ids/ref_labels (held-out instruction data), image, ref_image.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from halva_tpu_torch.constants import (
    DEFAULT_IMAGE_TOKEN,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    MASK_PLACEHOLDER_END,
    MASK_PLACEHOLDER_START,
)
from halva_tpu_torch.conversation import ConvTemplate, get_template
from halva_tpu_torch.mm_utils import (
    ImageProcessor,
    expand2square,
    tokenizer_image_token,
)


# --------------------------------------------------------------------------
# Phrase-span extraction
# --------------------------------------------------------------------------


def phrase_spans(masked: str) -> Tuple[str, List[Tuple[int, int]]]:
    """Strip <MASK>..</MASK> tags; return (unmasked text, char spans).

    Border normalization mirrors the reference (train_halva.py:296-332):
    span content ending in a space followed by '.'/',' becomes
    "content.<space>" with the punctuation outside the span; same for "'s".
    """
    out: List[str] = []
    spans: List[Tuple[int, int]] = []
    pos = 0
    cur = 0  # length of text emitted so far
    while True:
        start = masked.find(MASK_PLACEHOLDER_START, pos)
        if start == -1:
            out.append(masked[pos:])
            break
        out.append(masked[pos:start])
        cur += start - pos
        end = masked.find(MASK_PLACEHOLDER_END, start)
        if end == -1:
            raise ValueError("unbalanced <MASK> tag")
        content = masked[start + len(MASK_PLACEHOLDER_START) : end]
        after = end + len(MASK_PLACEHOLDER_END)

        nxt1 = masked[after : after + 1]
        nxt2 = masked[after : after + 2]
        # A span like "<MASK>cat </MASK>." reconstructs as "cat." — the
        # reference's trailing-space token is a fragment artifact its
        # [:-1] slice drops, so the effective text has no double space.
        if nxt1 in ".,":
            body = content[:-1] if content.endswith(" ") else content
            emitted = body + nxt1
            spans.append((cur, cur + len(body)))
            out.append(emitted)
            cur += len(emitted)
            pos = after + 1
        elif nxt2 == "'s":
            body = content[:-1] if content.endswith(" ") else content
            emitted = body + "'s"
            spans.append((cur, cur + len(body)))
            out.append(emitted)
            cur += len(emitted)
            pos = after + 2
        else:
            spans.append((cur, cur + len(content)))
            out.append(content)
            cur += len(content)
            pos = after
    return "".join(out), spans


# --------------------------------------------------------------------------
# Token -> character offsets
# --------------------------------------------------------------------------

_BYTE_PIECE = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")


def token_char_offsets(
    tokenizer, ids: Sequence[int], text: str
) -> List[Tuple[int, int]]:
    """Character interval of each token id within `text`.

    Works with sentencepiece-style slow tokenizers via piece strings
    ("▁" = space, "<0xHH>" byte fallback); raises ValueError when pieces
    cannot be aligned (caller drops the sample, matching the reference's
    drop-on-mismatch behavior).
    """
    pieces = tokenizer.convert_ids_to_tokens(list(ids))
    offsets: List[Tuple[int, int]] = []
    c = 0
    pending_bytes = b""
    pending_start = 0
    for i, piece in enumerate(pieces):
        m = _BYTE_PIECE.match(piece)
        if m:
            if not pending_bytes:
                pending_start = c
            pending_bytes += bytes([int(m.group(1), 16)])
            try:
                s = pending_bytes.decode("utf-8")
            except UnicodeDecodeError:
                offsets.append((c, c))  # mid-codepoint byte: empty span
                continue
            # codepoint completed
            if text[pending_start : pending_start + len(s)] != s:
                raise ValueError(
                    f"byte piece mismatch at {pending_start}: {s!r}"
                )
            offsets.append((pending_start, pending_start + len(s)))
            c = pending_start + len(s)
            pending_bytes = b""
            continue
        if pending_bytes:
            raise ValueError("dangling byte-fallback sequence")

        if piece in ("<s>", "</s>", "<unk>", "<pad>"):
            if text[c : c + len(piece)] == piece:
                offsets.append((c, c + len(piece)))
                c += len(piece)
            else:
                offsets.append((c, c))  # implicit special (e.g. bos)
            continue

        body = piece.replace("▁", " ")
        # sentencepiece dummy-prefix space: emitted at the start of the
        # text AND after every special-token split (legacy slow-tokenizer
        # behavior) — tolerate a spurious leading space wherever the text
        # doesn't actually have one.
        if (
            body.startswith(" ")
            and text[c : c + len(body)] != body
            and text[c : c + len(body) - 1] == body[1:]
        ):
            body = body[1:]
        if text[c : c + len(body)] != body:
            raise ValueError(
                f"piece mismatch at {c}: piece={body!r} "
                f"text={text[c:c+len(body)]!r}"
            )
        offsets.append((c, c + len(body)))
        c += len(body)
    return offsets


def assign_signs(
    offsets: Sequence[Tuple[int, int]],
    spans: Sequence[Tuple[int, int]],
    text: str,
) -> List[int]:
    """Sign id per token: k iff the token's non-space chars overlap span k."""
    signs = [0] * len(offsets)
    for k, (s, e) in enumerate(spans, start=1):
        hit = False
        for i, (a, b) in enumerate(offsets):
            # trim leading space char (the "▁" belongs to the word)
            a_eff = a
            while a_eff < b and text[a_eff] == " ":
                a_eff += 1
            if a_eff < e and b > s and max(a_eff, s) < min(b, e):
                signs[i] = k
                hit = True
        if not hit:
            raise ValueError(f"phrase span {k} matched no tokens")
    return signs


# --------------------------------------------------------------------------
# Prompt building + tokenization
# --------------------------------------------------------------------------


def _normalize_image_marker(value: str) -> str:
    """reference preprocess_multimodal (train_halva.py:236-257): the image
    marker moves to the front, newline-separated."""
    if DEFAULT_IMAGE_TOKEN in value:
        value = value.replace(DEFAULT_IMAGE_TOKEN, "").strip()
        value = (DEFAULT_IMAGE_TOKEN + "\n" + value).strip()
    return value


@dataclasses.dataclass
class EncodedSample:
    input_ids: np.ndarray  # (S,) int32, -200 image sentinel
    labels: np.ndarray  # (S,) int32
    signs: np.ndarray  # (S,) int32


def encode_masked_conversation(
    question: str,
    masked_answer: str,
    unmasked_answer: str,
    tokenizer,
    template: Optional[ConvTemplate] = None,
) -> Optional[EncodedSample]:
    """Build the v1 prompt, tokenize the unmasked text, assign phrase signs
    and label masks. Returns None when alignment fails (sample dropped —
    same policy as the reference's tokenization sanity check)."""
    template = template or get_template("v1")
    question = _normalize_image_marker(question)
    try:
        answer_text, spans = phrase_spans(masked_answer)
    except ValueError:
        return None
    if answer_text != unmasked_answer:
        # normalization mismatch -> drop (reference train_halva.py:426-430)
        return None

    # the rendered v1 prompt ends with the literal "</s>" (sep2), which a
    # llama-family tokenizer emits as the eos id — no explicit append
    prompt = template.prompt(question, unmasked_answer)
    ids = list(tokenizer_image_token(prompt, tokenizer))

    # answer char span within the rendered prompt
    ans_start = prompt.rfind(unmasked_answer)
    if ans_start == -1:
        return None
    abs_spans = [(s + ans_start, e + ans_start) for s, e in spans]

    # char offsets: tokenize per <image> chunk like tokenizer_image_token
    parts = prompt.split(DEFAULT_IMAGE_TOKEN)
    signs = np.zeros(len(ids), np.int32)
    labels = np.full(len(ids), IGNORE_INDEX, np.int32)
    try:
        offsets = _prompt_token_offsets(tokenizer, ids, prompt)
    except ValueError:
        return None

    for k, (s, e) in enumerate(abs_spans, start=1):
        hit = False
        for i, (a, b) in enumerate(offsets):
            if a is None:
                continue
            a_eff = a
            while a_eff < b and prompt[a_eff] == " ":
                a_eff += 1
            if max(a_eff, s) < min(b, e):
                signs[i] = k
                hit = True
        if not hit:
            return None

    # label mask: supervise answer tokens + the closing </s>; ignore the
    # instruction part (reference preprocess_v1 target masking,
    # train_halva.py:435-465)
    for i, (a, b) in enumerate(offsets):
        if b > ans_start and ids[i] != IMAGE_TOKEN_INDEX:
            labels[i] = ids[i]

    return EncodedSample(
        np.asarray(ids, np.int32), labels, signs
    )


def _prompt_token_offsets(tokenizer, ids, prompt):
    """Offsets for a tokenizer_image_token stream: the -200 sentinel maps
    to the <image> marker chars; pre/post chunks tokenized separately just
    like tokenizer_image_token built them."""
    offsets: List[Tuple[int, int]] = []
    img_idx = prompt.find(DEFAULT_IMAGE_TOKEN)
    try:
        split = list(ids).index(IMAGE_TOKEN_INDEX)
    except ValueError:
        split = None
    if split is None:
        return token_char_offsets(tokenizer, list(ids), prompt)

    pre_ids = list(ids[:split])
    post_ids = list(ids[split + 1 :])
    pre_text = prompt[:img_idx]
    post_base = img_idx + len(DEFAULT_IMAGE_TOKEN)
    post_text = prompt[post_base:]

    offsets.extend(token_char_offsets(tokenizer, pre_ids, pre_text))
    offsets.append((img_idx, img_idx + len(DEFAULT_IMAGE_TOKEN)))
    post_off = token_char_offsets(tokenizer, post_ids, post_text)
    offsets.extend([(a + post_base, b + post_base) for a, b in post_off])
    return offsets


def _answer_regions(
    template: ConvTemplate, turns, prompt: str
) -> Optional[List[Tuple[int, int]]]:
    """Supervised char regions (answer + closing separator) per style —
    generalizes the reference's per-template preprocess_{v1,llama_2,mpt,
    plain} target masking (vila/data/dataset.py:151-527)."""
    from halva_tpu_torch.conversation import SeparatorStyle

    style = template.sep_style
    regions: List[Tuple[int, int]] = []
    cursor = 0
    for q, a in turns:
        if style == SeparatorStyle.TWO:
            marker = template.roles[1] + ": " + a + (template.sep2 or "")
            astart_off = len(template.roles[1]) + 2
            alen = len(a) + len(template.sep2 or "")
        elif style == SeparatorStyle.MPT:
            marker = template.roles[1] + a + template.sep
            astart_off = len(template.roles[1])
            alen = len(a) + len(template.sep)
        elif style == SeparatorStyle.LLAMA_2:
            marker = "[/INST] " + a + " " + (template.sep2 or "")
            astart_off = len("[/INST] ")
            alen = len(a) + 1 + len(template.sep2 or "")
        elif style == SeparatorStyle.PLAIN:
            marker = a + (template.sep2 or template.sep)
            astart_off = 0
            alen = len(marker)
        else:
            return None
        idx = prompt.find(marker, cursor)
        if idx == -1:
            return None
        astart = idx + astart_off
        regions.append((astart, astart + alen))
        cursor = idx + len(marker)
    return regions


def encode_plain_conversation(
    turns: Sequence[Tuple[str, str]],  # (question, answer) pairs
    tokenizer,
    template: Optional[ConvTemplate] = None,
) -> Optional[EncodedSample]:
    """preprocess_v1_ref equivalent (multi-turn, no signs), generalized
    over separator styles; labels keep each answer + closing separator."""
    template = template or get_template("v1")
    msgs = []
    for q, a in turns:
        msgs.append((template.roles[0], _normalize_image_marker(q)))
        msgs.append((template.roles[1], a))
    prompt = template.render(msgs)
    ids = list(tokenizer_image_token(prompt, tokenizer))
    try:
        offsets = _prompt_token_offsets_noappend(tokenizer, ids, prompt)
    except ValueError:
        return None

    regions = _answer_regions(template, turns, prompt)
    if regions is None:
        return None
    labels = np.full(len(ids), IGNORE_INDEX, np.int32)
    for i, (a, b) in enumerate(offsets):
        if ids[i] == IMAGE_TOKEN_INDEX:
            continue
        for s, e in regions:
            if b > s and a < e and b > a:
                labels[i] = ids[i]
                break
    return EncodedSample(
        np.asarray(ids, np.int32),
        labels,
        np.zeros(len(ids), np.int32),
    )


def _prompt_token_offsets_noappend(tokenizer, ids, prompt):
    return _prompt_token_offsets(tokenizer, ids, prompt)


# --------------------------------------------------------------------------
# Dataset
# --------------------------------------------------------------------------


def balance_yes_no(
    data: List[dict], seed: int = 42
) -> List[dict]:
    """Equalize yes/no one-word QA samples (train_halva.py:636-668)."""
    closed = [s for s in data if s["tag"] == "closed"]
    open_ = [s for s in data if s["tag"] == "open"]
    qa = [s for s in data if s["tag"] == "qa"]
    rng = random.Random(seed)
    rng.shuffle(qa)
    yes = [s for s in qa if s["raw_answer"].lower() == "yes"]
    no = [s for s in qa if s["raw_answer"].lower() == "no"]
    n = min(len(yes), len(no))
    out = closed + open_ + yes[:n] + no[:n]
    rng2 = random.Random(seed)
    rng2.shuffle(out)
    return out


class HallDataset:
    """Contrastive pos/neg pairs + held-out reference samples.

    data.json sample schema (from the reference):
      {id, image, tag, question, correct_answer, correct_answer_masked,
       hallucinated_answer, hallucinated_answer_masked, raw_answer}
    ref_data.json: llava-mix-665k-style {conversations: [{from, value}],
       image?}.
    """

    def __init__(
        self,
        data_path: str,
        ref_data_path: Optional[str],
        tokenizer,
        image_processor: ImageProcessor,
        image_folder: str = "",
        image_aspect_ratio: str = "pad",
        template_name: str = "v1",
        max_length: int = 2048,
        seed: int = 42,
    ):
        with open(data_path) as f:
            data = json.load(f)
        self.samples = balance_yes_no(data, seed)
        if ref_data_path in (None, "none"):
            self.ref_samples = None
        else:
            with open(ref_data_path) as f:
                ref = json.load(f)
            assert len(ref) >= len(self.samples)
            self.ref_samples = ref[: len(self.samples)]
        self.tokenizer = tokenizer
        self.image_processor = image_processor
        self.image_folder = image_folder
        self.image_aspect_ratio = image_aspect_ratio
        self.template = get_template(template_name)
        self.max_length = max_length

    def __len__(self):
        return len(self.samples)

    @property
    def modality_lengths(self) -> List[int]:
        out = []
        for s in self.samples:
            n = len(s["question"].split()) + len(
                s["correct_answer"].split()
            )
            out.append(n if "image" in s else -n)
        return out

    def _load_image(self, rel_path: str) -> np.ndarray:
        from PIL import Image

        path = os.path.join(self.image_folder, rel_path)
        img = Image.open(path).convert("RGB")
        if self.image_aspect_ratio == "pad":
            bg = tuple(
                int(x * 255) for x in self.image_processor.image_mean
            )
            img = expand2square(img, bg)
        return self.image_processor(img)

    def __getitem__(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        s = self.samples[i]
        q = s["question"]
        pos = encode_masked_conversation(
            q,
            s["correct_answer_masked"],
            s["correct_answer"],
            self.tokenizer,
            self.template,
        )
        neg = encode_masked_conversation(
            q,
            s["hallucinated_answer_masked"],
            s["hallucinated_answer"],
            self.tokenizer,
            self.template,
        )
        if pos is None or neg is None:
            return None  # dropped sample, reference parity

        # the DPA loss derives its present-phrase column set from pos_signs
        # (train/dpa.py:alignment_loss); the reference requires
        # unique(pos) == unique(neg) anyway (halva_trainer.py:564-567 would
        # raise a shape error otherwise). Enforce here: drop mismatches
        # (e.g. a phrase truncated out of only one answer by max_length).
        pos_ids = set(np.unique(pos.signs[: self.max_length])) - {0}
        neg_ids = set(np.unique(neg.signs[: self.max_length])) - {0}
        if pos_ids != neg_ids:
            return None
        # both sides truncated to NO phrases at all (max_length shorter
        # than the prompt): the sample would train with zero alignment
        # signal and exactly-0 loss — drop it like any other alignment
        # failure. Samples that never had <MASK> spans are kept (they
        # still contribute the KL term).
        if not pos_ids and (
            np.any(pos.signs) or np.any(neg.signs)
        ):
            return None

        image = self._load_image(s["image"])

        out = {
            "input_ids": pos.input_ids[: self.max_length],
            "labels": pos.labels[: self.max_length],
            "pos_signs": pos.signs[: self.max_length],
            "neg_input_ids": neg.input_ids[: self.max_length],
            "neg_labels": neg.labels[: self.max_length],
            "neg_signs": neg.signs[: self.max_length],
            "image": image,
        }

        if self.ref_samples is None:
            out["ref_input_ids"] = out["input_ids"]
            out["ref_labels"] = out["labels"]
            out["ref_image"] = image
        else:
            r = self.ref_samples[i]
            turns = []
            conv = r["conversations"]
            for j in range(0, len(conv) - 1, 2):
                if conv[j]["from"] != "human":
                    return None
                turns.append((conv[j]["value"], conv[j + 1]["value"]))
            enc = encode_plain_conversation(
                turns, self.tokenizer, self.template
            )
            if enc is None:
                return None
            out["ref_input_ids"] = enc.input_ids[: self.max_length]
            out["ref_labels"] = enc.labels[: self.max_length]
            if "image" in r:
                out["ref_image"] = self._load_image(r["image"])
            else:
                out["ref_image"] = np.zeros_like(image)
        return out


def collate(
    batch: Sequence[Dict[str, np.ndarray]],
    pad_token_id: int,
    pad_to: Optional[int] = None,
    pad_multiple: int = 64,
) -> Dict[str, np.ndarray]:
    """Pad the 9-field samples into fixed arrays + segment masks.

    Lengths are bucketed to `pad_multiple` (static-shape friendly: few
    distinct compiled programs) unless `pad_to` pins them.
    """
    out: Dict[str, np.ndarray] = {}

    def pad_group(ids_key, extra_keys, tgt=None):
        lens = [len(s[ids_key]) for s in batch]
        if tgt is None:
            tgt = pad_to or -(-max(lens) // pad_multiple) * pad_multiple
        n = len(batch)
        ids = np.full((n, tgt), pad_token_id, np.int32)
        seg = np.zeros((n, tgt), np.int32)
        extras = {
            k: np.full(
                (n, tgt),
                IGNORE_INDEX if "labels" in k else 0,
                np.int32,
            )
            for k in extra_keys
        }
        for i, s in enumerate(batch):
            L = min(len(s[ids_key]), tgt)
            ids[i, :L] = s[ids_key][:L]
            seg[i, :L] = 1
            for k in extra_keys:
                extras[k][i, :L] = s[k][:L]
        return ids, seg, extras

    # pos and neg share one bucket: the trainer stacks them into a single
    # 2B-row forward (reference concatenated_forward pads to common max,
    # halva_trainer.py:434-447)
    pn_max = max(
        max(len(s["input_ids"]) for s in batch),
        max(len(s["neg_input_ids"]) for s in batch),
    )
    pn_tgt = pad_to or -(-pn_max // pad_multiple) * pad_multiple

    ids, seg, ex = pad_group("input_ids", ["labels", "pos_signs"], pn_tgt)
    out["input_ids"], out["segment_ids"] = ids, seg
    out["labels"], out["pos_signs"] = ex["labels"], ex["pos_signs"]

    ids, seg, ex = pad_group(
        "neg_input_ids", ["neg_labels", "neg_signs"], pn_tgt
    )
    out["neg_input_ids"], out["neg_segment_ids"] = ids, seg
    out["neg_labels"], out["neg_signs"] = ex["neg_labels"], ex["neg_signs"]

    ids, seg, ex = pad_group("ref_input_ids", ["ref_labels"])
    out["ref_input_ids"], out["ref_segment_ids"] = ids, seg
    out["ref_labels"] = ex["ref_labels"]

    out["images"] = np.stack([s["image"] for s in batch]).astype(np.float32)
    out["ref_images"] = np.stack(
        [s["ref_image"] for s in batch]
    ).astype(np.float32)
    return out
