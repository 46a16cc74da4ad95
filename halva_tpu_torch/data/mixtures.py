"""General supervised/pretraining data engine: registry + lazy datasets.

Covers the VILA data engine surface (vila/data/datasets_mixture.py:4-44
registry; vila/data/dataset.py lazy dataset classes + build_datasets
"+"-mixture syntax) with TPU-era plumbing: everything yields numpy sample
dicts that the HALVA collator / packing layer consumes, and webdataset
shards go through the native tario reader.

Dataset types:
  "json"     — llava-format instruction json (LazySupervisedDataset);
  "wds"      — tar shards of image+json pairs (LazyWDSDataset, via wids);
  "caption"  — tar shards with txt captions (LazyCCSWebDataset-style).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DatasetSpec:
    dataset_name: str
    dataset_type: str = "json"
    data_path: Optional[str] = None
    image_path: Optional[str] = None
    meta_path: Optional[str] = None
    description: Optional[str] = None


DATASETS: Dict[str, DatasetSpec] = {}


def add_dataset(spec: DatasetSpec) -> None:
    if spec.dataset_name in DATASETS:
        warnings.warn(
            f"{spec.dataset_name} already registered; overwriting"
        )
    assert "+" not in spec.dataset_name, "'+' is the mixture separator"
    DATASETS[spec.dataset_name] = spec


def get_dataset_spec(name: str) -> DatasetSpec:
    if name not in DATASETS:
        raise KeyError(
            f"unknown dataset {name!r}; registered: {sorted(DATASETS)}"
        )
    return DATASETS[name]


class LazySupervisedDataset:
    """llava-format json: [{conversations: [{from, value}], image?}].

    Tokenization/encoding is deferred to __getitem__ via the provided
    `encode_fn(sample_dict) -> encoded` (usually
    halva_tpu_torch.train.data.encode_plain_conversation + image load).
    """

    def __init__(
        self,
        data_path: str,
        image_path: Optional[str],
        encode_fn: Callable[[dict, Optional[str]], Any],
    ):
        with open(data_path) as f:
            self.records = json.load(f)
        self.image_path = image_path
        self.encode_fn = encode_fn

    def __len__(self):
        return len(self.records)

    @property
    def modality_lengths(self) -> List[int]:
        out = []
        for r in self.records:
            n = sum(
                len(c["value"].split()) for c in r["conversations"]
            )
            out.append(n if "image" in r else -n)
        return out

    def __getitem__(self, i: int):
        r = self.records[i]
        img = (
            os.path.join(self.image_path, r["image"])
            if "image" in r and self.image_path
            else None
        )
        return self.encode_fn(r, img)


class LazyWDSDataset:
    """webdataset tar shards (image + json per sample) via native wids."""

    def __init__(
        self,
        data_path: str,
        encode_fn: Callable[[dict], Any],
        cache_size: int = 4,
    ):
        from halva_tpu_torch.data.wids import ShardListDataset

        shards = sorted(glob.glob(os.path.join(data_path, "*.tar")))
        if not shards:
            raise FileNotFoundError(f"no tar shards under {data_path}")
        self.ds = ShardListDataset(shards, cache_size=cache_size)
        self.encode_fn = encode_fn

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i: int):
        return self.encode_fn(self.ds[i])


def _decode_image(rec) -> "Any":
    """base64 str / raw bytes / PIL -> PIL.Image (RGB)."""
    import base64
    import io

    from PIL import Image

    if hasattr(rec, "convert"):
        return rec.convert("RGB")
    if isinstance(rec, str):
        rec = base64.b64decode(rec)
    return Image.open(io.BytesIO(rec)).convert("RGB")


def _load_pickle_shards(data_path: str):
    """MMC4/COYO shard layout: NNNNN.pkl sample lists + NNNNN.count files
    (reference LazyMMC4Dataset.__init__, vila/data/dataset.py:855-905;
    per-host sharding happens downstream in the sampler, not here)."""
    import pickle

    counts = sorted(glob.glob(os.path.join(data_path, "*.count")))
    names = [c[: -len(".count")] + ".pkl" for c in counts]
    if not names:
        names = sorted(glob.glob(os.path.join(data_path, "*.pkl")))
    if not names:
        raise FileNotFoundError(f"no .pkl shards under {data_path}")
    out = []
    for name in names:
        with open(name, "rb") as f:
            out.extend(pickle.load(f))
    return out


class LazyMMC4Dataset:
    """Interleaved image-text documents (MMC4 pickle shards).

    Behavior parity with reference LazyMMC4Dataset (vila/data/
    dataset.py:849-1040): pre-existing "<image>" strings in the text are
    neutralized to "<IMAGE>"; up to `max_images` base64 images are matched
    to sentences via matched_text_index and inserted in text order as
    "<image>" markers; sentences joined with " " (or the pad token under
    image_following_text_only); whitespace around markers collapsed; eos
    appended. Yields {"text", "images"} records through `encode_fn`.
    """

    def __init__(
        self,
        data_path: str,
        encode_fn: Callable[[dict], Any],
        eos_token: str = "</s>",
        pad_token: str = "<unk>",
        max_images: int = 6,
        text_only: bool = False,
        image_following_text_only: bool = False,
    ):
        self.records = _load_pickle_shards(data_path)
        self.encode_fn = encode_fn
        self.eos = eos_token
        self.pad = pad_token
        self.max_images = max_images
        self.text_only = text_only
        self.image_following_text_only = image_following_text_only

    def __len__(self):
        return len(self.records)

    @property
    def modality_lengths(self) -> List[int]:
        out = []
        for info in self.records:
            n_img = min(self.max_images, len(info["image_info"]))
            sents = [
                info["text_list"][x["matched_text_index"]]
                for x in info["image_info"][: n_img]
            ]
            # reference unit: words; images ~ 576/2 words each (:925)
            out.append(n_img * 288 + sum(len(s) for s in sents))
        return out

    def __getitem__(self, i: int):
        info = self.records[i]
        sentences = [
            s.replace("<image>", "<IMAGE>") for s in info["text_list"]
        ]
        images, sent_ixs = [], []
        if not self.text_only:
            for im in info["image_info"][: self.max_images]:
                images.append(_decode_image(im["image_base64"]))
                sent_ixs.append(im["matched_text_index"])
        # insertion order = text order
        images = [images[j] for j in np.argsort(sent_ixs)]
        for ix in sent_ixs:
            sentences[ix] = "<image>" + sentences[ix]
        joiner = self.pad if self.image_following_text_only else " "
        text = joiner.join(sentences)
        text = text.replace("<image> ", "<image>").replace(
            " <image>", "<image>"
        )
        return self.encode_fn(
            {"text": text + self.eos, "images": images}
        )


class LazyCoyoDataset:
    """COYO caption pairs from pickle shards (reference LazyCoyoDataset,
    vila/data/dataset.py:1042-1210): each record holds a base64/bytes
    image + caption; text = "<image>" + caption + eos."""

    def __init__(
        self,
        data_path: str,
        encode_fn: Callable[[dict], Any],
        eos_token: str = "</s>",
    ):
        self.records = _load_pickle_shards(data_path)
        self.encode_fn = encode_fn
        self.eos = eos_token

    def __len__(self):
        return len(self.records)

    @property
    def modality_lengths(self) -> List[int]:
        return [
            288 + len(_rec_caption(r).split()) for r in self.records
        ]

    def __getitem__(self, i: int):
        r = self.records[i]
        img = _decode_image(r.get("image", r.get("image_base64")))
        return self.encode_fn(
            {
                "text": "<image>" + _rec_caption(r) + self.eos,
                "images": [img],
            }
        )


def _rec_caption(r: dict) -> str:
    for k in ("caption", "text", "txt"):
        if k in r:
            return r[k]
    raise KeyError(f"no caption field in record keys {sorted(r)}")


def extract_video_frames(source, num_frames: int = 8):
    """Uniformly sample `num_frames` PIL frames from a video.

    TPU-host replacement for the reference's opencv_extract_frames
    (vila/mm_utils.py:87-114; decord/cv2 are GPU-era deps). Supports:
    - a directory of frame images (sorted),
    - PIL multi-frame containers (gif/webp/tiff/mjpeg),
    - any cv2-readable file when cv2 happens to be installed.
    Short videos repeat the last frame to reach num_frames (reference
    get_frame_from_vcap pads the same way).
    """
    from PIL import Image

    frames: List[Any] = []
    if isinstance(source, str) and os.path.isdir(source):
        paths = sorted(
            p
            for p in glob.glob(os.path.join(source, "*"))
            if p.lower().endswith((".jpg", ".jpeg", ".png", ".webp"))
        )
        total = len(paths)
        if total == 0:
            raise FileNotFoundError(f"no frames under {source}")
        idxs = np.linspace(0, total - 1, num_frames).round().astype(int)
        return [Image.open(paths[j]).convert("RGB") for j in idxs]

    try:
        img = Image.open(source)
        total = getattr(img, "n_frames", 1)
        idxs = np.linspace(0, total - 1, num_frames).round().astype(int)
        for j in idxs:
            img.seek(int(j))
            frames.append(img.convert("RGB"))
        return frames
    except Exception:
        pass

    try:  # optional cv2 path (mp4 etc.)
        import cv2

        cap = cv2.VideoCapture(source)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or 1
        idxs = set(
            np.linspace(0, total - 1, num_frames).round().astype(int)
        )
        got = []
        for j in range(total):
            ok, frame = cap.read()
            if not ok:
                break
            if j in idxs:
                got.append(
                    Image.fromarray(frame[:, :, ::-1])  # BGR -> RGB
                )
        cap.release()
        while got and len(got) < num_frames:
            got.append(got[-1])
        if got:
            return got
    except ImportError:
        pass
    raise ValueError(f"cannot decode video source {source!r}")


class LazyVideoDataset:
    """Video instruction data: one video per record, sampled to K frames
    spliced as K image blocks (reference LazyVideoWebDataset +
    LazySupervisedDataset._load_video, vila/data/dataset.py:734-758,
    1787-1900). Records: [{video: path, conversations|caption: ...}]."""

    def __init__(
        self,
        data_path: str,  # json listing
        video_folder: Optional[str],
        encode_fn: Callable[[dict], Any],
        num_frames: int = 8,
        eos_token: str = "</s>",
    ):
        with open(data_path) as f:
            self.records = json.load(f)
        self.video_folder = video_folder
        self.encode_fn = encode_fn
        self.num_frames = num_frames
        self.eos = eos_token

    def __len__(self):
        return len(self.records)

    @property
    def modality_lengths(self) -> List[int]:
        out = []
        for r in self.records:
            if "conversations" in r:
                n = sum(
                    len(c["value"].split()) for c in r["conversations"]
                )
            else:
                n = len(_rec_caption(r).split())
            out.append(n + self.num_frames * 288)
        return out

    def __getitem__(self, i: int):
        r = self.records[i]
        src = r["video"]
        if self.video_folder and not os.path.isabs(src):
            src = os.path.join(self.video_folder, src)
        frames = extract_video_frames(src, self.num_frames)
        markers = "<image>\n" * self.num_frames
        if "conversations" in r:
            conv = [dict(c) for c in r["conversations"]]
            conv[0] = dict(
                conv[0],
                value=markers
                + conv[0]["value"].replace("<video>", "").strip(),
            )
            rec = {"conversations": conv, "images": frames}
        else:
            rec = {
                "text": markers + _rec_caption(r) + self.eos,
                "images": frames,
            }
        return self.encode_fn(rec)


OCR_PROMPT = (
    "Please read the texts on image and type it below, each word "
    "separated by space.\n"
)  # verbatim contract: vila/data/dataset_impl/textocr.py:199


class LazySAMWebDataset:
    """SAM high-resolution captioning shards (reference dataset_impl/
    sam.py:44-150): wds tar shards of images + per-sample json/txt
    caption, optionally relabeled from a recap caption dir keyed by
    sample key."""

    def __init__(
        self,
        data_path: str,
        encode_fn: Callable[[dict], Any],
        caption_dir: Optional[str] = None,
        eos_token: str = "</s>",
        cache_size: int = 4,
    ):
        from halva_tpu_torch.data.wids import ShardListDataset

        shards = sorted(glob.glob(os.path.join(data_path, "*.tar")))
        if not shards:
            raise FileNotFoundError(f"no tar shards under {data_path}")
        self.ds = ShardListDataset(shards, cache_size=cache_size)
        self.encode_fn = encode_fn
        self.caption_dir = caption_dir
        self.eos = eos_token

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i: int):
        sample = self.ds[i]
        key = sample.get("__key__", str(i))
        caption = None
        if self.caption_dir:
            path = os.path.join(self.caption_dir, f"{key}.txt")
            if os.path.exists(path):
                caption = open(path).read().strip()
        if caption is None:
            meta = sample.get("json", sample.get(".json"))
            txt = sample.get("txt", sample.get(".txt"))
            if meta is not None:
                if isinstance(meta, (bytes, str)):
                    meta = json.loads(meta)
                caption = _rec_caption(meta)
            elif txt is not None:
                caption = (
                    txt.decode() if isinstance(txt, bytes) else txt
                ).strip()
            else:
                raise KeyError(f"no caption entry in sample {key}")
        img_key = next(
            k
            for k in sample
            if k.lstrip(".").lower() in ("jpg", "jpeg", "png", "webp")
        )
        img = _decode_image(sample[img_key])
        return self.encode_fn(
            {"text": "<image>" + caption + self.eos, "images": [img]}
        )


class VILATextOCR:
    """TextOCR word-reading data (reference dataset_impl/textocr.py):
    images + word annotations -> the OCR prompt with space-joined words.
    Annotation format: {"imgs": {id: {file_name}}, "imgToAnns":
    {id: [ann_id]}, "anns": {ann_id: {utf8_string}}}."""

    def __init__(
        self,
        data_path: str,  # annotation json
        image_folder: Optional[str],
        encode_fn: Callable[[dict], Any],
        eos_token: str = "</s>",
    ):
        with open(data_path) as f:
            ann = json.load(f)
        self.imgs = ann["imgs"]
        self.img_ids = sorted(self.imgs)
        self.img_to_anns = ann["imgToAnns"]
        self.anns = ann["anns"]
        self.image_folder = image_folder
        self.encode_fn = encode_fn
        self.eos = eos_token

    def __len__(self):
        return len(self.img_ids)

    def _words(self, img_id) -> List[str]:
        out = []
        for ann_id in self.img_to_anns.get(img_id, []):
            w = self.anns[str(ann_id)]["utf8_string"]
            if w and w != ".":  # textocr marks illegible words "."
                out.append(w)
        return out

    def __getitem__(self, i: int):
        img_id = self.img_ids[i]
        rec = self.imgs[img_id]
        path = rec["file_name"]
        if self.image_folder and not os.path.isabs(path):
            path = os.path.join(self.image_folder, path)
        from PIL import Image

        text = " ".join(self._words(img_id))
        return self.encode_fn(
            {
                "text": "<image>" + OCR_PROMPT + text + self.eos,
                "images": [Image.open(path).convert("RGB")],
            }
        )


class VILAHierText:
    """HierText word-reading data (reference dataset_impl/hiertext.py):
    gt json {annotations: [{image_id, paragraphs/lines/words}]} -> the
    same OCR prompt over non-vertical word transcriptions."""

    def __init__(
        self,
        data_path: str,  # gt json
        image_folder: Optional[str],
        encode_fn: Callable[[dict], Any],
        eos_token: str = "</s>",
        mode: str = "words",
    ):
        with open(data_path) as f:
            gt = json.load(f)
        self.records = gt["annotations"]
        self.image_folder = image_folder
        self.encode_fn = encode_fn
        self.eos = eos_token
        self.mode = mode

    def __len__(self):
        return len(self.records)

    def _texts(self, rec) -> List[str]:
        out = []
        for para in rec.get("paragraphs", []):
            for line in para.get("lines", []):
                if self.mode == "lines":
                    if not line.get("vertical"):
                        out.append(line["text"])
                else:
                    for word in line.get("words", []):
                        if not word.get("vertical"):
                            out.append(word["text"])
        return out

    def __getitem__(self, i: int):
        rec = self.records[i]
        path = str(rec["image_id"])
        if not path.lower().endswith((".jpg", ".jpeg", ".png")):
            path += ".jpg"
        if self.image_folder and not os.path.isabs(path):
            path = os.path.join(self.image_folder, path)
        from PIL import Image

        text = " ".join(self._texts(rec))
        return self.encode_fn(
            {
                "text": "<image>" + OCR_PROMPT + text + self.eos,
                "images": [Image.open(path).convert("RGB")],
            }
        )


class ConcatDataset:
    """Mixture over member datasets (reference build_datasets result)."""

    def __init__(self, members: Sequence[Any]):
        self.members = list(members)
        self.cum = []
        total = 0
        for m in self.members:
            total += len(m)
            self.cum.append(total)
        self.total = total

    def __len__(self):
        return self.total

    @property
    def modality_lengths(self) -> List[int]:
        out: List[int] = []
        for m in self.members:
            if hasattr(m, "modality_lengths"):
                out.extend(m.modality_lengths)
            else:
                out.extend([1] * len(m))
        return out

    def __getitem__(self, i: int):
        import bisect

        mi = bisect.bisect_right(self.cum, i)
        prev = self.cum[mi - 1] if mi else 0
        return self.members[mi][i - prev]


def build_datasets(
    mixture: str,
    encode_json: Callable[[dict, Optional[str]], Any],
    encode_wds: Optional[Callable[[dict], Any]] = None,
    encode_interleaved: Optional[Callable[[dict], Any]] = None,
) -> ConcatDataset:
    """"name1+name2" -> ConcatDataset (reference dataset.py:1974-2065).

    encode_interleaved consumes the normalized {"text" (with <image>
    markers), "images": [PIL]} records the MMC4/COYO/video/SAM/OCR
    classes emit (multi-image rows feed splice_image_tokens_multi).
    """
    inter = encode_interleaved or encode_wds
    members: List[Any] = []
    for name in mixture.split("+"):
        spec = get_dataset_spec(name.strip())
        t = spec.dataset_type
        if t in ("json", "torch"):
            members.append(
                LazySupervisedDataset(
                    spec.data_path, spec.image_path, encode_json
                )
            )
        elif t in ("wds", "caption", "ccs-wds"):
            assert encode_wds is not None, (
                f"{name}: webdataset mixture needs encode_wds"
            )
            members.append(LazyWDSDataset(spec.data_path, encode_wds))
        elif t == "mmc4":
            members.append(LazyMMC4Dataset(spec.data_path, inter))
        elif t == "coyo":
            members.append(LazyCoyoDataset(spec.data_path, inter))
        elif t == "sam-wds":
            members.append(
                LazySAMWebDataset(
                    spec.data_path, inter, caption_dir=spec.meta_path
                )
            )
        elif t == "textocr":
            members.append(
                VILATextOCR(spec.data_path, spec.image_path, inter)
            )
        elif t == "hiertext":
            members.append(
                VILAHierText(spec.data_path, spec.image_path, inter)
            )
        elif t in ("video", "video-wds"):
            members.append(
                LazyVideoDataset(spec.data_path, spec.image_path, inter)
            )
        else:
            raise ValueError(f"unsupported dataset_type {t!r}")
    return ConcatDataset(members)


def register_default_mixtures(root: str = "./playground/data") -> None:
    """Mirror of the reference's register_datasets_mixtures entries that
    make sense standalone; paths keyed off `root`."""
    add_dataset(
        DatasetSpec(
            "llava_1_5_mm_align",
            "json",
            data_path=os.path.join(
                root, "LLaVA-Pretrain/LLaVA-CC3M-Pretrain-595K.json"
            ),
            image_path=os.path.join(root, "LLaVA-Pretrain/images"),
        )
    )
    add_dataset(
        DatasetSpec(
            "llava_1_5_sft",
            "json",
            data_path=os.path.join(
                root, "llava-1.5/llava_v1_5_mix665k.json"
            ),
            image_path=os.path.join(root, "llava-1.5"),
        )
    )
    add_dataset(
        DatasetSpec(
            "coyo",
            "wds",
            data_path=os.path.join(root, "coyo-700m/shards"),
        )
    )
    add_dataset(
        DatasetSpec(
            "mmc4core",
            "wds",
            data_path=os.path.join(root, "mmc4-core/shards"),
        )
    )
