"""Convert an HF LLaVA/Llama/CLIP checkpoint dir into a `save_params` dir
that `python -m halva_tpu_torch.train.run --model-path` trains from.

    python -m halva_tpu_torch.convert_checkpoint \
        --hf-dir /ckpt/llava-v1.5-7b \
        [--vision-tower-dir /ckpt/clip-vit-large-patch14-336] \
        --out /ckpt/llava-v1.5-7b-torch [--dtype bfloat16] [--device cuda]

Counterpart of scripts/convert_checkpoint.py: `models/builder.
load_pretrained_model` reads the shards (a tower from its own dir where
the checkpoint has none), the tree goes to `--dtype` on `--device` (the
card unless the caller names the CPU), and `train/checkpoint.save_params`
writes it. The output is what `train/checkpoint.load_params` reads, and
what `load_pretrained_model(out)` loads through its save_params branch.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="halva_tpu_torch.convert_checkpoint")
    p.add_argument("--hf-dir", required=True)
    p.add_argument("--vision-tower-dir", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--device", default="cuda",
                   help="the device the tree is converted on (cpu: no card)")
    args = p.parse_args(argv)

    from halva_tpu_torch import tree
    from halva_tpu_torch.models.builder import load_pretrained_model
    from halva_tpu_torch.train.checkpoint import save_params

    params, cfg = load_pretrained_model(
        args.hf_dir,
        vision_tower_path=args.vision_tower_dir,
        dtype=DTYPES[args.dtype],
        device=args.device,
    )
    save_params(args.out, params)
    n = sum(t.numel() for _, t in tree.flatten(params))
    print(f"wrote {args.out}: {n/1e9:.2f}B params, config {cfg}")


if __name__ == "__main__":
    main()
