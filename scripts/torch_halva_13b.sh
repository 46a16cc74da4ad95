#!/bin/bash
# HALVA-13B DPA recipe through the PyTorch port (scripts/halva_13b.sh,
# value for value: as 7B with KL alpha 0.5), at the recipe's global batch
# of 64: per-device batch 2 x data ranks x gradient accumulation (32 / data
# ranks). The reference adds --mesh-model 2 for small-HBM chips; here
# MESH_MODEL defaults to 1: on one 80 GB card the recipe's micro-step, every
# row at --max-length 2048, peaks at 39.99 GiB (an H100, random weights:
# python3 chip_smoke.py --recipe-peak-only, PERF.md).
#
# MODEL_PATH: a save_params dir written by
#   python -m halva_tpu_torch.convert_checkpoint --hf-dir <llava-v1.5-13b> --out <dir>
# HALVA_TOKENIZER: the tokenizer dir (default lmsys/vicuna-7b-v1.5).
# NGPU (default 1) cards; MESH_MODEL (default 1) tensor-parallel ranks.
set -euo pipefail
source "$(dirname "${BASH_SOURCE[0]}")/torch_launch.sh"
mesh_check 32
MODEL_PATH=${MODEL_PATH:-/ckpt/llava-v1.5-13b-torch}
launch halva_tpu_torch.train.run \
  --model llava-v1.5-13b \
  --model-path "$MODEL_PATH" \
  --output-dir "${OUTDIR:-out/halva-13b-lora}" \
  --data-path "${DATA:-data/data.json}" \
  --ref-data-path "${REF_DATA:-data/ref_data.json}" \
  --image-folder "${IMG_DIR:-/data/images}" \
  --epochs 1 --per-device-batch 2 --grad-accum-steps $(( 32 / DATA_RANKS )) \
  --learning-rate 5e-6 --mm-projector-lr 0 --loss-alpha 0.5 \
  --lora-r 128 --lora-alpha 256 --warmup-ratio 0.03 \
  --weight-decay 0.0 --max-length 2048 --seed 42
