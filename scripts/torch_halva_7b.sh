#!/bin/bash
# HALVA-7B DPA fine-tune on NVIDIA GPUs through the PyTorch port — the
# published recipe of scripts/halva_7b.sh, value for value (1 epoch, lr
# 5e-6 cosine, warmup 3%, KL alpha 0.4, LoRA r=128/alpha=256, bf16,
# max_len 2048, seed 42), at the recipe's global batch of 64: per-device
# batch 2 x data ranks x gradient accumulation (32 / data ranks).
#
# MODEL_PATH: a save_params dir written from the released HF checkpoint by
#   python -m halva_tpu_torch.convert_checkpoint --hf-dir <llava-v1.5-7b> --out <dir>
# HALVA_TOKENIZER: the tokenizer dir (default lmsys/vicuna-7b-v1.5).
# NGPU (default 1) cards; MESH_MODEL (default 1) tensor-parallel ranks of
# them (scripts/torch_launch.sh).
set -euo pipefail
source "$(dirname "${BASH_SOURCE[0]}")/torch_launch.sh"
mesh_check 32

MODEL_PATH=${MODEL_PATH:-/ckpt/llava-v1.5-7b-torch}
DATA=${DATA:-data/data.json}
REF_DATA=${REF_DATA:-data/ref_data.json}
IMG_DIR=${IMG_DIR:-/data/images}
OUTDIR=${OUTDIR:-out/halva-7b-lora}

launch halva_tpu_torch.train.run \
  --model llava-v1.5-7b \
  --model-path "$MODEL_PATH" \
  --output-dir "$OUTDIR" \
  --data-path "$DATA" \
  --ref-data-path "$REF_DATA" \
  --image-folder "$IMG_DIR" \
  --epochs 1 \
  --per-device-batch 2 \
  --grad-accum-steps $(( 32 / DATA_RANKS )) \
  --learning-rate 5e-6 \
  --mm-projector-lr 0 \
  --loss-alpha 0.4 \
  --lora-r 128 \
  --lora-alpha 256 \
  --warmup-ratio 0.03 \
  --weight-decay 0.0 \
  --max-length 2048 \
  --seed 42
