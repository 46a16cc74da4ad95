#!/bin/bash
# HALVA VILA-13B/384 DPA recipe through the PyTorch port
# (scripts/halva_vila_13b.sh, value for value: KL alpha 0.2, lr 2.5e-5,
# max_len 4096, SigLIP-so400m-384 tower, mlp_downsample projector, the
# projector trained at the base lr), at the recipe's global batch of 64:
# per-device batch 2 x data ranks x gradient accumulation (32 / data
# ranks). The reference adds --mesh-model 2 for small-HBM chips; here
# MESH_MODEL defaults to 1: on one 80 GB card the recipe's micro-step, every
# row at --max-length 4096, peaks at 48.86 GiB (an H100, random weights:
# python3 chip_smoke.py --recipe-peak-only, PERF.md).
#
# MODEL_PATH: a save_params dir of the VILA-13B/384 tree.
# HALVA_TOKENIZER: the tokenizer dir (default lmsys/vicuna-7b-v1.5).
# NGPU (default 1) cards; MESH_MODEL (default 1) tensor-parallel ranks.
set -euo pipefail
source "$(dirname "${BASH_SOURCE[0]}")/torch_launch.sh"
mesh_check 32
MODEL_PATH=${MODEL_PATH:-/ckpt/vila-13b-384-torch}
launch halva_tpu_torch.train.run \
  --model vila-13b-384 \
  --model-path "$MODEL_PATH" \
  --output-dir "${OUTDIR:-out/halva-vila-13b}" \
  --data-path "${DATA:-data/data.json}" \
  --ref-data-path "${REF_DATA:-data/ref_data.json}" \
  --image-folder "${IMG_DIR:-/data/images}" \
  --epochs 1 --per-device-batch 2 --grad-accum-steps $(( 32 / DATA_RANKS )) \
  --learning-rate 2.5e-5 --mm-projector-lr 2.5e-5 --loss-alpha 0.2 \
  --lora-r 128 --lora-alpha 256 --warmup-ratio 0.03 \
  --weight-decay 0.0 --max-length 4096 --seed 42
