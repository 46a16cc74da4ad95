#!/bin/bash
# Full hallucination eval suite through the PyTorch port (the calls of
# scripts/eval_suite.sh, flag for flag): CHAIR, POPE, AMBER, MME over one
# loaded model each, on python -m halva_tpu_torch.evals.cli. NGPU (default
# 1) cards: several run each call under torchrun with --mesh-data (the
# data ranks split each batch of 8; MESH_MODEL, default 1, tensor-parallel
# ranks). MODEL_PATH is an adapter, an HF checkpoint or a save_params dir.
set -euo pipefail
source "$(dirname "${BASH_SOURCE[0]}")/torch_launch.sh"
mesh_check 8
MODEL_PATH=${MODEL_PATH:?path to adapter or full checkpoint}
MODEL_BASE=${MODEL_BASE:-}
OUT=${OUT:-out/eval}
COMMON=(--model-path "$MODEL_PATH" ${MODEL_BASE:+--model-base "$MODEL_BASE"} --batch-size 8)

launch halva_tpu_torch.evals.cli chair "${COMMON[@]}" \
  --image-folder "${COCO_VAL2014:?}" --coco-path "${COCO_ANN:?}" \
  --chair-cache "$OUT/chair.pkl" --answers-file "$OUT/chair.jsonl"

launch halva_tpu_torch.evals.cli pope "${COMMON[@]}" \
  --question-file "${POPE_QUESTIONS:?}" --image-folder "${COCO_VAL2014:?}" \
  --annotation-dir "${POPE_ANN:?}" --answers-file "$OUT/pope.jsonl" \
  --max-new-tokens 64

launch halva_tpu_torch.evals.cli amber "${COMMON[@]}" \
  --query-file "${AMBER_QUERY:?}" --image-folder "${AMBER_IMAGES:?}" \
  --anno-dir "${AMBER_ANNO:?}" --answers-file "$OUT/amber.jsonl"

launch halva_tpu_torch.evals.cli mme "${COMMON[@]}" \
  --question-file "${MME_QUESTIONS:?}" --image-folder "${MME_IMAGES:?}" \
  --mme-data "${MME_DATA:?}" --answers-file "$OUT/mme.jsonl" \
  --max-new-tokens 64
