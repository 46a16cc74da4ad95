#!/bin/bash
# The device-count rule of the scripts/torch_*.sh launchers, sourced by
# each. NGPU (default 1) cards; MESH_MODEL (default 1) of them form a
# tensor-parallel group, and NGPU / MESH_MODEL data-parallel ranks split
# the recipe's rows. One card runs `python -m MODULE`; several run
# `torchrun --nproc-per-node $NGPU -m MODULE ... --mesh-data D --mesh-model M`.
NGPU=${NGPU:-1}
MESH_MODEL=${MESH_MODEL:-1}

# mesh_check ROWS: sets DATA_RANKS, or stops the script with a message
# when NGPU and MESH_MODEL do not split ROWS evenly.
mesh_check() {
  local rows=$1
  if ! [[ "$NGPU" =~ ^[1-9][0-9]*$ && "$MESH_MODEL" =~ ^[1-9][0-9]*$ ]]; then
    echo "$(basename "$0"): NGPU and MESH_MODEL must be positive integers" \
      "(NGPU=$NGPU MESH_MODEL=$MESH_MODEL)" >&2
    exit 2
  fi
  if (( NGPU % MESH_MODEL )); then
    echo "$(basename "$0"): MESH_MODEL=$MESH_MODEL does not divide" \
      "NGPU=$NGPU" >&2
    exit 2
  fi
  DATA_RANKS=$(( NGPU / MESH_MODEL ))
  if (( rows % DATA_RANKS )); then
    echo "$(basename "$0"): $DATA_RANKS data ranks (NGPU=$NGPU /" \
      "MESH_MODEL=$MESH_MODEL) do not divide the recipe's $rows" >&2
    exit 2
  fi
}

# launch MODULE ARGS...: on one card, or under torchrun over NGPU cards.
launch() {
  local module=$1
  shift
  if (( NGPU == 1 )); then
    python -m "$module" "$@"
  else
    torchrun --nproc-per-node "$NGPU" -m "$module" "$@" \
      --mesh-data "$DATA_RANKS" --mesh-model "$MESH_MODEL"
  fi
}
