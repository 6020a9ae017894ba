#!/usr/bin/env bash
# Launch script for training on the card, counterpart of the JAX package's
# training/train.sh (the reference's training/train.sh parity).
#
# One process drives one card. Several cards: run it under torchrun
# (RANK, WORLD_SIZE and MASTER_ADDR set for every process), or start one
# process per card with RANK and WORLD_SIZE set and COORDINATOR=host:port
# (the port's --coordinator). Without COCO_ROOT it makes a synthetic smoke
# run. Extra arguments go to the trainer (e.g. --device cpu, --use-pallas).
set -euo pipefail

OUTPUT_DIR=${OUTPUT_DIR:-./runs/flamingo-torch}
COCO_ROOT=${COCO_ROOT:-}
COCO_ANN=${COCO_ANN:-}
COORDINATOR=${COORDINATOR:-}          # host:port for multi-process runs

ARGS=(
  --output-dir "$OUTPUT_DIR"
  # reference hyperparameters (train.sh:6-27)
  --learning-rate 1e-4
  --warmup-steps 5000
  --per-device-batch-size 8
  --eval-every-steps 1000
  --save-total-limit 2
  --log-every-steps 50
  # reference model config (train.py:149-156)
  --lm facebook/opt-125m
  --clip-model-type openai/clip-vit-large-patch14
  --dim 768
  --dim-visual 1024
  --resampler-act sqrelu
  --xattn-act sqrelu
)

if [[ -n "$COCO_ROOT" ]]; then
  ARGS+=(--coco-root "$COCO_ROOT" --coco-ann-file "$COCO_ANN")
else
  echo "COCO_ROOT not set -> synthetic smoke run"
  ARGS+=(--synthetic-size 512 --max-steps 50)
fi

if [[ -n "$COORDINATOR" ]]; then
  ARGS+=(--coordinator "$COORDINATOR")
fi

export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
exec python -m flamingo_mini_tpu_torch.train "${ARGS[@]}" "$@"
