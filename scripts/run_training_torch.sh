#!/usr/bin/env bash
# Launcher of the PyTorch + CUDA port (vision_collision_detection_tpu_torch):
# the modes and environment block of scripts/run_training.sh, driving the
# port's command line. `distributed [N]` starts one process per card with
# torch.distributed.run over min(N, available) cards.
#
#   scripts/run_training_torch.sh {single|distributed [N]|grid-search|test|check}
#
# DEVICE (e.g. DEVICE=cpu) is passed to the commands as --device.
set -euo pipefail

# ---- configuration (env-var overridable) ----
METADATA_CSV="${METADATA_CSV:-}"
VIDEO_DIRS="${VIDEO_DIRS:-}"
BACKBONE="${BACKBONE:-convnext_tiny}"
TEMPORAL_MODE="${TEMPORAL_MODE:-gru}"
EPOCHS="${EPOCHS:-15}"
BATCH_SIZE="${BATCH_SIZE:-8}"            # per device
LEARNING_RATE="${LEARNING_RATE:-1e-4}"
SAVE_DIR="${SAVE_DIR:-runs}"
SAMPLE_STRATEGY="${SAMPLE_STRATEGY:-random}"
DEVICE="${DEVICE:-}"                    # default: the card
PYTHON="${PYTHON:-python}"

usage() {
  cat <<EOF
Usage: $0 {single|distributed [N]|grid-search|test|check}

  single          train on one device
  distributed [N] data-parallel training over min(N, available) devices
  grid-search     sweep backbones x temporal modes x learning rates
  test            1-epoch synthetic smoke run into \${SAVE_DIR}_test
  check           verify environment, package imports, data paths

Config via env vars: METADATA_CSV VIDEO_DIRS BACKBONE TEMPORAL_MODE EPOCHS
BATCH_SIZE LEARNING_RATE SAVE_DIR SAMPLE_STRATEGY DEVICE
Grid-search axes:    GRID_BACKBONES GRID_TEMPORAL_MODES GRID_LRS
EOF
  exit 1
}

device_args() {
  if [[ -n "$DEVICE" ]]; then
    echo --device "$DEVICE"
  fi
}

common_args() {
  local args=(--backbone "$BACKBONE" --temporal-mode "$TEMPORAL_MODE"
              --epochs "$EPOCHS" --batch-size "$BATCH_SIZE"
              --learning-rate "$LEARNING_RATE" --save-dir "$SAVE_DIR"
              --sample-strategy "$SAMPLE_STRATEGY")
  if [[ -n "$METADATA_CSV" ]]; then
    args+=(--metadata-csv "$METADATA_CSV")
  fi
  if [[ -n "$VIDEO_DIRS" ]]; then
    # shellcheck disable=SC2206
    args+=(--video-dirs $VIDEO_DIRS)
  fi
  echo "${args[@]}" $(device_args)
}

check() {
  echo "== environment check =="
  $PYTHON - <<'PY'
import torch
print(f"torch {torch.__version__}; CUDA available: "
      f"{torch.cuda.is_available()}; devices: "
      f"{[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}")
import vision_collision_detection_tpu_torch as vcd
print(f"package {vcd.__version__} imports OK")
from vision_collision_detection_tpu_torch.media.build import build
print(f"media library: {build()}")
PY
  if [[ -n "$METADATA_CSV" ]]; then
    [[ -f "$METADATA_CSV" ]] && echo "metadata CSV: $METADATA_CSV OK" \
      || { echo "ERROR: missing $METADATA_CSV"; exit 1; }
  fi
  for d in $VIDEO_DIRS; do
    [[ -d "$d" ]] && echo "video dir: $d OK" \
      || { echo "ERROR: missing dir $d"; exit 1; }
  done
  echo "check passed"
}

case "${1:-}" in
  single)
    # shellcheck disable=SC2046
    $PYTHON -m vision_collision_detection_tpu_torch.cli.train \
      $(common_args) --single-device --test
    ;;
  distributed)
    N="${2:-0}"
    AVAIL=$($PYTHON -c "import torch; print(torch.cuda.device_count())")
    NPROC="$AVAIL"
    if [[ "$N" -gt 0 && "$N" -lt "$AVAIL" ]]; then
      echo "clamping data-parallel width to $N of $AVAIL devices"
      NPROC="$N"
    fi
    if [[ "$NPROC" -lt 1 ]]; then
      echo "ERROR: no CUDA device: distributed runs one process per card"
      exit 1
    fi
    echo "effective global batch: $((BATCH_SIZE * NPROC))"
    # shellcheck disable=SC2046
    $PYTHON -m torch.distributed.run --standalone --nproc-per-node "$NPROC" \
      -m vision_collision_detection_tpu_torch.cli.train \
      $(common_args) --data-parallel --test
    ;;
  grid-search)
    # shellcheck disable=SC2046,SC2086
    $PYTHON -m vision_collision_detection_tpu_torch.cli.grid_search \
      $(common_args) \
      --backbones ${GRID_BACKBONES:-resnet18 convnext_tiny} \
      --temporal-modes ${GRID_TEMPORAL_MODES:-attention gru lstm} \
      --learning-rates ${GRID_LRS:-1e-4 5e-5}
    ;;
  test)
    # shellcheck disable=SC2046
    $PYTHON -m vision_collision_detection_tpu_torch.cli.train \
      --synthetic 3 --save-dir "${SAVE_DIR}_test" \
      --backbone "$BACKBONE" --temporal-mode "$TEMPORAL_MODE" \
      --fps 5 --duration 1 --frame-size 64 --batch-size 2 \
      --epochs 1 --validation-freq 0 --test \
      --experiment-name smoke $(device_args)
    ;;
  check)
    check
    ;;
  *)
    usage
    ;;
esac
