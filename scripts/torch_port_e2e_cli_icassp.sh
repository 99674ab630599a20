#!/bin/bash
# Synthetic-corpus rehearsal of the reference's icassp.sh sweep
# (reference icassp.sh:36-70) through the port's CLIs on the card: the
# counterpart of scripts/e2e_cli_icassp.sh. Run
# scripts/torch_port_setup_synth_icassp.py first.
#
#   bash scripts/torch_port_e2e_cli_icassp.sh [ROOT] [EPOCHS]
#
# Flow: train (SimCLR, --ckp tc_29 so that test_fp applies the tc_29
# preset, offset 0.05 / overlap 0.9) -> test_fp per SNR in {20, 15, 10, 5,
# 0} with IR (+ one 'sanir' row), 'ivfpq' index, the frozen split, hit-rate
# tables to stdout and TensorBoard. Writes checkpoint/, logs/ and runs/
# under the working directory. PYTHON overrides the interpreter.

set -e
ROOT=${1:-${TMPDIR:-/tmp}/grafp_cli_e2e}
EPOCHS=${2:-90}
REPO=$(cd "$(dirname "$0")/.." && pwd)
PY=${PYTHON:-python}
CFG=$ROOT/synth.yaml
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

echo "==== train (${EPOCHS} epochs) ===="
$PY -m grafp_tpu_torch.cli.train --config "$CFG" --ckp tc_29 --epochs "$EPOCHS" \
    --validate_every 30 --cache_decoded

echo "==== eval sweep (reference icassp.sh:36-70 shape) ===="
RECOMPUTE=--recompute
for SNR in 20 15 10 5 0; do
  echo "---- test_fp SNR=${SNR}dB (with IR) ----"
  $PY -m grafp_tpu_torch.cli.test_fp --config "$CFG" --test_config "$ROOT/test_config.yaml" \
      --test_dir "$ROOT/eval_tracks" --model tc_29 --text "synth_snr$SNR" \
      --test_snr "$SNR" --n_query_db 200 --test_ids 400 $RECOMPUTE
  RECOMPUTE=""
done

echo "---- test_fp SNR=5dB sanir (no IR) ----"
$PY -m grafp_tpu_torch.cli.test_fp --config "$CFG" --test_config "$ROOT/test_config.yaml" \
    --test_dir "$ROOT/eval_tracks" --model tc_29 --text "synth_sanir_snr5" \
    --test_snr 5 --n_query_db 200 --test_ids 400

echo "==== done ===="
