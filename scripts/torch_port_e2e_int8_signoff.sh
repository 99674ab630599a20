#!/bin/bash
# The int8_static retrieval sign-off through the port's test_fp CLI on the
# card: the counterpart of scripts/e2e_int8_signoff.sh. The same trained
# checkpoint under bf16 and under serve_quant int8_static, at SNR 10, 5
# and 0, with the same corruption seed and test ids; compare the hit-rate
# tables of run_bf16 and run_int8_static (scripts/
# torch_port_e2e_int8_retrieval_signoff.py does the same in one process
# and prints the deltas).
#
# Needs r5's trained checkpoint (R5ROOT/run/checkpoint/model_tc29r5_best.pth,
# scripts/torch_port_e2e_cli_icassp_r5.sh) and an eval corpus:
#   python scripts/torch_port_setup_synth_icassp.py --root ROOT \
#       --train_tracks 4 --eval_tracks 1200 --dur 20
#   bash scripts/torch_port_e2e_int8_signoff.sh [ROOT] [R5ROOT]
#
# Each quant mode runs in its own working directory ROOT/run_<mode>, with
# a link to the checkpoint (fingerprint dirs are keyed by the checkpoint's
# name relative to the working directory); the dummy DB is built once per
# mode (int8 fingerprints differ from bf16's) and the SNR rows reuse it.
# PYTHON overrides the interpreter of the CLI; the yaml edits run on
# python3.

set -e
ROOT=${1:-${TMPDIR:-/tmp}/grafp_int8_signoff}
R5ROOT=${2:-${TMPDIR:-/tmp}/grafp_cli_e2e_r5}
REPO=$(cd "$(dirname "$0")/.." && pwd)
PY=${PYTHON:-python}
CKP=tc29r5
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

python3 - "$ROOT/test_config.yaml" "$CKP" <<'PYEOF'
import sys, yaml
yaml.safe_dump({sys.argv[2]: ["best"]}, open(sys.argv[1], "w"))
PYEOF

for QUANT in bf16 int8_static; do
  CFG=$ROOT/synth_$QUANT.yaml
  python3 - "$ROOT/synth.yaml" "$CFG" "$QUANT" <<'PYEOF'
import sys, yaml
cfg = yaml.safe_load(open(sys.argv[1]))
cfg["scan_topk"] = "approx"
cfg["scan_recall"] = 0.99
if sys.argv[3] != "bf16":
    cfg["serve_quant"] = sys.argv[3]
yaml.safe_dump(cfg, open(sys.argv[2], "w"), sort_keys=False)
PYEOF
  RUN=$ROOT/run_$QUANT
  mkdir -p "$RUN/checkpoint"
  ln -sf "$(cd "$R5ROOT/run/checkpoint" && pwd)/model_${CKP}_best.pth" "$RUN/checkpoint/"
  cd "$RUN"
  RECOMPUTE=--recompute
  for SNR in 10 5 0; do
    echo "==== $QUANT SNR=${SNR}dB ===="
    $PY -m grafp_tpu_torch.cli.test_fp --config "$CFG" \
        --test_config "$ROOT/test_config.yaml" \
        --test_dir "$ROOT/eval_tracks" --model "$CKP" \
        --text "int8signoff_${QUANT}_snr$SNR" \
        --test_snr "$SNR" --n_query_db 200 --test_ids 400 $RECOMPUTE
    RECOMPUTE=""
  done
done
echo "==== done: compare the hit-rate tables of run_bf16 and run_int8_static ===="
