#!/bin/bash
# The scale-doubled rehearsal of the reference's icassp.sh sweep through
# the port's CLIs on the card: the counterpart of
# scripts/e2e_cli_icassp_r4.sh. >= 5k eval tracks, ~1M segment rows, the
# published index ('ivfpq') with the approximate block scan.
#
#   python scripts/torch_port_setup_synth_icassp.py --root ROOT \
#       --train_tracks 400 --eval_tracks 5000 --dur 20
#   bash scripts/torch_port_e2e_cli_icassp_r4.sh [ROOT] [EPOCHS]
#
# A unique checkpoint and model name (tc29r4, never tc_29) and an isolated
# working directory (ROOT/run): the CLIs key checkpoint/ and the
# fingerprint dirs by name relative to the working directory, so no other
# run can overwrite the trained checkpoint or the memmaps. The tc_29
# geometry (offset 0.05, overlap 0.9) comes from the yaml itself. The eval
# config adds the approximate block scan (scan_topk approx, scan_recall
# 0.99; retrieval/search.py). PYTHON overrides the interpreter of the
# CLIs; the yaml edits run on python3.

set -e
ROOT=${1:-${TMPDIR:-/tmp}/grafp_cli_e2e_r4}
EPOCHS=${2:-90}
REPO=$(cd "$(dirname "$0")/.." && pwd)
PY=${PYTHON:-python}
CFG=$ROOT/synth.yaml
EVALCFG=$ROOT/synth_eval.yaml
CKP=tc29r4
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

mkdir -p "$ROOT/run"
cd "$ROOT/run"

# the eval config: the train config plus the approximate block scan
python3 - "$CFG" "$EVALCFG" <<'PYEOF'
import sys, yaml
cfg = yaml.safe_load(open(sys.argv[1]))
cfg["scan_topk"] = "approx"
cfg["scan_recall"] = 0.99
yaml.safe_dump(cfg, open(sys.argv[2], "w"), sort_keys=False)
PYEOF
python3 - "$ROOT/test_config.yaml" "$CKP" <<'PYEOF'
import sys, yaml
yaml.safe_dump({sys.argv[2]: ["best"]}, open(sys.argv[1], "w"))
PYEOF

echo "==== train ($EPOCHS epochs, ckp $CKP, cwd $PWD) ===="
$PY -m grafp_tpu_torch.cli.train --config "$CFG" --ckp "$CKP" --epochs "$EPOCHS" \
    --validate_every 30 --cache_decoded

echo "==== eval sweep (reference icassp.sh:36-70 shape; ivfpq + approx scan) ===="
RECOMPUTE=--recompute
for SNR in 20 15 10 5 0; do
  echo "---- test_fp SNR=${SNR}dB (with IR) ----"
  $PY -m grafp_tpu_torch.cli.test_fp --config "$EVALCFG" \
      --test_config "$ROOT/test_config.yaml" \
      --test_dir "$ROOT/eval_tracks" --model "$CKP" --text "r4_snr$SNR" \
      --test_snr "$SNR" --n_query_db 400 --test_ids 400 $RECOMPUTE
  RECOMPUTE=""
done

echo "---- test_fp SNR=5dB sanir (no IR) ----"
$PY -m grafp_tpu_torch.cli.test_fp --config "$EVALCFG" \
    --test_config "$ROOT/test_config.yaml" \
    --test_dir "$ROOT/eval_tracks" --model "$CKP" --text "r4_sanir_snr5" \
    --test_snr 5 --n_query_db 400 --test_ids 400

echo "==== done ===="
