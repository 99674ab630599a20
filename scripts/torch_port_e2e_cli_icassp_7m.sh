#!/bin/bash
# One SNR row at the fma_medium protocol's row count, ~7M segment rows,
# through the port's test_fp CLI on the card: the counterpart of
# scripts/e2e_cli_icassp_7m.sh. 35,000 eval tracks x 20 s at overlap 0.9 =
# 34,600 dummy tracks x 199 segments = 6.89M dummy rows + 79,600 query
# rows, against the reference protocol's 24.5k dummy + 500 query tracks,
# ~7M rows (reference test_fp.py:49,169-172). 'ivfpq' with the
# approximate block scan, on the checkpoint that
# scripts/torch_port_e2e_cli_icassp_r5.sh trained (no new training: this
# row exercises the build, the index and the search at protocol scale).
#
#   python scripts/torch_port_setup_synth_icassp.py --root ROOT \
#       --train_tracks 4 --eval_tracks 35000 --dur 20
#   bash scripts/torch_port_e2e_cli_icassp_7m.sh [ROOT] [R5ROOT] [SNR]
#
# An isolated working directory (ROOT/run) holding a link to r5's
# checkpoint, R5ROOT/run/checkpoint/model_tc29r5_best.pth, under its own
# name: the CLIs key checkpoint/ and the fingerprint dirs by name relative
# to the working directory. PYTHON overrides the interpreter of the CLI;
# the yaml edits run on python3.

set -e
ROOT=${1:-${TMPDIR:-/tmp}/grafp_cli_e2e_7m}
R5ROOT=${2:-${TMPDIR:-/tmp}/grafp_cli_e2e_r5}
SNR=${3:-10}
REPO=$(cd "$(dirname "$0")/.." && pwd)
PY=${PYTHON:-python}
CKP=tc29r5
EVALCFG=$ROOT/synth_eval.yaml
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

mkdir -p "$ROOT/run/checkpoint"
ln -sf "$(cd "$R5ROOT/run/checkpoint" && pwd)/model_${CKP}_best.pth" "$ROOT/run/checkpoint/"
cd "$ROOT/run"

python3 - "$ROOT/synth.yaml" "$EVALCFG" <<'PYEOF'
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

echo "==== test_fp SNR=${SNR}dB (with IR) @ ~7M rows ===="
time $PY -m grafp_tpu_torch.cli.test_fp --config "$EVALCFG" \
    --test_config "$ROOT/test_config.yaml" \
    --test_dir "$ROOT/eval_tracks" --model "$CKP" --text "7m_snr$SNR" \
    --test_snr "$SNR" --n_query_db 400 --test_ids 400 --recompute
echo "==== done ===="
