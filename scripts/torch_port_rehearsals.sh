#!/bin/bash
# The protocol rehearsals at their defaults on one card, in one run:
#
#   bash scripts/torch_port_rehearsals.sh WORK r5    # ~34 min on an H100
#   bash scripts/torch_port_rehearsals.sh WORK 7m    # ~40 min
#
# r5:    the workspace of scripts/torch_port_e2e_cli_icassp_r5.sh (400 train
#        and 11,000 eval tracks x 20 s, scripts/torch_port_setup_synth_icassp.py),
#        the sweep at 90 epochs, then the int8_static sign-off
#        (scripts/torch_port_e2e_int8_retrieval_signoff.py) on its
#        checkpoint at its defaults;
# 7m:    r5's training alone (the sweep's train command line, in
#        WORK/r5/run), then the 7m workspace (35,000 eval tracks x 20 s) and
#        scripts/torch_port_e2e_cli_icassp_7m.sh on that checkpoint.
# Every CLI runs under scripts/torch_port_cli_probe.py, which prints its
# stage seconds, launches and memory peaks; each step's wall seconds and
# the card's name and power limit are printed too. The kernels are built
# first, so that no CLI's time includes nvcc.

set -e
WORK=$1
MODE=${2:-r5}
REPO=$(cd "$(dirname "$0")/.." && pwd)
export PYTHON="python $REPO/scripts/torch_port_cli_probe.py"
mkdir -p "$WORK"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
stamp() { echo "[rehearsals] $1 at $SECONDS s" ; }
(cd "$REPO" && python -c "from grafp_tpu_torch.ops.build import build_all
print({n: round(s, 1) for n, (s, _) in build_all(
    ['mrconv_concat', 'max_neighbors', 'grapher_block']).items()})")
stamp "kernels built"

case $MODE in
  r5)
    python "$REPO/scripts/torch_port_setup_synth_icassp.py" --root "$WORK/r5" \
        --train_tracks 400 --eval_tracks 11000 --dur 20
    stamp "setup done"
    bash "$REPO/scripts/torch_port_e2e_cli_icassp_r5.sh" "$WORK/r5" 90
    stamp "r5 done"
    python "$REPO/scripts/torch_port_e2e_int8_retrieval_signoff.py" --root "$WORK/r5"
    stamp "sign-off done"
    ;;
  7m)
    python "$REPO/scripts/torch_port_setup_synth_icassp.py" --root "$WORK/r5" \
        --train_tracks 400 --eval_tracks 0 --dur 20
    mkdir -p "$WORK/r5/run"
    (cd "$WORK/r5/run" && $PYTHON -m grafp_tpu_torch.cli.train --config "$WORK/r5/synth.yaml" \
        --ckp tc29r5 --epochs 90 --validate_every 30 --cache_decoded)
    stamp "r5 training done"
    python "$REPO/scripts/torch_port_setup_synth_icassp.py" --root "$WORK/7m" \
        --train_tracks 4 --eval_tracks 35000 --dur 20
    stamp "7m setup done"
    bash "$REPO/scripts/torch_port_e2e_cli_icassp_7m.sh" "$WORK/7m" "$WORK/r5" 10
    stamp "7m done"
    ;;
  *)
    echo "mode must be r5 or 7m" >&2; exit 2 ;;
esac
