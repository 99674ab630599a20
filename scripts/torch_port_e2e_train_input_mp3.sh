#!/bin/bash
# The train CLI's input throughput on an mp3 corpus (fma's format, 44.1 kHz
# masters), on the card: the counterpart of scripts/e2e_train_input_mp3.sh.
# Trains for EPOCHS epochs in each input mode and prints the epoch wall
# times that the train CLI prints; pairs/s = steps x 256 / epoch time.
#
# Needs the mp3 corpus of scripts/torch_port_profile_input_pipeline.py
# (libmp3lame to write it, libmpg123 to read it), extended to 512 tracks
# (bsz 256 -> 2 steps an epoch):
#   python - <<'EOF'
#   import sys; sys.path[:0] = ['REPO', 'REPO/scripts']
#   from torch_port_profile_input_pipeline import build_corpus
#   build_corpus('ROOT', 512, 30.0, 44100)
#   EOF
#   bash scripts/torch_port_e2e_train_input_mp3.sh [ROOT] [EPOCHS]
#
# Three runs, a fresh process each (own working directories, unique
# checkpoint names):
#   nocache   no cache: every epoch decodes again (the reference's way)
#   ramcache  --cache_decoded: a RAM dict, epoch 1 cold, 2+ warm
#   diskwarm  --cache_dir ROOT/decoded_cache: the disk cache, filled on
#             first touch of each track (warm from the first epoch where
#             the profiler filled it)
# PYTHON overrides the interpreter of the CLI; the set-up runs on python3.

set -e
ROOT=${1:-${TMPDIR:-/tmp}/grafp_input_prof}
EPOCHS=${2:-4}
REPO=$(cd "$(dirname "$0")/.." && pwd)
PY=${PYTHON:-python}
TRACKS=$ROOT/mp3_tracks
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

# the noise and IR banks and the config (the corpus maker writes neither)
python3 - "$ROOT" "$TRACKS" "$REPO" <<'PYEOF'
import os, sys, yaml
from grafp_tpu_torch.data.synthetic import make_wav_dir
root, tracks, repo = sys.argv[1:4]
for name, n, dur, seed, kind in (("noise", 24, 5.0, 30, "noise"),
                                 ("ir", 12, 0.5, 40, "ir")):
    d = os.path.join(root, name)
    if not os.path.isdir(d) or len(os.listdir(d)) < n:
        make_wav_dir(d, n=n, dur_s=dur, sr=16000, seed=seed, kind=kind)
cfg = yaml.safe_load(open(os.path.join(repo, "config", "grafp.yaml")))
n = len([f for f in os.listdir(tracks) if f.endswith(".mp3")])
cfg.update(data_dir=os.path.join(root, "data"), train_dir=tracks,
           val_dir=tracks, noise_dir=os.path.join(root, "noise"),
           ir_dir=os.path.join(root, "ir"), train_sz=n, val_sz=n,
           bsz_train=256)
yaml.safe_dump(cfg, open(os.path.join(root, "mp3_train.yaml"), "w"),
               sort_keys=False)
print(f"[setup] config for {n} mp3 tracks, bsz 256")
PYEOF

CFG=$ROOT/mp3_train.yaml
run() {  # name, extra flags...
  NAME=$1; shift
  RUN=$ROOT/tr_$NAME
  mkdir -p "$RUN"
  cd "$RUN"
  echo "==== train mode $NAME ($EPOCHS epochs) ===="
  $PY -m grafp_tpu_torch.cli.train --config "$CFG" --ckp "mp3e2e_$NAME" \
      --epochs "$EPOCHS" --validate_every 0 "$@" \
    | grep -E "Epoch|epoch time|Net Loss" || true
}

run nocache
run ramcache --cache_decoded
run diskwarm --cache_dir "$ROOT/decoded_cache"
echo "==== done: pairs/s = (steps x 256) / epoch time per mode ===="
