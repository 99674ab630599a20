#!/bin/bash
# Baseline ablation sweep on the PyTorch/CUDA port (the JAX package's
# baselines/ablation.sh):
#   bash scripts/torch_port_baselines_ablation.sh [snr] [checkpoint_dir]
# checkpoint_dir (default ./checkpoint) holds model_tc<9-12>_<epoch>.pth;
# its files are linked into ./checkpoint. PYTHON overrides the interpreter.
PY=${PYTHON:-python}
CKPT=${2:-checkpoint}
mkdir -p checkpoint
if [ "$(cd "$CKPT" && pwd)" != "$(cd checkpoint && pwd)" ]; then
    for f in "${CKPT%/}"/model_*.pth; do
        [ -e "$f" ] && ln -sf "$(cd "$(dirname "$f")" && pwd)/$(basename "$f")" checkpoint/
    done
fi
for model in tc9 tc10 tc11 tc12; do
    echo "########## Baseline ablation: $model ##########"
    $PY -m grafp_tpu_torch.cli.baseline_test_fp --query_lens=1,2,3,5 --n_query_db=500 \
        --test_snr=${1:-10} --text=baseline_ablation_$model \
        --test_ids=data/medeval_ids.npy --model=$model
done
