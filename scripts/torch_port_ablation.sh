#!/bin/bash
# Offset/overlap ablation sweep over the tc_2x preset checkpoints on the
# PyTorch/CUDA port (the root ablation.sh):
#   bash scripts/torch_port_ablation.sh [snr] [checkpoint_dir]
# checkpoint_dir (default ./checkpoint) holds model_tc_2x_<epoch>.pth; its
# files are linked into ./checkpoint. PYTHON overrides the interpreter.
PY=${PYTHON:-python}
CKPT=${2:-checkpoint}
mkdir -p checkpoint
if [ "$(cd "$CKPT" && pwd)" != "$(cd checkpoint && pwd)" ]; then
    for f in "${CKPT%/}"/model_*.pth; do
        [ -e "$f" ] && ln -sf "$(cd "$(dirname "$f")" && pwd)/$(basename "$f")" checkpoint/
    done
fi
for model in tc_27 tc_29 tc_30 tc_31; do
    echo "########## Ablation: $model ##########"
    $PY -m grafp_tpu_torch.cli.test_fp --query_lens=1,2,3,5 --n_query_db=500 \
        --test_snr=${1:-10} --text=ablation_$model \
        --test_ids=data/medeval_ids.npy --model=$model
done
