#!/bin/bash
# Baseline single-SNR eval on the PyTorch/CUDA port (the JAX package's
# baselines/test_pipeline.sh):
#   bash scripts/torch_port_baselines_test_pipeline.sh [snr] [checkpoint_dir]
# checkpoint_dir (default ./checkpoint) holds model_tc10_<epoch>.pth; its
# files are linked into ./checkpoint. PYTHON overrides the interpreter.
PY=${PYTHON:-python}
CKPT=${2:-checkpoint}
mkdir -p checkpoint
if [ "$(cd "$CKPT" && pwd)" != "$(cd checkpoint && pwd)" ]; then
    for f in "${CKPT%/}"/model_*.pth; do
        [ -e "$f" ] && ln -sf "$(cd "$(dirname "$f")" && pwd)/$(basename "$f")" checkpoint/
    done
fi
$PY -m grafp_tpu_torch.cli.baseline_test_fp --query_lens=1,2,3,5 --n_query_db=500 \
    --test_snr=${1:-10} --text=baseline_pipeline \
    --test_ids=data/medeval_ids.npy --model=tc10 --small_test
