#!/bin/bash
# Small single-SNR eval against stored test ids on the PyTorch/CUDA port
# (the root test_pipeline.sh):
#   bash scripts/torch_port_test_pipeline.sh [snr] [checkpoint_dir]
# checkpoint_dir (default ./checkpoint) holds model_tc_29_<epoch>.pth; its
# files are linked into ./checkpoint. PYTHON overrides the interpreter.
PY=${PYTHON:-python}
CKPT=${2:-checkpoint}
mkdir -p checkpoint
if [ "$(cd "$CKPT" && pwd)" != "$(cd checkpoint && pwd)" ]; then
    for f in "${CKPT%/}"/model_*.pth; do
        [ -e "$f" ] && ln -sf "$(cd "$(dirname "$f")" && pwd)/$(basename "$f")" checkpoint/
    done
fi
$PY -m grafp_tpu_torch.cli.test_fp --query_lens=1,2,3,5 --n_query_db=500 \
    --test_snr=${1:-10} --text=pipeline_test \
    --test_ids=data/medeval_ids.npy --model=tc_29 --small_test
