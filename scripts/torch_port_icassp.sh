#!/bin/bash
# ICASSP evaluation reproduction on the PyTorch/CUDA port (the sweep of the
# root icassp.sh, without its download step: nothing is fetched):
#   bash scripts/torch_port_icassp.sh <audio_root> <aug_root> <checkpoint_dir>
# <checkpoint_dir> holds model_tc_29_<epoch>.pth (the port's or the
# reference's .pth); its files are linked into ./checkpoint. Rebases the
# index files and the configs onto the local roots, then sweeps SNR x
# {without, with IR} on fma_medium and fma_large with the tc_29 model.
# PYTHON overrides the interpreter (default: python).

set -u

AUDIO=${1%/}
AUG=${2%/}
CKPT=${3%/}
PY=${PYTHON:-python}

mkdir -p checkpoint
if [ "$(cd "$CKPT" && pwd)" != "$(cd checkpoint && pwd)" ]; then
    for f in "$CKPT"/model_*.pth; do
        [ -e "$f" ] && ln -sf "$(cd "$(dirname "$f")" && pwd)/$(basename "$f")" checkpoint/
    done
fi

$PY -m grafp_tpu_torch.cli.setup_config --noise_dir=$AUG/noise --ir_dir=$AUG/ir
EVAL=$(basename $AUDIO)
$PY -m grafp_tpu_torch.cli.setup_icassp --test_dir=$AUDIO --noise_dir=$AUG/noise --ir_dir=$AUG/ir --eval_type=$EVAL

echo "########## Evaluating without IR corruption ##########"
for snr in 20 15 10 5 0; do
    echo "Test with SNR = $snr"
    $PY -m grafp_tpu_torch.cli.test_fp --query_lens=1,2,3,5 --n_query_db=500 \
        --test_snr=$snr --text=sanir_fma_medium_$snr \
        --test_ids=data/medeval_ids.npy --model=tc_29
done
for snr in 20 15 10 5 0; do
    echo "Test with SNR = $snr"
    $PY -m grafp_tpu_torch.cli.test_fp --query_lens=1,2,3,5 --n_query_db=500 --test_dir=data/fma_large.json \
        --test_snr=$snr --text=sanir_fma_large_$snr \
        --test_ids=data/largeval_ids.npy --model=tc_29
done

echo "########## Evaluating with IR corruption ##########"
for snr in 20 15 10 5 0; do
    echo "Test with SNR = $snr"
    $PY -m grafp_tpu_torch.cli.test_fp --query_lens=1,2,3,5 --n_query_db=500 \
        --test_snr=$snr --text=withir_fma_medium_$snr \
        --test_ids=data/medeval_ids.npy --model=tc_29
done
for snr in 20 15 10 5 0; do
    echo "Test with SNR = $snr"
    $PY -m grafp_tpu_torch.cli.test_fp --query_lens=1,2,3,5 --n_query_db=500 --test_dir=data/fma_large.json \
        --test_snr=$snr --text=withir_fma_large_$snr \
        --test_ids=data/largeval_ids.npy --model=tc_29
done
