#!/usr/bin/env bash
# The PyTorch port's action training recipe, one-to-one with
# scripts/train_dir.sh (the reference train_action/train_dir/train.sh: 100k
# iters, lr 3e-4, batch 4, ckpt every 10k). Extra flags pass through. Runs
# on the CUDA card; --device cpu runs the plain versions.
set -euo pipefail
cd "$(dirname "$0")/.."
exec python -m tpugan_tpu_torch.cli.train_action --preset train_dir "$@"
