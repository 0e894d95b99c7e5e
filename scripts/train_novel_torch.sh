#!/usr/bin/env bash
# The PyTorch port's fluid position-only training recipe, one-to-one with
# scripts/train_novel.sh (the reference train_fluid/train_novel/train.sh:
# 80k iters, batch 4, ckpt every 10k). Extra flags pass through. Runs on
# the CUDA card; --device cpu runs the plain versions.
set -euo pipefail
cd "$(dirname "$0")/.."
exec python -m tpugan_tpu_torch.cli.train_fluid --preset train_novel "$@"
