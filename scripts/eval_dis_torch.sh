#!/usr/bin/env bash
# The PyTorch port's feature-transfer evaluation recipe, one-to-one with
# scripts/eval_dis.sh (the reference train_action/eval_dis/run.sh). Point
# --data_dir at the MSR-Action3D directory and --ckpt_path at a trained GAN
# checkpoint. Runs on the CUDA card; --device cpu runs the plain versions.
set -euo pipefail
cd "$(dirname "$0")/.."
exec python -m tpugan_tpu_torch.cli.eval_tempo_feat --preset eval_dis "$@"
