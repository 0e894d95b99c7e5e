#!/usr/bin/env bash
# The PyTorch port's fluid velocity-conditioned training recipe, one-to-one
# with scripts/train_vel.sh (the reference train_fluid/train_vel/train.sh:
# --use_vel --in_node_feats 6, 80k iters, batch 4, ckpt every 10k). Extra
# flags pass through. Runs on the CUDA card; --device cpu runs the plain
# versions.
set -euo pipefail
cd "$(dirname "$0")/.."
exec python -m tpugan_tpu_torch.cli.train_fluid --preset train_vel "$@"
