#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port, ``tpugan_tpu_torch``.

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py                 # the whole run, a few minutes
    python3 chip_smoke.py --profile DIR   # also profiles one forward of each
                                          # serving mode and writes the
                                          # tables (and the train step's)
                                          # into DIR

Phases, one JSON line each (``phase`` names it):
  device   nvidia-smi name and power limit, torch and CUDA versions, the
           kernels' build time and their ptxas register / spill report
           (and the tensor-core and the f32 register-tiled EdgeConv
           kernels' alone, the latter must not spill; the approximate kNN
           kernel's; the pooled MLP's kernels of both forms, rows_gemm,
           dw_gemm and top_kernel, every instance of them and of the
           cell-grid interp's binned_walk, and every instance of the FPS
           kernel's
           fps_warp and fps_cluster, of nn1's nn1_split_kernel and
           nn1_finish, of the dense interp's interp_split_kernel and
           interp_finish, of the approximate kNN's approx_kernel and
           approx_prep and of the ball query's ball_query_kernel, which
           must not spill);
  kernel   each CUDA kernel of the serving path against its plain PyTorch
           version on the card, at every shape the serving path and the
           train step give it: the error against the stated tolerance,
           CUDA-event medians of the kernel, the plain version and a
           PyTorch yardstick the port never calls, the bound; kNN also on
           exact ties at serving width (duplicated grid points), equal to
           the plain version; each EdgeConv row names its variant (the
           bf16 classes of TC_CLASSES run the tensor-core kernel, "tc",
           the f32 classes of F32_TILED_CLASSES the f32 register-tiled
           one, "f32t", the rest the general one, "simt") and adds the
           device time of the wrapper's launches (torch.profiler), and
           every tc and f32t class on exact inputs at serving width
           equals the plain version bit for bit;
  kernel   (approx) the approximate bf16 kNN kernel against its plain
           version at the six approximate serving shapes (the f32 dynamic
           forward's five graph shapes at 10,240 points, the first also the
           bf16 static graph's; the rollout's 10,112-row frame, its last
           112 rows at the 999 sentinel with no invalid bias, as the
           rollout pads it), with the share of queries whose neighbour set
           differs from the exact kernel's, its launch plan (query tile,
           blocks, blocks an SM, waves), two launches bit for bit, the
           device time of it and of the exact kernel (torch.profiler), the
           times of the exact kernel, the plain version and the yardstick,
           and its bound with the per-pair epilogue counted at its pipes'
           rates beside the product-only bound counted before; the
           duplicated grid (bit for bit) and a query whose lane column holds
           more of its neighbours than the mode keeps (the same neighbour
           dropped);
  serving  with the launch counts reset: the trained checkpoint through the
           port's loader, the f32 dynamic and the bf16 static forward of a
           10,240-point frame, the Chamfer gate between them, the launches
           of each (the bf16 static forward's 9 EdgeConvs are 9
           tensor-core launches, none on the general kernel, the f32
           dynamic's 9 f32t launches and no tensor-core one); autograd off
           in this phase and the next three;
  rollout  a 25-frame rollout of about 10,000-point frames (counts read
           after it; 9 tensor-core EdgeConv launches a frame, no other);
  timing   the card's forward against the CPU's (plain versions) at 2,048
           points, and ms per frame of both serving forwards;
  serving_approx with the launch counts reset: the exact f32 dynamic
           forward, then with the approximate graph kNN switched on the f32
           dynamic (7 approximate launches) and the bf16 static forward (1),
           each with the normalised Chamfer against the exact one under
           GATE, the keep-mask agreement and ms per frame; then the rollout
           above with the switch on (1 approximate launch a frame); counts
           read after it;
  profile  with --profile only: device time by kernel and idle share of one
           forward of each serving mode;
  kernel   (train) the train step's kernels (fps, ball_query, the pooled
           MLP forward and backward, interp) against their plain versions
           at every shape one train step gives them (the dense interp on a
           random cloud in random order and on the train step's own call,
           train_interp_case: the first batch's predicted frames against
           their ground truth, each row with its launch plan, the share of
           pairs within the cutoff, its device time and two launches bit
           for bit; the ball query index for index, each row with its
           launch plan, its device time and two launches bit for bit; FPS
           index for index,
           each row with its launch plan (variant, cluster size, threads,
           points a thread), its device time and its device microseconds a
           round, also on rows of exact ties and rows that run out of valid
           points, then the round's fixed cost, "fps_floor": one point a
           thread, 1,024 rounds, on one warp and on clusters of 1 to 16
           blocks; the pooled MLP also
           with gammas of both signs and zero, and with the device time of
           each of its kernels); the EdgeConv backward
           at each shape class of the fused train step (12 frames of 1,152
           points; f32, one bf16 case, exact ties between duplicated planes
           at each f32 class), each row with the path it takes ("tiled":
           every f32 row, the redesigned kernel of F32_TILED_BWD_CLASSES,
           one launch of it a call and two calls equal bit for bit;
           "general": the bf16 row) and the device time of each of its
           kernels; and the pooled MLP's affine form, forward (autograd
           off) and backward, at the spatial critic's sa_0 and a group_all
           shape, each with its device time by kernel;
  train    with the launch counts reset: the trainer state of
           checkpoints/fluid_vel_20k.ckpt resumed for 4 full-width
           train_vel steps (B=4, 9,216-point patches, device sampling,
           dense interp) on the port's synthetic fluid data; losses, the
           adversarial gate, the critics' updates and state, the launches
           of each step against the counts the step's code implies, ms per
           step by CUDA events, the peak device memory from resuming the
           state on; then a profile of 2 more steps;
  train_cpu one small step (B=2, 1,024-point patches) from the same state
           and draws on the card and on the CPU (plain versions);
  train_fused with the launch counts reset: the train CLI twin
           (cli/train_fluid.main, called as a function) with
           TPUGAN_FUSED_EDGECONV_TRAIN=1, --preset train_vel
           --device_sampling --synthetic, resumed from the checkpoint for
           iterations 20001-20004 (log dir runs/chip_smoke_train_fluid/):
           each step's launches against STEP_ALWAYS + STEP_FUSED (9 fused
           EdgeConv forwards and 9 backwards, STEP_TILED_BWD = 9 of those
           on the redesigned f32 backward, none on the general kernel and
           none between steps) and the gate's and critics'
           counts, the checkpoint iterations' test split and sample dump
           against CKPT_EVAL, the last checkpoint read back equal to the
           state in memory; then one step with the switch off and on from
           the same state and draws (graphs replayed), the generator's
           gradients against FUSED_GRAD_TOL, ms per step of both, G only
           and G+D, and a profile of 2 more fused steps;
  kernel   (eval) kNN at k = 32 over [1, 9,216] x [1, 9,216] (the capped
           interpolation) and k = 64 over [1, 9,216]^2 (the capped
           density), nn1 at the eval Chamfers' shapes (sentinel-padded
           queries, a masked candidate tail), each against its plain
           version (run with the kernel checks above); every nn1 row with
           its launch plan, its device time and two launches bit for bit;
  eval     with the launch counts reset: the port's eval CLI, called as a
           function, on the trained checkpoint at 9,216-point patches with
           its default 2,000 auction rounds, 2 samples f32 dynamic and 1
           bf16 static with the exact twin, on synthetic data under
           runs/eval_fluid_synth/; every metric finite, each EMD a full
           permutation, each sample's launches equal to EVAL_SAMPLE /
           EVAL_SAMPLE_AGREEMENT; seconds per sample, seconds and rounds
           of each auction;
  eval_approx with the launch counts reset: one eval CLI sample with
           --approx_graph --agreement_vs_exact at --patch_size 32768 (4,096
           inputs, the first size whose graphs reach the approximate
           kernel) on a 40,000-particle synthetic dataset under
           runs/eval_fluid_synth_approx/, --emd_iters cut to
           EVAL_APPROX_EMD_ITERS; launches against EVAL_APPROX_SAMPLE,
           every metric finite, the Chamfer against the exact twin under
           GATE, the switch off again after the call;
  density  with the launch counts reset: the trained SRNet on a whole
           12,000-particle frame (96,000 slots), the exact density of its
           kept points and of a 32^3 grid over it (the cell-grid kernel,
           cutoff 0.05), the capped k = 64 density of a 9,216-point ground
           truth (against the kNN's plain version); launches against
           DENSITY_LAUNCHES; then the binned kernel against its plain
           version and the dense interp kernel at both shapes
           (check_binned_interp), with the pairs within the cutoff (the
           bound's work) and those its 27 cells hold (the walk's), its
           tiles (binned_plan), two launches bit for bit, its time, its
           device time by kernel, its bound and the dense kernel's time;
  eval_cpu position_metrics, cycle_consistency and the exact density on
           fixed small clouds, on the card and on the CPU;
  library  with the launch counts reset: the library functions that reach a
           kernel, at sizes users run (after the eval paths): the geometry
           losses (repulsion, density, refinement, temporal, free-particle,
           edge) with their gradient and the graph builders on the trained
           SRNet's [4, 9,216] output, the density of the density phase's
           12,000-particle frame, the EMD loss on [4, 2,048], a multi-scale
           SetConv at the fluid spatial critic's first stage (two scales,
           1,024 centres) in train (forward, backward) and eval; launches
           read after (every one of LIBRARY_KERNELS at least once), then the
           same calls with every kernel's plain version, held to the
           LIBRARY_* limits (clouds on a 2^-10 grid, on_grid);
  kernel   (action) the affine pooled-MLP forward at the action towers'
           SetConvs (sa1 [24, 512, 64, 6] 64 -> 64 -> 128, sa2 [24, 256,
           32, 131] 128 -> 256, the classifier's pooling [24, 1, 256, 259]
           512 -> 512 and the critic's 256 -> 512), folded affines of both
           signs, two launches bit for bit, with its forward instances'
           ptxas report, and a gradient above MAX_WIDTH and the batch-norm
           form above it refused; kNN at 128-point frames and the flow's
           k = 32 at B = 24, FPS on 72 rows of 2,048 and of 512, the ball
           query at nsample 64 and 32, the f32t EdgeConv forward at
           EdgeConv_0's (1, 3, 64, 128) and the general forward at
           GENERAL_EDGECONV (a class no path runs); each against its plain
           version (run with the kernel checks above);
  action_serving with the launch counts reset: checkpoints/
           action_tempo_20k.ckpt's NoMaskSRNet through the action demo
           twin's upsample_clip, 24 frames of 128 -> 2,048 points of a
           synthetic clip (runs/chip_smoke_action/), launches against
           ACTION_FRAME a frame (7 f32t EdgeConvs, 0 general), the same
           model on the CPU with the card's graphs replayed, ms per frame;
  tempo_feat with the launch counts reset: ActionCls transferred from the
           checkpoint's temporal critic, one infer batch of 24 clips x 3
           frames x 2,048 points (TEMPO_INFER: 7 affine pooled-MLP
           forwards, 512-wide layers included), logits against the CPU's
           with the flow graphs replayed; then the eval_tempo_feat twin
           for 2 epochs on its synthetic set (runs/chip_smoke_tempo_feat/),
           clip and video accuracy, ms per train step and per infer batch;
  kernel   (action train) the action GAN step's shapes: kNN at the
           generator's 12 x 128 graphs and the flow's k = 32 at B = 4, FPS
           at device sampling's 12 x 2,048 -> 128 and every critic stage,
           the ball query at the spatial critic's radii 0.3 / 0.6 / 1.0
           and the temporal critic's, nn1 at [4, 2,048]^2, EdgeConv_0's
           (1, 3, 64, 128) on the f32t forward and the redesigned f32
           backward, and the general f32 backward at GENERAL_EDGECONV (12
           frames of 128 points, random and exact ties); each against its
           plain version (run with the kernel checks above);
  train_action with the launch counts reset: the action train CLI twin
           (cli/train_action.main, called as a function) with
           TPUGAN_FUSED_EDGECONV_TRAIN=1, --preset train_dir
           --device_sampling --synthetic, resumed from
           checkpoints/action_tempo_20k.ckpt for iterations 20001-20004
           (runs/chip_smoke_train_action/): each step's launches against
           ACTION_STEP_* (7 fused EdgeConv forwards and backwards, all 7 on
           the f32t forward and the redesigned backward, none on the
           general kernels; no pooled-MLP launch), the checkpoint
           iterations' test split against ACTION_CKPT_EVAL, every loss
           finite, the last checkpoint read back equal, ms per step (G only
           and G+D), the peak memory, and a profile of 2 more steps; then
           one step with the switch off and on from the same state and
           draws (graphs and flow kNN replayed), the generator's gradients
           against ACTION_FUSED_GRAD_TOL with a lossy control that must fail
           it; then one step on the card and on the CPU from the same state
           and draws, the updates by norm, and a card step without the
           generator's adversarial losses that must fail the comparison;
  train_recipes with the launch counts and the native library's calls
           reset before each: both train CLI twins as the recipe scripts
           run them (--preset train_vel / train_dir, host sampling: no
           --device_sampling, no fused switch) with --synthetic, resumed
           from the checkpoints for iterations 20001-20004
           (runs/chip_smoke_train_recipes/); each step's launches against
           the device-sampling counts less its one FPS, every loss finite,
           the native library's calls a batch (RECIPE_NATIVE), the loader's
           ms a batch in the prefetch thread, each step's wait on the
           queue and its ms; then the loader alone, native and plain in
           turns on the same seeds (ms a batch; every library call held to
           its plain version within LOADER_ROUNDING, the batch arrays that
           differ counted), beside the host CPU and the card; a
           native_library line before the kernels line;
  kernel   (fluid demo) kNN at the f32 dynamic forward's five graph shapes
           and the f32 EdgeConv forward at its six classes over 512 inputs,
           nn1 at 4,096 points both ways; each against its plain version
           (run with the kernel checks above);
  rollout_cli with the launch counts reset: the rollout CLI twin
           (cli/rollout.main, called as a function) on the checkpoint with
           --use_vel over its synthetic sequence of 25 frames of 10,240
           particles, f32 dynamic and bf16 static through the
           device-resident rollout, bf16 static through the host pipeline
           with --export_bgeo, and f32 dynamic with --approx_graph
           (runs/chip_smoke_rollout_cli/); each run's launches a frame (7
           kNN and 9 f32t EdgeConvs; 1 kNN and 9 tensor-core EdgeConvs; 7
           approximate kNN and 9 f32t EdgeConvs), the switch off again
           after the approximate run, the host pipeline's frames equal to
           the device path's bit for bit, every bf16 static and every
           approximate frame against the f32 dynamic one under GATE, every
           bgeo read back equal to its npy; frames/s, ms a frame in events
           and in device time;
  bench_metrics with the launch counts reset: the bench_metrics twin at
           its defaults (8 x 79,872, 100 auction rounds), its nn1 launches
           and auction rounds; nn1 on its own clouds against the plain
           version both ways, and a kernel row at that shape;
  fluid_demo with the launch counts reset: the fluid demo twin with the
           checkpoint and --use_vel at its defaults (24 frames of 4,096
           synthetic particles, runs/chip_smoke_fluid_demo/), launches
           against FLUID_DEMO_FRAME a frame, the mean normalised Chamfer
           and the wall time;
  kernel   (fast_d) FPS, the ball query and the flow kNN at the shapes the
           critics' stacked applies give them (FAST_D_FPS, FAST_D_BALL,
           FAST_D_KNN: [2B] and frame-stacked rows, FPS mask-aware on the
           fake half's rows), each index for index against its plain
           version, with its launch plan, device time and two launches bit
           for bit (run with the kernel checks above);
  fast_d_critics the checkpoints' critics at full width, spectral norm
           frozen: (a) the fluid temporal critic's frame-stacked apply
           against its per-frame loop, (b) the action tower on [fake; real]
           under stat_groups(2) against two applies, (c) the fluid spatial
           critic on [fake; real] under stat_groups(2) (the plain stack, no
           pooled-MLP launch) against two calls on the pooled-MLP kernel;
           scores and every running moment against the FAST_D_* tolerances,
           and the stacked apply with G = 1 as a control that must fail;
  train_fast_d with the launch counts reset: the train CLI twin with
           --fast_d and TPUGAN_FUSED_EDGECONV_TRAIN=1, --preset train_vel
           --device_sampling --synthetic, resumed from the checkpoint for
           iterations 20001-20004 (runs/chip_smoke_train_fast_d/): each
           step's launches against STEP_GATE_FAST_D / STEP_CRITICS_FAST_D,
           every loss finite, the critics' parameters moved exactly on the
           critic updates, the last checkpoint read back equal, ms per step
           (G only and G+D), the peak memory; then fast-d and sequential
           steps in turns from one state and one set of draws (ms, and a
           profile of 2 more steps of each: device time, idle share), and
           one fast-d step on the card and on the CPU (StepReplay), the
           updates by norm;
  train_action_fast_d the same with the action CLI twin (--preset
           train_dir, checkpoints/action_tempo_20k.ckpt,
           runs/chip_smoke_train_action_fast_d/, ACTION_STEP_*_FAST_D);
  sharded_rollout the rollout CLI with --shard_points over 5 synthetic
           frames of 40,960 particles (SHARD_POINTS, four times the serving
           frame), f32 dynamic and bf16 static, in ranks launched by
           torchrun (this file with --rank-worker): one rank over NCCL and
           two ranks on the one card over gloo (runs/chip_smoke_parallel/;
           the backend each rank's group took is checked); each world's
           frames against the unsharded CLI's (SHARD_GATE), each rank's
           launches a frame against SHARD_RUNS (counts reset in the rank
           before each run, read after), ms a frame in CUDA events and on
           the host clock; past the counted runs, every graph of the f32
           dynamic rollout on each rank against the unsharded kNN of the
           same gathered cloud (indices may differ only between candidates
           whose exact distances tie within f32 noise);
  data_parallel in the same ranks: the fluid train CLI twin with
           --data_parallel --preset train_vel --device_sampling
           --synthetic and the fused switch, resumed from the checkpoint
           for iterations 20001-20004 (B = 4); at one rank (NCCL) in turns
           with the same run without --data_parallel (DP_TURNS: the same
           launches every step, the first step's losses equal bit for
           bit), its checkpoint read back equal; at two ranks (gloo) both
           ranks' parameters and buffers equal bit for bit after every
           step, every launch as at one rank (the pooled-MLP batch-norm
           kernel's too, 4 a G-only and 12 a G+D step, its moments summed
           over the ranks), the gate's decisions equal, the first step's losses within
           DP_LOSS_TOL_FIRST of one rank's and every later step's within
           the one-rank runs' spread at that step widened by
           DP_SPREAD_WIDEN times it on each side; then the action twin with
           --data_parallel --fast_d for iterations 20001-20002 at two
           ranks, ranks equal after every step; ms a step (G only and G+D),
           the collectives' share and count a step at two ranks (each
           collective synchronised, timed and counted), and the count of
           the same fluid run for 2 iterations with every SetConv on the
           plain stack (the kernel's must not exceed it), the peak memory of
           each rank; in the ranks, the pooled-MLP batch-norm kernel
           forward and backward at every shape the two-rank fluid run gave
           it, against its plain versions under the same real two-rank sum
           (check_pooled_mlp's limits);
  kernel   (sharded_rollout, data_parallel) each kernel at every shape the
           ranks' counted runs gave it (the wrappers' call sites record the
           shapes, and their calls must add up to the runs' launches): the
           sharded rollout's at one and two ranks, the data-parallel runs'
           at two (one rank's are the train phases' shapes), each against
           its plain version by the limits of its own rows above (the
           pooled-MLP rows made in the ranks, on the real two-rank sum).
Then the ``native_library`` line, one ``{"kernels": [...]}`` line, the
card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero before the ok line. Without a CUDA card, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "checkpoints", "fluid_vel_20k.ckpt")
N_POINTS = 10240          # serving frame (the JAX bench's frame)
ROLLOUT_FRAMES = 25
ROLLOUT_POINTS = 10000    # not a multiple of the rollout's ALIGN
ROLLOUT_BUCKET = 10112    # the frames' rows (rounded up to ALIGN = 128)
GATE = 5e-3               # normalised Chamfer gate, as in bench.py

# H100 SXM published peaks (dense): HBM bytes/s and the rates by type
PEAK_BYTES = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12}
# Instruction rates of one H100 SXM by pipe, for work that is not FMAs:
# results a clock an SM (the CUDA C++ Programming Guide's arithmetic
# throughput table, compute capability 9.0) x 132 SMs x 1.98 GHz, the clock
# the 67 TFLOP/s f32 peak assumes (2 x 128 x 132 x 1.98e9): f32 add, fma
# and min / max 128; 32-bit integer add, logic and min / max 64;
# conversions 16; and 128 instructions a clock an SM issued in all
SM_CLOCKS = 132 * 1.98e9
PIPE_RATE = {"f32": 128 * SM_CLOCKS, "int": 64 * SM_CLOCKS,
             "cvt": 16 * SM_CLOCKS, "issue": 128 * SM_CLOCKS}

REPS = 10

DATA_DIR = os.path.join(ROOT, "runs", "chip_smoke_fluid")   # gitignored
TRAIN_STEPS = 4

# Launches per train step, read off tpugan_tpu_torch/train/step.py (the
# wrappers count one per call):
#   every step: device sampling's FPS; the generator's 7 kNN graphs (one
#     [3B] batch); the Chamfer's 2 nn1 and the masking target's 1;
#   gate open: the spatial critic's 3 FPS, 3 ball queries and 4 pooled-MLP
#     forwards (one per SetConv) and their 4 backwards (the gradient to the
#     generator); the dense interp; the temporal critic's 2 stacked FPS,
#     6 ball queries (sa1 and sa2 per frame) and 3 flow kNN;
#   critic update (even iteration, gate open): the temporal critic twice
#     (fake, real) and the spatial critic twice, with their backwards.
STEP_ALWAYS = {"fps": 1, "knn": 7, "nn1": 3}
STEP_GATE = {"fps": 5, "ball_query": 9, "pooled_mlp_fwd": 4,
             "pooled_mlp_bwd": 4, "interp": 1, "knn": 3}
STEP_CRITICS = {"fps": 10, "ball_query": 18, "pooled_mlp_fwd": 8,
                "pooled_mlp_bwd": 8, "knn": 6}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, reps=REPS, warmup=2) -> float:
    """Median over ``reps`` runs of CUDA-event time, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, torch, reps=REPS, by_kernel=False, tries=3):
    """Device time of the kernels ``fn`` launches, per call (torch.profiler,
    after a warm-up): what the card spends, without the host's launch
    overhead that ``time_ms`` includes where the host is the slower side.
    ``by_kernel``: also the time per call of each kernel, by name (the
    demangled name up to its argument list). A profile that lost kernel
    records (a kernel counted other than a multiple of ``reps`` times, or
    none at all, as happens now and then on the card) is taken again, up
    to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with prof(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in p.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events and all(e.count % reps == 0 for e in events):
            break
    names = {}
    for e in events:
        name = e.key.replace("(anonymous namespace)::", "")
        name = name.split("(", 1)[0] or name
        names[name] = names.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    total = sum(names.values())
    return (total, names) if by_kernel else total


def bound(flops: float, nbytes: float, kind: str):
    """(least time in ms, "bytes" or "operations") on the published peaks."""
    t_ops = flops / PEAK_OPS[kind] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_instances(name: str, functions) -> dict:
    """Per kernel instance of ``csrc/<name>.cu`` whose mangled name holds
    one of ``functions``: [registers, spill store bytes]."""
    from tpugan_tpu_torch import _build

    out = {}
    for part in _build.ptxas_report(name).split("Compiling entry function")[1:]:
        fn = part.split("\n", 1)[0].strip().strip("'")
        if not any(f in fn for f in functions):
            continue
        regs = re.findall(r"Used (\d+) registers", part)
        spills = re.findall(r"(\d+) bytes spill stores", part)
        out[fn] = [int(regs[0]) if regs else 0, sum(int(v) for v in spills)]
    return out


def ptxas_summary(name: str, function: str = "") -> dict:
    """Registers and spills of ``csrc/<name>.cu``'s kernels (only those whose
    mangled name holds ``function``, when given)."""
    from tpugan_tpu_torch import _build

    text = _build.ptxas_report(name)
    if function:
        parts = text.split("Compiling entry function")
        text = "".join(p for p in parts[1:] if function in p.split("\n", 1)[0])
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
    return {"functions": len(regs), "max_registers": max(regs, default=0),
            "spill_store_bytes": sum(spills)}


# ---------------------------------------------------------------- phase 2

# (path, B, Nq, Nc, D, k, self graph, launches per serving forward, per
# G+D train step, per eval sample, per density phase)
KNN_SHAPES = [
    # the f32 dynamic serving forward of one 10,240-point frame
    ("serving", 1, N_POINTS, N_POINTS, 3, 20, True, 1, 0, 0, 0),  # EdgeConv_0
    ("serving", 1, N_POINTS, N_POINTS, 32, 20, True, 2, 0, 0, 0),  # IDGCN
    ("serving", 1, N_POINTS, N_POINTS, 64, 12, True, 2, 0, 0, 0),  # up / mask
    ("serving", 1, N_POINTS, N_POINTS, 64, 4, True, 1, 0, 0, 0),   # upsampler
    ("serving", 1, N_POINTS, N_POINTS, 64, 8, True, 1, 0, 0, 0),   # mask head
    # the train step: the generator's graphs over its [3B] = 12 rows of
    # 1,152 inputs, and the temporal critic's flow embeddings (k = 32 from
    # one frame's 256 sa2 centres to the next frame's; 3 per critic call)
    ("train", 12, 1152, 1152, 3, 20, True, 0, 1, 0, 0),
    ("train", 12, 1152, 1152, 32, 20, True, 0, 2, 0, 0),
    ("train", 12, 1152, 1152, 64, 12, True, 0, 2, 0, 0),
    ("train", 12, 1152, 1152, 64, 4, True, 0, 1, 0, 0),
    ("train", 12, 1152, 1152, 64, 8, True, 0, 1, 0, 0),
    ("train", 4, 256, 256, 3, 32, False, 0, 9, 0, 0),
    # eval: the capped interpolation's k = 32 radius kNN from the 9,216
    # predicted points to the 9,216-point ground truth; the capped
    # density's k = 64 over a 9,216-point patch
    ("eval", 1, 9216, 9216, 3, 32, False, 0, 0, 1, 0),
    ("density", 1, 9216, 9216, 3, 64, True, 0, 0, 0, 1),
]

EDGECONV_SHAPES = [  # (name, C, H, O, K, aggregate, mlp, launches per forward)
    ("EdgeConv_0", 6, 64, 128, 20, "max", True, 1),
    ("IDGCN d=1", 32, 16, 32, 20, "max", True, 2),
    ("IDGCN d=2", 32, 16, 32, 10, "max", True, 2),
    ("up/mask k=12", 64, 128, 256, 12, "max", True, 2),
    ("up k=4", 64, 128, 256, 4, "max", True, 1),
    ("mask k=8 sum", 64, 128, 128, 8, "sum", False, 1),
]
# bf16 static forward launches of the tensor-core EdgeConv kernel: every
# shape class above
TC_PER_BF16_FORWARD = 9
# f32 dynamic forward launches of the f32 register-tiled EdgeConv kernel:
# every shape class above
F32T_PER_F32_FORWARD = 9


def exact_sqdist(q, c, bi, qi, ci):
    """float64 |q[b, i] - c[b, j]|^2 for index arrays (numpy)."""
    return np.sum((q[bi, qi].astype(np.float64)
                   - c[bi, ci].astype(np.float64)) ** 2, -1)


def index_gaps(q_np, c_np, ik, ip):
    """(mismatches, largest exact-distance gap between the two sides'
    choices where their indices differ) of [B, Nq(, k)] index tensors."""
    ik_np, ip_np = ik.cpu().numpy(), ip.cpu().numpy()
    diff = np.nonzero(ik_np != ip_np)
    gap = np.abs(exact_sqdist(q_np, c_np, diff[0], diff[1], ik_np[diff])
                 - exact_sqdist(q_np, c_np, diff[0], diff[1], ip_np[diff]))
    return int(gap.size), float(gap.max()) if gap.size else 0.0


def tie_grid(torch, dev):
    """[1, 10,240, 3]: a 16 x 16 x 20 integer grid, every point twice, so
    every distance is exact in f32 and each neighbour has a twin."""
    g = np.stack(np.meshgrid(np.arange(16.0), np.arange(16.0), np.arange(20.0),
                             indexing="ij"), -1).reshape(-1, 3)
    return torch.from_numpy(np.concatenate([g, g])[None].astype(np.float32)).to(dev)


def _knn_row(torch, dev, rng, what, b, nq, nc, d, k, own, scale):
    """The exact kNN kernel against its plain version on a cloud of
    ``scale`` (a graph over itself with ``own``; with ``own="rows"`` the
    queries are the first ``nq`` candidates, a rank's rows of a sharded
    graph), its times and bound.
    Distances to 1e-5 of 2 max |q|^2 (the f32 error of max(|q|^2 + |c|^2 -
    2 q.c, 0)); an index may differ only where the two candidates' exact
    distances tie within twice that."""
    from tpugan_tpu_torch.ops.kernels import knn as K

    q_np = (rng.standard_normal((b, nq, d)) * scale).astype(np.float32)
    c_np = q_np if own is True else (rng.standard_normal((b, nc, d)) * scale
                                     ).astype(np.float32)
    if own == "rows":
        q_np = np.ascontiguousarray(c_np[:, :nq])
    q, c = torch.from_numpy(q_np).to(dev), torch.from_numpy(c_np).to(dev)
    bias = torch.zeros((b, nc), device=dev)
    d2k, ik = K.knn_kernel(q, c, bias, k)
    d2p, ip = K.knn_plain(q, c, bias, k)
    torch.cuda.synchronize()
    tol = 1e-5 * 2 * float(max((q * q).sum(-1).max(), (c * c).sum(-1).max()))
    err = float((d2k - d2p).abs().max())
    bad, gap = index_gaps(q_np, c_np, ik, ip)
    if not (err <= tol and gap <= 2 * tol):
        raise AssertionError(f"knn {what} B={b} N={nq} D={d} k={k}: err "
                             f"{err} tol {tol}, index gaps up to {gap}")
    ms = time_ms(lambda: K.knn_kernel(q, c, bias, k), torch)
    plain_ms = time_ms(lambda: K.knn_plain(q, c, bias, k), torch)
    lib_ms = time_ms(lambda: torch.topk(torch.cdist(q, c), k, largest=False),
                     torch)
    flops = b * nq * nc * (2 * d + 3)
    nbytes = 4 * b * (nq * d + nc * d + nc) + b * nq * k * 12
    b_ms, b_by = bound(flops, nbytes, "f32")
    return dict(B=b, Nq=nq, Nc=nc, D=d, k=k, max_abs_err=err, tol=tol,
                index_mismatch=bad, max_tie_gap=gap, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def check_knn(torch, dev, rng):
    """Every kNN graph shape of the serving forward and of the train step
    (the step's graphs are rows of one launch each), by ``_knn_row``."""
    from tpugan_tpu_torch.ops.kernels import knn as K

    rows = []
    for (path, b, nq, nc, d, k, own, per_fwd, per_step, per_sample,
         per_density) in KNN_SHAPES:
        row = _knn_row(torch, dev, rng, path, b, nq, nc, d, k, own,
                       0.3 if d == 3 else 1.0)
        rows.append(dict(path=path, per_forward=per_fwd, per_step=per_step,
                         per_sample=per_sample, per_density=per_density,
                         **row))
        emit({"phase": "kernel", "kernel": "knn", **rows[-1]})

    # exact ties at serving width: 5,120 integer grid points, each twice, so
    # every distance is exact in f32 and each neighbour has a twin; the
    # kernel must give the plain version's (stable argsort's) lists exactly
    pts = tie_grid(torch, dev)
    bias = torch.zeros((1, N_POINTS), device=dev)
    d2k, ik = K.knn_kernel(pts, pts, bias, 20)
    d2p, ip = K.knn_plain(pts, pts, bias, 20)
    torch.cuda.synchronize()
    bad = int((ik != ip).sum())
    emit({"phase": "kernel", "kernel": "knn", "case": "exact ties", "B": 1,
          "Nq": N_POINTS, "Nc": N_POINTS, "D": 3, "k": 20,
          "max_abs_err": float((d2k - d2p).abs().max()), "index_mismatch": bad})
    if bad or not torch.equal(d2k, d2p):
        raise AssertionError(f"knn exact ties: {bad} indices differ from the "
                             "plain version's")
    return rows


# (graph, Nq = Nc, D, k, sentinel rows, launches per f32 dynamic forward,
# per bf16 static forward, per rollout frame) of the approximate kernel
# with the switch on. The rollout's graphs carry no valid mask: its padding
# rows sit at the 999 sentinel with bias 0, as real candidates far away.
APPROX_SHAPES = [
    ("EdgeConv_0 / static graph", N_POINTS, 3, 20, 0, 1, 1, 0),
    ("IDGCN", N_POINTS, 32, 20, 0, 2, 0, 0),
    ("up/mask k=12", N_POINTS, 64, 12, 0, 2, 0, 0),
    ("up k=4", N_POINTS, 64, 4, 0, 1, 0, 0),
    ("mask k=8", N_POINTS, 64, 8, 0, 1, 0, 0),
    ("rollout frame", ROLLOUT_BUCKET, 3, 20, ROLLOUT_BUCKET - ROLLOUT_POINTS,
     0, 0, 1),
]


def _set_overlap(a, b):
    """(share of rows whose index sets differ, mean share of b's entries
    missing from a's row) of [B, Nq, k] index tensors."""
    hit = (a[..., :, None] == b[..., None, :]).any(-2)   # b's entries in a
    return (float((~hit.all(-1)).float().mean()),
            float((~hit).float().mean()))


def check_knn_approx(torch, dev, rng):
    """The approximate kNN kernel at every approximate serving shape against
    its plain version (``knn.approx_agreement`` over the real rows: d2
    within half a bf16 ulp plus 1e-5 of 2 max |q|^2 of the float64 value,
    differing lists only where a distance rounds to bf16 within that of a
    boundary, at most 2% of the queries; the sentinel rows bit for bit),
    with its recall against the exact kernel; then the grid (bit for bit)
    and the dropped-neighbour case."""
    from tpugan_tpu_torch import PAD_SENTINEL
    from tpugan_tpu_torch.ops.kernels import knn as K

    rows = []
    for (graph, n, d, k, pad, per_fwd, per_static,
         per_frame) in APPROX_SHAPES:
        scale = 0.3 if d == 3 else 1.0
        c_np = (rng.standard_normal((1, n, d)) * scale).astype(np.float32)
        c_np[:, n - pad:] = PAD_SENTINEL
        c = torch.from_numpy(c_np).to(dev)
        bias = torch.zeros((1, n), device=dev)
        got = K.knn_approx_kernel(c, c, bias, k)
        want = K.knn_approx_plain(c, c, bias, k)
        exact = K.knn_kernel(c, c, bias, k)
        torch.cuda.synchronize()
        # the real rows pick real neighbours only, so their tolerance takes
        # the real points' norms; the sentinel rows tie at d2 = 0 exactly
        real = n - pad
        if pad and not (int(got[1][:, :real].max()) < real
                        and torch.equal(got[0][:, real:], want[0][:, real:])
                        and torch.equal(got[1][:, real:], want[1][:, real:])):
            raise AssertionError(f"knn approx {graph}: the sentinel rows")
        agree = K.approx_agreement(
            (got[0][:, :real], got[1][:, :real]),
            (want[0][:, :real], want[1][:, :real]),
            (c[:, :real], c[:, :real], bias[:, :real]))
        if not (agree["d2_excess"] <= 0 and agree["d2_unexplained"] == 0
                and agree["rows_unexplained"] == 0
                and agree["rows"] <= 0.02 * agree["queries"]):
            raise AssertionError(f"knn approx {graph} D={d} k={k}: {agree}")
        differ, missing = _set_overlap(got[1][:, :real], exact[1][:, :real])
        # queries whose exact top-k holds more than kp members of one lane
        # column: the mode's own losses, before any bf16 rank flip
        per_col = torch.zeros((1, real, K.LANES), device=dev).scatter_add_(
            -1, exact[1][:, :real] % K.LANES,
            torch.ones_like(exact[0][:, :real]))
        crowded = float((per_col.amax(-1) > K.chunk_kp_approx(k)).float().mean())
        again = K.knn_approx_kernel(c, c, bias, k)
        torch.cuda.synchronize()
        repeat = bool(torch.equal(got[0], again[0])
                      and torch.equal(got[1], again[1]))
        if not repeat:
            raise AssertionError(f"knn approx {graph}: two launches differ")
        run = lambda: K.knn_approx_kernel(c, c, bias, k)
        ms = time_ms(run, torch)
        dev_ms = device_ms(run, torch)
        exact_ms = time_ms(lambda: K.knn_kernel(c, c, bias, k), torch)
        exact_dev_ms = device_ms(lambda: K.knn_kernel(c, c, bias, k), torch)
        plain_ms = time_ms(lambda: K.knn_approx_plain(c, c, bias, k), torch)
        lib_ms = time_ms(lambda: torch.topk(torch.cdist(c, c), k, largest=False),
                         torch)
        kp = K.chunk_kp_approx(k)
        pairs = n * n
        # the least time of the work the function needs, the larger over
        # the pipes that run side by side. A pair: the cross term's 2 D bf16
        # operations on the tensor cores; 4 f32 (|q|^2 + |c|^2, the fma with
        # -2 q.c, the clamp, the bias); half a conversion (one bf16x2 rounds
        # two distances); 2.5 integer (the key from the rounded pair: 1.5;
        # one compare with its lane column's kp-th key). A lane column of
        # m = Nc / 128 candidates in random order admits
        # kp (1 + ln(m / kp)) of them, each a 2 kp - 1 min / max insert.
        # Every one of these at the issue rate too.
        m = n / K.LANES
        admitted = min(m, kp * (1 + math.log(m / kp)))
        inserts = admitted * (2 * kp - 1) / m      # a pair, on average
        t_ops = max(2 * d * pairs / PEAK_OPS["bf16"],
                    4 * pairs / PIPE_RATE["f32"],
                    (2.5 + inserts) * pairs / PIPE_RATE["int"],
                    0.5 * pairs / PIPE_RATE["cvt"],
                    (7 + inserts) * pairs / PIPE_RATE["issue"]) * 1e3
        t_bytes = (4 * (2 * n * d + n) + n * k * 12) / PEAK_BYTES * 1e3
        b_ms, b_by = max((t_ops, "operations"), (t_bytes, "bytes"))
        # the bound counted before this one (the products, 3 f32 operations
        # a pair at the FMA peak)
        b_old = max((2 * d * pairs / PEAK_OPS["bf16"]
                     + 3 * pairs / PEAK_OPS["f32"]) * 1e3, t_bytes)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = K.knn_approx_plan(1, n, n, d, k, sms)
        rows.append(dict(graph=graph, B=1, Nq=n, Nc=n, D=d, k=k,
                         kp=kp, sentinel_rows=pad,
                         per_forward=per_fwd, per_static=per_static,
                         per_frame=per_frame, wq=plan.wq,
                         queries_a_block=plan.queries, blocks=plan.blocks(1, n),
                         blocks_per_sm=plan.per_sm, waves=plan.waves(1, n, sms),
                         max_abs_err=float((got[0] - want[0]).abs().max()),
                         index_mismatch=int((got[1] != want[1]).sum()),
                         **agree, rows_set_differs_vs_exact=differ,
                         neighbours_missing_vs_exact=missing,
                         rows_column_crowded=crowded, repeat_bit_equal=repeat,
                         ms=ms, device_ms=dev_ms, exact_ms=exact_ms,
                         exact_device_ms=exact_dev_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         bound_ms_products_only=b_old))
        emit({"phase": "kernel", "kernel": "knn_approx", **rows[-1]})

    # exact inputs: the duplicated grid of check_knn, bit for bit
    pts = tie_grid(torch, dev)
    bias = torch.zeros((1, N_POINTS), device=dev)
    got = K.knn_approx_kernel(pts, pts, bias, 20)
    want = K.knn_approx_plain(pts, pts, bias, 20)
    torch.cuda.synchronize()
    bad = int((got[1] != want[1]).sum())
    emit({"phase": "kernel", "kernel": "knn_approx", "case": "exact ties",
          "Nq": N_POINTS, "Nc": N_POINTS, "D": 3, "k": 20,
          "max_abs_err": float((got[0] - want[0]).abs().max()),
          "index_mismatch": bad})
    if bad or not torch.equal(got[0], want[0]):
        raise AssertionError(f"knn approx exact ties: {bad} indices differ")

    # a query at the origin whose 4 nearest candidates are 5, 133 and 261
    # (lane column 5) and 7, the rest 2-3 away: k = 4 keeps 2 keys a column,
    # so 261 is dropped on both sides; the exact kernel keeps it
    drng = np.random.default_rng(3)
    dirs = drng.standard_normal((4096, 3))
    cand = dirs / np.linalg.norm(dirs, axis=1, keepdims=True) * drng.uniform(
        2.0, 3.0, (4096, 1))
    for i, r in ((5, 0.125), (133, 0.25), (261, 0.375), (7, 0.5)):
        cand[i] = (r, 0.0, 0.0)
    c = torch.from_numpy(cand[None].astype(np.float32)).to(dev)
    q = torch.zeros((1, 1, 3), device=dev)
    bias = torch.zeros((1, 4096), device=dev)
    got = K.knn_approx_kernel(q, c, bias, 4)
    want = K.knn_approx_plain(q, c, bias, 4)
    exact = K.knn_kernel(q, c, bias, 4)
    torch.cuda.synchronize()
    emit({"phase": "kernel", "kernel": "knn_approx", "case": "dropped neighbour",
          "approx_idx": got[1][0, 0].tolist(), "plain_idx": want[1][0, 0].tolist(),
          "exact_idx": exact[1][0, 0].tolist()})
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and got[1][0, 0].tolist()[:3] == [5, 133, 7]
            and exact[1][0, 0].tolist() == [5, 133, 261, 7]):
        raise AssertionError("knn approx dropped-neighbour case")
    return rows


def _edgeconv_row(torch, dev, rng, name, cdt, kind, n, c, h, o, k, agg, mlp,
                  b=1):
    """The fused EdgeConv forward of ``b`` frames of ``n`` points against its
    plain version (f32: to 1e-4 of the scale, summation order only; bf16:
    3e-2, a 1-ulp rounding flip of one layer's value may carry through the
    next layers), launching the variant its class takes, with its times and
    bound."""
    from tpugan_tpu_torch.ops.kernels import edgeconv as E

    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)
    nbr = t(b, k, n, c)
    ctr = t(b, n, c)
    wn, we = t(c, h) / np.sqrt(c), t(c, h) / np.sqrt(c)
    w1 = t(h, h) / np.sqrt(h) if mlp else None
    w2 = t(h, o) / np.sqrt(h) if mlp else None
    args = (nbr.to(cdt), ctr.to(cdt), wn, we, w1, w2, agg, cdt)
    variant = ("tc" if E.takes_tensor_cores(cdt, mlp, c, h, o) else
               "f32t" if E.takes_f32_tiled(cdt, mlp, c, h, o) else "simt")
    tc0, f0 = E.TC_LAUNCHES, E.F32_TILED_LAUNCHES
    out_k = E.edgeconv_fused(*args).float()
    got = (E.TC_LAUNCHES - tc0, E.F32_TILED_LAUNCHES - f0)
    if got != (int(variant == "tc"), int(variant == "f32t")):
        raise AssertionError(f"edgeconv {name} {kind}: (tensor-core, f32t) "
                             f"launches {got}, variant {variant}")
    out_p = E.edgeconv_plain(*args).float()
    torch.cuda.synchronize()
    scale = float(out_p.abs().max())
    tol = (1e-4 if kind == "f32" else 3e-2) * scale
    err = float((out_k - out_p).abs().max())
    if not (err <= tol and bool(torch.isfinite(out_k).all())):
        raise AssertionError(f"edgeconv {name} {kind}: err {err} tol {tol}")
    ms = time_ms(lambda: E.edgeconv_fused(*args), torch)
    dev_ms = device_ms(lambda: E.edgeconv_fused(*args), torch)
    plain_ms = time_ms(lambda: E.edgeconv_plain(*args), torch)
    esz = 4 if kind == "f32" else 2
    flops = 2 * b * n * k * (2 * c * h + ((h * h + h * o) if mlp else 0))
    nbytes = esz * (b * (k * n * c + n * c + n * o) + 2 * c * h
                    + ((h * h + h * o) if mlp else 0))
    b_ms, b_by = bound(flops, nbytes, kind)
    return dict(dtype=kind, variant=variant, C=c, H=h, O=o, K=k,
                aggregate=agg, max_abs_err=err, tol=tol, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by)


def check_edgeconv(torch, dev, rng):
    """Each EdgeConv shape class of the serving forward in f32 and bf16; a
    bf16 class of ``TC_CLASSES`` must launch the tensor-core kernel
    (variant "tc") once, an f32 class of ``F32_TILED_CLASSES`` the f32
    register-tiled kernel ("f32t") once, every other row the general
    kernel ("simt"). Then exact inputs at those classes and serving width,
    bit for bit."""
    rows = []
    for name, c, h, o, k, agg, mlp, per_fwd in EDGECONV_SHAPES:
        for cdt, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            rows.append(dict(config=name, per_forward=per_fwd, **_edgeconv_row(
                torch, dev, rng, name, cdt, kind, N_POINTS, c, h, o, k, agg,
                mlp)))
            emit({"phase": "kernel", "kernel": "edgeconv", **rows[-1]})
    check_edgeconv_exact(torch, dev)
    return rows


def check_edgeconv_exact(torch, dev, k=12):
    """Each class of the tensor-core kernel (bf16) and of the f32
    register-tiled kernel (f32) at serving width on exact inputs: ctr = 0
    and sparse {0, 1} neighbours and weights, so leaky ReLU is the identity
    and every product and sum is an integer, exact in f32 in any order;
    planes 1 and 3 repeat planes 0 and 2 (max and min tie). Every aggregate
    must equal the plain version bit for bit and launch its kernel once.
    Its own generator keeps the other checks' data as it was."""
    from tpugan_tpu_torch.ops.kernels import edgeconv as E

    gen = np.random.default_rng(8)
    bits = lambda p, *s: torch.from_numpy(
        (gen.random(s) < p).astype(np.float32)).to(dev)
    classes = [("tc", torch.bfloat16, cls)
               for cls in sorted(E.TC_CLASSES, reverse=True)]
    classes += [("f32t", torch.float32, cls)
                for cls in sorted(E.F32_TILED_CLASSES, reverse=True)]
    for variant, cdt, (mlp, c, h, o) in classes:
        nbr = bits(0.5, 1, k, N_POINTS, c)
        nbr[:, 1], nbr[:, 3] = nbr[:, 0], nbr[:, 2]
        args = (nbr.to(cdt), torch.zeros(1, N_POINTS, c, device=dev).to(cdt),
                bits(0.03, c, h), bits(0.03, c, h),
                bits(0.03, h, h) if mlp else None,
                bits(0.03, h, o) if mlp else None)
        for agg in E.AGGREGATES:
            counter = "TC_LAUNCHES" if variant == "tc" else "F32_TILED_LAUNCHES"
            n0 = getattr(E, counter)
            out_k = E.edgeconv_fused(*args, agg, cdt)
            out_p = E.edgeconv_plain(*args, agg, cdt)
            torch.cuda.synchronize()
            launched = getattr(E, counter) - n0
            bad = int((out_k != out_p).sum())
            emit({"phase": "kernel", "kernel": "edgeconv", "case": "exact",
                  "variant": variant, "dtype": str(cdt).split(".")[-1],
                  "C": c, "H": h, "O": o, "mlp": mlp, "K": k, "N": N_POINTS,
                  "aggregate": agg, "launches": launched,
                  "max_abs_err": float((out_k.float() - out_p.float()).abs().max()),
                  "mismatches": bad, "output_max": float(out_p.float().max())})
            if bad or launched != 1:
                raise AssertionError(f"edgeconv exact {variant} ({c}, {h}, {o}) "
                                     f"{agg}: {bad} outputs differ from the "
                                     f"plain version's, {launched} launches")


# (path, B, Nq, M, masked candidate tail, sentinel query tail, launches per
# Chamfer gate, per train step, per eval sample)
NN1_SHAPES = [
    # the serving gate: both directions between two 81,920-point outputs
    ("serving", 1, N_POINTS * 8, N_POINTS * 8, 4096, 0, 2, 0, 0),
    # the train step: its Chamfer (both directions between the centre
    # frame's ground truth and prediction; the step passes no masks) and
    # the masking target (inputs to their nearest ground-truth point)
    ("train", 4, 9216, 9216, 0, 0, 0, 2, 0),
    ("train", 4, 1152, 9216, 0, 0, 0, 1, 0),
    # eval: position_metrics' Chamfer between the kept prediction, padded
    # to a 1,024 bucket with 999-sentinel rows and a mask, and the 9,216
    # ground-truth points (both directions); cycle_consistency's between
    # two 9,216-point predictions (both directions, no masks)
    ("eval", 1, 9216, 9216, 0, 1024, 0, 0, 1),
    ("eval", 1, 9216, 9216, 1024, 0, 0, 0, 1),
    ("eval", 1, 9216, 9216, 0, 0, 0, 0, 2),
]


def _nn1_row(torch, dev, rng, path, b, nq, m, masked=0, q_tail=0,
             clouds=None):
    """nn1 against its plain version: distances and the tie rule as in
    :func:`check_knn` over the live queries; no index may point into a
    masked tail; sentinel queries (the 999 rows of a padded prediction) to
    1e-5 of their distance. With its launch plan, the device time of the
    wrapper's launches and whether two launches agree bit for bit. The
    clouds are drawn from ``rng`` unless given (``clouds``: query and
    candidate arrays of the row's shapes)."""
    from tpugan_tpu_torch.ops.kernels import nn1 as N1

    if clouds is None:
        q_np = (rng.standard_normal((b, nq, 3)) * 0.3).astype(np.float32)
        c_np = (rng.standard_normal((b, m, 3)) * 0.3).astype(np.float32)
    else:
        q_np, c_np = (np.array(a, np.float32) for a in clouds)
    live = nq - q_tail
    q_np[:, live:] = 999.0
    q, c = torch.from_numpy(q_np).to(dev), torch.from_numpy(c_np).to(dev)
    bias = torch.zeros((b, m), device=dev)
    if masked:
        bias[:, -masked:] = 1e10
    d2k, ik = N1.nn1_kernel(q, c, bias)
    d2p, ip = N1.nn1_plain(q, c, bias)
    again = N1.nn1_kernel(q, c, bias)
    torch.cuda.synchronize()
    repeat = bool(torch.equal(d2k, again[0]) and torch.equal(ik, again[1]))
    tol = 1e-5 * 2 * float(max((q[:, :live] ** 2).sum(-1).max(),
                               (c * c).sum(-1).max()))
    err = float((d2k - d2p)[:, :live].abs().max())
    bad, gap = index_gaps(q_np[:, :live], c_np, ik[:, :live], ip[:, :live])
    tail_rel = (float(((d2k - d2p)[:, live:].abs() / d2p[:, live:]).max())
                if q_tail else 0.0)
    if not (err <= tol and gap <= 2 * tol and tail_rel <= 1e-5
            and int(ik.max()) < m - masked and repeat):
        raise AssertionError(f"nn1 {path} B={b} Nq={nq} M={m}: err {err} "
                             f"tol {tol}, index gaps up to {gap}, "
                             f"sentinel rows {tail_rel}, repeat {repeat}")
    run = lambda: N1.nn1_kernel(q, c, bias)
    ms = time_ms(run, torch)
    dev_ms = device_ms(run, torch)
    plain_ms = time_ms(lambda: N1.nn1_plain(q, c, bias), torch)

    def yardstick():
        for s in range(0, nq, 8192):
            torch.cdist(q[:, s:s + 8192], c).min(-1)

    lib_ms = time_ms(yardstick, torch)
    # the least work of a pair: three FMAs and a min (7 flops)
    b_ms, b_by = bound(7.0 * b * nq * m,
                       4 * b * (3 * nq + 3 * m + m) + 12 * b * nq, "f32")
    plan = N1.nn1_plan(b, nq, m, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    return dict(path=path, B=b, Nq=nq, M=m, masked=masked,
                sentinel_queries=q_tail, threads=plan.threads, qpt=N1.QPT,
                splits=plan.splits, span=plan.span, blocks=plan.blocks(b, nq),
                max_abs_err=err, tol=tol, index_mismatch=bad, max_tie_gap=gap,
                repeat_bit_equal=repeat, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


def check_nn1(torch, dev, rng):
    """Every NN1_SHAPES row by :func:`_nn1_row`, weighted per gate, train
    step and eval sample."""
    rows = []
    for (path, b, nq, m, masked, q_tail, per_gate, per_step,
         per_sample) in NN1_SHAPES:
        rows.append(dict(_nn1_row(torch, dev, rng, path, b, nq, m, masked,
                                  q_tail),
                         per_gate=per_gate, per_step=per_step,
                         per_sample=per_sample))
        emit({"phase": "kernel", "kernel": "nn1", **rows[-1]})
    return rows


# ---------------------------------------------------------- phases 3 and 4

def counts(kernels) -> dict:
    return {name: k.launches for name, k in kernels.items()}


def delta(before, after) -> dict:
    return {n: after[n] - before[n] for n in after}


def expect(got: dict, want: dict, what: str) -> None:
    """``got`` must hold ``want``'s counts and 0 for every other kernel."""
    full = {n: want.get(n, 0) for n in got}
    if got != full:
        raise AssertionError(f"{what}: launches {got}, expected {full}")


def serving(torch, dev, kernels):
    from tpugan_tpu_torch.checkpoint import load_srnet
    from tpugan_tpu_torch.ops.kernels import edgeconv as E
    from tpugan_tpu_torch.ops.metrics import chamfer

    f32 = load_srnet(CHECKPOINT, device=dev)
    bf16 = load_srnet(CHECKPOINT, device=dev, compute_dtype=torch.bfloat16,
                      graph_mode="static")
    r = f32.upsample_ratio
    rng = np.random.default_rng(0)
    pos_np = rng.standard_normal((1, N_POINTS, 3)).astype(np.float32) * 0.3
    pos = torch.from_numpy(pos_np).to(dev)
    feat = torch.cat([pos, torch.zeros_like(pos)], -1)    # zero velocity

    c0, tc0, ft0 = counts(kernels), E.TC_LAUNCHES, E.F32_TILED_LAUNCHES
    with torch.no_grad():
        exp_f32, mask_f32, _, valid_f32 = f32(feat, pos)
    torch.cuda.synchronize()
    c1, tc1, ft1 = counts(kernels), E.TC_LAUNCHES, E.F32_TILED_LAUNCHES
    expect(delta(c0, c1), {"knn": 7, "edgeconv": 9, "nn1": 0},
           "f32 dynamic forward")
    with torch.no_grad():
        exp_bf16, _, _, valid_bf16 = bf16(feat, pos)
    torch.cuda.synchronize()
    c2, tc2, ft2 = counts(kernels), E.TC_LAUNCHES, E.F32_TILED_LAUNCHES
    expect(delta(c1, c2), {"knn": 1, "edgeconv": 9, "nn1": 0},
           "bf16 static forward")
    # of the EdgeConv launches, those of the tensor-core kernel: every one
    # of the bf16 static forward's, none on the general kernel
    if (tc1 - tc0, tc2 - tc1) != (0, TC_PER_BF16_FORWARD):
        raise AssertionError(f"tensor-core EdgeConv launches: f32 dynamic "
                             f"{tc1 - tc0}, bf16 static {tc2 - tc1}; expected "
                             f"0 and {TC_PER_BF16_FORWARD}")
    # and those of the f32 register-tiled kernel
    if (ft1 - ft0, ft2 - ft1) != (F32T_PER_F32_FORWARD, 0):
        raise AssertionError(f"f32t EdgeConv launches: f32 dynamic "
                             f"{ft1 - ft0}, bf16 static {ft2 - ft1}; expected "
                             f"{F32T_PER_F32_FORWARD} and 0")
    general = (c1["edgeconv"] - c0["edgeconv"] - (tc1 - tc0) - (ft1 - ft0),
               c2["edgeconv"] - c1["edgeconv"] - (tc2 - tc1) - (ft2 - ft1))
    if general != (0, 0):
        raise AssertionError(f"general EdgeConv launches (f32 dynamic, bf16 "
                             f"static): {general}, expected (0, 0)")
    scale = float((pos ** 2).sum(-1).mean())
    with torch.no_grad():
        cd = float(chamfer(exp_f32, exp_bf16).mean())
    cd_norm = cd / (exp_f32.shape[1] * scale)
    torch.cuda.synchronize()
    expect(delta(c2, counts(kernels)), {"knn": 0, "edgeconv": 0, "nn1": 2},
           "Chamfer gate")
    for name, out, valid in (("f32", exp_f32, valid_f32),
                             ("bf16", exp_bf16, valid_bf16)):
        n_valid = int(valid.sum())
        if (tuple(out.shape) != (1, N_POINTS * r, 3)
                or not bool(torch.isfinite(out).all())
                or not N_POINTS <= n_valid <= N_POINTS * r):
            raise AssertionError(f"{name} forward: shape {tuple(out.shape)}, "
                                 f"valid {n_valid}")
    if not cd_norm < GATE:
        raise AssertionError(f"Chamfer gate failed: {cd_norm} >= {GATE}")

    emit({"phase": "serving", "checkpoint": os.path.relpath(CHECKPOINT, ROOT),
          "points": N_POINTS, "ratio": r,
          "f32_dynamic_valid": int(valid_f32.sum()),
          "bf16_static_valid": int(valid_bf16.sum()),
          "chamfer_norm": cd_norm, "gate": GATE,
          "launches": {"f32_dynamic": delta(c0, c1), "bf16_static": delta(c1, c2),
                       "gate": {"nn1": 2}},
          "tc_launches": {"f32_dynamic": tc1 - tc0, "bf16_static": tc2 - tc1},
          "f32t_launches": {"f32_dynamic": ft1 - ft0,
                            "bf16_static": ft2 - ft1}})
    return (f32, bf16), (feat, pos, pos_np)


class GraphReplay:
    """Runs one forward (or step) recording every kNN graph it builds, then
    another (the CPU's, or the card's other path) with those graphs
    replayed in order. Each replayed list is first held against the second
    run's own kNN of its own features: they may differ only between
    candidates whose exact distances tie within f32 noise (the two runs
    round |q|^2 + |c|^2 - 2 q.c, or their features, differently, and under
    the IDGCN's ::2 dilation one such swap changes a point's features and
    then its neighbours'). With equal graphs the outputs must agree to f32
    noise. ``flow``: the flow embeddings' kNN from one frame's points to
    the next frame's, in place of the generator's graphs."""

    def __init__(self, torch, flow=False):
        import tpugan_tpu_torch.models.generator as generator
        import tpugan_tpu_torch.nn.edgeconv as edgeconv
        import tpugan_tpu_torch.nn.flow as flow_mod

        self.torch = torch
        if flow:     # knn(query, cand, k)
            self.modules, self.name = (flow_mod,), "knn"
            self.pair = lambda args: (args[0], args[1])
        else:        # graph_knn(x, k, c_valid): a graph over x itself
            self.modules, self.name = (generator, edgeconv), "graph_knn"
            self.pair = lambda args: (args[0], args[0])
        self.own = getattr(self.modules[0], self.name)
        self.lists, self.swaps = [], 0

    def _run(self, knn_fn, call, *args):
        for m in self.modules:
            setattr(m, self.name, knn_fn)
        try:
            return call(*args)
        finally:
            for m in self.modules:
                setattr(m, self.name, self.own)

    def saved(self):
        """The recorded lists, to replay once more (:meth:`restore`)."""
        return list(self.lists)

    def restore(self, saved):
        self.lists = list(saved)

    def record(self, call, *args):
        """``call(*args)`` (a forward or a train step), recording."""
        def recording(*a, **kw):
            d2, idx = self.own(*a, **kw)
            self.lists.append(idx.cpu())
            return d2, idx
        return self._run(recording, call, *args)

    def replay(self, call, *args):
        def replaying(*a, **kw):
            d2, own = self.own(*a, **kw)
            rec = self.lists.pop(0).to(own.device)
            qf, cf = (x.detach().double() for x in self.pair(a))
            b, r, s = (rec != own).nonzero(as_tuple=True)
            exact = lambda idx: ((qf[b, r] - cf[b, idx[b, r, s]]) ** 2).sum(-1)
            tol = 1e-5 * 2 * float(max((qf * qf).sum(-1).max(),
                                       (cf * cf).sum(-1).max()))
            gap = (exact(rec) - exact(own)).abs()
            if gap.numel() and float(gap.max()) > tol:
                raise AssertionError(f"kNN differs beyond f32 noise: {gap.max()}")
            self.swaps += int(gap.numel())
            return d2, rec
        return self._run(replaying, call, *args)


def cpu_reference(torch, dev, pos_np, points=2048):
    """The card's forward (kernels) against the CPU's (plain versions) on
    the first ``points`` points of the frame, f32, both graph modes, with
    the card's graphs replayed on the CPU (see GraphReplay). Keep masks may
    differ only where the raw mask lies within 1e-4 of epsilon."""
    from tpugan_tpu_torch.checkpoint import load_srnet

    small = torch.from_numpy(pos_np[:, :points])
    small_feat = torch.cat([small, torch.zeros_like(small)], -1)
    out = {"cpu_check_points": points}
    for mode in ("dynamic", "static"):
        gpu = load_srnet(CHECKPOINT, device=dev, graph_mode=mode)
        cpu = load_srnet(CHECKPOINT, device="cpu", graph_mode=mode)
        replay = GraphReplay(torch)
        e_gpu, m_gpu, _, v_gpu = replay.record(gpu, small_feat.to(dev),
                                               small.to(dev))
        e_cpu, m_cpu, _, v_cpu = replay.replay(cpu, small_feat, small)
        e_gpu, m_gpu, v_gpu = e_gpu.cpu(), m_gpu.cpu(), v_gpu.cpu()
        flipped = v_gpu != v_cpu
        near = ((m_cpu - gpu.epsilon).abs() < 1e-4).repeat_interleave(
            gpu.upsample_ratio, 1)
        out[f"{mode}_mask_err"] = float((m_gpu - m_cpu).abs().max())
        out[f"{mode}_position_err"] = float((e_gpu - e_cpu).abs().max())
        out[f"{mode}_knn_tie_swaps"] = replay.swaps
        out[f"{mode}_keep_flips"] = int(flipped.sum())
        if not (bool(near[flipped].all()) and out[f"{mode}_mask_err"] < 1e-4
                and out[f"{mode}_position_err"] < 1e-4):
            raise AssertionError(f"{mode} card vs CPU: {out}")
    return out


def profile(torch, name, model, feat, pos, out_dir):
    """torch.profiler table of one forward (device time by kernel, and the
    device's busy share of the forward's wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        model(feat, pos)
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            model(feat, pos)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # device rows only: a host op's self device time is the time of the
    # kernels it launched, which have rows of their own
    table = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                    for e in p.key_averages()
                    if e.device_type == DeviceType.CUDA),
                   key=lambda x: -x[1])
    kernels_ms = sum(t for _, t, _ in table)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as fh:
        fh.write(p.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=60))
    emit({"phase": "profile", "forward": name, "wall_ms": wall_ms,
          "device_kernel_ms": kernels_ms,
          "device_idle_share": 1.0 - kernels_ms / wall_ms,
          "top": [(n[:60], round(t, 4), c) for n, t, c in table[:12]]})


def rollout_frames(torch, model):
    """25 frames chained as the JAX bench chains them (frame t+1 is the
    first 10,000 expanded points of frame t's forward, times 0.999), with
    zero velocity; frame t keeps 10,000 - 8 * (t % 4) of them, so the
    frames are ragged within one bucket."""
    dev = next(model.parameters()).device
    rng = np.random.default_rng(1)
    pos = torch.from_numpy(rng.standard_normal((1, ROLLOUT_POINTS, 3))
                           .astype(np.float32) * 0.3).to(dev)
    frames = []
    for t in range(ROLLOUT_FRAMES):
        n = ROLLOUT_POINTS - 8 * (t % 4)
        frames.append((pos[0, :n].cpu().numpy(), None))
        with torch.no_grad():
            expanded = model(torch.cat([pos, torch.zeros_like(pos)], -1),
                             pos)[0]
        pos = expanded[:, :ROLLOUT_POINTS] * 0.999
    return frames


def rollout(torch, model, kernels, approx=False):
    """``rollout_sequence`` over ``rollout_frames``, with the approximate
    graph kNN on when ``approx`` (one approximate launch a frame)."""
    from tpugan_tpu_torch.eval.rollout import rollout_sequence
    from tpugan_tpu_torch.ops import neighbors
    from tpugan_tpu_torch.ops.kernels import edgeconv as E

    frames = rollout_frames(torch, model)
    c0, tc0, ft0 = counts(kernels), E.TC_LAUNCHES, E.F32_TILED_LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    neighbors.set_approx_graph_knn(approx)
    try:
        outs = rollout_sequence(model, frames, use_vel=True)   # no autograd
    finally:
        neighbors.set_approx_graph_knn(False)
    wall = time.perf_counter() - t0
    got = delta(c0, counts(kernels))
    want = {"knn_approx" if approx else "knn": ROLLOUT_FRAMES,
            "edgeconv": 9 * ROLLOUT_FRAMES}
    expect(got, want, "rollout" + (" (approximate graphs)" if approx else ""))
    tc, ft = E.TC_LAUNCHES - tc0, E.F32_TILED_LAUNCHES - ft0
    if (tc, ft) != (TC_PER_BF16_FORWARD * ROLLOUT_FRAMES, 0):
        raise AssertionError(f"rollout: {tc} tensor-core and {ft} f32t EdgeConv "
                             f"launches, expected "
                             f"{TC_PER_BF16_FORWARD * ROLLOUT_FRAMES} and 0 "
                             f"(none on the general kernel)")
    if len(outs) != ROLLOUT_FRAMES:
        raise AssertionError(f"rollout returned {len(outs)} frames")
    sizes = []
    for (p, _), o in zip(frames, outs):
        n = p.shape[0]
        if not (np.isfinite(o).all() and n <= o.shape[0] <= n * model.upsample_ratio
                and np.abs(o).max() < 100):
            raise AssertionError(f"rollout frame of {n}: {o.shape[0]} points")
        sizes.append(int(o.shape[0]))
    emit({"phase": "rollout", "approx_graph": approx, "frames": ROLLOUT_FRAMES,
          "points": [int(f[0].shape[0]) for f in frames[:4]],
          "output_points_first_last": [sizes[0], sizes[-1]],
          "launches": got, "tc_launches": tc, "f32t_launches": ft,
          "wall_ms_per_frame": wall * 1e3 / ROLLOUT_FRAMES})


def serving_approx(torch, models, feat, pos, kernels):
    """With the counts reset by the caller: the exact f32 dynamic forward,
    then the f32 dynamic and the bf16 static forward with the approximate
    graph kNN on, each against the exact one (normalised Chamfer under
    GATE, keep-mask agreement). Returns the phase's line (ms per frame are
    added past the counted run, by ``approx_ms``)."""
    from tpugan_tpu_torch.ops import neighbors
    from tpugan_tpu_torch.ops.metrics import chamfer

    f32, bf16 = models
    c0 = counts(kernels)
    with torch.no_grad():
        exp_e, _, _, valid_e = f32(feat, pos)
    torch.cuda.synchronize()
    expect(delta(c0, counts(kernels)), {"knn": 7, "edgeconv": 9},
           "exact f32 dynamic forward")
    scale = float((pos ** 2).sum(-1).mean())
    out = {"phase": "serving_approx", "points": N_POINTS, "gate": GATE}
    for name, model, want in (
            ("f32_dynamic", f32, {"knn_approx": 7, "edgeconv": 9}),
            ("bf16_static", bf16, {"knn_approx": 1, "edgeconv": 9})):
        c0 = counts(kernels)
        neighbors.set_approx_graph_knn(True)
        try:
            with torch.no_grad():
                exp_a, _, _, valid_a = model(feat, pos)
        finally:
            neighbors.set_approx_graph_knn(False)
        torch.cuda.synchronize()
        got = delta(c0, counts(kernels))
        expect(got, want, f"approximate {name} forward")
        with torch.no_grad():
            cd = float(chamfer(exp_e, exp_a).mean()) / (exp_e.shape[1] * scale)
        out[name] = {"launches": got, "chamfer_norm_vs_exact": cd,
                     "keep_mask_agreement_vs_exact":
                         float((valid_a == valid_e).float().mean()),
                     "valid": int(valid_a.sum())}
        if not (cd < GATE and bool(torch.isfinite(exp_a).all())):
            raise AssertionError(f"approximate {name}: {out[name]}")
    return out


def approx_ms(torch, model, feat, pos) -> float:
    """ms per frame of a forward with the approximate graph kNN on."""
    from tpugan_tpu_torch.ops import neighbors

    neighbors.set_approx_graph_knn(True)
    try:
        with torch.no_grad():
            return time_ms(lambda: model(feat, pos), torch)
    finally:
        neighbors.set_approx_graph_knn(False)


# ------------------------------------------------- train-step kernel checks

FPS_SHAPES = [   # (stage, rows, N, m, masked, launches per G+D step)
    ("device sampling", 4, 9216, 1152, False, 1),
    ("spatial sa_0", 4, 9216, 1024, True, 3),
    ("spatial sa_1", 4, 1024, 512, False, 3),
    ("spatial sa_2", 4, 512, 128, False, 3),
    ("tempo sa1 (3 frames stacked)", 12, 9216, 1024, True, 3),
    ("tempo sa2 (3 frames stacked)", 12, 1024, 256, False, 3),
]

BALL_SHAPES = [  # (stage, B, Nq, Nc, radius, nsample, launches per G+D step)
    ("spatial sa_0", 4, 1024, 9216, 0.15, 32, 3),
    ("spatial sa_1", 4, 512, 1024, 0.30, 32, 3),
    ("spatial sa_2", 4, 128, 512, 0.60, 16, 3),
    ("tempo sa1 (per frame)", 4, 1024, 9216, 0.10, 32, 9),
    ("tempo sa2 (per frame)", 4, 256, 1024, 0.20, 32, 9),
]

POOLED_SHAPES = [  # (stage, (B, M, ns, C0), widths, slope, per G+D step,
    #                  gammas: "positive" around 1, "mixed" of both signs and 0)
    ("spatial sa_0", (4, 1024, 32, 6), (64, 128), 0.01, 3, "positive"),
    ("spatial sa_1", (4, 512, 32, 131), (128, 128), 0.01, 3, "positive"),
    ("spatial sa_2", (4, 128, 16, 131), (128, 256), 0.01, 3, "positive"),
    ("spatial sa_pooling", (4, 1, 128, 259), (256, 256), 0.0, 3, "positive"),
    # a trained critic may hold gammas <= 0: the max then comes from the
    # min of z (the kernels pool from each neighbourhood's extremes)
    ("spatial sa_1 mixed-sign gamma", (4, 512, 32, 131), (128, 128), 0.01, 0,
     "mixed"),
]


def _cloud(torch, dev, rng, *shape, scale=0.3):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(dev)


# Rows on which the selections tie or run out of valid points, at the
# variants' widths (none runs in the train step): (stage, rows, N, m,
# points: "lattice" at multiples of 0.25, exact distances and ties; or the
# count of valid points, the rest at -1e10 and far away)
FPS_EDGE_SHAPES = [
    ("ties: lattice, cluster", 4, 9216, 1024, "lattice"),
    ("ties: lattice, one block", 12, 1024, 256, "lattice"),
    ("ties: lattice, one warp", 4, 512, 128, "lattice"),
    ("exhausted: 700 valid, cluster", 4, 9216, 1024, 700),
    ("exhausted: 100 valid, one block", 4, 1024, 256, 100),
    ("exhausted: 60 valid, one warp", 4, 512, 128, 60),
]
# The round's fixed cost: rows of one point a thread, FPS_FLOOR_ROUNDS
# rounds, on one warp and on clusters of each size of 128-thread blocks.
FPS_FLOOR_ROUNDS = 1024
FPS_FLOOR_CLUSTERS = (1, 2, 4, 8, 16)


def _fps_case(torch, dev, rng, b, n, masked):
    """(pos, penalty, start) of an FPS stage: a cloud, with a hard-masked
    tail as the critics see (``masked`` True), the lattice (``masked``
    "lattice") or all but ``masked`` points invalid (an int)."""
    pos = _cloud(torch, dev, rng, b, n, 3)
    pen = torch.zeros((b, n), device=dev)
    n_valid = n - n // 8 if masked is True else n
    if masked == "lattice":
        pos = torch.from_numpy(rng.integers(-16, 17, (b, n, 3))
                               .astype(np.float32) * 0.25).to(dev)
    elif masked is True:
        pen[:, n_valid:] = -1e10
        pos[:, n_valid:] = 999.0
    elif masked:
        n_valid = masked
        pen[:, n_valid:] = -1e10
        pos[:, n_valid:] *= 1000.0
    start = torch.from_numpy(rng.integers(0, n_valid, b)).to(dev)
    return pos, pen, start


def _fps_row(torch, F, stage, b, n, m, pos, pen, start, plan=None, plain=True):
    """The kernel against the plain version (index for index), its times
    and its bound; ``plan`` a launch other than the wrapper's own."""
    ik = F.fps_kernel(pos, m, pen, start, plan)
    ip = F.fps_plain(pos, m, pen, start)
    torch.cuda.synchronize()
    bad = int((ik != ip).sum())
    if bad:
        raise AssertionError(f"fps {stage}: {bad} indices differ")
    run = lambda: F.fps_kernel(pos, m, pen, start, plan)
    ms = time_ms(run, torch)
    dev_ms = device_ms(run, torch)
    plain_ms = (time_ms(lambda: F.fps_plain(pos, m, pen, start), torch,
                        reps=3, warmup=1) if plain else None)
    b_ms, b_by = bound(8.0 * b * m * n, 4 * b * n * 4 + 8 * b * (m + 1), "f32")
    plan = plan or F.fps_plan(n)
    return dict(stage=stage, rows=b, N=n, m=m, variant=plan.variant,
                cluster=plan.cluster, threads=plan.threads, ppt=plan.ppt,
                max_abs_err=0.0, index_mismatch=bad, ms=ms, device_ms=dev_ms,
                us_per_round=dev_ms * 1e3 / max(m - 1, 1), plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def check_fps(torch, dev, rng):
    """The train step's FPS stages (each weighted by its launches per G+D
    step), then the tie and exhaustion rows (weight 0), each the kernel
    against the plain version; then the round's fixed cost (``fps_floor``
    rows, not in the returned list)."""
    from tpugan_tpu_torch.ops.kernels import fps as F

    rows = []
    for stage, b, n, m, masked, per in FPS_SHAPES:
        pos, pen, start = _fps_case(torch, dev, rng, b, n, masked)
        rows.append(dict(_fps_row(torch, F, stage, b, n, m, pos, pen, start),
                         per_step=per))
        emit({"phase": "kernel", "kernel": "fps", **rows[-1]})
    for stage, b, n, m, points in FPS_EDGE_SHAPES:
        pos, pen, start = _fps_case(torch, dev, rng, b, n, points)
        rows.append(dict(_fps_row(torch, F, stage, b, n, m, pos, pen, start),
                         per_step=0))
        emit({"phase": "kernel", "kernel": "fps", **rows[-1]})
    plans = [("warp", F.FpsPlan("warp", 1, 32, 1))] + [
        (f"cluster {c}", F.FpsPlan("cluster", c, 128, 1))
        for c in FPS_FLOOR_CLUSTERS]
    for name, plan in plans:
        n = plan.cluster * plan.slice
        pos, pen, start = _fps_case(torch, dev, rng, 4, n, False)
        row = _fps_row(torch, F, f"floor: {name}", 4, n, FPS_FLOOR_ROUNDS,
                       pos, pen, start, plan, plain=False)
        emit({"phase": "kernel", "kernel": "fps_floor", **row})
    return rows


def _ball_row(torch, dev, rng, stage, b, nq, nc, r, ns, scale=0.3,
              masked=True):
    """The ball query index for index against the plain version on queries
    drawn from a cloud of ``scale`` (every ninth candidate masked with
    ``masked``), with its launch plan, two launches bit for bit, its device
    time (torch.profiler) and its bound over the pairs this data scans."""
    from tpugan_tpu_torch.ops.kernels import ball_query as BQ

    cand = _cloud(torch, dev, rng, b, nc, 3, scale=scale)
    query = cand[:, torch.randperm(nc, device=dev)[:nq]]
    bias = torch.zeros((b, nc), device=dev)
    if masked:
        bias[:, ::9] = 2.0
    ik = BQ.ball_query_kernel(query, cand, r, ns, bias)
    ip = BQ.ball_query_plain(query, cand, r, ns, bias)
    again = BQ.ball_query_kernel(query, cand, r, ns, bias)
    torch.cuda.synchronize()
    # both evaluate the same f32 expression in the same order: equal
    bad = int((ik != ip).sum())
    repeat = bool(torch.equal(ik, again))
    if bad or not repeat:
        raise AssertionError(f"ball_query {stage}: {bad} indices differ, "
                             f"repeat {repeat}")
    run = lambda: BQ.ball_query_kernel(query, cand, r, ns, bias)
    ms = time_ms(run, torch)
    dev_ms = device_ms(run, torch)
    plain_ms = time_ms(lambda: BQ.ball_query_plain(query, cand, r, ns, bias),
                       torch)
    # the scan ends at the nsample-th hit: count the candidates this data
    # needs (a full ball's indices rise strictly to the last slot)
    full = ik[..., -1] > ik[..., -2]
    scanned = float(torch.where(full, ik[..., -1] + 1, nc).sum())
    b_ms, b_by = bound(8.0 * scanned,
                       4 * (b * nq * 3 + b * nc * 4) + 8 * b * nq * ns, "f32")
    return dict(stage=stage, B=b, Nq=nq, Nc=nc, radius=r, nsample=ns,
                full_balls=float(full.float().mean()), warps=BQ.WARPS,
                tile=BQ.TILE, blocks=BQ.blocks(b, nq), max_abs_err=0.0,
                index_mismatch=bad, repeat_bit_equal=repeat, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by)


def check_ball_query(torch, dev, rng):
    """Each train stage's ball query, by ``_ball_row``."""
    rows = []
    for stage, b, nq, nc, r, ns, per in BALL_SHAPES:
        rows.append(dict(_ball_row(torch, dev, rng, stage, b, nq, nc, r, ns),
                         per_step=per))
        emit({"phase": "kernel", "kernel": "ball_query", **rows[-1]})
    return rows


def pooled_bounds(shape, widths):
    """((ms, by) of the forward, (ms, by) of the backward) of a pooled MLP
    over a table [B, M, ns, C0]: 2 flops a MAC over every row forward; the
    backward recomputes the activations (2) and forms dX and dW (4). Bytes:
    the table, the weights and per-layer vectors, the pooled output (twice
    each backward)."""
    b, m, ns, c0 = shape
    cs = (c0,) + tuple(widths)
    rows_n = b * m * ns
    mac = sum(cs[i] * cs[i + 1] for i in range(len(widths)))
    nw = sum(cs[i] * cs[i + 1] for i in range(len(widths))) + 2 * sum(widths)
    once = rows_n * c0 + nw + b * m * widths[-1]
    return (bound(2.0 * rows_n * mac, 4 * once, "f32"),
            bound(6.0 * rows_n * mac, 8 * once, "f32"))


def _pooled_row(torch, dev, rng, stage, shape, widths, slope, per, gammas,
                reduce=None, world=1, tries=3):
    """(forward row, backward row) of the pooled-MLP batch-norm kernel at
    one table shape against its plain versions (check_pooled_mlp's limits),
    each with ``per_step`` = ``per``. With ``reduce`` (a sum over ``world``
    ranks, made in every rank in the same order) both sides sum their
    moments over the ranks through it."""
    from tpugan_tpu_torch.ops.kernels import pooled_mlp as P

    b, m, _, c0 = shape
    kw = dict(reduce=reduce, world=world)
    tab = _cloud(torch, dev, rng, *shape, scale=1.0)
    tab[:, :, 1] = tab[:, :, 0]
    tab[:, :, -1] = tab[:, :, 0]
    cs = (c0,) + tuple(widths)
    ws = [_cloud(torch, dev, rng, cs[i], cs[i + 1], scale=cs[i] ** -0.5)
          for i in range(len(widths))]
    gs = [1.0 + _cloud(torch, dev, rng, h, scale=0.1) for h in widths]
    if gammas == "mixed":
        for gamma in gs:
            gamma[::3] *= -1
            gamma[1::5] = 0.0
    bs = [_cloud(torch, dev, rng, h, scale=0.1) for h in widths]
    g = _cloud(torch, dev, rng, b, m, widths[-1], scale=1.0)
    leaves = [x.clone().requires_grad_() for x in [tab, *ws, *gs, *bs]]
    nl = len(widths)
    pooled, mus, vars_ = P.pooled_mlp_bn_train(
        leaves[0], leaves[1:1 + nl], leaves[1 + nl:1 + 2 * nl],
        leaves[1 + 2 * nl:], slope, **kw)
    grads = torch.autograd.grad(pooled, leaves, g, retain_graph=True)
    with torch.no_grad():
        fp = P.pooled_mlp_bn_forward_plain(tab, ws, gs, bs, slope, **kw)
        gp = P.pooled_mlp_bn_backward_plain(tab, ws, fp[4], fp[5], fp[1],
                                            fp[3], fp[0], g, slope, **kw)
    torch.cuda.synchronize()
    f_err = 0.0
    for got, want in zip([pooled, *mus, *vars_], [fp[0], *fp[1], *fp[2]]):
        e = float((got.detach() - want).abs().max())
        f_err = max(f_err, e)
        if e > 1e-5 * max(1.0, float(want.abs().max())):
            raise AssertionError(f"pooled_mlp {stage} forward: err {e}")
    b_err, b_rel = 0.0, 0.0
    names = ["dtable"] + [f"{n}{i}" for n in ("dW", "dgamma", "dbeta")
                          for i in range(nl)]
    for name, got, want in zip(names, grads, [gp[0], *gp[1], *gp[2], *gp[3]]):
        diff = (got - want).abs()
        b_err = max(b_err, float(diff.max()))
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        b_rel = max(b_rel, rel)
        off = float((diff > 1e-3 * want.abs().max()).float().mean())
        if rel > 1e-2 or (name == "dtable" and off > 1e-3):
            raise AssertionError(f"pooled_mlp {stage} backward {name}: "
                                 f"norm rel {rel}, share off {off}")
        if name == "dtable":
            dtable_off = off
    with torch.no_grad():
        fwd = lambda: P.pooled_mlp_bn_train(tab, ws, gs, bs, slope, **kw)
        ms = time_ms(fwd, torch)
        dev_ms, fwd_kernels = device_ms(fwd, torch, by_kernel=True,
                                        tries=tries)
        plain_ms = time_ms(lambda: P.pooled_mlp_bn_forward_plain(
            tab, ws, gs, bs, slope, **kw), torch)
        bwd_plain_ms = time_ms(lambda: P.pooled_mlp_bn_backward_plain(
            tab, ws, fp[4], fp[5], fp[1], fp[3], fp[0], g, slope, **kw),
            torch)
    bwd = lambda: torch.autograd.grad(pooled, leaves, g, retain_graph=True)
    bwd_ms = time_ms(bwd, torch)
    bwd_dev_ms, bwd_kernels = device_ms(bwd, torch, by_kernel=True,
                                        tries=tries)
    f_bound, b_bound = pooled_bounds(shape, widths)
    common = dict(stage=stage, table=list(shape), widths=list(widths),
                  slope=slope, gammas=gammas, per_step=per)
    return (dict(**common, max_abs_err=f_err, ms=ms, device_ms=dev_ms,
                 device_ms_by_kernel=fwd_kernels, plain_ms=plain_ms,
                 library_ms=None, bound_ms=f_bound[0], bound_by=f_bound[1]),
            dict(**common, max_abs_err=b_err, max_norm_rel_err=b_rel,
                 dtable_share_off=dtable_off, ms=bwd_ms, device_ms=bwd_dev_ms,
                 device_ms_by_kernel=bwd_kernels, plain_ms=bwd_plain_ms,
                 library_ms=None, bound_ms=b_bound[0], bound_by=b_bound[1]))


def check_pooled_mlp(torch, dev, rng):
    """Forward (pooled, moments) and backward (dtable, dW, dgamma, dbeta)
    against the plain versions, on tables with exact max ties (the ball
    query's repeated first hit), at each stage and once with gammas of both
    signs and zero. Forward to 1e-5 of each tensor's scale
    (f32 sums in another order). Backward: each gradient to 1e-2 of its
    norm, and at most 1e-3 of dtable's elements off by more than 1e-3 of
    its scale. The two sides sum the layers in another order, so where two
    rows' values lie within f32 rounding of each other the max-pool can
    send a cotangent to another row, and a leaky-ReLU pre-activation
    within f32 noise of 0 can take the other slope: a few rows of dtable
    move by order 1, which a norm over millions of entries hides and an
    elementwise bound does not. Then, at the first stage, the kernel's
    stages with the identity for the cross-rank sum (world 1) against its
    one-call launch, bit for bit (the split the data-parallel step takes
    at more than one rank)."""
    from tpugan_tpu_torch.ops.kernels import pooled_mlp as P

    fwd_rows, bwd_rows = [], []
    for stage, shape, widths, slope, per, gammas in POOLED_SHAPES:
        fwd, bwd = _pooled_row(torch, dev, rng, stage, shape, widths, slope,
                               per, gammas)
        fwd_rows.append(fwd)
        bwd_rows.append(bwd)
        emit({"phase": "kernel", "kernel": "pooled_mlp_fwd", **fwd})
        emit({"phase": "kernel", "kernel": "pooled_mlp_bwd", **bwd})
    stage, shape, widths, slope, _, _ = POOLED_SHAPES[0]
    rng = np.random.default_rng(24)      # the caller's draws stay as they were
    tab = _cloud(torch, dev, rng, *shape, scale=1.0)
    cs = (shape[-1],) + widths
    params = [_cloud(torch, dev, rng, cs[i], cs[i + 1], scale=cs[i] ** -0.5)
              for i in range(len(widths))]
    params += [1.0 + _cloud(torch, dev, rng, h, scale=0.1) for h in widths]
    params += [_cloud(torch, dev, rng, h, scale=0.1) for h in widths]
    g = _cloud(torch, dev, rng, *shape[:2], widths[-1], scale=1.0)

    def run(**kw):
        leaves = [x.clone().requires_grad_() for x in [tab, *params]]
        n = len(widths)
        out = P.pooled_mlp_bn_train(leaves[0], leaves[1:1 + n],
                                    leaves[1 + n:1 + 2 * n],
                                    leaves[1 + 2 * n:], slope, **kw)
        pooled, mus, vars_ = out
        return [pooled, *mus, *vars_, *torch.autograd.grad(pooled, leaves, g)]

    if not all(torch.equal(a, b) for a, b in zip(
            run(), run(reduce=lambda t: t, world=1))):
        raise AssertionError("pooled_mlp: the stages with the identity sum "
                             "differ from the one-call launch")
    emit({"phase": "kernel", "kernel": "pooled_mlp_fwd", "stage": stage,
          "stages_equal_one_call": True})
    return fwd_rows, bwd_rows


# The EdgeConv backward at each shape class of the fused train step: the
# generator's [3B] = 12 frames of 1,152 points. (name, C, H, O, K,
# aggregate, mlp, dtype, exact ties, launches per fused train step)
EDGECONV_BWD_SHAPES = [
    ("extractor EdgeConv_0", 6, 64, 128, 20, "max", True, "f32", False, 1),
    ("IDGCN d=1", 32, 16, 32, 20, "max", True, "f32", False, 2),
    ("IDGCN d=2", 32, 16, 32, 10, "max", True, "f32", False, 2),
    ("upsampler/mask k=12", 64, 128, 256, 12, "max", True, "f32", False, 2),
    ("upsampler k=4", 64, 128, 256, 4, "max", True, "f32", False, 1),
    ("mask k=8 sum", 64, 128, 128, 8, "sum", False, "f32", False, 1),
    ("IDGCN d=1 bf16", 32, 16, 32, 20, "max", True, "bf16", False, 0),
    ("upsampler k=12 exact ties", 64, 128, 256, 12, "max", True, "f32", True, 0),
    ("EdgeConv_0 exact ties", 6, 64, 128, 20, "max", True, "f32", True, 0),
    ("IDGCN d=1 exact ties", 32, 16, 32, 20, "max", True, "f32", True, 0),
    ("mask k=8 max exact ties", 64, 128, 128, 8, "max", False, "f32", True, 0),
]
TRAIN_ROWS, TRAIN_POINTS = 12, 1152
# Each gradient to this share of its norm, and at most SHARE_OFF of gnbr's
# elements off by more than NORM_TOL of its scale. Both sides round the
# same values but sum in another order, so where two planes' outputs lie
# within f32 rounding of each other the max can send a (point, column)'s
# cotangent to the other plane, and a leaky-ReLU pre-activation within f32
# noise of 0 can take the other slope: a few elements of gnbr move by order
# 1. bf16: a rounding flip of one cotangent carries through the layers.
EC_BWD_TOL = {"f32": (1e-3, 1e-3), "bf16": (2e-2, 1e-2)}   # (norm, share off)


def _grad_errors(got, want, tol, share_tol, what):
    """(max abs err, max norm-relative err, share of the first tensor's
    elements off by more than tol of its scale); raises past the limits."""
    err, rel, share = 0.0, 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            continue
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        err = max(err, float(diff.max()))
        r = float((a - b).norm() / b.norm().clamp_min(1e-30))
        rel = max(rel, r)
        if i == 0:
            share = float((diff > tol * b.abs().max()).float().mean())
        if r > tol or share > share_tol:
            raise AssertionError(f"{what} gradient {i}: norm rel {r}, "
                                 f"share off {share}")
    return err, rel, share


def _edgeconv_bwd_row(torch, dev, rng, name, c, h, o, k, agg, mlp, kind,
                      ties, b, n, tiled_expected):
    """The backward kernel against its plain version (the kernel's rounding
    points, max ties recomputed) on [b, k, n] planes; with ``ties``,
    planes 1 and 5 repeat planes 0 and 3, so a max shared by two planes
    must split its cotangent evenly between them. The row names its path
    ("tiled": a class of F32_TILED_BWD_CLASSES, one launch of the
    redesigned kernel a call and a second call equal bit for bit;
    "general": the general kernel, none), which must be
    ``tiled_expected``, and the device time of each of its kernels."""
    from tpugan_tpu_torch.ops.kernels import edgeconv as E

    cdt = torch.float32 if kind == "f32" else torch.bfloat16
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)
    nbr, ctr = t(b, k, n, c), t(b, n, c)
    if ties:
        nbr[:, 1], nbr[:, 5] = nbr[:, 0], nbr[:, 3]
    wn, we = t(c, h) / np.sqrt(c), t(c, h) / np.sqrt(c)
    w1 = t(h, h) / np.sqrt(h) if mlp else None
    w2 = t(h, o) / np.sqrt(h) if mlp else None
    g = t(b, n, o if mlp else h).to(cdt)
    args = (nbr.to(cdt), ctr.to(cdt), wn, we, w1, w2, g, agg, cdt)
    tiled = E.takes_f32_tiled_bwd(cdt, mlp, c, h, o)
    if tiled != tiled_expected:
        raise AssertionError(f"edgeconv_bwd {name}: path "
                             f"{'tiled' if tiled else 'general'}")
    f0, l0 = E.F32_TILED_BWD_LAUNCHES, E.BWD.launches
    got = E.edgeconv_backward(*args)
    if (E.F32_TILED_BWD_LAUNCHES - f0, E.BWD.launches - l0) != (int(tiled), 1):
        raise AssertionError(f"edgeconv_bwd {name}: tiled launches "
                             f"{E.F32_TILED_BWD_LAUNCHES - f0}, launches "
                             f"{E.BWD.launches - l0}")
    want = E.edgeconv_backward_plain(*args)
    torch.cuda.synchronize()
    tol, share_tol = EC_BWD_TOL[kind]
    err, rel, share = _grad_errors(got, want, tol, share_tol,
                                   f"edgeconv_bwd {name}")
    split = None
    if ties:
        # the duplicated planes' gradients are equal, both sides
        split = float(max((got[0][:, 1] - got[0][:, 0]).abs().max(),
                          (got[0][:, 5] - got[0][:, 3]).abs().max()))
        if split != 0.0:
            raise AssertionError(f"edgeconv_bwd ties: planes differ {split}")
    repeat = None
    if tiled:
        repeat = all(torch.equal(x, y) for x, y in
                     zip(got, E.edgeconv_backward(*args)) if x is not None)
        if not repeat:
            raise AssertionError(f"edgeconv_bwd {name}: two calls differ")
    ms = time_ms(lambda: E.edgeconv_backward(*args), torch)
    dev_ms, by_kernel = device_ms(lambda: E.edgeconv_backward(*args),
                                  torch, by_kernel=True)
    plain_ms = time_ms(lambda: E.edgeconv_backward_plain(*args), torch)
    esz = 4 if kind == "f32" else 2
    # the function recomputes the forward and forms two products per
    # layer (the inputs' and the weights' gradients): 3x the forward
    mac = 2 * c * h + ((h * h + h * o) if mlp else 0)
    flops = 3 * 2 * b * k * n * mac
    nbytes = (esz * (2 * b * k * n * c + 2 * b * n * c + b * n * (o if mlp else h))
              + 4 * 2 * mac)
    b_ms, b_by = bound(flops, nbytes, kind)
    return dict(config=name, dtype=kind, B=b, N=n, C=c, H=h, O=o, K=k,
                aggregate=agg, exact_ties=ties,
                path="tiled" if tiled else "general", max_abs_err=err,
                max_norm_rel_err=rel, gnbr_share_off=share,
                tie_split_err=split, tol=tol, repeat_bit_equal=repeat, ms=ms,
                device_ms=dev_ms, device_ms_by_kernel=by_kernel,
                plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)


def check_edgeconv_bwd(torch, dev, rng):
    """The backward at the fused train step's shapes (EDGECONV_BWD_SHAPES,
    by :func:`_edgeconv_bwd_row`): every f32 row on the redesigned kernel,
    the bf16 row on the general one."""
    rows = []
    for name, c, h, o, k, agg, mlp, kind, ties, per in EDGECONV_BWD_SHAPES:
        rows.append(dict(_edgeconv_bwd_row(
            torch, dev, rng, name, c, h, o, k, agg, mlp, kind, ties,
            TRAIN_ROWS, TRAIN_POINTS, kind == "f32"), per_step=per))
        emit({"phase": "kernel", "kernel": "edgeconv_bwd", **rows[-1]})
    return rows


AFFINE_SHAPES = [  # (stage, (B, M, ns, C0), widths, slope)
    ("spatial sa_0", (4, 1024, 32, 6), (64, 128), 0.01),
    ("group_all (sa_pooling)", (4, 1, 128, 259), (256, 256), 0.0),
]


def check_pooled_affine_bwd(torch, dev, rng):
    """The affine form (the eval-mode SetConv, a norm-free SetConv trained
    fused), forward and backward, against its plain versions on tables with
    exact max ties; limits as for the batch-norm form (check_pooled_mlp).
    Returns (forward rows, backward rows)."""
    from tpugan_tpu_torch.ops.kernels import pooled_mlp as P

    fwd_rows, rows = [], []
    for stage, shape, widths, slope in AFFINE_SHAPES:
        b, m, _, c0 = shape
        tab = _cloud(torch, dev, rng, *shape, scale=1.0)
        tab[:, :, 1] = tab[:, :, 0]
        cs = (c0,) + widths
        nl = len(widths)
        ws = [_cloud(torch, dev, rng, cs[i], cs[i + 1], scale=cs[i] ** -0.5)
              for i in range(nl)]
        a_s = [1.0 + _cloud(torch, dev, rng, h, scale=0.1) for h in widths]
        b_s = [_cloud(torch, dev, rng, h, scale=0.1) for h in widths]
        g = _cloud(torch, dev, rng, b, m, widths[-1], scale=1.0)
        leaves = [x.clone().requires_grad_() for x in [tab, *ws, *a_s, *b_s]]
        pooled = P.pooled_mlp_affine(leaves[0], leaves[1:1 + nl],
                                     leaves[1 + nl:1 + 2 * nl],
                                     leaves[1 + 2 * nl:], slope)
        got = torch.autograd.grad(pooled, leaves, g, retain_graph=True)
        pp = P.pooled_mlp_affine_plain(tab, ws, a_s, b_s, slope)
        want = P.pooled_mlp_affine_backward_plain(tab, ws, a_s, b_s, pp, g,
                                                  slope)
        with torch.no_grad():
            fwd = lambda: P.pooled_mlp_affine(tab, ws, a_s, b_s, slope)
            f_nograd = fwd()
        torch.cuda.synchronize()
        f_err = max(float((pooled.detach() - pp).abs().max()),
                    float((f_nograd - pp).abs().max()))
        if f_err > 1e-5 * max(1.0, float(pp.abs().max())):
            raise AssertionError(f"pooled_mlp_affine {stage} forward: {f_err}")
        err, rel, share = _grad_errors(
            got, [want[0], *want[1], *want[2], *want[3]], 1e-2, 1e-3,
            f"pooled_mlp_affine_bwd {stage}")
        with torch.no_grad():
            f_ms = time_ms(fwd, torch)
            f_dev, f_kernels = device_ms(fwd, torch, by_kernel=True)
            f_plain = time_ms(lambda: P.pooled_mlp_affine_plain(
                tab, ws, a_s, b_s, slope), torch)
        bwd = lambda: torch.autograd.grad(pooled, leaves, g, retain_graph=True)
        ms = time_ms(bwd, torch)
        dev_ms, kernels = device_ms(bwd, torch, by_kernel=True)
        with torch.no_grad():
            plain_ms = time_ms(lambda: P.pooled_mlp_affine_backward_plain(
                tab, ws, a_s, b_s, pp, g, slope), torch)
        (f_ms_b, f_by), (b_ms, b_by) = pooled_bounds(shape, widths)
        common = dict(stage=stage, table=list(shape), widths=list(widths),
                      slope=slope, per_check=1)
        fwd_rows.append(dict(**common, max_abs_err=f_err, ms=f_ms,
                             device_ms=f_dev, device_ms_by_kernel=f_kernels,
                             plain_ms=f_plain, library_ms=None,
                             bound_ms=f_ms_b, bound_by=f_by))
        emit({"phase": "kernel", "kernel": "pooled_mlp_affine", **fwd_rows[-1]})
        rows.append(dict(**common, max_abs_err=err, max_norm_rel_err=rel,
                         dtable_share_off=share, ms=ms, device_ms=dev_ms,
                         device_ms_by_kernel=kernels, plain_ms=plain_ms,
                         library_ms=None, bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", "kernel": "pooled_mlp_affine_bwd", **rows[-1]})
    return fwd_rows, rows


def _interp_in_radius(torch, query, cand, bias, cutoff):
    """Pairs of one interp call within the cutoff (u <= 1), the pairs whose
    weight the kernel computes."""
    from tpugan_tpu_torch.ops.kernels import interp as I

    inv_c2 = torch.tensor(I.kernel_constants(cutoff, "bicubic")[0],
                          dtype=torch.float32, device=query.device)
    in_radius = 0
    for s in range(0, query.shape[1], 1024):
        diff = query[:, s:s + 1024, None, :] - cand[:, None]
        in_radius += int((~(I.sq_dist(diff, bias[:, None, :]) * inv_c2
                            > 1.0)).sum())
    return in_radius


def _interp_row(torch, layout, query, cand, vals, bias, cutoff, kind,
                per_step):
    """The kernel against the plain version (out to 1e-5 of the values'
    scale, den to 1e-5 relative: f32 sums in another order), two launches
    bit for bit, times, the plan and the bound: about 9 f32 operations a
    pair (the distance and the test) and about 20 more a pair within the
    cutoff (the weight and the sums), counted on this call's pairs."""
    from tpugan_tpu_torch.ops.kernels import interp as I

    b, nq, m, c = query.shape[0], query.shape[1], cand.shape[1], vals.shape[-1]
    run = lambda: I.interp_kernel(query, cand, vals, cutoff, bias, kind)
    ok, dk = run()
    op, dp = I.interp_plain(query, cand, vals, cutoff, bias, kind)
    again = run()
    torch.cuda.synchronize()
    repeat = bool(torch.equal(ok, again[0]) and torch.equal(dk, again[1]))
    err = float((ok - op).abs().max())
    den_rel = float(((dk - dp).abs() / dp.abs()).max())
    if not (err <= 1e-5 * float(vals.abs().max()) and den_rel <= 1e-5
            and bool(torch.isfinite(ok).all()) and repeat):
        raise AssertionError(f"interp {layout}: err {err}, den rel {den_rel}, "
                             f"repeat {repeat}")
    ms = time_ms(run, torch)
    dev_ms = device_ms(run, torch)
    plain_ms = time_ms(lambda: I.interp_plain(query, cand, vals, cutoff, bias,
                                              kind), torch, reps=3, warmup=1)
    plan = I.interp_plan(b, nq, m, c)
    in_radius = _interp_in_radius(torch, query, cand, bias, cutoff)
    b_ms, b_by = bound(9.0 * b * nq * m + 20.0 * in_radius,
                       4 * (b * nq * 3 + b * m * (3 + c + 1) + b * nq * (c + 1)),
                       "f32")
    row = dict(layout=layout, B=b, Nq=nq, M=m, C=c, cutoff=cutoff, kind=kind,
               per_step=per_step, threads=plan.threads, qpt=I.QPT,
               splits=plan.splits, span=plan.span, blocks=plan.blocks(b, nq),
               in_radius_share=in_radius / (b * nq * m), max_abs_err=err,
               den_max_rel_err=den_rel, repeat_bit_equal=repeat, ms=ms,
               device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "kernel", "kernel": "interp", **row})
    return row


def train_interp_case(torch, dev):
    """The dense interp's call in the train step, as the train phase's first
    step makes it: (query, cand, values, bias, cutoff, kind), captured from
    a train_vel step resumed from the checkpoint on the train phase's first
    batch with its generator's draws (the three predicted frames of each
    item, 12 rows of 9,216 points with the 999 rows of dropped points,
    against the ground truth and its advection)."""
    import tpugan_tpu_torch.ops.interpolate as interpolate
    from tpugan_tpu_torch.checkpoint import load_trainer_state
    from tpugan_tpu_torch.train.step import FluidGanStep, FluidTrainConfig

    cfg = FluidTrainConfig()
    batch = fluid_batches(torch, dev, cfg.patch_size, cfg.batch_size, 1)[0]
    state = load_trainer_state(CHECKPOINT, cfg, device=dev)
    step = FluidGanStep(cfg, generator=torch.Generator().manual_seed(1))
    own, calls = interpolate.interp_kernel, []

    def capture(query, cand, values, cutoff, bias, kind="bicubic"):
        calls.append((query.clone(), cand.clone(), values.clone(),
                      bias.clone(), cutoff, kind))
        return own(query, cand, values, cutoff, bias, kind=kind)

    interpolate.interp_kernel = capture
    try:
        step(state, batch)
    finally:
        interpolate.interp_kernel = own
    torch.cuda.synchronize()
    if len(calls) != 1:
        raise AssertionError(f"the train step's first batch made {len(calls)} "
                             f"dense interp calls, not 1 (gate shut?)")
    return calls[0]


def check_interp(torch, dev, rng, b=12, n=9216):
    """The velocity transfer's shape: the three predicted frames (with
    999-sentinel rows) against the ground truth, bicubic, cutoff 1.6 R, on
    a random cloud in random order (weight 0), then on the train step's own
    call (:func:`train_interp_case`, one a G+D step); each row by
    :func:`_interp_row`."""
    c, cutoff = 3, 0.16
    cand = _cloud(torch, dev, rng, b, n, 3)
    query = cand + _cloud(torch, dev, rng, b, n, 3, scale=0.01)
    query[:, -n // 10:] = 999.0
    vals = _cloud(torch, dev, rng, b, n, c, scale=0.025)
    bias = torch.zeros((b, n), device=dev)
    rows = [_interp_row(torch, "random", query, cand, vals, bias, cutoff,
                        "bicubic", 0)]
    query, cand, vals, bias, cutoff, kind = train_interp_case(torch, dev)
    rows.append(_interp_row(torch, "train", query, cand, vals, bias, cutoff,
                            kind, 1))
    return rows


# ---------------------------------------------------------- train phases

def fluid_batches(torch, dev, patch, batch_size, count):
    """``count`` batches of the port's synthetic fluid data (the JAX CLI's
    --synthetic defaults: seed 1, 2 cases, 8 steps, 12,000 particles)."""
    from tpugan_tpu_torch.data.fluid import (SiamFluidDataset,
                                             fluid_batch_iterator)
    from tpugan_tpu_torch.data.synthetic import make_synthetic_fluid_dataset

    root = make_synthetic_fluid_dataset(DATA_DIR, case_num=2, case_steps=8,
                                        num_particles=12000, seed=1)
    it = fluid_batch_iterator(SiamFluidDataset(root, 2, 8, sample_num=patch),
                              batch_size, seed=1)
    out = []
    for _ in range(count):
        batch = next(it)
        out.append({k: torch.from_numpy(batch[k]).to(dev)
                    for k in ("highres_pos", "highres_vel")})
    return out


def _critic_state(state):
    """(params, BatchNorm running moments, spectral-norm u) of both critics."""
    snap = {}
    for name in ("tempo", "spatial"):
        for k, t in getattr(state, name).module.state_dict().items():
            kind = ("u" if k.endswith(".u") else
                    "bn" if k.endswith((".mean", ".var")) else
                    "param" if not k.endswith(".sigma") else None)
            if kind:
                snap[(name, kind, k)] = t.detach().clone()
    return snap


def _moved(before, after, name, kind):
    return any(bool((before[key] != after[key]).any())
               for key in before if key[0] == name and key[1] == kind)


def train(torch, dev, kernels, profile_dir=None, cfg=None):
    """Resume the trainer state and run TRAIN_STEPS steps at full width
    (``cfg`` None: the train_vel defaults, device sampling); the launch
    counts are reset just before and read just after."""
    from tpugan_tpu_torch.checkpoint import load_trainer_state
    from tpugan_tpu_torch.train.step import FluidGanStep, FluidTrainConfig

    cfg = cfg or FluidTrainConfig()
    batches = fluid_batches(torch, dev, cfg.patch_size, cfg.batch_size,
                            TRAIN_STEPS + 2)
    state = load_trainer_state(CHECKPOINT, cfg, device=dev)
    n0 = state.n_iter
    step = FluidGanStep(cfg, generator=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()

    for k in kernels.values():
        k.launches = 0
    steps = []
    for i in range(TRAIN_STEPS):
        before = _critic_state(state)
        c0 = counts(kernels)
        ev = {n: torch.cuda.Event(enable_timing=True)
              for n in ("start", "generator", "critics")}
        ev["start"].record()
        t0 = time.perf_counter()
        metrics = step(state, batches[i], mark=lambda n: ev[n].record())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = delta(c0, counts(kernels))
        d_update = metrics["gate"] and state.n_iter % 2 == 0
        want = dict(STEP_ALWAYS)
        for extra in ([STEP_GATE] if metrics["gate"] else []) + (
                [STEP_CRITICS] if d_update else []):
            for n, v in extra.items():
                want[n] = want.get(n, 0) + v
        expect(got, want, f"train step {state.n_iter}")
        after = _critic_state(state)
        for name, v in metrics.items():
            if not np.isfinite(v):
                raise AssertionError(f"step {state.n_iter}: {name} = {v}")
        moved = {f"{name}_{kind}": _moved(before, after, name, kind)
                 for name in ("tempo", "spatial")
                 for kind in ("param", "bn", "u")}
        if any(moved[f"{n}_param"] != d_update for n in ("tempo", "spatial")):
            raise AssertionError(f"step {state.n_iter}: critic params moved "
                                 f"{moved}, critic update {d_update}")
        if metrics["gate"] and not all(moved[f"{n}_{k}"] for n in
                                       ("tempo", "spatial") for k in ("bn", "u")):
            raise AssertionError(f"step {state.n_iter}: critic state {moved}")
        steps.append(dict(iteration=state.n_iter, **metrics,
                          critic_update=d_update, launches=got,
                          ms=ev["start"].elapsed_time(ev["critics"]),
                          generator_ms=ev["start"].elapsed_time(ev["generator"]),
                          critics_ms=ev["generator"].elapsed_time(ev["critics"]),
                          wall_ms=wall, moved=moved))
        emit({"phase": "train", **steps[-1]})
    launches = counts(kernels)
    if not any(s["critic_update"] for s in steps):
        raise AssertionError("the adversarial gate never opened on an even "
                             "step: the critics' path did not run")
    emit({"phase": "train", "resumed_from": os.path.relpath(CHECKPOINT, ROOT),
          "first_iteration": n0 + 1, "steps": TRAIN_STEPS,
          "batch": cfg.batch_size, "patch": cfg.patch_size,
          "gate_open": sum(s["gate"] for s in steps),
          "critic_updates": sum(s["critic_update"] for s in steps),
          "launches": launches,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    train_profile(torch, step, state, batches[TRAIN_STEPS:], profile_dir)
    return launches, steps


def train_profile(torch, step, state, batches, out_dir, of="train"):
    """torch.profiler over two more steps (one odd, one even): device time
    by kernel and the device's idle share of the steps' wall time; ``of``
    names the path in the output."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for batch in batches:
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    table = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                    for e in p.key_averages()
                    if e.device_type == DeviceType.CUDA),
                   key=lambda x: -x[1])
    kernels_ms = sum(t for _, t, _ in table)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_{of}_step.txt"), "w") as fh:
            fh.write(p.key_averages().table(sort_by="self_device_time_total",
                                            row_limit=80))
    emit({"phase": "profile", "of": of, "train_steps": len(batches),
          "wall_ms": wall_ms, "device_kernel_ms": kernels_ms,
          "device_idle_share": 1.0 - kernels_ms / wall_ms,
          "top": [(n[:60], round(t, 4), c) for n, t, c in table[:20]]})


def _bias_under_bn(module, key):
    """A Dense bias that a batch norm follows (the critics' heads): its
    gradient is zero in exact arithmetic, so it is f32 noise on both sides,
    and the resumed Adam state (whose nu holds 20,000 steps of that noise)
    turns the noise into steps of the learning rate's size."""
    prefix, _, leaf = key.rpartition(".")
    head, _, dense = prefix.rpartition(".")
    if leaf != "bias" or not dense.startswith("Dense_"):
        return False
    bn = (head + "." if head else "") + "BatchNorm_" + dense.split("_")[1]
    return bn in dict(module.named_modules())


CARD_CPU_LOSS_TOL = 5e-3
CARD_CPU_CHANGE_TOL = {"sr": 0.02, "tempo": 0.1, "spatial": 0.1}
BIAS_GRAD_TOL = 1e-3


def _change_over_limit(module, before, got_params, want_params, tol):
    """(largest err / limit, its parameter) of each parameter's change in
    ``got_params`` against ``want_params`` from ``before``: the limit is
    ``tol`` of the wanted change's norm plus 1e-3 of the largest RMS change
    per element. Dense biases under a batch norm are checked apart
    (:func:`_bias_grads_over_limit`)."""
    changes = [(k, got_params[k].detach().cpu() - before[k],
                want_params[k].detach().cpu() - before[k])
               for k in want_params if not _bias_under_bn(module, k)]
    r = max(float(w.norm()) / w.numel() ** 0.5 for _, _, w in changes)
    worst, worst_k = 0.0, None
    for k, got, want in changes:
        err = float((got - want).norm())
        lim = tol * float(want.norm()) + 1e-3 * want.numel() ** 0.5 * r
        if err / lim > worst:
            worst, worst_k = err / lim, k
    return worst, worst_k


def _bias_grads_over_limit(net, mu_before):
    """Largest max |g| of a Dense bias under a batch norm over
    ``BIAS_GRAD_TOL`` max |g| of that Dense's weight, the step's gradients
    recovered from Adam's first moment, g = (mu - b1 mu_before) / (1 - b1).
    The batch norm makes such a bias's gradient zero in exact arithmetic,
    so it is f32 noise; the resumed Adam state turns noise into steps of
    the learning rate's size, which no comparison of the changes between
    two devices can hold."""
    opt, worst = net.opt, 0.0
    g = lambda k: (opt.mu[k] - opt.b1 * mu_before[k]) / (1.0 - opt.b1)
    for k in opt.params:
        if _bias_under_bn(net.module, k):
            w = k[:-len("bias")] + "weight"
            worst = max(worst, float(g(k).abs().max())
                        / (BIAS_GRAD_TOL * float(g(w).abs().max())))
    return worst


def train_card_vs_cpu(torch, dev, patch=1024):
    """One small step (B=2, 1,024-point patches; iteration 20,002 with the
    gate held open, so both critics update) from the same checkpoint state
    and the same draws on the card and on the CPU, with the card's generator
    graphs replayed on the CPU (GraphReplay). Losses to CARD_CPU_LOSS_TOL
    relative, each parameter's change to CARD_CPU_CHANGE_TOL of its norm
    (a few times the error measured on the H100: at B=2 the critics' heads
    normalise over 2 items and amplify f32 noise, see
    tests/test_torch_train_step.py), and the gradients of Dense biases
    under a batch norm to zero on both sides. Then the card's step with
    the gate shut (no adversarial loss reaches the generator) must fail
    the generator's comparison: the check sees a lost adversarial path."""
    import dataclasses

    from tpugan_tpu_torch.checkpoint import load_trainer_state
    from tpugan_tpu_torch.models.discriminator import dropout_widths
    from tpugan_tpu_torch.train.step import (FluidGanStep, FluidTrainConfig,
                                             StepDraws)

    # the gate held open: this phase checks the wiring of every kernel
    cfg = FluidTrainConfig(batch_size=2, patch_size=patch, ml_gate=1e9)
    shut = dataclasses.replace(cfg, ml_gate=0.0)      # ml >= 0: never open
    batch = fluid_batches(torch, "cpu", cfg.patch_size, cfg.batch_size, 1)[0]
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    states = {d: load_trainer_state(CHECKPOINT, cfg, device=d)
              for d in (dev, "cpu")}
    states["no_adv"] = load_trainer_state(CHECKPOINT, cfg, device=dev)
    nets = ("sr", "tempo", "spatial")
    for s in states.values():
        s.n_iter += 1                                   # the step is even
    before = {n: {k: v.detach().clone() for k, v in
                  getattr(states["cpu"], n).module.named_parameters()}
              for n in nets}
    mu_before = {d: {n: {k: v.clone() for k, v in
                         getattr(states[d], n).opt.mu.items()} for n in nets}
                 for d in (dev, "cpu")}
    draws = StepDraws.draw(torch.Generator().manual_seed(2), cfg,
                           cfg.patch_size,
                           dropout_widths(states["cpu"].spatial.module))
    step = FluidGanStep(cfg)
    replay = GraphReplay(torch)
    t0 = time.perf_counter()
    m_card = replay.record(step, states[dev], card_batch, draws)
    t1 = time.perf_counter()
    m_cpu = replay.replay(step, states["cpu"], batch, draws)
    t2 = time.perf_counter()
    m_shut = FluidGanStep(shut)(states["no_adv"], card_batch, draws)
    if not (m_card["gate"] and m_cpu["gate"]) or m_shut["gate"]:
        raise AssertionError(f"card vs CPU: gate {m_card['gate']}, "
                             f"{m_cpu['gate']}, shut {m_shut['gate']}")
    out = {"phase": "train_cpu", "batch": 2, "patch": patch,
           "iteration": states["cpu"].n_iter, "knn_tie_swaps": replay.swaps,
           "card_s": t1 - t0, "cpu_s": t2 - t1}
    hold_card_to_cpu(out, states, dev, m_card, m_cpu, before, mu_before,
                     CARD_CPU_LOSS_TOL, CARD_CPU_CHANGE_TOL)


def hold_card_to_cpu(out, states, dev, m_card, m_cpu, before, mu_before,
                     loss_tol, change_tol):
    """The card's step against the CPU's from one state and one set of
    draws: each loss to ``loss_tol`` relative, each network's parameter
    changes by :func:`_change_over_limit` to ``change_tol[net]``, the
    gradients of Dense biases under a batch norm to zero on both sides
    (:func:`_bias_grads_over_limit`); then ``states["no_adv"]``, the
    card's step without the generator's adversarial losses, must fail the
    generator's comparison. Fills and emits ``out``; raises past a limit."""
    out.update(loss_rel_err={}, change_tol=change_tol,
               change_err_over_limit={}, bias_grad_over_limit={})

    def fail(msg):
        emit(out)
        raise AssertionError(f"{out['phase']}: {msg}")

    for k, v in m_cpu.items():
        if k == "gate":
            continue
        rel = abs(m_card[k] - v) / max(abs(v), 1e-5)
        out["loss_rel_err"][k] = rel
        if rel > loss_tol:
            fail(f"{k}: {m_card[k]} vs {v}")
    for n in ("sr", "tempo", "spatial"):
        module = getattr(states["cpu"], n).module
        cpu = dict(module.named_parameters())
        card = dict(getattr(states[dev], n).module.named_parameters())
        worst, k = _change_over_limit(module, before[n], card, cpu,
                                      change_tol[n])
        out["change_err_over_limit"][n] = worst
        if worst > 1.0:
            fail(f"{n} {k}: change err {worst} of the limit")
        bias = max(_bias_grads_over_limit(getattr(states[d], n),
                                          mu_before[d][n]) for d in (dev, "cpu"))
        out["bias_grad_over_limit"][n] = bias
        if bias > 1.0:
            fail(f"{n}: a Dense bias under a batch norm has a gradient "
                 f"({bias})")
    sr_cpu = dict(states["cpu"].sr.module.named_parameters())
    lost, _ = _change_over_limit(
        states["cpu"].sr.module, before["sr"],
        dict(states["no_adv"].sr.module.named_parameters()), sr_cpu,
        change_tol["sr"])
    out["no_adversarial_sr_change_over_limit"] = lost
    if lost <= 1.0:
        fail(f"the generator's change without its adversarial losses passes "
             f"the check ({lost})")
    emit(out)


# ------------------------------------------------------ fused-train phase

FUSED_DIR = os.path.join(ROOT, "runs", "chip_smoke_train_fluid")   # gitignored
FUSED_ITERS = 20004
# Launches per fused train step on top of STEP_ALWAYS (and STEP_GATE,
# STEP_CRITICS): the generator's 9 EdgeConvs through the fused forward and
# its backward kernel (tpugan_tpu_torch/nn/edgeconv.py with fused_train).
STEP_FUSED = {"edgeconv": 9, "edgeconv_bwd": 9}
# Of those backwards, the redesigned f32 backward's (edgeconv.
# F32_TILED_BWD_LAUNCHES): all 9, the upsampler's k=12 and k=4 and the mask
# head's k=12 EdgeConvs at (64, 128, 256), the mask head's k=8 sum,
# EdgeConv_0 and the IDGCN's four (on GEMM tiles or one plane-row a
# thread); none on the general kernel.
STEP_TILED_BWD = 9
# After a checkpoint iteration (20001 and 20004 at the train_vel preset's
# --ckpt_every 10000, cli/train_fluid.py): the test split's 4 batches, one
# serving forward each (7 kNN, 9 EdgeConv) and its Chamfer (2 nn1), and
# the sample dump's serving forward.
CKPT_EVAL = {"knn": 5 * 7, "edgeconv": 5 * 9, "nn1": 4 * 2}
# Limit of the generator's gradients with the switch on against off (each
# parameter's step gradient, recovered from Adam's first moment, by norm,
# from one state and one set of draws, with the graphs replayed): the two
# paths sum in another order in f32. About 9x the error measured on an
# NVIDIA H100 80GB HBM3 at 700 W (5.6e-7, PERF.md section 6), so a fused
# backward off by 1e-5 in any parameter fails; the changes are only
# reported, since with the resumed moments one step's gradient is a tenth
# of the new mu.
FUSED_GRAD_TOL = 5e-6
FUSED_LOSS_TOL = 5e-3
# The control's loss: this share of each EdgeConv's neighbour-table
# gradient dropped (a fault in the gather's backward) must fail the check.
LOSSY_NBR_GRAD = 0.05


def _grads_rel_err(net_a, net_b, mu_before):
    """(largest ||g_a - g_b|| / ||g_b||, its parameter) over the step
    gradients of two nets that stepped from the same Adam state, each
    recovered as g = (mu - b1 mu_before) / (1 - b1)."""
    b1, worst, worst_k = net_b.opt.b1, 0.0, None
    for k, before in mu_before.items():
        ga = (net_a.opt.mu[k] - b1 * before) / (1.0 - b1)
        gb = (net_b.opt.mu[k] - b1 * before) / (1.0 - b1)
        err = float((ga - gb).norm()) / max(float(gb.norm()), 1e-30)
        if err > worst:
            worst, worst_k = err, k
    return worst, worst_k


def _changes_rel_err(module_a, module_b, before):
    """Largest ||change_a - change_b|| / ||change_b|| of each parameter
    from ``before``."""
    pa, pb = dict(module_a.named_parameters()), dict(module_b.named_parameters())
    return max(float((pa[k].detach().cpu() - pb[k].detach().cpu()).norm())
               / max(float((pb[k].detach().cpu() - v).norm()), 1e-30)
               for k, v in before.items())


def _state_equal(a, b):
    """(name of the first tensor that differs, or None) between two trainer
    states: every parameter, buffer, Adam moment and count."""
    if a.n_iter != b.n_iter:
        return "n_iter"
    for name in ("sr", "tempo", "spatial"):
        na, nb = getattr(a, name), getattr(b, name)
        sa, sb = na.module.state_dict(), nb.module.state_dict()
        for k in sa:
            if not bool((sa[k] == sb[k]).all()):
                return f"{name} {k}"
        if (na.opt.count, na.opt.sched_count) != (nb.opt.count, nb.opt.sched_count):
            return f"{name} adam counts"
        for moments in ("mu", "nu"):
            ma, mb = getattr(na.opt, moments), getattr(nb.opt, moments)
            for k in ma:
                if not bool((ma[k] == mb[k]).all()):
                    return f"{name} adam {moments} {k}"
    return None


def fused_train(torch, dev, kernels):
    """The train CLI twin called as a function, resumed from the trained
    checkpoint for iterations 20001-20004 at the train_vel preset with
    device sampling on its synthetic data, with TPUGAN_FUSED_EDGECONV_TRAIN=1:
    every generator EdgeConv trains through the fused forward and backward
    kernels. Counts reset just before; each step's launches against the
    counts the code implies, the windows between steps against CKPT_EVAL
    after checkpoint iterations (0 else); the last checkpoint read back
    equal to the state in memory. The counts hold "edgeconv_bwd_tiled",
    the redesigned f32 backwards (STEP_TILED_BWD a step, 0 between)."""
    import shutil

    from tpugan_tpu_torch.checkpoint import load_trainer_state
    from tpugan_tpu_torch.cli import train_fluid as cli
    from tpugan_tpu_torch.ops.kernels import edgeconv as E
    from tpugan_tpu_torch.train.step import FluidTrainConfig

    shutil.rmtree(FUSED_DIR, ignore_errors=True)
    argv = ["--preset", "train_vel", "--device_sampling", "--synthetic",
            "--resume", "--path_to_resume", CHECKPOINT, "--iters",
            str(FUSED_ITERS), "--log_dir", FUSED_DIR]
    marks = []
    tally = lambda: {**counts(kernels),
                     "edgeconv_bwd_tiled": E.F32_TILED_BWD_LAUNCHES}

    def hook(event, n_iter, metrics):
        if event in ("start", "end"):
            torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((event, n_iter, tally(), ev, metrics,
                      time.perf_counter()))

    for k in kernels.values():
        k.launches = 0
    E.F32_TILED_BWD_LAUNCHES = 0
    os.environ[cli.FUSED_SWITCH] = "1"
    t0 = time.perf_counter()
    try:
        out = cli.main(argv, hook=hook)
    finally:
        del os.environ[cli.FUSED_SWITCH]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = tally()
    for k in kernels.values():
        k.launches = 0

    ckpt_iter = lambda n: (n - 1) % 10000 == 0 or n >= FUSED_ITERS
    steps, prev_counts, prev_iter = [], {n: 0 for n in launches}, None
    by = {}
    for event, n_iter, c, ev, metrics, wall in marks:
        by.setdefault(n_iter, {})[event] = (c, ev, metrics, wall)
    for n_iter in sorted(by):
        m = by[n_iter]
        between = delta(prev_counts, m["start"][0])
        expect(between, CKPT_EVAL if prev_iter and ckpt_iter(prev_iter) else {},
               f"fused CLI before iteration {n_iter}")
        metrics = m["end"][2]
        d_update = metrics["gate"] and n_iter % 2 == 0
        want = dict(STEP_ALWAYS, edgeconv_bwd_tiled=STEP_TILED_BWD)
        for extra in [STEP_FUSED] + ([STEP_GATE] if metrics["gate"] else []) + (
                [STEP_CRITICS] if d_update else []):
            for name, v in extra.items():
                want[name] = want.get(name, 0) + v
        got = delta(m["start"][0], m["end"][0])
        expect(got, want, f"fused train step {n_iter}")
        for name, v in metrics.items():
            if not np.isfinite(v):
                raise AssertionError(f"fused step {n_iter}: {name} = {v}")
        start, gen, crit = m["start"][1], m["generator"][1], m["critics"][1]
        steps.append(dict(iteration=n_iter, **metrics, critic_update=d_update,
                          launches=got,
                          f32_tiled_bwd_launches=got["edgeconv_bwd_tiled"],
                          ms=start.elapsed_time(crit),
                          generator_ms=start.elapsed_time(gen),
                          critics_ms=gen.elapsed_time(crit),
                          wall_ms=(m["end"][3] - m["start"][3]) * 1e3))
        emit({"phase": "train_fused", **steps[-1]})
        prev_counts, prev_iter = m["end"][0], n_iter
    expect(delta(prev_counts, launches), CKPT_EVAL, "fused CLI after the last step")
    if len(steps) != FUSED_ITERS - 20000 or not any(s["critic_update"]
                                                     for s in steps):
        raise AssertionError(f"fused CLI ran {len(steps)} steps, critic "
                             f"updates {[s['critic_update'] for s in steps]}")
    back = load_trainer_state(out["checkpoint"], FluidTrainConfig(), dev)
    differs = _state_equal(out["state"], back)
    if differs is not None:
        raise AssertionError(f"checkpoint read back differs: {differs}")
    test_cd = out["test_chamfer"]
    if len(test_cd) != 2 or not all(np.isfinite(test_cd)):
        raise AssertionError(f"test Chamfer {test_cd}")
    emit({"phase": "train_fused", "resumed_from": os.path.relpath(CHECKPOINT, ROOT),
          "checkpoint": os.path.relpath(out["checkpoint"], ROOT),
          "checkpoint_read_back_equal": True, "test_chamfer": test_cd,
          "steps": len(steps), "cli_s": total_s, "launches": launches})
    return launches


def switch_check(torch, step, states, control, batches, draws, replay,
                 grad_tol, phase):
    """One step of ``states[False]`` (the switch off) and ``states[True]``
    (on) from one state with ``draws[0]``, the first run's graphs replayed
    into the second by ``replay``: the losses to FUSED_LOSS_TOL relative,
    each generator parameter's step gradient (recovered from Adam's first
    moment) to ``grad_tol`` of its norm, the largest relative error of the
    changes reported beside it; ``control`` (switch on), stepped with
    LOSSY_NBR_GRAD of every EdgeConv's neighbour-table gradient dropped,
    must fail that check. Then ms per step of both, G only (odd
    iterations) and G+D (even), in turns over the other batches. Emits and
    returns the phase's line."""
    import tpugan_tpu_torch.ops.kernels.edgeconv as ek

    before = {k: v.detach().cpu().clone()
              for k, v in states[False].sr.module.named_parameters()}
    mu_before = {k: v.clone() for k, v in states[False].sr.opt.mu.items()}
    m_off = replay.record(step, states[False], batches[0], draws[0])
    graphs = replay.saved()
    m_on = replay.replay(step, states[True], batches[0], draws[0])
    own_bwd = ek.edgeconv_backward

    def lossy_bwd(*args, **kw):
        gnbr, *rest = own_bwd(*args, **kw)
        return ((1.0 - LOSSY_NBR_GRAD) * gnbr, *rest)

    replay.restore(graphs)
    ek.edgeconv_backward = lossy_bwd
    try:
        replay.replay(step, control, batches[0], draws[0])
    finally:
        ek.edgeconv_backward = own_bwd
    lossy, _ = _grads_rel_err(control.sr, states[False].sr, mu_before)
    loss_rel = {k: abs(m_on[k] - v) / max(abs(v), 1e-5)
                for k, v in m_off.items() if k != "gate"}
    worst, worst_k = _grads_rel_err(states[True].sr, states[False].sr,
                                    mu_before)
    out = {"phase": phase, "iteration": states[True].n_iter,
           "gate": [m_off.get("gate"), m_on.get("gate")],
           "knn_tie_swaps": replay.swaps, "loss_rel_err": loss_rel,
           "grad_tol": grad_tol, "sr_grad_rel_err": worst,
           "worst_parameter": worst_k,
           "sr_change_rel_err": _changes_rel_err(
               states[True].sr.module, states[False].sr.module, before),
           "lossy_nbr_grad": LOSSY_NBR_GRAD, "lossy_sr_grad_rel_err": lossy}
    if (m_off.get("gate") != m_on.get("gate") or worst > grad_tol
            or lossy <= grad_tol or max(loss_rel.values()) > FUSED_LOSS_TOL):
        emit(out)
        raise AssertionError(f"{phase}: {out}")
    ms = {False: [], True: []}
    for i in range(1, len(batches)):
        for on in (False, True):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(states[on], batches[i], draws[i])
            end.record()
            end.synchronize()
            ms[on].append((states[on].n_iter, start.elapsed_time(end)))
    for on, name in ((False, "grouped"), (True, "fused")):
        out[f"{name}_ms"] = {"g_only": [t for n, t in ms[on] if n % 2],
                             "g_and_d": [t for n, t in ms[on] if n % 2 == 0]}
    emit(out)
    return out


def fused_vs_grouped(torch, dev, profile_dir=None):
    """One step from the trained state with the same draws, the switch off
    (grouped formulation) and on (fused kernels), the graphs of the first
    replayed into the second: the losses to FUSED_LOSS_TOL relative, each
    generator parameter's step gradient to FUSED_GRAD_TOL of its norm (the
    largest relative error of the changes is reported beside it). A control
    step with the switch on and LOSSY_NBR_GRAD of every EdgeConv's
    neighbour-table gradient dropped must fail that check. Then the ms per
    step of both, G only (odd iterations) and G+D (even), and a profile of
    two more fused steps. The gate is held open, so the adversarial losses
    reach the generator through the fused backward in every step
    (:func:`switch_check`)."""
    from tpugan_tpu_torch.checkpoint import load_trainer_state
    from tpugan_tpu_torch.models.discriminator import dropout_widths
    from tpugan_tpu_torch.train.step import (FluidGanStep, FluidTrainConfig,
                                             StepDraws)

    cfg = FluidTrainConfig(ml_gate=1e9)
    steps = 4
    batches = fluid_batches(torch, dev, cfg.patch_size, cfg.batch_size, steps)
    states = {on: load_trainer_state(CHECKPOINT, cfg, dev, fused_train=on)
              for on in (False, True)}
    control = load_trainer_state(CHECKPOINT, cfg, dev, fused_train=True)
    widths = dropout_widths(states[False].spatial.module)
    draws = [StepDraws.draw(torch.Generator().manual_seed(3 + i), cfg,
                            cfg.patch_size, widths) for i in range(steps)]
    step = FluidGanStep(cfg)
    out = switch_check(torch, step, states, control, batches, draws,
                       GraphReplay(torch), FUSED_GRAD_TOL,
                       "train_fused_vs_grouped")
    train_profile(torch, step, states[True], batches[2:], profile_dir,
                  of="train_fused")
    return out


# ---------------------------------------------------------- eval phases

EVAL_SAMPLES = 2
# Launches per eval sample, read off tpugan_tpu_torch/cli/eval_fluid.py and
# eval/analysis.py (the wrappers count one per call):
#   f32 dynamic: 3 SRNet forwards of 1,152 inputs (the centre frame for
#     position_metrics, the left and the right frame in cycle_consistency),
#     7 kNN graphs and 9 EdgeConvs each; the capped interpolation's k = 32
#     radius kNN; the Chamfers' 2 nn1 in position_metrics and 2 in
#     cycle_consistency (the eps-scaled auctions end in the Hungarian
#     repair, so no nearest-target nn1);
#   bf16 static with --agreement_vs_exact: the bf16 static forward (1
#     graph) and its exact f32 dynamic twin (7), the Chamfer between them
#     (2 nn1), then as above with bf16 static forwards (1 graph each).
EVAL_SAMPLE = {"knn": 3 * 7 + 1, "edgeconv": 3 * 9, "nn1": 2 + 2}
EVAL_SAMPLE_AGREEMENT = {"knn": 1 + 7 + 2 * 1 + 1, "edgeconv": 4 * 9,
                         "nn1": 2 + 2 + 2}
# The density phase: one f32 dynamic forward of a whole 12,000-particle
# frame (7 graphs, 9 EdgeConvs), the exact densities of its kept points and
# of a grid over it (the cell-grid kernel, one launch each) and the capped
# density of a 9,216-point ground-truth patch (one k = 64 radius kNN).
DENSITY_LAUNCHES = {"knn": 7 + 1, "edgeconv": 9, "binned_interp": 2}
DENSITY_CUTOFF = 0.05      # 2 x the reference's particle radius
DENSITY_GRID = 32          # grid points per axis
# card vs CPU: the nn1 kernel and the plain version round |q|^2 + |c|^2 -
# 2 q.c in another order (about 2.4e-7 of max |p|^2 per distance), which a
# Chamfer of near-identical clouds sums over every point; the auctions are
# two eps-optimal assignments (near-tie bids may go another way): 5e-2
# relative on the EMD; the MMD's exp(-|d|^2 / 2 blur^2) turns the same
# distance rounding into 1e-3 relative at most; densities are f32 sums in
# another order, 1e-5 relative.
EMD_RTOL = 5e-2
MMD_RTOL = 1e-3


def eval_phase(torch, kernels):
    """The port's eval CLI, called as a function, on the trained checkpoint
    at the train_vel width (9,216-point patches, 1,152 inputs) with its
    default 2,000 auction rounds: EVAL_SAMPLES samples f32 dynamic, then one
    bf16 static with the exact twin. Counts are reset before each run and
    read after each sample. Returns the launches of both runs."""
    import warnings

    import tpugan_tpu_torch.eval.analysis as analysis
    import tpugan_tpu_torch.ops.metrics as metrics
    from tpugan_tpu_torch.cli import eval_fluid

    base = ["--ckpt", CHECKPOINT, "--in_node_feats", "6", "--use_vel",
            "--patch_size", "9216"]
    total = {n: 0 for n in kernels}
    # seconds (host clock around a synchronised call) and rounds of each
    # auction (position EMD, cycle EMD)
    auction, emd_s, emd_rounds = analysis.auction_assignment, [], []

    def timed_auction(*args, **kw):
        torch.cuda.synchronize()
        metrics.auction_rounds = 0
        t0 = time.perf_counter()
        out = auction(*args, **kw)
        torch.cuda.synchronize()
        emd_s.append(time.perf_counter() - t0)
        emd_rounds.append(metrics.auction_rounds)
        return out

    for mode, extra, per in (
            ("f32 dynamic", ["--num_samples", str(EVAL_SAMPLES)], EVAL_SAMPLE),
            ("bf16 static + exact", ["--num_samples", "1", "--compute_dtype",
                                     "bf16", "--graph_mode", "static",
                                     "--agreement_vs_exact"],
             EVAL_SAMPLE_AGREEMENT)):
        marks = []

        def mark(_=None):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), counts(kernels)))

        for k in kernels.values():
            k.launches = 0
        emd_s.clear()
        emd_rounds.clear()
        mark()
        analysis.auction_assignment = timed_auction
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = eval_fluid.evaluate(eval_fluid.parser().parse_args(
                    base + extra), on_sample=mark)
        finally:
            analysis.auction_assignment = auction
        # marks: before the call, setup done (-1), after each sample
        expect(delta(marks[0][1], marks[1][1]), {}, f"eval {mode} setup")
        per_sample = [delta(a[1], b[1]) for a, b in zip(marks[1:], marks[2:])]
        seconds = [b[0] - a[0] for a, b in zip(marks[1:], marks[2:])]
        emit({"phase": "eval", "mode": mode, "result": out,
              "setup_s": marks[1][0] - marks[0][0],
              "seconds_per_sample": seconds, "emd_seconds": list(emd_s),
              "emd_rounds": list(emd_rounds),
              "launches_per_sample": per_sample})
        dup = [str(w.message) for w in caught
               if "duplicate assignments" in str(w.message)]
        if dup:
            raise AssertionError(f"eval {mode}: the EMD assignment is not a "
                                 f"permutation: {dup}")
        bad = {k: v for k, v in out.items()
               if k != "serving_mode" and not np.isfinite(v)}
        if bad or out["samples"] != len(per_sample):
            raise AssertionError(f"eval {mode}: {bad or out['samples']}")
        for i, got in enumerate(per_sample):
            expect(got, per, f"eval {mode} sample {i}")
        for n, v in counts(kernels).items():
            total[n] += v
    return total


# The eval CLI with --approx_graph at --patch_size 32768 (4,096 inputs, the
# first size whose graphs reach the approximate kernel), on a synthetic
# dataset of 40,000 particles (the CLI's own has 12,000), 4 frames, 1
# sample, the auction cut from 2,000 rounds a phase to 100 (a 32,768-point
# EMD at the default would take minutes). Launches per sample, read off
# cli/eval_fluid.py and eval/analysis.py: the approximate f32 dynamic
# forward (7 graphs, all approximate), the exact twin (7 exact), their
# Chamfer (2 nn1); position_metrics' Chamfer (2 nn1) and the capped
# interpolation's radius kNN (exact); cycle_consistency's 2 approximate
# forwards and its Chamfer (2 nn1).
EVAL_APPROX_DIR = os.path.join(ROOT, "runs", "eval_fluid_synth_approx")
EVAL_APPROX_PARTICLES = 40000
EVAL_APPROX_EMD_ITERS = 100
EVAL_APPROX_SAMPLE = {"knn": 7 + 1, "knn_approx": 3 * 7,
                      "edgeconv": 4 * 9, "nn1": 2 + 2 + 2}


def eval_approx(torch, kernels):
    """One eval CLI sample with --approx_graph --agreement_vs_exact (counts
    reset here, read after the sample); returns the launches."""
    from tpugan_tpu_torch.cli import eval_fluid
    from tpugan_tpu_torch.data.synthetic import make_synthetic_fluid_dataset
    from tpugan_tpu_torch.ops import neighbors

    t0 = time.perf_counter()
    make_synthetic_fluid_dataset(EVAL_APPROX_DIR, case_num=1, case_steps=4,
                                 num_particles=EVAL_APPROX_PARTICLES, seed=100)
    data_s = time.perf_counter() - t0
    argv = ["--ckpt", CHECKPOINT, "--in_node_feats", "6", "--use_vel",
            "--patch_size", "32768", "--num_samples", "1",
            "--sequence_length", "4", "--dataset_path", EVAL_APPROX_DIR,
            "--emd_iters", str(EVAL_APPROX_EMD_ITERS), "--approx_graph",
            "--agreement_vs_exact"]
    marks = []

    def mark(_=None):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), counts(kernels)))

    for k in kernels.values():
        k.launches = 0
    mark()
    out = eval_fluid.evaluate(eval_fluid.parser().parse_args(argv),
                              on_sample=mark)
    launches = counts(kernels)
    expect(delta(marks[0][1], marks[1][1]), {}, "eval approx setup")
    expect(delta(marks[1][1], marks[2][1]), EVAL_APPROX_SAMPLE,
           "eval approx sample")
    emit({"phase": "eval_approx", "argv": argv, "result": out,
          "data_s": data_s, "setup_s": marks[1][0] - marks[0][0],
          "sample_s": marks[2][0] - marks[1][0],
          "launches": delta(marks[1][1], marks[2][1])})
    bad = {k: v for k, v in out.items()
           if k != "serving_mode" and not np.isfinite(v)}
    if (bad or out["samples"] != 1 or not out["serving_mode"]["approx_graph"]
            or not out["chamfer_norm_vs_exact"] < GATE
            or neighbors.APPROX_GRAPH_KNN):
        raise AssertionError(f"eval approx: {out}")
    return launches


def density_grid(pred):
    """DENSITY_GRID^3 points over the bounding box of ``pred`` [N, 3]."""
    lo, hi = pred.min(0), pred.max(0)
    axes = [np.linspace(lo[a], hi[a], DENSITY_GRID, dtype=np.float32)
            for a in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def binned_case(torch, dev, synth_dir):
    """The density phase's two binned-interp inputs, (pred, grid): the
    trained SRNet's kept points on the first frame of a synthetic
    12,000-particle sequence written to ``synth_dir`` as the eval CLI
    writes its own (seed 100), and the grid over them."""
    from tpugan_tpu_torch import DT
    from tpugan_tpu_torch.checkpoint import load_srnet
    from tpugan_tpu_torch.data.sampling import normalize_point_cloud
    from tpugan_tpu_torch.data.synthetic import make_synthetic_fluid_dataset

    make_synthetic_fluid_dataset(synth_dir, case_num=1, case_steps=8,
                                 num_particles=12000, seed=100)
    with np.load(os.path.join(synth_dir, "case1", "data_1.npz")) as z:
        frame = normalize_point_cloud(z["pos"].astype(np.float32))[0]
        vel = z["vel"].astype(np.float32)
    model = load_srnet(CHECKPOINT, device=dev)
    pos = torch.from_numpy(frame)[None].to(dev)
    feat = torch.cat([pos, torch.from_numpy(vel)[None].to(dev) * DT], -1)
    with torch.no_grad():
        _, _, padded, valid = model(feat, pos)
    pred = padded[0][valid[0]].cpu().numpy()
    return pred, density_grid(pred)


def _binned_tiling(torch, BI, q, cells):
    """binned_plan's tiles of one call: how many, the pairs the kernel tests
    (tested_pairs), and the tiles and queries at each lane count (None
    where the checkout has no plan)."""
    if not hasattr(BI, "binned_plan"):
        return None
    bits = BI.sub_bits(q.shape[0], cells.dims)
    keys = torch.sort(BI.query_keys(q, cells, bits)).values
    tiles = BI.binned_plan(keys, bits)
    lanes = tiles[:, 3]
    return {"tiles": int(tiles.shape[0]), "sub_bits": bits,
            "occupied_cells": int(torch.unique_consecutive(keys >> bits).numel()),
            "tested_pairs": int(BI.tested_pairs(q, cells, DENSITY_CUTOFF).sum()),
            "by_lanes": {str(int(v)): {"tiles": int((lanes == v).sum()),
                                       "queries": int(tiles[lanes == v, 2].sum())}
                         for v in torch.unique(lanes)}}


def check_binned_interp(torch, dev, pred, grid, cutoff=DENSITY_CUTOFF):
    """The cell-grid kernel at the density phase's two calls (``pred``'s
    points, then the ``grid`` points, each over ``pred``) against its plain
    version and the dense interp kernel, on a random field of values (the
    density calls pass zeros; C = 1 as there), to 1e-5 of the values' scale
    and 1e-5 of den. Each row: the pairs within the cutoff (the bound's
    work) and those the 27 cells hold (the walk's), per query and in all;
    binned_plan's tiles; ms (CUDA events), device ms (torch.profiler, by
    kernel), the plain version's and the dense kernel's ms, and a digest of
    (out, den). Uses only what every checkout's binned_interp module has
    (tools/compare_knn_torch.py runs it against another checkout)."""
    import hashlib

    from tpugan_tpu_torch.ops.kernels import binned_interp as BI
    from tpugan_tpu_torch.ops.kernels import interp as I

    rows = []
    rng = np.random.default_rng(4)
    cand = torch.from_numpy(pred)[None].to(dev)
    bias = torch.zeros(cand.shape[:2], device=dev)
    vals = torch.from_numpy(rng.standard_normal((1, pred.shape[0], 1))
                            .astype(np.float32)).to(dev)
    for name, q_np in (("frame", pred), ("grid", grid)):
        q = torch.from_numpy(q_np)[None].to(dev)
        cells = BI.build_grid(cand, vals, bias, cutoff)
        run = lambda: BI.binned_interp_launch(q, cells, cutoff, "spline1")
        ok, dk = run()
        again = run()
        op, dp = BI.binned_interp_plain(q, cells, cutoff, "spline1")
        od, dd = I.interp_kernel(q, cand, vals, cutoff, bias, "spline1")
        torch.cuda.synchronize()
        scale = float(vals.abs().max())
        err = max(float((ok - op).abs().max()), float((ok - od).abs().max()))
        den_rel = max(float(((dk - dp).abs() / dp).max()),
                      float(((dk - dd).abs() / dd).max()))
        repeat = bool(torch.equal(ok, again[0]) and torch.equal(dk, again[1]))
        h = hashlib.sha256()
        for t in (ok, dk):
            h.update(t.contiguous().cpu().numpy().tobytes())
        walked, pairs = (t.float() for t in BI.pair_counts(q, cells, cutoff))
        ms = time_ms(run, torch)
        dev_ms, by_kernel = device_ms(run, torch, by_kernel=True)
        grid_ms = time_ms(lambda: BI.build_grid(cand, vals, bias, cutoff),
                          torch)
        plain_ms = time_ms(lambda: BI.binned_interp_plain(q, cells, cutoff,
                                                          "spline1"),
                           torch, reps=3, warmup=1)
        dense_ms = time_ms(lambda: I.interp_kernel(q, cand, vals, cutoff,
                                                   bias, "spline1"),
                           torch, reps=3, warmup=1)
        nq, m = q.shape[1], cand.shape[1]
        # the function's work: about 20 f32 operations and a square root
        # per pair within the cutoff, and one FMA per value channel; the
        # walked pairs (the 27 cells') are the design's overhead
        b_ms, b_by = bound(22.0 * float(pairs.sum()),
                           4 * (3 * nq + 4 * m + m + 2 * nq), "f32")
        rows.append(dict(call=name, Nq=nq, M=m, C=1, cutoff=cutoff,
                         grid_dims=list(cells.dims), per_density=1,
                         in_radius_mean=float(pairs.mean()),
                         in_radius_max=int(pairs.max()),
                         in_radius_pairs=int(pairs.sum()),
                         walked_mean=float(walked.mean()),
                         walked_max=int(walked.max()),
                         walked_pairs=int(walked.sum()),
                         tiling=_binned_tiling(torch, BI, q, cells),
                         max_abs_err=err, den_max_rel_err=den_rel,
                         repeat_bit_equal=repeat, sha=h.hexdigest()[:16],
                         ms=ms, device_ms=dev_ms,
                         device_ms_by_kernel=by_kernel,
                         grid_build_ms=grid_ms, plain_ms=plain_ms,
                         dense_kernel_ms=dense_ms, library_ms=None,
                         bound_ms=b_ms, bound_by=b_by))
        emit({"phase": "kernel", "kernel": "binned_interp", **rows[-1]})
        if not (err <= 1e-5 * scale and den_rel <= 1e-5 and repeat
                and bool(torch.isfinite(ok).all())):
            raise AssertionError(f"binned_interp {name}: err {err}, den rel "
                                 f"{den_rel}, repeat {repeat}")
    return rows


def density_phase(torch, dev, kernels):
    """With the counts reset: the trained SRNet (f32 dynamic) on a whole
    12,000-particle synthetic frame with its velocities (96,000 slots), the
    exact density of its kept points and of a DENSITY_GRID^3 grid over its
    bounding box (cell-grid kernel), and the capped k = 64 density of an
    eval sample's 9,216-point ground truth; then each kernel of the phase
    against its plain version on the same inputs (check_binned_interp).
    Returns (launches, the binned kernel's rows)."""
    from tpugan_tpu_torch import DT
    from tpugan_tpu_torch.checkpoint import load_srnet
    from tpugan_tpu_torch.cli.eval_fluid import SYNTH_DIR
    from tpugan_tpu_torch.data.fluid import SiamFluidDataset
    from tpugan_tpu_torch.data.sampling import normalize_point_cloud
    from tpugan_tpu_torch.eval.analysis import (get_particle_density,
                                                particle_dns2grid_dns)

    with np.load(os.path.join(SYNTH_DIR, "case1", "data_1.npz")) as z:
        frame, vel = normalize_point_cloud(z["pos"].astype(np.float32))[0], \
            z["vel"].astype(np.float32)
    gt = SiamFluidDataset(SYNTH_DIR, 1, 8, sample_num=9216,
                          seed=0)[0]["highres_pos"][1]
    model = load_srnet(CHECKPOINT, device=dev)
    pos = torch.from_numpy(frame)[None].to(dev)
    feat = torch.cat([pos, torch.from_numpy(vel)[None].to(dev) * DT], -1)
    cutoff = DENSITY_CUTOFF
    torch.cuda.synchronize()

    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        _, _, padded, valid = model(feat, pos)
    pred = padded[0][valid[0]].cpu().numpy()
    dns = get_particle_density(pred, cutoff, device=dev)
    grid = density_grid(pred)
    gdns = particle_dns2grid_dns(grid, pred, cutoff, device=dev)
    capped = get_particle_density(gt, cutoff, dense=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernels)
    expect(launches, DENSITY_LAUNCHES, "density phase")
    # a particle's own weight is 1: exactly in the exact form (direct
    # differences), and to within the spline's slope times the kNN's
    # rounding of a zero distance (2.4e-7 of |p|^2) in the capped form
    own_capped = 1.0 - 6.0 * 2.4e-7 * float((gt ** 2).sum(-1).max()) / cutoff ** 2
    if not (dns.shape == (pred.shape[0], 1) and gdns.shape == (len(grid), 1)
            and capped.shape == (gt.shape[0], 1)
            and all(np.isfinite(a).all() for a in (dns, gdns, capped))
            and dns.min() >= 1.0 - 1e-5 and capped.min() >= own_capped):
        raise AssertionError(
            f"density phase: densities not finite or below a particle's own "
            f"weight: {dns.min()}, {capped.min()} (limit {own_capped})")

    # the capped form against the kNN's plain version (on the CPU): their
    # d2 = |q|^2 + |c|^2 - 2 q.c round in another order (2.4e-7 of max
    # |p|^2), which the spline's slope in d2 (at most 6 / cutoff^2) carries
    # into each in-radius neighbour's weight
    plain_capped = get_particle_density(gt, cutoff, dense=False, device="cpu")
    gq = torch.from_numpy(gt).to(dev)
    n_max = int((torch.cdist(gq, gq) < cutoff).sum(-1).max())
    cap_tol = n_max * 6.0 / cutoff ** 2 * 2.4e-7 * float((gt ** 2).sum(-1).max())
    cap_err = float(np.abs(capped - plain_capped).max())
    summary = {"phase": "density", "slots": int(padded.shape[1]),
               "kept": int(pred.shape[0]), "grid_points": int(len(grid)),
               "cutoff": cutoff, "wall_s": wall, "launches": launches,
               "density_mean": float(dns.mean()),
               "grid_density_max": float(gdns.max()),
               "capped_patch_points": int(gt.shape[0]),
               "capped_in_radius_max": n_max, "capped_max_abs_err": cap_err,
               "capped_tol": cap_tol}
    if cap_err > cap_tol:
        emit(summary)
        raise AssertionError(f"capped density vs plain: {cap_err} > {cap_tol}")

    rows = check_binned_interp(torch, dev, pred, grid, cutoff)
    emit(summary)
    return launches, rows


def eval_card_vs_cpu(torch, dev):
    """position_metrics (a masked, padded prediction), cycle_consistency
    (a fixed stand-in for the generator) and the exact density on fixed
    small clouds from a seed, on the card and on the CPU."""
    from tpugan_tpu_torch.data.sampling import pad_with_appropriate_size
    from tpugan_tpu_torch.eval.analysis import (cycle_consistency,
                                                get_particle_density,
                                                position_metrics)

    rng = np.random.default_rng(3)
    cloud = lambda *s, scale=0.3: (rng.standard_normal(s) * scale
                                   ).astype(np.float32)
    gt = cloud(1, 2048, 3)
    pred, valid = pad_with_appropriate_size(gt[0, :1800] + cloud(1800, 3,
                                                                 scale=0.01))
    low, vel = cloud(2, 1, 256, 3), cloud(2, 1, 256, 3, scale=1.0)
    high, adv = cloud(1, 2048, 3), cloud(1, 2048, 3, scale=0.01)
    offsets = cloud(4, 3, scale=0.02)
    dens_pts = (rng.random((6000, 3)) * 0.4).astype(np.float32)

    def run(d):
        t = lambda a: torch.from_numpy(a).to(d)

        def sr_apply(feature, p):
            scale = 1.0 + feature[..., 3:].abs().sum(-1, keepdim=True)
            out = p[:, :, None] + t(offsets) * scale[:, :, None]
            return out.reshape(p.shape[0], -1, 3)

        kw = dict(emd_iters=300, emd_eps=0.01)
        pm = position_metrics(t(pred[None]), t(gt), pred_valid=t(valid[None]),
                              **kw)
        cc = cycle_consistency(sr_apply, t(low[0]), t(low[1]), t(adv), t(high),
                               cutoff=0.1, use_vel=True,
                               lowres_vel_left=t(vel[0]),
                               lowres_vel_right=t(vel[1]), **kw)
        return pm, cc, get_particle_density(dens_pts, 0.05, dense=True,
                                            device=d)

    (pm_g, cc_g, dn_g), (pm_c, cc_c, dn_c) = run(dev), run("cpu")

    def cd_tol(n_terms, n_div, r2max):
        # each nearest distance rounds to within 2.4e-7 of max |p|^2
        return n_terms * 2.4e-7 * float(r2max) / n_div

    out = {"phase": "eval_cpu",
           "position": {"card": pm_g, "cpu": pm_c},
           "cycle": {"card": cc_g, "cpu": cc_c},
           "density_max_rel_err": float(np.max(np.abs(dn_g - dn_c) / dn_c))}
    emit(out)
    checks = [
        abs(pm_g[0] - pm_c[0]) <= cd_tol(1800 + 2048, 2048,
                                         (gt ** 2).sum(-1).max()),
        # the stand-in and the advection move points by under 0.2
        abs(cc_g[0] - cc_c[0]) <= cd_tol(2 * 1024, 1024,
                                         3 * (np.abs(low).max() + 0.2) ** 2),
        abs(pm_g[1] - pm_c[1]) <= EMD_RTOL * abs(pm_c[1]),
        abs(cc_g[1] - cc_c[1]) <= EMD_RTOL * abs(cc_c[1]),
        abs(pm_g[2] - pm_c[2]) <= MMD_RTOL * abs(pm_c[2]) + 1e-7,
        abs(cc_g[2] - cc_c[2]) <= MMD_RTOL * abs(cc_c[2]) + 1e-7,
        out["density_max_rel_err"] <= 1e-5]
    if not all(checks):
        raise AssertionError(f"eval card vs CPU: checks {checks}")


# ------------------------------------------------------- the action workload

# The library phase: the port's library functions that reach a kernel, at
# sizes users run, on the card against the same calls with every kernel's
# plain version on the card. Its clouds lie on a grid of 2^-10 of their
# largest coordinate (:func:`on_grid`): every squared distance,
# |q|^2 + |c|^2 - 2 q.c, is then exact in f32 whatever the order of its
# sums, as the reference's masks need (they keep a pair whose squared
# distance exceeds 1e-8 or 1e-9, so a point's distance to itself, f32
# noise of about that size off the grid, would be kept or dropped by how
# each side rounds, each self pair adding about 1 to its point's sum; the
# first card run, off the grid, read the radius losses 9% apart and the
# densities 64%). Losses and densities to LIBRARY_RTOL of their value (f32
# sums in another order); gradients to 1e-2 of their norms
# (check_pooled_mlp's limit; the scatter-adds of both sides add in another
# order); graph indices equal (equal distances go to the lower index on
# both sides); the EMD to EMD_RTOL (its auction's bids may tie
# differently); the multi-scale SetConv's outputs and running moments to
# LIBRARY_RTOL of their scale.
LIBRARY_RTOL = 1e-4
LIBRARY_RADIUS = 0.025        # the reference's particle radius
LIBRARY_EMD_POINTS = 2048
# the fluid spatial critic's first stage (sa_0: 1,024 centres, radius 0.15,
# 32 samples, 64 -> 128) as two scales
LIBRARY_MSG = dict(mlps=[[32, 64], [64, 128]], npoint=1024,
                   radii=[0.075, 0.15], nsamples=[16, 32])
# kernels every library drive must launch
LIBRARY_KERNELS = ("knn", "nn1", "fps", "ball_query", "pooled_mlp_fwd",
                   "pooled_mlp_bwd", "pooled_mlp_affine")


class plain_kernels:
    """Every kernel wrapper the library functions reach replaced by its
    plain version (on the card), and every SetConv on the plain stack."""

    def __enter__(self):
        import tpugan_tpu_torch.nn.setconv as S
        from tpugan_tpu_torch.ops import metrics, neighbors
        from tpugan_tpu_torch.ops.kernels import ball_query, fps, knn, nn1

        self.own = [(neighbors, "knn_kernel"), (metrics, "nn1_kernel"),
                    (neighbors, "fps_kernel"), (neighbors, "ball_query_kernel"),
                    (S, "fusable_stats")]
        self.own = [(m, a, getattr(m, a)) for m, a in self.own]
        neighbors.knn_kernel = knn.knn_plain
        metrics.nn1_kernel = nn1.nn1_plain
        neighbors.fps_kernel = (lambda pos, m, pen, start, plan=None:
                                fps.fps_plain(pos, m, pen, start))
        neighbors.ball_query_kernel = ball_query.ball_query_plain
        S.fusable_stats = lambda: False

    def __exit__(self, *exc):
        for m, a, fn in self.own:
            setattr(m, a, fn)


def on_grid(torch, x):
    """``x`` rounded to multiples of 2^-10 of its largest magnitude (a power
    of two): coordinates of at most 11 bits, whose squared distances are
    exact in f32."""
    step = 2.0 ** (math.ceil(math.log2(float(x.abs().max()))) - 10)
    return torch.round(x / step) * step


def _library_inputs(torch, dev):
    """The trained SRNet's [4, 9,216] output on a train_vel batch (device
    sampling's 1,152 inputs a patch), the batch's three frames and
    velocities, and the density phase's 12,000-particle frame; the clouds
    on their grids (:func:`on_grid`)."""
    from tpugan_tpu_torch import DT
    from tpugan_tpu_torch.checkpoint import load_srnet
    from tpugan_tpu_torch.cli.eval_fluid import SYNTH_DIR
    from tpugan_tpu_torch.data.sampling import normalize_point_cloud
    from tpugan_tpu_torch.data.synthetic import make_synthetic_fluid_dataset
    from tpugan_tpu_torch.ops.neighbors import fps, gather

    batch = fluid_batches(torch, dev, 9216, 4, 1)[0]
    hp, hv = batch["highres_pos"], batch["highres_vel"]
    idx = fps(hp[1], 1152)
    low = gather(hp[1], idx)
    feat = torch.cat([low, gather(hv[1], idx) * DT], -1)
    with torch.no_grad():
        pred = load_srnet(CHECKPOINT, device=dev)(feat, low)[0]
    path = os.path.join(SYNTH_DIR, "case1", "data_1.npz")
    if not os.path.exists(path):    # the eval CLI's synthetic set, seed 100
        make_synthetic_fluid_dataset(SYNTH_DIR, case_num=1, case_steps=8,
                                     num_particles=12000, seed=100)
    with np.load(path) as z:
        frame = normalize_point_cloud(z["pos"].astype(np.float32))[0]
    frame = torch.from_numpy(frame).to(dev)
    return (on_grid(torch, pred).contiguous(), on_grid(torch, hp), hv,
            on_grid(torch, frame))


def _library_drive(torch, pred, hp, hv, frame, msg):
    """One call of every library function (losses with their gradient in
    the prediction; the multi-scale SetConv train, forward and backward,
    then eval): their outputs, by name."""
    from tpugan_tpu_torch.losses import geometry as G
    from tpugan_tpu_torch.ops import neighbors as N
    from tpugan_tpu_torch.train.step import advect_particle

    r = LIBRARY_RADIUS
    out = {}
    p = pred.detach().clone().requires_grad_()
    losses = {
        "repulsion_loss": G.repulsion_loss(p, r),
        "density_loss": G.density_loss(p, r),
        "refinement_loss": G.refinement_loss(0.5, hp[1], p, r)[0],
        "temporal_loss": G.temporal_loss(advect_particle(hp[1], hv[1], 1),
                                         advect_particle(hp[1], hv[1], -1),
                                         p, p),
        "free_particle_loss": G.free_particle_loss(hp[1], p)}
    sum(losses.values()).backward()
    out.update({k: v.detach() for k, v in losses.items()})
    out["losses_grad"] = p.grad
    with torch.no_grad():
        out["dilated_knn_graph"] = N.dilated_knn_graph(pred, 20, 2)
        out["knn_graph"] = N.knn_graph(pred, 16)
        idx, near = N.fixed_radius_graph(pred, 2 * r, 32)
        out["fixed_radius_graph"] = torch.where(near, idx, -1)
        edge = N.gather(pred, out["knn_graph"].flatten(1)).reshape(
            *out["knn_graph"].shape, 3) - pred[:, :, None]
        out["edge_uniform_loss"] = G.edge_uniform_loss(edge, r)
        out["density"] = G.density(frame, r)
        n = LIBRARY_EMD_POINTS
        out["earth_mover_distance_loss"] = G.earth_mover_distance_loss(
            pred[:, :n], hp[1][:, :n])
    x = pred.detach().clone().requires_grad_()
    _, feats = msg(x, x, train=True)
    g = torch.from_numpy(np.random.default_rng(41).standard_normal(
        tuple(feats.shape)).astype(np.float32)).to(x.device)
    (feats * g).sum().backward()
    out["msg_train"] = feats.detach()
    out["msg_grads"] = [x.grad] + [q.grad for q in msg.parameters()]
    out["msg_state"] = [b.clone() for b in msg.buffers()]
    with torch.no_grad():
        out["msg_eval"] = msg(pred, pred, train=False)[1]
    return out


def library_errors(torch, got, want):
    """({name: error by its LIBRARY_* measure}, the names off their limit or
    not finite) of two library drives."""
    errs, bad = {}, []
    for name, w in want.items():
        a = got[name]
        if name.endswith("graph"):
            errs[name] = float((a != w).float().mean())
            ok = errs[name] == 0.0
        elif name in ("msg_grads", "losses_grad"):
            a, w = (a, w) if name == "msg_grads" else ([a], [w])
            errs[name] = max(float((u - v).norm() / v.norm().clamp_min(1e-30))
                             for u, v in zip(a, w))
            ok = errs[name] <= 1e-2
        elif name == "msg_state":
            errs[name] = max(float((u - v).abs().max()
                                   / max(1.0, float(v.abs().max())))
                             for u, v in zip(a, w))
            ok = errs[name] <= LIBRARY_RTOL
        else:
            scale = max(float(w.abs().max()), 1e-30)
            errs[name] = float((a - w).abs().max()) / scale
            ok = errs[name] <= (EMD_RTOL if name == "earth_mover_distance_loss"
                                else LIBRARY_RTOL)
        if not (ok and all(bool(torch.isfinite(t).all()) for t in
                           (a if isinstance(a, list) else [a]))):
            bad.append(name)
    return errs, bad


def library_phase(torch, dev, kernels):
    """With the launch counts reset: one call of each library function
    that reaches a kernel (module docstring's library), launches read
    after; then the same calls with every kernel's plain version (on the
    card, from the same module state), held to the LIBRARY_* limits, and
    the wall time of both. Returns the launches."""
    import copy

    from tpugan_tpu_torch.nn.layers import leaky_relu_001
    from tpugan_tpu_torch.nn.setconv import SetConv

    pred, hp, hv, frame = _library_inputs(torch, dev)
    msg = SetConv.msg(3, act=leaky_relu_001, mask_dummy=True,
                      fused_train=True,
                      generator=torch.Generator().manual_seed(5), device=dev,
                      **LIBRARY_MSG)
    plain_msg = copy.deepcopy(msg)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    got = _library_drive(torch, pred, hp, hv, frame, msg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernels)
    missing = [k for k in LIBRARY_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"library: no launch of {missing}: {launches}")
    t0 = time.perf_counter()
    with plain_kernels():
        want = _library_drive(torch, pred, hp, hv, frame, plain_msg)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    errs, bad = library_errors(torch, got, want)
    line = {"phase": "library", "prediction": list(pred.shape),
            "density_frame": list(frame.shape), "msg": LIBRARY_MSG,
            "emd_points": LIBRARY_EMD_POINTS, "rel_errs": errs,
            "launches": launches, "wall_s": wall, "plain_wall_s": plain_wall}
    emit(line)
    if bad:
        raise AssertionError(f"library: {bad} off their limits: {errs}")
    return launches


ACTION_CHECKPOINT = os.path.join(ROOT, "checkpoints", "action_tempo_20k.ckpt")
ACTION_DEMO_DIR = os.path.join(ROOT, "runs", "chip_smoke_action")    # gitignored
TEMPO_FEAT_DIR = os.path.join(ROOT, "runs", "chip_smoke_tempo_feat")  # gitignored
ACTION_FRAMES = 24        # the demo's clip: 24 frames of 2,048 points
ACTION_CLIPS = 24         # an eval_tempo_feat batch: 24 clips of 3 frames
ACTION_POINTS = 2048      # of 2,048 points (eval_tempo_feat's default)
ACTION_CUTOFF = 2.0       # eval_tempo_feat's default cutoff
TEMPO_FEAT_EPOCHS = 2

# Launches per action_demo frame (NoMaskSRNet, width 128, r 16, f32 dynamic
# graphs over a 128-point frame): EdgeConv_0's, the two IDGCN layers' and
# the upsampler's two graphs; 7 EdgeConvs, all on the f32 register-tiled
# kernel (EdgeConv_0's class (1, 3, 64, 128) among F32_TILED_CLASSES), none
# on the general one.
ACTION_FRAME = {"knn": 5, "edgeconv": 7}
ACTION_FRAME_F32T = 7
# Launches per ActionCls.infer call (3 frames): the two stacked FPS (sa1
# over 3 x B rows, sa2), 3 ball queries each of sa1 and sa2, 3 flow kNN
# (2 + 1 embeddings), and one affine pooled-MLP forward per SetConv call
# (3 sa1, 3 sa2, 1 sa_pooling); the FWD handle counts both forms.
TEMPO_INFER = {"fps": 2, "ball_query": 6, "knn": 3, "pooled_mlp_fwd": 7,
               "pooled_mlp_affine": 7}
# ... per train step of the head: the tower in train mode runs the plain
# grouped stacks (no pooled-MLP kernel), the same graph ops.
TEMPO_STEP = {"fps": 2, "ball_query": 6, "knn": 3}

# The action paths' shapes for the kernels that already run elsewhere (the
# same checks, weighted per action frame or per inference batch)
ACTION_KNN_SHAPES = [  # (graph, B, Nq, Nc, D, k, self, per frame, per infer)
    ("EdgeConv_0", 1, 128, 128, 3, 20, True, 1, 0),
    ("IDGCN", 1, 128, 128, 32, 20, True, 2, 0),
    ("upsampler k=12", 1, 128, 128, 64, 12, True, 1, 0),
    ("upsampler k=4", 1, 128, 128, 64, 4, True, 1, 0),
    ("flow embedding", ACTION_CLIPS, 256, 256, 3, 32, False, 0, 3),
]
ACTION_FPS_SHAPES = [  # (stage, rows, N, m, per infer)
    ("action sa1 (3 frames stacked)", 3 * ACTION_CLIPS, 2048, 512, 1),
    ("action sa2 (3 frames stacked)", 3 * ACTION_CLIPS, 512, 256, 1),
]
ACTION_BALL_SHAPES = [  # (stage, B, Nq, Nc, radius, nsample, per infer)
    ("action sa1 (per frame)", ACTION_CLIPS, 512, 2048, 0.8, 64, 3),
    ("action sa2 (per frame)", ACTION_CLIPS, 256, 512, 1.2, 32, 3),
]
# The affine pooled MLP at the action towers' SetConvs (eval, ReLU; the
# folded batch norm's a may be negative): (stage, (B, M, ns, C0), widths,
# launches per ActionCls.infer)
ACTION_AFFINE_SHAPES = [
    ("action sa1 (per frame)", (ACTION_CLIPS, 512, 64, 6), (64, 64, 128), 3),
    ("action sa2 (per frame)", (ACTION_CLIPS, 256, 32, 131), (128, 256), 3),
    ("ActionCls sa_pooling", (ACTION_CLIPS, 1, 256, 259), (512, 512), 1),
    ("ActionTempoDis sa_pooling", (ACTION_CLIPS, 1, 256, 259), (256, 512), 0),
]
# the action generator's EdgeConv_0 class: (C, H, O, K, frame rows)
ACTION_EDGECONV = (3, 64, 128, 20, 128)
# A class outside every f32 EdgeConv design (F32_TILED_CLASSES,
# F32_TILED_BWD_CLASSES) that no path runs: the general f32 forward and
# backward serve such classes, so the kernel rows keep holding them to
# their plain versions here, at the action frames' shape. (mlp, C, H, O, K)
GENERAL_EDGECONV = (True, 5, 32, 64, 20)


def check_action_kernels(torch, dev):
    """The action paths' shapes: the affine pooled-MLP forward at the
    towers' three SetConvs (and the critic's 256 -> 512 pooling) against
    its plain version on tables with exact max ties and folded affines of
    both signs, to 1e-5 of the scale (as the pooled rows), with its times,
    device time by kernel, bound and the forward instances' ptxas report;
    that a gradient through a layer above MAX_WIDTH and the batch-norm form
    above it are refused on the card; then kNN at Nc = 128 and the flow's
    k = 32, FPS on 72 rows, the ball query at nsample 64, the f32t EdgeConv
    forward at EdgeConv_0's (1, 3, 64, 128) and the general forward at
    GENERAL_EDGECONV's class (no path's), each against its plain version by
    the limits of its own rows. Its own generator keeps the other checks'
    data. Returns {kernel: rows}."""
    from tpugan_tpu_torch.ops.kernels import fps as F
    from tpugan_tpu_torch.ops.kernels import pooled_mlp as P

    rng = np.random.default_rng(19)
    out = {k: [] for k in ("pooled_mlp_affine", "knn", "fps", "ball_query",
                           "edgeconv")}
    fwd_instances = {n: v for n, v in ptxas_instances(
        "pooled_mlp", ("rows_gemm", "pool_extremes")).items()
        if "Lb0E" in n or "pool_extremes" in n}
    for stage, shape, widths, per in ACTION_AFFINE_SHAPES:
        b, m, ns, c0 = shape
        tab = _cloud(torch, dev, rng, *shape, scale=1.0)
        tab[:, :, 1] = tab[:, :, 0]
        cs = (c0,) + widths
        nl = len(widths)
        ws = [_cloud(torch, dev, rng, cs[i], cs[i + 1], scale=cs[i] ** -0.5)
              for i in range(nl)]
        a_s = [1.0 + _cloud(torch, dev, rng, h, scale=0.1) for h in widths]
        for a in a_s:
            a[::3] *= -1
        b_s = [_cloud(torch, dev, rng, h, scale=0.1) for h in widths]
        run = lambda: P.pooled_mlp_affine(tab, ws, a_s, b_s, 0.0)
        with torch.no_grad():
            n0 = P.AFFINE_FWD.launches
            got = run()
            again = run()
            launched = P.AFFINE_FWD.launches - n0
            want = P.pooled_mlp_affine_plain(tab, ws, a_s, b_s, 0.0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if (launched != 2 or err > 1e-5 * max(1.0, float(want.abs().max()))
                or not torch.equal(got, again)):
            raise AssertionError(f"pooled_mlp_affine {stage}: err {err}, "
                                 f"{launched} launches")
        refused = {}
        if max(widths) > P.MAX_WIDTH:
            # no backward above MAX_WIDTH: a gradient is refused up front,
            # and so is the batch-norm form
            for name, call in (
                    ("affine_with_grad", lambda: P.pooled_mlp_affine(
                        tab, [w.clone().requires_grad_() for w in ws], a_s,
                        b_s, 0.0)),
                    ("bn_train", lambda: P.pooled_mlp_bn_train(
                        tab, ws, a_s, b_s, 0.0))):
                try:
                    call()
                    refused[name] = False
                except ValueError:
                    refused[name] = True
            if not all(refused.values()):
                raise AssertionError(f"pooled_mlp {stage}: above "
                                     f"{P.MAX_WIDTH} not refused: {refused}")
        with torch.no_grad():
            ms = time_ms(run, torch)
            dev_ms, by_kernel = device_ms(run, torch, by_kernel=True)
            plain_ms = time_ms(lambda: P.pooled_mlp_affine_plain(
                tab, ws, a_s, b_s, 0.0), torch)
        b_ms, b_by = pooled_bounds(shape, widths)[0]
        plan = P.forward_plan(shape, widths, 0.0, affine=True)
        out["pooled_mlp_affine"].append(dict(
            stage=stage, table=list(shape), widths=list(widths), slope=0.0,
            per_infer=per, per_check=0, tile_rows=plan["tile_rows"],
            grids=[p["grid"] for p in plan["passes"]], refused=refused,
            max_abs_err=err, repeat_bit_equal=True, ms=ms, device_ms=dev_ms,
            device_ms_by_kernel=by_kernel, plain_ms=plain_ms, library_ms=None,
            bound_ms=b_ms, bound_by=b_by, ptxas_forward=fwd_instances))
        emit({"phase": "kernel", "kernel": "pooled_mlp_affine",
              **out["pooled_mlp_affine"][-1]})

    # clouds at the action clips' extent (depth units / 300: about 0.2)
    for graph, b, nq, nc, d, k, own, per_frame, per_infer in ACTION_KNN_SHAPES:
        row = _knn_row(torch, dev, rng, f"action {graph}", b, nq, nc, d, k,
                       own, 0.2 if d == 3 else 1.0)
        out["knn"].append(dict(path="action", graph=graph,
                               per_action_frame=per_frame,
                               per_infer=per_infer, **row))
        emit({"phase": "kernel", "kernel": "knn", **out["knn"][-1]})

    for stage, b, n, m, per in ACTION_FPS_SHAPES:
        pos = _cloud(torch, dev, rng, b, n, 3, scale=0.2)
        pen = torch.zeros((b, n), device=dev)
        start = torch.from_numpy(rng.integers(0, n, b)).to(dev)
        out["fps"].append(dict(_fps_row(torch, F, stage, b, n, m, pos, pen,
                                        start), per_step=0, per_infer=per))
        emit({"phase": "kernel", "kernel": "fps", **out["fps"][-1]})

    for stage, b, nq, nc, r, ns, per in ACTION_BALL_SHAPES:
        out["ball_query"].append(dict(
            _ball_row(torch, dev, rng, stage, b, nq, nc, r, ns, scale=0.2,
                      masked=False), per_step=0, per_infer=per))
        emit({"phase": "kernel", "kernel": "ball_query",
              **out["ball_query"][-1]})

    c, h, o, k, n = ACTION_EDGECONV
    _, gc, gh, go, gk = GENERAL_EDGECONV
    for config, cls, variant, per in (
            ("action EdgeConv_0", (c, h, o, k), "f32t", 1),
            ("general (no path's class)", (gc, gh, go, gk), "simt", 0)):
        row = _edgeconv_row(torch, dev, rng, config, torch.float32, "f32", n,
                            *cls, "max", True)
        if row["variant"] != variant:
            raise AssertionError(f"edgeconv {config}: {row['variant']}")
        out["edgeconv"].append(dict(config=config, N=n, per_forward=0,
                                    per_action_frame=per, **row))
        emit({"phase": "kernel", "kernel": "edgeconv", **out["edgeconv"][-1]})
    return out


def action_serving(torch, dev, kernels):
    """With the counts reset by the caller: the action demo's clip (the
    first test clip of a synthetic MSR-schema set, 4 videos x 30 frames x
    3,000 points, seed 0, written under runs/chip_smoke_action/) through
    ``cli/action_demo.upsample_clip`` with the trained NoMaskSRNet, 24
    frames of 128 points -> 2,048; each frame's launches against
    ACTION_FRAME (all 7 on the f32 register-tiled EdgeConv, 0 on the general
    kernel); the same model on the CPU (plain versions) with the card's
    graphs replayed, positions to 1e-4; ms per frame (CUDA events) and its
    device time. Returns the phase's launches."""
    from tpugan_tpu_torch.checkpoint import load_nomask_srnet
    from tpugan_tpu_torch.cli import action_demo
    from tpugan_tpu_torch.config import ActionTrainConfig
    from tpugan_tpu_torch.data.msr import MSRAction3DDataset
    from tpugan_tpu_torch.data.synthetic import make_synthetic_action_dataset
    from tpugan_tpu_torch.ops.kernels import edgeconv as E

    make_synthetic_action_dataset(ACTION_DEMO_DIR, num_videos=4, frames=30,
                                  points=3000, seed=0)
    ds = MSRAction3DDataset(ACTION_DEMO_DIR, frames_per_clip=ACTION_FRAMES,
                            num_points=ActionTrainConfig.num_points,
                            train=False, fps_ratio=ActionTrainConfig.fps_ratio)
    item = ds[0]
    model = load_nomask_srnet(ACTION_CHECKPOINT, device=dev)
    replay = GraphReplay(torch)
    c0, ft0, tc0 = counts(kernels), E.F32_TILED_LAUNCHES, E.TC_LAUNCHES
    preds = replay.record(action_demo.upsample_clip, model, item, dev)
    torch.cuda.synchronize()
    got = delta(c0, counts(kernels))
    want = {n: v * ACTION_FRAMES for n, v in ACTION_FRAME.items()}
    expect(got, want, "action demo clip")
    f32t, tc = E.F32_TILED_LAUNCHES - ft0, E.TC_LAUNCHES - tc0
    general = got["edgeconv"] - f32t - tc
    if (f32t, tc, general) != (ACTION_FRAME_F32T * ACTION_FRAMES, 0,
                               (ACTION_FRAME["edgeconv"] - ACTION_FRAME_F32T)
                               * ACTION_FRAMES):
        raise AssertionError(f"action demo EdgeConv launches: f32t {f32t}, "
                             f"tc {tc}, general {general}")
    r = model.upsample_ratio
    n_low = ActionTrainConfig().lowres_size
    if (preds.shape != (ACTION_FRAMES, n_low * r, 3)
            or not np.isfinite(preds).all()):
        raise AssertionError(f"action demo output {preds.shape}")
    cpu = load_nomask_srnet(ACTION_CHECKPOINT, device="cpu")
    ref = replay.replay(action_demo.upsample_clip, cpu, item, "cpu")
    err = float(np.abs(preds - ref).max())
    if err > 1e-4:
        raise AssertionError(f"action demo card vs CPU: {err}")
    low = torch.from_numpy(item["lowres_pos"][:1]).to(dev)
    with torch.no_grad():
        fwd = lambda: model(low, low)
        ms = time_ms(fwd, torch)
        dev_ms, by_kernel = device_ms(fwd, torch, by_kernel=True)
    emit({"phase": "action_serving",
          "checkpoint": os.path.relpath(ACTION_CHECKPOINT, ROOT),
          "frames": ACTION_FRAMES, "points_in": n_low, "ratio": r,
          "points_out": n_low * r, "label": int(item["label"]),
          "launches": got, "edgeconv_f32t": f32t, "edgeconv_general": general,
          "cpu_position_err": err, "knn_tie_swaps": replay.swaps,
          "ms_per_frame": ms, "device_ms_per_frame": dev_ms,
          "device_idle_share": 1.0 - dev_ms / ms,
          "device_ms_by_kernel": by_kernel})
    return got


def tempo_feat(torch, dev, kernels):
    """With the counts reset by the caller: ActionCls with its tower
    transferred from the action checkpoint's temporal critic
    (``cli/eval_tempo_feat.build_classifier``), one ``infer`` batch of 24
    test clips x 3 frames x 2,048 points of the CLI's synthetic set (8
    videos, seed 0, under runs/chip_smoke_tempo_feat/), its launches
    against TEMPO_INFER, its probabilities held against the same model on
    the CPU (plain versions, the flow kNN replayed) to 1e-4 of the scale;
    then the eval_tempo_feat twin (``main``, called as a function) for
    TEMPO_FEAT_EPOCHS epochs on the same set, its launches against
    TEMPO_STEP a train step and TEMPO_INFER a test batch. Returns the
    phase's launches."""
    import shutil

    from tpugan_tpu_torch.cli import eval_tempo_feat as cli
    from tpugan_tpu_torch.data.msr import (MSRAction3DDataset,
                                           action_batch_iterator)
    from tpugan_tpu_torch.data.synthetic import make_synthetic_action_dataset

    shutil.rmtree(TEMPO_FEAT_DIR, ignore_errors=True)
    data = make_synthetic_action_dataset(
        os.path.join(TEMPO_FEAT_DIR, "synthetic_msr"), num_videos=8,
        frames=10, points=3000, num_classes=3, seed=0)
    test_ds = MSRAction3DDataset(data, num_points=ACTION_POINTS, train=False,
                                 return_lowres=False)
    batch = next(action_batch_iterator(test_ds, ACTION_CLIPS, shuffle=False,
                                       endless=False))
    pos_np = batch["highres_pos"]                          # [3, 24, 2048, 3]
    cls, _ = cli.build_classifier(3, 20, ACTION_CHECKPOINT, dev, True)
    pos = [torch.from_numpy(p).to(dev) for p in pos_np]
    c0 = counts(kernels)
    probs = cls.infer(pos, ACTION_CUTOFF)
    torch.cuda.synchronize()
    infer_launches = delta(c0, counts(kernels))
    expect(infer_launches, TEMPO_INFER, "ActionCls.infer")
    # the same forward's logits on the card and, its flow graphs replayed,
    # on the CPU
    cpu_cls, _ = cli.build_classifier(3, 20, ACTION_CHECKPOINT, "cpu", True)
    replay = GraphReplay(torch, flow=True)
    with torch.no_grad():
        logits = replay.record(cls, pos, ACTION_CUTOFF).cpu()
        ref_logits = replay.replay(cpu_cls, [torch.from_numpy(p)
                                             for p in pos_np], ACTION_CUTOFF)
    err = float((probs.cpu() - torch.softmax(ref_logits, -1)).abs().max())
    logit_err = float((logits - ref_logits).abs().max())
    logit_tol = 1e-4 * max(1.0, float(ref_logits.abs().max()))
    if not (err <= 1e-4 and logit_err <= logit_tol
            and bool(torch.isfinite(probs).all())
            and tuple(probs.shape) == (ACTION_CLIPS, 20)):
        raise AssertionError(f"ActionCls card vs CPU: probabilities {err}, "
                             f"logits {logit_err} (tol {logit_tol})")
    with torch.no_grad():
        infer_ms = time_ms(lambda: cls.infer(pos, ACTION_CUTOFF), torch,
                           reps=5)
        infer_dev, by_kernel = device_ms(lambda: cls.infer(pos, ACTION_CUTOFF),
                                         torch, reps=5, by_kernel=True)

    c2 = counts(kernels)
    t0 = time.perf_counter()
    res = cli.main(["--synthetic", "--ckpt_path", ACTION_CHECKPOINT,
                    "--epochs", str(TEMPO_FEAT_EPOCHS), "--log_dir",
                    TEMPO_FEAT_DIR, "--batch_size", str(ACTION_CLIPS),
                    "--num_points", str(ACTION_POINTS), "--device", str(dev)])
    cli_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cli_launches = delta(c2, counts(kernels))
    steps, batches = len(res["train_step_s"]), len(res["infer_batch_s"])
    want = {n: TEMPO_STEP.get(n, 0) * steps + TEMPO_INFER.get(n, 0) * batches
            for n in set(TEMPO_STEP) | set(TEMPO_INFER)}
    expect(cli_launches, want, "eval_tempo_feat CLI")
    accs = [(e["clip_acc"], e["video_acc"]) for e in res["epochs"]]
    if not (len(accs) == TEMPO_FEAT_EPOCHS
            and all(np.isfinite(e["nll"]) for e in res["epochs"])):
        raise AssertionError(f"eval_tempo_feat CLI: {res['epochs']}")
    emit({"phase": "tempo_feat",
          "checkpoint": os.path.relpath(ACTION_CHECKPOINT, ROOT),
          "clips": ACTION_CLIPS, "frames": 3, "points": int(pos_np.shape[2]),
          "infer_launches": infer_launches,
          "cpu_probability_err": err, "cpu_logit_err": logit_err,
          "logit_tol": logit_tol, "flow_knn_tie_swaps": replay.swaps,
          "infer_ms": infer_ms, "infer_device_ms": infer_dev,
          "infer_device_idle_share": 1.0 - infer_dev / infer_ms,
          "infer_device_ms_by_kernel": by_kernel,
          "cli": {"epochs": res["epochs"],
                  "best_video_acc": res["best_video_acc"],
                  "train_clips": res["train_clips"],
                  "test_clips": res["test_clips"],
                  "ms_per_train_step": [s * 1e3 for s in res["train_step_s"]],
                  "ms_per_infer_batch": [s * 1e3 for s in res["infer_batch_s"]],
                  "launches": cli_launches, "wall_s": cli_s}})
    return {n: infer_launches[n] + cli_launches[n] for n in cli_launches}


# ------------------------------------------------ the action GAN training

ACTION_TRAIN_DIR = os.path.join(ROOT, "runs", "chip_smoke_train_action")  # gitignored
ACTION_TRAIN_ITERS = 20004
# Launches per action train step, read off tpugan_tpu_torch/train/step.py :
# ActionGanStep (the wrappers count one per call; B = 4 clips of 3 frames of
# 2,048 points, device sampling):
#   every step: device sampling's FPS over the 12 frames; the generator's 5
#     kNN graphs (one [3B] batch: EdgeConv_0, the two IDGCN layers, the
#     upsampler's two); the Chamfer's 2 nn1;
#   the generator's pass of both critics (no gate: every step): the spatial
#     critic's 3 FPS and 3 ball queries, the temporal critic's 2 stacked
#     FPS, 6 ball queries (sa1 and sa2 per frame) and 3 flow kNN;
#   critic update (even iterations): the temporal critic twice (fake, real),
#     then the spatial critic twice. The action critics train on the plain
#     grouped stacks: no pooled-MLP launch anywhere.
ACTION_STEP_ALWAYS = {"fps": 1, "knn": 5, "nn1": 2}
ACTION_STEP_G = {"fps": 5, "ball_query": 9, "knn": 3}
ACTION_STEP_CRITICS = {"fps": 10, "ball_query": 18, "knn": 6}
# With TPUGAN_FUSED_EDGECONV_TRAIN=1 the generator's 7 EdgeConvs run the
# fused forward and backward kernels: all 7 on the f32 register-tiled
# forward and the redesigned backward (EdgeConv_0's class (1, 3, 64, 128)
# among F32_TILED_CLASSES and F32_TILED_BWD_CLASSES), none on the general
# kernels.
ACTION_STEP_FUSED = {"edgeconv": 7, "edgeconv_bwd": 7, "edgeconv_f32t": 7,
                     "edgeconv_bwd_tiled": 7}
# After a checkpoint iteration (20001 and 20004 at the train_dir preset's
# --ckpt_every 10000): the test split's 4 batches, one serving forward of
# frame 0 each (5 kNN, 7 EdgeConvs, all f32t) and its Chamfer (2 nn1).
ACTION_CKPT_EVAL = {"knn": 4 * 5, "edgeconv": 4 * 7, "edgeconv_f32t": 4 * 7,
                    "nn1": 4 * 2}
# Limit of the generator's gradients with the switch on against off (by
# norm, as FUSED_GRAD_TOL; one state, one set of draws, the generator graphs
# and the flow kNN replayed): about 5x the error measured on an NVIDIA H100
# 80GB HBM3 at 700 W (1.83e-6, PERF.md section 6), so a fused
# backward off by 1e-5 in any parameter fails; LOSSY_NBR_GRAD's control
# measured 0.098.
ACTION_FUSED_GRAD_TOL = 1e-5
# The card-vs-CPU step (B = 4 clips of 3 frames of ACTION_CPU_POINTS, 64
# inputs, iteration 20,002: both critics update), held as the fluid one.
ACTION_CPU_POINTS = 1024
ACTION_CARD_CPU_LOSS_TOL = 5e-3
ACTION_CARD_CPU_CHANGE_TOL = {"sr": 0.02, "tempo": 0.1, "spatial": 0.1}
# The action train step's kernel shapes, each weighted by its launches per
# G+D step with the fused switch on:
ACTION_TRAIN_KNN = [  # (graph, B, Nq, Nc, D, k, self, per G+D step)
    ("generator EdgeConv_0", 12, 128, 128, 3, 20, True, 1),
    ("generator IDGCN", 12, 128, 128, 32, 20, True, 2),
    ("generator upsampler k=12", 12, 128, 128, 64, 12, True, 1),
    ("generator upsampler k=4", 12, 128, 128, 64, 4, True, 1),
    ("tempo flow embedding", 4, 256, 256, 3, 32, False, 9),
]
ACTION_TRAIN_FPS = [  # (stage, rows, N, m, per G+D step)
    ("device sampling (12 frames)", 12, 2048, 128, 1),
    ("spatial sa_0", 4, 2048, 512, 3),
    ("spatial sa_1", 4, 512, 256, 3),
    ("spatial sa_2", 4, 256, 128, 3),
    ("tempo sa1 (3 frames stacked)", 12, 2048, 512, 3),
    ("tempo sa2 (3 frames stacked)", 12, 512, 256, 3),
]
ACTION_TRAIN_BALL = [  # (stage, B, Nq, Nc, radius, nsample, per G+D step)
    ("spatial sa_0", 4, 512, 2048, 0.3, 32, 3),
    ("spatial sa_1", 4, 256, 512, 0.6, 32, 3),
    ("spatial sa_2", 4, 128, 256, 1.0, 32, 3),
    ("tempo sa1 (per frame)", 4, 512, 2048, 0.8, 64, 9),
    ("tempo sa2 (per frame)", 4, 256, 512, 1.2, 32, 9),
]
# the Chamfer (both directions) and EdgeConv_0's f32t forward and
# redesigned backward at 12 frames of 128 points, k = 20 (random and exact
# ties)
ACTION_TRAIN_NN1 = ("action Chamfer", 4, 2048, 2048, 2)
ACTION_TRAIN_EC0 = (3, 64, 128, 20, 12, 128)   # C, H, O, K, frames, points


def check_action_train_kernels(torch, dev):
    """The action train step's kernel shapes, each against its plain
    version by the limits of its own rows: kNN at the generator's 12 x 128
    graphs and the flow's k = 32 at B = 4; FPS at device sampling's 12 rows
    of 2,048 -> 128 and every critic stage, index for index; the ball query
    at the spatial critic's radii 0.3 / 0.6 / 1.0 and the temporal
    critic's, bit for bit; nn1 at [4, 2,048]^2; EdgeConv_0's (1, 3, 64,
    128) on the f32t forward and the redesigned f32 backward (random and
    exact ties), and the general f32 backward at GENERAL_EDGECONV's class
    (no path's; random and exact ties). Its own generator keeps the other
    checks' data. Returns {kernel: rows}, each row with
    ``per_action_step``."""
    from tpugan_tpu_torch.ops.kernels import fps as F

    rng = np.random.default_rng(20)
    out = {k: [] for k in ("knn", "fps", "ball_query", "nn1", "edgeconv",
                           "edgeconv_bwd")}

    def add(kernel, row, per):
        out[kernel].append(dict({"path": "action_train"}, **row,
                                per_action_step=per))
        emit({"phase": "kernel", "kernel": kernel, **out[kernel][-1]})

    for graph, b, nq, nc, d, k, own, per in ACTION_TRAIN_KNN:
        add("knn", dict(graph=graph, **_knn_row(
            torch, dev, rng, f"action train {graph}", b, nq, nc, d, k, own,
            0.2 if d == 3 else 1.0)), per)
    for stage, b, n, m, per in ACTION_TRAIN_FPS:
        pos = _cloud(torch, dev, rng, b, n, 3, scale=0.2)
        pen = torch.zeros((b, n), device=dev)
        start = torch.from_numpy(rng.integers(0, n, b)).to(dev)
        add("fps", _fps_row(torch, F, f"action {stage}", b, n, m, pos, pen,
                            start), per)
    for stage, b, nq, nc, r, ns, per in ACTION_TRAIN_BALL:
        add("ball_query", _ball_row(torch, dev, rng, f"action {stage}", b, nq,
                                    nc, r, ns, scale=0.2, masked=False), per)
    path, b, nq, m, per = ACTION_TRAIN_NN1
    add("nn1", _nn1_row(torch, dev, rng, path, b, nq, m), per)
    c, h, o, k, frames, n = ACTION_TRAIN_EC0
    row = _edgeconv_row(torch, dev, rng, "action train EdgeConv_0",
                        torch.float32, "f32", n, c, h, o, k, "max", True,
                        b=frames)
    if row["variant"] != "f32t":
        raise AssertionError(f"edgeconv action EdgeConv_0: {row['variant']}")
    add("edgeconv", dict(config="action train EdgeConv_0", B=frames, N=n,
                         **row), 1)
    _, gc, gh, go, gk = GENERAL_EDGECONV
    for name, cls, tiled, per in (("action EdgeConv_0", (c, h, o, k), True, 1),
                                  ("general (no path's class)",
                                   (gc, gh, go, gk), False, 0)):
        for ties in (False, True):
            add("edgeconv_bwd", _edgeconv_bwd_row(
                torch, dev, rng, name + (" exact ties" if ties else ""),
                *cls, "max", True, "f32", ties, frames, n, tiled),
                0 if ties else per)
    return out


def action_batches(torch, dev, root, cfg, count, seed=1):
    """``count`` device-sampling batches (``highres_pos`` [3, B, P, 3]) of
    the MSR-schema set at ``root``, as the train CLI's loader draws them."""
    from tpugan_tpu_torch.data.msr import (MSRAction3DDataset,
                                           action_batch_iterator)

    ds = MSRAction3DDataset(root, frames_per_clip=cfg.frames_per_clip,
                            num_points=cfg.num_points, fps_ratio=cfg.fps_ratio,
                            seed=seed, return_lowres=False)
    it = action_batch_iterator(ds, cfg.batch_size, seed=seed)
    return [{"highres_pos": torch.from_numpy(next(it)["highres_pos"]).to(dev)}
            for _ in range(count)]


class StepReplay:
    """:class:`GraphReplay` over a whole action step: the generator's
    graphs and the temporal critic's flow kNN, each recorded in one run and
    replayed, in order, into the next."""

    def __init__(self, torch):
        self.graphs, self.flow = GraphReplay(torch), GraphReplay(torch, flow=True)

    def record(self, call, *args):
        return self.graphs.record(lambda *a: self.flow.record(call, *a), *args)

    def replay(self, call, *args):
        return self.graphs.replay(lambda *a: self.flow.replay(call, *a), *args)

    def saved(self):
        return self.graphs.saved(), self.flow.saved()

    def restore(self, saved):
        self.graphs.restore(saved[0])
        self.flow.restore(saved[1])

    @property
    def swaps(self):
        return {"graph": self.graphs.swaps, "flow": self.flow.swaps}


def action_train(torch, dev, kernels, profile_dir=None):
    """The action train CLI twin (``cli/train_action.main``, called as a
    function) with TPUGAN_FUSED_EDGECONV_TRAIN=1, --preset train_dir
    --device_sampling --synthetic, resumed from the action checkpoint for
    iterations 20001-20004 (log dir runs/chip_smoke_train_action/). Counts
    reset just before; each step's launches against ACTION_STEP_* (the
    f32t forwards and redesigned backwards counted apart, no tensor-core
    launch), the windows between steps against ACTION_CKPT_EVAL after a
    checkpoint iteration (0 else); every loss finite; the last checkpoint
    read back equal to the state in memory; ms per step by CUDA events
    (G only on odd iterations, G+D on even), the peak device memory of the
    CLI; then a profile of 2 more steps (device idle share). Returns the
    phase's launches."""
    import shutil

    from tpugan_tpu_torch.checkpoint import load_action_trainer_state
    from tpugan_tpu_torch.cli import train_action as cli
    from tpugan_tpu_torch.config import ActionTrainConfig
    from tpugan_tpu_torch.ops.kernels import edgeconv as E
    from tpugan_tpu_torch.train.step import ActionGanStep

    shutil.rmtree(ACTION_TRAIN_DIR, ignore_errors=True)
    argv = ["--preset", "train_dir", "--device_sampling", "--synthetic",
            "--resume", "--path_to_resume", ACTION_CHECKPOINT, "--iters",
            str(ACTION_TRAIN_ITERS), "--log_dir", ACTION_TRAIN_DIR]
    marks = []
    tally = lambda: {**counts(kernels), "edgeconv_tc": E.TC_LAUNCHES,
                     "edgeconv_f32t": E.F32_TILED_LAUNCHES,
                     "edgeconv_bwd_tiled": E.F32_TILED_BWD_LAUNCHES}

    def hook(event, n_iter, metrics):
        if event in ("start", "end"):
            torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((event, n_iter, tally(), ev, metrics,
                      time.perf_counter()))

    for k in kernels.values():
        k.launches = 0
    E.TC_LAUNCHES = E.F32_TILED_LAUNCHES = E.F32_TILED_BWD_LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    os.environ[cli.FUSED_SWITCH] = "1"
    t0 = time.perf_counter()
    try:
        out = cli.main(argv, hook=hook)
    finally:
        del os.environ[cli.FUSED_SWITCH]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = tally()
    for k in kernels.values():
        k.launches = 0

    ckpt_iter = lambda n: (n - 1) % 10000 == 0 or n >= ACTION_TRAIN_ITERS
    steps, prev_counts, prev_iter = [], {n: 0 for n in launches}, None
    by = {}
    for event, n_iter, c, ev, metrics, wall in marks:
        by.setdefault(n_iter, {})[event] = (c, ev, metrics, wall)
    for n_iter in sorted(by):
        m = by[n_iter]
        between = delta(prev_counts, m["start"][0])
        expect(between, ACTION_CKPT_EVAL if prev_iter and ckpt_iter(prev_iter)
               else {}, f"action CLI before iteration {n_iter}")
        metrics = m["end"][2]
        d_update = n_iter % 2 == 0
        want = {}
        for part in [ACTION_STEP_ALWAYS, ACTION_STEP_G, ACTION_STEP_FUSED] + (
                [ACTION_STEP_CRITICS] if d_update else []):
            for name, v in part.items():
                want[name] = want.get(name, 0) + v
        got = delta(m["start"][0], m["end"][0])
        expect(got, want, f"action train step {n_iter}")
        for name, v in metrics.items():
            if not np.isfinite(v):
                raise AssertionError(f"action step {n_iter}: {name} = {v}")
        if (metrics["tempo_D_loss"] != 0.0) != d_update:
            raise AssertionError(f"action step {n_iter}: critic update "
                                 f"{metrics}")
        start, gen, crit = m["start"][1], m["generator"][1], m["critics"][1]
        steps.append(dict(iteration=n_iter, **metrics, critic_update=d_update,
                          launches=got, ms=start.elapsed_time(crit),
                          generator_ms=start.elapsed_time(gen),
                          critics_ms=gen.elapsed_time(crit),
                          wall_ms=(m["end"][3] - m["start"][3]) * 1e3))
        emit({"phase": "train_action", **steps[-1]})
        prev_counts, prev_iter = m["end"][0], n_iter
    expect(delta(prev_counts, launches), ACTION_CKPT_EVAL,
           "action CLI after the last step")
    if [s["iteration"] for s in steps] != list(range(20001,
                                                     ACTION_TRAIN_ITERS + 1)):
        raise AssertionError(f"action CLI ran {[s['iteration'] for s in steps]}")
    cfg = ActionTrainConfig(iters=ACTION_TRAIN_ITERS, device_sampling=True)
    back = load_action_trainer_state(out["checkpoint"], cfg, dev)
    differs = _state_equal(out["state"], back)
    if differs is not None:
        raise AssertionError(f"action checkpoint read back differs: {differs}")
    test_cd = out["test_chamfer"]
    if len(test_cd) != 2 or not all(np.isfinite(test_cd)):
        raise AssertionError(f"action test Chamfer {test_cd}")
    emit({"phase": "train_action",
          "resumed_from": os.path.relpath(ACTION_CHECKPOINT, ROOT),
          "checkpoint": os.path.relpath(out["checkpoint"], ROOT),
          "checkpoint_read_back_equal": True, "test_chamfer": test_cd,
          "steps": len(steps), "cli_s": total_s, "launches": launches,
          "g_only_ms": [s["ms"] for s in steps if not s["critic_update"]],
          "g_and_d_ms": [s["ms"] for s in steps if s["critic_update"]],
          "peak_memory_gib": peak_gib})
    batches = action_batches(torch, dev, os.path.join(ACTION_TRAIN_DIR,
                                                      "synthetic_msr"), cfg, 2)
    train_profile(torch, ActionGanStep(cfg), out["state"], batches,
                  profile_dir, of="train_action")
    return launches


def action_fused_vs_grouped(torch, dev):
    """One action step from the checkpoint (iteration 20,001: the
    generator's update, through both critics' losses) with the same draws,
    the switch off and on, the generator graphs and flow kNN of the first
    replayed into the second: the losses to FUSED_LOSS_TOL relative, each
    generator parameter's step gradient to ACTION_FUSED_GRAD_TOL of its
    norm; a control step with the switch on and LOSSY_NBR_GRAD of every
    EdgeConv's neighbour-table gradient dropped must fail that check. Then
    ms per step of both, G only and G+D, in turns (:func:`switch_check`)."""
    from tpugan_tpu_torch.checkpoint import load_action_trainer_state
    from tpugan_tpu_torch.config import ActionTrainConfig
    from tpugan_tpu_torch.models.discriminator import dropout_layers
    from tpugan_tpu_torch.train.step import ActionGanStep, ActionStepDraws

    cfg = ActionTrainConfig(iters=ACTION_TRAIN_ITERS, device_sampling=True)
    steps = 4
    batches = action_batches(torch, dev, os.path.join(ACTION_TRAIN_DIR,
                                                      "synthetic_msr"), cfg,
                             steps, seed=3)
    load = lambda on: load_action_trainer_state(ACTION_CHECKPOINT, cfg, dev,
                                                fused_train=on)
    states = {on: load(on) for on in (False, True)}
    layers = (dropout_layers(states[False].spatial.module),
              dropout_layers(states[False].tempo.module))
    draws = [ActionStepDraws.draw(
        torch.Generator().manual_seed(3 + i), cfg,
        tuple(batches[i]["highres_pos"].shape[:3]), *layers)
        for i in range(steps)]
    return switch_check(torch, ActionGanStep(cfg), states, load(True), batches,
                        draws, StepReplay(torch), ACTION_FUSED_GRAD_TOL,
                        "train_action_fused_vs_grouped")


def action_card_vs_cpu(torch, dev):
    """One action step (B = 4 clips of 3 frames of ACTION_CPU_POINTS;
    iteration 20,002, so both critics update) from the checkpoint's state
    and the same draws on the card and on the CPU (plain versions), the
    card's generator graphs and flow kNN replayed on the CPU: the losses to
    ACTION_CARD_CPU_LOSS_TOL relative, each parameter's change to
    ACTION_CARD_CPU_CHANGE_TOL of its norm, Dense biases under a batch
    norm to a zero gradient on both sides (as train_card_vs_cpu). Then the
    card's step with the generator's adversarial losses cut to zero must
    fail the generator's comparison: the check sees a lost adversarial
    path."""
    import tpugan_tpu_torch.train.step as step_mod
    from tpugan_tpu_torch.checkpoint import load_action_trainer_state
    from tpugan_tpu_torch.config import ActionTrainConfig
    from tpugan_tpu_torch.models.discriminator import dropout_layers
    from tpugan_tpu_torch.train.step import ActionGanStep, ActionStepDraws

    cfg = ActionTrainConfig(iters=ACTION_TRAIN_ITERS, device_sampling=True,
                            num_points=ACTION_CPU_POINTS)
    batch = action_batches(torch, "cpu", os.path.join(ACTION_TRAIN_DIR,
                                                      "synthetic_msr"), cfg,
                           1, seed=5)[0]
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    states = {d: load_action_trainer_state(ACTION_CHECKPOINT, cfg, d)
              for d in (dev, "cpu")}
    states["no_adv"] = load_action_trainer_state(ACTION_CHECKPOINT, cfg, dev)
    nets = ("sr", "tempo", "spatial")
    for s in states.values():
        s.n_iter += 1                                   # the step is even
    before = {n: {k: v.detach().clone() for k, v in
                  getattr(states["cpu"], n).module.named_parameters()}
              for n in nets}
    mu_before = {d: {n: {k: v.clone() for k, v in
                         getattr(states[d], n).opt.mu.items()} for n in nets}
                 for d in (dev, "cpu")}
    draws = ActionStepDraws.draw(
        torch.Generator().manual_seed(2), cfg,
        tuple(batch["highres_pos"].shape[:3]),
        dropout_layers(states["cpu"].spatial.module),
        dropout_layers(states["cpu"].tempo.module))
    step = ActionGanStep(cfg)
    replay = StepReplay(torch)
    t0 = time.perf_counter()
    m_card = replay.record(step, states[dev], card_batch, draws)
    t1 = time.perf_counter()
    m_cpu = replay.replay(step, states["cpu"], batch, draws)
    t2 = time.perf_counter()
    own = step_mod.lsgan_generator_loss
    step_mod.lsgan_generator_loss = lambda score, target: 0.0 * score.sum()
    try:
        step(states["no_adv"], card_batch, draws)
    finally:
        step_mod.lsgan_generator_loss = own
    out = {"phase": "train_action_cpu", "batch": cfg.batch_size,
           "points": cfg.num_points, "iteration": states["cpu"].n_iter,
           "knn_tie_swaps": replay.swaps, "card_s": t1 - t0, "cpu_s": t2 - t1}
    hold_card_to_cpu(out, states, dev, m_card, m_cpu, before, mu_before,
                     ACTION_CARD_CPU_LOSS_TOL, ACTION_CARD_CPU_CHANGE_TOL)


# --------------------------------------- the train recipes as scripts run them

RECIPES_DIR = os.path.join(ROOT, "runs", "chip_smoke_train_recipes")  # gitignored
RECIPE_ITERS = 20004
# The scripts' CLI flags (scripts/train_vel_torch.sh, train_dir_torch.sh:
# the preset) with --synthetic, resumed from the checkpoints; no
# --device_sampling, no fused switch.
RECIPE_ARGS = {
    "fluid": ["--preset", "train_vel", "--synthetic", "--resume",
              "--path_to_resume", CHECKPOINT],
    "action": ["--preset", "train_dir", "--synthetic", "--resume",
               "--path_to_resume", ACTION_CHECKPOINT]}
# The native library's calls a batch of the recipes' host sampling
# (data/fluid.py, data/msr.py): a fluid item's patch search and its FPS
# downsample, 4 items a batch; an action clip's FPS downsample of each of
# its 3 frames, 4 clips a batch. The test split's batches (at the
# checkpoint iterations) sample the same way.
RECIPE_NATIVE = {"fluid": {"fps": 4, "knn_patch": 4},
                 "action": {"fps": 12, "knn_patch": 0}}
# The loader alone, native against plain on the same seeds: turns of
# LOADER_BATCHES batches each.
LOADER_TURNS = ("native", "plain", "plain", "native")
LOADER_BATCHES = 3
# Where the native library and the plain versions part (data/sampling.py's
# note): the library's f32 squared distances (fused multiply-adds under
# -march=native) against the kd-tree's f64 ones and numpy's separately
# rounded f32 ones. A patch must hold the kd-tree query's points but for
# those within this share of the k-th distance of it, in an order whose f64
# distances never fall by more than this share of the larger; each FPS pick
# must lie within this share of the farthest remaining distance (f64). A
# few ulps of f32 (2^-24 = 6e-8 a rounding).
LOADER_ROUNDING = 1e-6


def _host_cpu() -> dict:
    """The host CPU's model as lscpu and /proc/cpuinfo name it (a virtual
    machine's lscpu may say "unknown"), and the cores this process may
    use."""
    def field(text, key, sep=":"):
        return next((line.split(sep, 1)[1].strip()
                     for line in text.splitlines()
                     if line.lower().startswith(key)), "unknown")

    lscpu = subprocess.run(["lscpu"], capture_output=True, text=True,
                           timeout=60).stdout
    try:
        with open("/proc/cpuinfo") as fh:
            cpuinfo = fh.read()
    except OSError:
        cpuinfo = ""
    return {"model": field(lscpu, "model name"),
            "cpuinfo_model": field(cpuinfo, "model name"),
            "vendor": field(lscpu, "vendor id"),
            "family_model": [field(lscpu, "cpu family"),
                             field(lscpu, "model:")],
            "cores": len(os.sched_getaffinity(0))}


class LoaderProbe:
    """Times a train CLI's host loader where it runs: patches
    ``data/prefetch.prefetch_iterator`` (the train batches' only user) so
    that its producer thread makes the batches the recipe's own producer
    makes while ``steps`` steps run, when the loader keeps up: the one each
    step takes, the queue's ``size`` ready ones and the one it holds while
    it waits for a slot (``limit`` = steps + size + 1). So every step runs
    beside loader work. Each batch's making is timed there (``spans`` on
    the host clock, ``loader_ms``; ``overlap_ms`` is the share inside a
    step's window), and the consumer times each ``next`` the step waits
    for (``wait_ms``). Patches the batch iterator ``name`` of ``module`` to
    count every batch made (train and test splits). ``wait()`` returns
    once the producer has made its last batch; the thread then blocks on
    the full queue, as the recipe's does when its run ends, and what it
    holds is dropped."""

    def __init__(self, module, name, steps):
        self.module, self.name, self.steps = module, name, steps
        self.spans, self.wait_ms, self.made, self.limit = [], [], 0, None
        self.done = threading.Event()

    @property
    def loader_ms(self):
        return [(b - a) * 1e3 for a, b in self.spans]

    def overlap_ms(self, start, end):
        """The loader's work (ms) inside the host-clock window
        [start, end]."""
        return 1e3 * sum(max(0.0, min(b, end) - max(a, start))
                         for a, b in self.spans)

    def wait(self, timeout=600):
        if not self.done.wait(timeout):
            raise AssertionError(f"loader: {len(self.spans)} of {self.limit}"
                                 f" batches after {timeout} s")

    def __enter__(self):
        import itertools

        from tpugan_tpu_torch.data import prefetch as pf

        self.pf, self.orig_pf = pf, pf.prefetch_iterator
        self.orig_it = getattr(self.module, self.name)

        def counted(*a, **kw):
            for batch in self.orig_it(*a, **kw):
                self.made += 1
                yield batch

        def timed(it):          # runs in the producer thread
            it = itertools.islice(it, self.limit)
            try:
                while True:
                    t0 = time.perf_counter()
                    batch = next(it, None)
                    if batch is None:
                        return
                    self.spans.append((t0, time.perf_counter()))
                    if len(self.spans) == self.limit:
                        self.done.set()
                    yield batch
            finally:
                self.done.set()

        def prefetch(it, size=2):
            self.limit = self.steps + size + 1
            inner = self.orig_pf(timed(it), size)
            while True:
                t0 = time.perf_counter()
                batch = next(inner, None)
                if batch is None:
                    return
                self.wait_ms.append((time.perf_counter() - t0) * 1e3)
                yield batch

        pf.prefetch_iterator = prefetch
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        self.pf.prefetch_iterator = self.orig_pf
        setattr(self.module, self.name, self.orig_it)


class HostSampling:
    """The loader's two library entry points (``data/native.py : fps,
    knn_patch``) on the plain versions (``plain``) or on the library, every
    call recorded with its inputs and output in ``calls``."""

    def __init__(self, plain):
        self.plain, self.calls = plain, []

    def __enter__(self):
        from tpugan_tpu_torch.data import native
        from tpugan_tpu_torch.data import sampling as S

        self.native = native
        self.orig = {name: getattr(native, name) for name in S.PLAIN}

        def recorded(name):
            run = S.PLAIN[name] if self.plain else self.orig[name]

            def call(*args):
                out = run(*args)
                self.calls.append((name, *args, out))
                return out
            return call

        for name in S.PLAIN:
            setattr(native, name, recorded(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.native, name, fn)


def _library_call_vs_plain(call) -> dict:
    """One recorded library call against its plain version on the same
    inputs: equal, or apart only where LOADER_ROUNDING says they may be
    (raises otherwise). Returns the positions that differ."""
    from tpugan_tpu_torch.data import sampling as S

    kind, pts, a, b, got = call
    p64 = np.asarray(pts, np.float64)
    if kind == "knn_patch":
        seed, k = a, b
        want = S.knn_patch_plain(pts, seed, k)
        d = np.sum((p64 - p64[seed]) ** 2, -1)
        kth = d[want[-1]]
        extra = np.setxor1d(got, want)
        far = extra[np.abs(d[extra] - kth) > LOADER_ROUNDING * kth]
        dg = d[got]
        falls = dg[:-1] - dg[1:]
        if far.size or (falls > LOADER_ROUNDING * dg[:-1]).any():
            raise AssertionError(f"native patch: {far.size} points off the "
                                 f"kd-tree's set, order falls by "
                                 f"{float(falls.max())}")
        return {"kind": kind, "differ": int((got != want).sum()),
                "set_differs": int(extra.size)}
    k, start = a, b
    want = S.fps_plain(pts, k, start)
    if not np.array_equal(got, want):
        if got[0] != start:
            raise AssertionError("native FPS: wrong start")
        min_d = np.sum((p64 - p64[start]) ** 2, -1)
        for j in range(1, k):
            best = min_d.max()
            if min_d[got[j]] < best * (1.0 - LOADER_ROUNDING):
                raise AssertionError(f"native FPS pick {j}: {min_d[got[j]]} "
                                     f"of the farthest {best}")
            np.minimum(min_d, np.sum((p64 - p64[got[j]]) ** 2, -1), out=min_d)
    return {"kind": kind, "differ": int((got != want).sum()),
            "set_differs": 0}


def loader_turns(make_batches) -> dict:
    """The loader alone, in LOADER_TURNS: each turn LOADER_BATCHES batches
    from ``make_batches()`` (a fresh iterator on the same seeds), its host
    sampling on the library or on the plain versions, ms a batch (host
    clock). Every library call is then held to its plain version on the
    same inputs (_library_call_vs_plain), and each native batch is
    compared with the plain one, array for array."""
    ms = {"native": [], "plain": []}
    batches, calls = {}, []
    for mode in LOADER_TURNS:
        it = make_batches()
        with HostSampling(plain=mode == "plain") as hs:
            got = []
            for _ in range(LOADER_BATCHES):
                t0 = time.perf_counter()
                got.append(next(it))
                ms[mode].append((time.perf_counter() - t0) * 1e3)
        it.close()
        batches.setdefault(mode, got)
        if mode == "native":
            calls += hs.calls
    checked = [_library_call_vs_plain(c) for c in calls]
    arrays, equal, elements = 0, 0, 0
    for a, b in zip(batches["native"], batches["plain"]):
        if set(a) != set(b):
            raise AssertionError(f"loader: keys {sorted(a)} vs {sorted(b)}")
        for key in a:
            if a[key].shape != b[key].shape or a[key].dtype != b[key].dtype:
                raise AssertionError(f"loader {key}: {a[key].shape} "
                                     f"{a[key].dtype} vs {b[key].shape} "
                                     f"{b[key].dtype}")
            arrays += 1
            equal += bool(np.array_equal(a[key], b[key]))
            elements += int((a[key] != b[key]).sum())
    return {"turns": list(LOADER_TURNS), "batches_a_turn": LOADER_BATCHES,
            "native_ms_per_batch": ms["native"],
            "plain_ms_per_batch": ms["plain"],
            "native_median_ms": statistics.median(ms["native"]),
            "plain_median_ms": statistics.median(ms["plain"]),
            "library_calls_checked": len(checked),
            "library_calls_equal_to_plain": sum(c["differ"] == 0
                                                for c in checked),
            "library_positions_apart_within_rounding": sum(
                c["differ"] for c in checked),
            "patch_points_apart_at_kth_distance": sum(
                c["set_differs"] for c in checked),
            "batch_arrays_equal": [equal, arrays],
            "batch_elements_apart": elements}


def _recipe_spec(name):
    """The recipe's CLI, argv (its script's preset, --synthetic, resumed
    from the checkpoint for iterations 20001-20004, no --device_sampling,
    no fused switch), the launches a step and between steps, and a maker of
    its loader's batches on the data the CLI wrote."""
    log_dir = os.path.join(RECIPES_DIR, name)
    if name == "fluid":
        from tpugan_tpu_torch.cli import train_fluid as cli
        from tpugan_tpu_torch.data import fluid as data
        from tpugan_tpu_torch.train.step import FluidTrainConfig

        argv = RECIPE_ARGS[name]
        opt = cli.get_arguments(argv + ["--log_dir", log_dir])
        cfg = FluidTrainConfig()

        def make_batches():     # as cli/train_fluid.main makes them
            ds = data.SiamFluidDataset(
                os.path.join(log_dir, "synthetic_data"), opt.synthetic_cases,
                opt.synthetic_steps, sample_num=opt.patch_size or 9216,
                fps_ratio=cfg.fps_ratio,
                jitter=cfg.jitter, seed=opt.seed, emit_lowres=True)
            return data.fluid_batch_iterator(ds, opt.batch_size, seed=opt.seed)

        return dict(cli=cli, data=data, iterator="fluid_batch_iterator",
                    argv=argv, log_dir=log_dir, make_batches=make_batches,
                    always=STEP_ALWAYS, gate=STEP_GATE, critics=STEP_CRITICS,
                    between=CKPT_EVAL)
    from tpugan_tpu_torch.cli import train_action as cli
    from tpugan_tpu_torch.config import ActionTrainConfig
    from tpugan_tpu_torch.data import msr as data

    argv = RECIPE_ARGS[name]
    opt = cli.get_arguments(argv + ["--log_dir", log_dir])
    cfg = ActionTrainConfig(num_points=opt.num_points, seed=opt.seed)

    def make_batches():         # as cli/train_action.main makes them
        ds = data.MSRAction3DDataset(
            os.path.join(log_dir, "synthetic_msr"),
            frames_per_clip=cfg.frames_per_clip, num_points=cfg.num_points,
            fps_ratio=cfg.fps_ratio, seed=cfg.seed, return_lowres=True)
        return data.action_batch_iterator(ds, opt.batch_size, seed=cfg.seed)

    return dict(cli=cli, data=data, iterator="action_batch_iterator",
                argv=argv, log_dir=log_dir, make_batches=make_batches,
                always=ACTION_STEP_ALWAYS, gate=ACTION_STEP_G,
                critics=ACTION_STEP_CRITICS, between=ACTION_CKPT_EVAL)


def train_recipes(torch, dev, kernels, smi):
    """Both train recipes as their scripts run them (scripts/train_vel_
    torch.sh, scripts/train_dir_torch.sh: the preset, host sampling, no
    fused switch), with --synthetic, resumed from the checkpoints for
    iterations 20001-20004 (runs/chip_smoke_train_recipes/). Counts (and
    the native library's calls) reset just before each CLI run: each step's
    launches against the device-sampling counts less device sampling's one
    FPS (no EdgeConv launch: the switch is off), the checkpoint iterations'
    evals between steps, every loss finite; the native library's calls a
    batch (RECIPE_NATIVE); the loader's ms a batch in the producer thread,
    each step's wait on the prefetch queue and its ms (CUDA events). Then
    the loader alone, native against plain in turns (loader_turns), beside
    the host CPU and the card. Returns the runs' launches and the native
    library's line."""
    import shutil

    from tpugan_tpu_torch.data import native

    host, lines, launches = _host_cpu(), {}, {}
    for name in ("fluid", "action"):
        spec = _recipe_spec(name)
        cli = spec["cli"]
        shutil.rmtree(spec["log_dir"], ignore_errors=True)
        if os.environ.get(cli.FUSED_SWITCH):
            raise AssertionError("the fused switch is set; the scripts run "
                                 "without it")
        marks = []

        def hook(event, n_iter, metrics):
            if event in ("start", "end"):
                torch.cuda.synchronize()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((event, n_iter, counts(kernels), ev, metrics,
                          time.perf_counter()))

        for k in kernels.values():
            k.launches = 0
        for k in native.CALLS:
            native.CALLS[k] = 0
        t0 = time.perf_counter()
        with LoaderProbe(spec["data"], spec["iterator"],
                         RECIPE_ITERS - 20000) as probe:
            out = cli.main(spec["argv"] + ["--iters", str(RECIPE_ITERS),
                                           "--log_dir", spec["log_dir"]],
                           hook=hook)
            probe.wait()
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches[name] = counts(kernels)
        calls = dict(native.CALLS)
        for k in kernels.values():
            k.launches = 0

        ckpt_iter = lambda n: (n - 1) % 10000 == 0 or n >= RECIPE_ITERS
        by, steps = {}, []
        for event, n_iter, c, ev, metrics, wall in marks:
            by.setdefault(n_iter, {})[event] = (c, ev, metrics, wall)
        prev_counts, prev_iter = {n: 0 for n in launches[name]}, None
        for n_iter in sorted(by):
            m = by[n_iter]
            expect(delta(prev_counts, m["start"][0]),
                   spec["between"] if prev_iter and ckpt_iter(prev_iter)
                   else {}, f"{name} recipe before iteration {n_iter}")
            metrics = m["end"][2]
            gate = metrics.get("gate", True)
            d_update = gate and n_iter % 2 == 0
            want = dict(spec["always"])
            want["fps"] -= 1                 # no device sampling
            for part in ([spec["gate"]] if gate else []) + (
                    [spec["critics"]] if d_update else []):
                for k, v in part.items():
                    want[k] = want.get(k, 0) + v
            got = delta(m["start"][0], m["end"][0])
            expect(got, want, f"{name} recipe step {n_iter}")
            for k, v in metrics.items():
                if not np.isfinite(v):
                    raise AssertionError(f"{name} recipe {n_iter}: {k} = {v}")
            start, crit = m["start"][1], m["critics"][1]
            steps.append(dict(iteration=n_iter, **metrics,
                              critic_update=d_update, launches=got,
                              ms=start.elapsed_time(crit),
                              wall_ms=(m["end"][3] - m["start"][3]) * 1e3,
                              loader_ms_beside=probe.overlap_ms(
                                  m["start"][3], m["end"][3])))
            prev_counts, prev_iter = m["end"][0], n_iter
        expect(delta(prev_counts, launches[name]), spec["between"],
               f"{name} recipe after the last step")
        if [s["iteration"] for s in steps] != list(range(20001,
                                                         RECIPE_ITERS + 1)):
            raise AssertionError(f"{name} recipe ran "
                                 f"{[s['iteration'] for s in steps]}")
        per_batch = {k: v / probe.made for k, v in calls.items()}
        want_calls = dict(RECIPE_NATIVE[name], radius_count=0,
                          voxel_downsample=0)
        if (len(probe.spans) != probe.limit or probe.made <= probe.limit
                or per_batch != want_calls):
            raise AssertionError(f"{name} recipe: {probe.made} batches, "
                                 f"{len(probe.spans)} of {probe.limit} from "
                                 f"the producer, native calls a batch "
                                 f"{per_batch}")
        test_cd = out["test_chamfer"]
        if len(test_cd) != 2 or not all(np.isfinite(test_cd)):
            raise AssertionError(f"{name} recipe test Chamfer {test_cd}")
        turns = loader_turns(spec["make_batches"])
        lines[name] = {
            "phase": "train_recipes", "recipe": name,
            "argv": spec["argv"] + ["--iters", str(RECIPE_ITERS)],
            "device_sampling": False, "steps": steps, "cli_s": cli_s,
            "test_chamfer": test_cd, "launches": launches[name],
            "native_calls": calls, "batches_sampled": probe.made,
            "native_calls_per_batch": per_batch,
            "loader_ms_per_batch": probe.loader_ms,
            "loader_ms_beside_step": [s["loader_ms_beside"] for s in steps],
            "queue_wait_ms_per_step": probe.wait_ms,
            "ms_per_step": [s["ms"] for s in steps],
            "wall_ms_per_step": [s["wall_ms"] for s in steps],
            "loader_alone": turns, "host_cpu": host, "card": smi}
        emit(lines[name])
    library = {"phase": "native_library",
               "source": "tpugan_tpu_torch/native/tpugan_native.cpp",
               "counterpart": "native/tpugan_native.cpp (tpugan_tpu/data/"
                              "native.py)",
               "compiler": native.compiler(), "flags": list(native.CXXFLAGS),
               "library": os.path.relpath(native.library_path(), ROOT),
               "host_cpu": host, "card": smi,
               **{f"{n}_loader": {
                   "calls_per_batch": lines[n]["native_calls_per_batch"],
                   "native_median_ms": lines[n]["loader_alone"][
                       "native_median_ms"],
                   "plain_median_ms": lines[n]["loader_alone"][
                       "plain_median_ms"]} for n in lines}}
    return launches, library


# ------------------------------------- the stacked-critic train path (fast_d)

FAST_D_DIR = os.path.join(ROOT, "runs", "chip_smoke_train_fast_d")   # gitignored
ACTION_FAST_D_DIR = os.path.join(ROOT, "runs",
                                 "chip_smoke_train_action_fast_d")    # gitignored
FAST_D_ITERS = 20004
# Launches per step with --fast_d, read off tpugan_tpu_torch/train/step.py
# and models/discriminator.py (the wrappers count one per call):
#   fluid, gate open: the spatial critic's generator pass as without fast_d
#     (3 FPS, 3 ball queries, 4 pooled-MLP forwards and backwards), the
#     dense interp, the temporal critic's frames stacked: 2 FPS and 2 ball
#     queries (sa1 and sa2 once each), 3 flow kNN;
#   fluid critic update: one temporal apply on [fake; real] with the frames
#     stacked (2 FPS, 2 ball queries, 3 flow kNN on [2B] rows) and one
#     spatial apply on [fake; real] (3 FPS, 3 ball queries), whose stages
#     take the plain stack under stat_groups(2): no pooled-MLP launch;
#   action generator pass: the spatial critic's 3 FPS and 3 ball queries,
#     the stacked temporal critic's 2 and 2 and 3 flow kNN; its critic
#     update: the same counts on [2B] rows.
STEP_GATE_FAST_D = {"fps": 5, "ball_query": 5, "pooled_mlp_fwd": 4,
                    "pooled_mlp_bwd": 4, "interp": 1, "knn": 3}
STEP_CRITICS_FAST_D = {"fps": 5, "ball_query": 5, "knn": 3}
ACTION_STEP_G_FAST_D = {"fps": 5, "ball_query": 5, "knn": 3}
ACTION_STEP_CRITICS_FAST_D = {"fps": 5, "ball_query": 5, "knn": 3}
# The shapes that stacking gives the kernels (B = 4), each with its launches
# per fast-d G+D step of the fluid and of the action workload; the shapes
# the fast-d step shares with the sequential one are the kernel rows above.
# (The generator pass's frame-stacked FPS is the sequential step's own,
# _stacked_fps: FPS_SHAPES and ACTION_TRAIN_FPS hold it.)
FAST_D_FPS = [  # (stage, rows, N, m, rows masked, per fluid, per action)
    ("fluid tempo sa1 update (fake; real)", 24, 9216, 1024, 12, 1, 0),
    ("fluid tempo sa2 update (fake; real)", 24, 1024, 256, 0, 1, 0),
    ("fluid spatial sa_0 update (fake; real)", 8, 9216, 1024, 4, 1, 0),
    ("fluid spatial sa_1 update (fake; real)", 8, 1024, 512, 0, 1, 0),
    ("fluid spatial sa_2 update (fake; real)", 8, 512, 128, 0, 1, 0),
    ("action tempo sa1 update (fake; real)", 24, 2048, 512, 0, 0, 1),
    ("action tempo sa2 update (fake; real)", 24, 512, 256, 0, 0, 1),
    ("action spatial sa_0 update (fake; real)", 8, 2048, 512, 0, 0, 1),
    ("action spatial sa_1 update (fake; real)", 8, 512, 256, 0, 0, 1),
    ("action spatial sa_2 update (fake; real)", 8, 256, 128, 0, 0, 1),
]
FAST_D_BALL = [  # (stage, B, Nq, Nc, radius, nsample, scale, per fluid,
    #               per action)
    ("fluid tempo sa1 (frames stacked)", 12, 1024, 9216, 0.10, 32, 0.3, 1, 0),
    ("fluid tempo sa2 (frames stacked)", 12, 256, 1024, 0.20, 32, 0.3, 1, 0),
    ("fluid tempo sa1 update (fake; real)", 24, 1024, 9216, 0.10, 32, 0.3,
     1, 0),
    ("fluid tempo sa2 update (fake; real)", 24, 256, 1024, 0.20, 32, 0.3,
     1, 0),
    ("fluid spatial sa_0 update (fake; real)", 8, 1024, 9216, 0.15, 32, 0.3,
     1, 0),
    ("fluid spatial sa_1 update (fake; real)", 8, 512, 1024, 0.30, 32, 0.3,
     1, 0),
    ("fluid spatial sa_2 update (fake; real)", 8, 128, 512, 0.60, 16, 0.3,
     1, 0),
    ("action tempo sa1 (frames stacked)", 12, 512, 2048, 0.8, 64, 0.2, 0, 2),
    ("action tempo sa2 (frames stacked)", 12, 256, 512, 1.2, 32, 0.2, 0, 2),
    ("action tempo sa1 update (fake; real)", 24, 512, 2048, 0.8, 64, 0.2,
     0, 1),
    ("action tempo sa2 update (fake; real)", 24, 256, 512, 1.2, 32, 0.2,
     0, 1),
    ("action spatial sa_0 update (fake; real)", 8, 512, 2048, 0.3, 32, 0.2,
     0, 1),
    ("action spatial sa_1 update (fake; real)", 8, 256, 512, 0.6, 32, 0.2,
     0, 1),
    ("action spatial sa_2 update (fake; real)", 8, 128, 256, 1.0, 32, 0.2,
     0, 1),
]
# the flow embeddings' kNN on the stacked update's [2B] rows of the 256 sa2
# centres (3 a G+D step of each workload)
FAST_D_KNN = ("flow embedding update (fake; real)", 8, 256, 256, 3, 32, 3, 3)
# fast_d_critics: stacked against sequential applies with the checkpoints'
# critic weights, spectral norm frozen. Scores to FAST_D_SCORE_TOL of
# max(1, |score|), running moments to FAST_D_BN_TOL of max(1, |moment|)
# (the action tower's under FAST_D_BN_ORDER_TOL: the stacked apply steps
# its averages frame-major over (fake, real), the sequential applies
# source-major, as in the JAX package's tests/test_fast_d.py).
FAST_D_SCORE_TOL = 1e-3
FAST_D_BN_TOL = 1e-4
FAST_D_BN_ORDER_TOL = 5e-3
# The fast-d card-vs-CPU step: B = 4 (at 2 the heads' batch norms over
# two items amplify f32 noise past the tolerances, see
# tests/test_torch_fast_d.py) of 1,024-point patches.
FAST_D_CPU_BATCH = 4


def _fps_half_masked(torch, dev, rng, rows, n, masked):
    """(pos, penalty, start) of a stacked FPS stage whose first ``masked``
    rows (the fake half) carry a hard-masked tail (the last n // 8 points
    at 999 and -1e10), the rest none."""
    pos = _cloud(torch, dev, rng, rows, n, 3)
    pen = torch.zeros((rows, n), device=dev)
    cut = n - n // 8
    pen[:masked, cut:] = -1e10
    pos[:masked, cut:] = 999.0
    start = torch.from_numpy(rng.integers(0, cut, rows)).to(dev)
    return pos, pen, start


def check_fast_d_kernels(torch, dev):
    """The kernels at the shapes stacking gives them: FPS (mask-aware on
    the fake half's rows), the ball query and the flow kNN on [2B] rows,
    each against its plain version index for index (kNN within f32 ties),
    with its launch plan, its device time and two launches bit for bit.
    Returns {kernel: rows}, each row with ``per_fast_d_step`` and
    ``per_action_fast_d_step``."""
    from tpugan_tpu_torch.ops.kernels import fps as F
    from tpugan_tpu_torch.ops.kernels import knn as K

    rng = np.random.default_rng(22)
    out = {"fps": [], "ball_query": [], "knn": []}

    def add(kernel, row, per, per_action):
        out[kernel].append(dict({"path": "fast_d"}, **row,
                                per_fast_d_step=per,
                                per_action_fast_d_step=per_action))
        emit({"phase": "kernel", "kernel": kernel, **out[kernel][-1]})

    for stage, rows, n, m, masked, per, per_a in FAST_D_FPS:
        pos, pen, start = _fps_half_masked(torch, dev, rng, rows, n, masked)
        row = _fps_row(torch, F, stage, rows, n, m, pos, pen, start)
        again = [F.fps_kernel(pos, m, pen, start) for _ in range(2)]
        row["repeat_bit_equal"] = bool(torch.equal(*again))
        row["masked_rows"] = masked
        if not row["repeat_bit_equal"]:
            raise AssertionError(f"fps {stage}: two launches differ")
        add("fps", row, per, per_a)
    for stage, b, nq, nc, r, ns, scale, per, per_a in FAST_D_BALL:
        # every ninth candidate masked on the fluid rows, as check_ball_query
        add("ball_query", _ball_row(torch, dev, rng, stage, b, nq, nc, r, ns,
                                    scale=scale, masked=per > 0), per, per_a)
    graph, b, nq, nc, d, k, per, per_a = FAST_D_KNN
    row = _knn_row(torch, dev, rng, graph, b, nq, nc, d, k, False, 0.2)
    q = _cloud(torch, dev, rng, b, nq, d, scale=0.2)
    c = _cloud(torch, dev, rng, b, nc, d, scale=0.2)
    bias = torch.zeros((b, nc), device=dev)
    again = [K.knn_kernel(q, c, bias, k)[1] for _ in range(2)]
    run = lambda: K.knn_kernel(q, c, bias, k)
    # csrc/knn.cu: 4 queries a warp, 256 threads a block
    add("knn", dict(graph=graph, **row, threads=256, queries_a_block=32,
                    blocks=-(-nq // 32) * b, device_ms=device_ms(run, torch),
                    repeat_bit_equal=bool(torch.equal(*again))), per, per_a)
    if not out["knn"][-1]["repeat_bit_equal"]:
        raise AssertionError("knn fast_d: two launches differ")
    return out


class frozen_spectral_norm:
    """Spectral norms that use their one power step but never store it, so
    every call sees the same normalised weights: a stacked apply advances
    each once, the sequential calls once each."""

    def __enter__(self):
        from tpugan_tpu_torch.nn.layers import SpectralNorm

        self.cls, self.own = SpectralNorm, SpectralNorm.forward
        SpectralNorm.forward = lambda m, w, update_stats: self.own(m, w, False)

    def __exit__(self, *exc):
        self.cls.forward = self.own


class pooled_moments:
    """Runs the critics' stacked applies with G = 1 (the lossy control):
    every ``stat_groups`` a module enters keeps 1 group, so each batch norm
    pools the moments of all the stacked calls."""

    def __enter__(self):
        import tpugan_tpu_torch.models.discriminator as disc
        import tpugan_tpu_torch.train.step as step_mod
        from tpugan_tpu_torch.nn.layers import stat_groups

        self.mods, self.own = (disc, step_mod), stat_groups
        for m in self.mods:
            m.stat_groups = lambda n: stat_groups(1)

    def __exit__(self, *exc):
        for m in self.mods:
            m.stat_groups = self.own


def _rel_err(got, want):
    """max |got - want| / max(1, max |want|)."""
    want = want.detach().float()
    return float((got.detach().float() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def _bn_errors(module, ref):
    """Largest ``_rel_err`` of each BatchNorm running moment of two modules,
    and its key."""
    a, b = module.state_dict(), ref.state_dict()
    errs = {k: _rel_err(a[k], b[k]) for k in a
            if k.endswith((".mean", ".var"))}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def _critic_case(name, stacked, sequential, lossy, bn_tol):
    """The row of one fast_d_critics check: ``stacked``, ``sequential`` and
    ``lossy`` are (scores, module) after their applies; raises unless the
    stacked apply holds the tolerances and the lossy control fails them."""
    score_err = _rel_err(stacked[0], sequential[0])
    bn_err, bn_key = _bn_errors(stacked[1], sequential[1])
    lossy_score = _rel_err(lossy[0], sequential[0])
    lossy_bn, _ = _bn_errors(lossy[1], sequential[1])
    row = {"phase": "fast_d_critics", "check": name,
           "score_rel_err": score_err, "score_tol": FAST_D_SCORE_TOL,
           "bn_rel_err": bn_err, "bn_worst": bn_key, "bn_tol": bn_tol,
           "lossy_score_rel_err": lossy_score, "lossy_bn_rel_err": lossy_bn}
    emit(row)
    if score_err > FAST_D_SCORE_TOL or bn_err > bn_tol:
        raise AssertionError(f"fast_d_critics {name}: {row}")
    if lossy_score <= FAST_D_SCORE_TOL and lossy_bn <= bn_tol:
        raise AssertionError(f"fast_d_critics {name}: the G = 1 control "
                             f"passes: {row}")
    return row


def fast_d_critics(torch, dev):
    """Stacked against sequential critic applies at full width with the
    checkpoints' critic weights, spectral norm frozen, dropout off, train
    mode: (a) the fluid temporal critic's frame-stacked apply against its
    per-frame loop on 4 x 3 frames of 9,216 points (each frame rotated, as
    the critic update rotates them, a hard-masked tail on every frame);
    (b) the action temporal tower on [fake; real] under stat_groups(2)
    against its two sequential applies (4 clips x 3 frames of 2,048
    points, "fake" another batch of clips than "real"); (c)
    the fluid spatial critic on [fake; real] under stat_groups(2), whose
    stages take the plain stack, against its two sequential calls, which
    take the pooled-MLP batch-norm kernel (G = 1). Each: the scores and
    every batch norm's running moments against the tolerances; then the
    stacked apply with G = 1, which pools the moments, must fail them."""
    import copy

    from tpugan_tpu_torch import DT
    from tpugan_tpu_torch.checkpoint import (load_action_trainer_state,
                                             load_trainer_state)
    from tpugan_tpu_torch.config import ActionTrainConfig
    from tpugan_tpu_torch.nn.layers import stat_groups
    from tpugan_tpu_torch.ops.kernels import pooled_mlp
    from tpugan_tpu_torch.train.step import (FluidTrainConfig, rotate_frames,
                                             rotation_matrix)

    gen = torch.Generator().manual_seed(22)
    cfg = FluidTrainConfig()
    state = load_trainer_state(CHECKPOINT, cfg, device=dev)
    batch = fluid_batches(torch, dev, cfg.patch_size, cfg.batch_size, 1)[0]
    b, n = cfg.batch_size, cfg.patch_size
    rots = rotation_matrix(torch.rand(3, 3, generator=gen) * 2 * math.pi)
    pos = rotate_frames(batch["highres_pos"], rots.to(dev))
    feat = rotate_frames(batch["highres_vel"] * DT, rots.to(dev))
    valid = torch.ones((3, b, n), dtype=torch.bool, device=dev)
    valid[:, :, n - n // 8:] = False
    pos[~valid] = 999.0
    keep = lambda rows: [torch.ones(rows, 256, device=dev)]
    rows = []
    with frozen_spectral_norm(), torch.no_grad():
        # (a) the fluid temporal critic: frames stacked against the loop
        tempo = {k: copy.deepcopy(state.tempo.module) for k in ("stk", "seq",
                                                                "lossy")}
        call = lambda m, stack: m(list(pos), cfg.R, feat_lst=list(feat),
                                  valid_lst=list(valid), train=True,
                                  keep=keep(b), stack_frames=stack)
        seq = call(tempo["seq"], False)
        stk = call(tempo["stk"], True)
        with pooled_moments():
            lossy = call(tempo["lossy"], True)
        rows.append(_critic_case(
            "fluid tempo: frames stacked vs per-frame loop",
            (stk, tempo["stk"]), (seq, tempo["seq"]), (lossy, tempo["lossy"]),
            FAST_D_BN_TOL))

        # (c) the fluid spatial critic: [fake; real] against two calls
        spatial = {k: copy.deepcopy(state.spatial.module)
                   for k in ("stk", "seq", "lossy")}
        fake, real = pos[2], batch["highres_pos"][1]
        both = torch.cat([fake, real])
        both_valid = torch.cat([valid[2], torch.ones_like(valid[2])])
        f0 = pooled_mlp.FWD.launches
        f_seq = spatial["seq"](fake, valid[2], train=True, keep=keep(b))
        t_seq = spatial["seq"](real, None, train=True, keep=keep(b))
        fused = pooled_mlp.FWD.launches - f0
        f0 = pooled_mlp.FWD.launches
        with stat_groups(2):
            s_stk = spatial["stk"](both, both_valid, train=True,
                                   keep=keep(2 * b))
        stacked_fused = pooled_mlp.FWD.launches - f0
        s_lossy = spatial["lossy"](both, both_valid, train=True,
                                   keep=keep(2 * b))
        if (fused, stacked_fused) != (8, 0):
            raise AssertionError(f"fast_d_critics: pooled-MLP launches "
                                 f"{fused} sequential, {stacked_fused} "
                                 f"stacked; expected 8 and 0")
        row = _critic_case(
            "fluid spatial: [fake; real] plain stack (G = 2) vs two calls "
            "on the pooled-MLP kernel", (s_stk, spatial["stk"]),
            (torch.cat([f_seq, t_seq]), spatial["seq"]),
            (s_lossy, spatial["lossy"]), FAST_D_BN_TOL)
        row.update(pooled_mlp_fwd_sequential=fused,
                   pooled_mlp_fwd_stacked=stacked_fused)
        rows.append(row)

        # (b) the action temporal tower: [fake; real] against two applies
        acfg = ActionTrainConfig(device_sampling=True)
        astate = load_action_trainer_state(ACTION_CHECKPOINT, acfg, dev)
        root = os.path.join(ACTION_TRAIN_DIR, "synthetic_msr")
        real, fake = (b["highres_pos"] for b in action_batches(
            torch, dev, root, acfg, 2, seed=22))
        tower = {k: copy.deepcopy(astate.tempo.module.tower)
                 for k in ("stk", "seq", "lossy")}
        f_seq = tower["seq"](list(fake), acfg.R, train=True)
        t_seq = tower["seq"](list(real), acfg.R, train=True)
        both = [torch.cat([f, t]) for f, t in zip(fake, real)]
        with stat_groups(2):
            s_stk = tower["stk"](both, acfg.R, train=True, stack_frames=True)
        with pooled_moments():
            s_lossy = tower["lossy"](both, acfg.R, train=True,
                                     stack_frames=True)
        rows.append(_critic_case(
            "action tower: [fake; real] under stat_groups(2) vs two applies",
            (s_stk, tower["stk"]), (torch.cat([f_seq, t_seq]), tower["seq"]),
            (s_lossy, tower["lossy"]), FAST_D_BN_ORDER_TOL))
    return rows


def _fast_d_spec(action):
    """What differs between the two workloads' fast-d phases."""
    from tpugan_tpu_torch.checkpoint import (load_action_trainer_state,
                                             load_trainer_state)
    from tpugan_tpu_torch.config import ActionTrainConfig
    from tpugan_tpu_torch.train.step import FluidTrainConfig

    if action:
        from tpugan_tpu_torch.cli import train_action as cli
        from tpugan_tpu_torch.train.step import ActionGanStep as Step

        cfg = ActionTrainConfig(iters=FAST_D_ITERS, device_sampling=True,
                                fast_d=True)
        return dict(
            phase="train_action_fast_d", cli=cli, step=Step, cfg=cfg,
            tally=("edgeconv_tc", "edgeconv_f32t", "edgeconv_bwd_tiled"),
            argv=["--preset", "train_dir"], log_dir=ACTION_FAST_D_DIR,
            checkpoint=ACTION_CHECKPOINT, load=load_action_trainer_state,
            between=ACTION_CKPT_EVAL,
            per_step=[ACTION_STEP_ALWAYS, ACTION_STEP_FUSED,
                      ACTION_STEP_G_FAST_D],
            critics=ACTION_STEP_CRITICS_FAST_D)
    from tpugan_tpu_torch.cli import train_fluid as cli
    from tpugan_tpu_torch.train.step import FluidGanStep as Step

    return dict(
        phase="train_fast_d", cli=cli, step=Step,
        tally=("edgeconv_bwd_tiled",),
        cfg=FluidTrainConfig(fast_d=True), argv=["--preset", "train_vel"],
        log_dir=FAST_D_DIR, checkpoint=CHECKPOINT, load=load_trainer_state,
        between=CKPT_EVAL,
        per_step=[STEP_ALWAYS, STEP_FUSED, {"edgeconv_bwd_tiled":
                                            STEP_TILED_BWD}],
        gate=STEP_GATE_FAST_D, critics=STEP_CRITICS_FAST_D)


def train_fast_d(torch, dev, kernels, action=False, profile_dir=None):
    """The train CLI twin (fluid, or with ``action`` the action one) called
    as a function with --fast_d and TPUGAN_FUSED_EDGECONV_TRAIN=1, its
    preset (train_vel / train_dir), --device_sampling --synthetic, resumed
    from the checkpoint for iterations 20001-20004 (log dir under runs/).
    Counts reset just before; each step's launches against the fast-d
    counts, the windows between steps against the checkpoint iterations'
    evals; every loss finite; the critics' parameters moved on the
    iterations whose critics update (even, the gate open) and only there;
    the last checkpoint read back equal to the state in memory; ms per step
    (G only and G+D) in CUDA events and the peak device memory of the CLI.
    Then (:func:`fast_d_turns`) fast-d and sequential steps in turns, and
    one fast-d step on the card and on the CPU. Returns the CLI's
    launches."""
    import shutil

    from tpugan_tpu_torch.ops.kernels import edgeconv as E

    spec = _fast_d_spec(action)
    cli, step_cls = spec["cli"], spec["step"]
    shutil.rmtree(spec["log_dir"], ignore_errors=True)
    argv = spec["argv"] + [
        "--device_sampling", "--synthetic", "--fast_d", "--resume",
        "--path_to_resume", spec["checkpoint"], "--iters", str(FAST_D_ITERS),
        "--log_dir", spec["log_dir"]]
    variants = {"edgeconv_tc": lambda: E.TC_LAUNCHES,
                "edgeconv_f32t": lambda: E.F32_TILED_LAUNCHES,
                "edgeconv_bwd_tiled": lambda: E.F32_TILED_BWD_LAUNCHES}
    tally = lambda: {**counts(kernels),
                     **{n: variants[n]() for n in spec["tally"]}}
    marks, moved = {}, {}
    own_call = step_cls.__call__

    def watched(self, state, batch, draws=None, mark=None):
        """The step between two snapshots of the critics, timed apart from
        them: launches, CUDA events at its start, after the generator's and
        after the critics' update, and its host wall time."""
        cur = state.n_iter + 1
        before = _critic_state(state)
        torch.cuda.synchronize()
        ev = {n: torch.cuda.Event(enable_timing=True)
              for n in ("start", "generator", "critics")}
        c0 = tally()
        ev["start"].record()
        t0 = time.perf_counter()
        metrics = own_call(self, state, batch, draws,
                           lambda n: (ev[n].record(),
                                      mark(n) if mark else None))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        marks[cur] = (c0, tally(), ev, wall, metrics)
        after = _critic_state(state)
        moved[cur] = {f"{n}_{k}": _moved(before, after, n, k)
                      for n in ("tempo", "spatial")
                      for k in ("param", "bn", "u")}
        return metrics

    for k in kernels.values():
        k.launches = 0
    E.TC_LAUNCHES = E.F32_TILED_LAUNCHES = E.F32_TILED_BWD_LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    os.environ[cli.FUSED_SWITCH] = "1"
    step_cls.__call__ = watched
    t0 = time.perf_counter()
    try:
        out = cli.main(argv)
    finally:
        step_cls.__call__ = own_call
        del os.environ[cli.FUSED_SWITCH]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = tally()
    for k in kernels.values():
        k.launches = 0

    ckpt_iter = lambda n: (n - 1) % 10000 == 0 or n >= FAST_D_ITERS
    steps, prev, prev_iter = [], {n: 0 for n in launches}, None
    for n_iter in sorted(marks):
        c0, c1, ev, wall, metrics = marks[n_iter]
        expect(delta(prev, c0), spec["between"] if prev_iter and
               ckpt_iter(prev_iter) else {},
               f"{spec['phase']} before iteration {n_iter}")
        gate = metrics.get("gate", True)
        d_update = gate and n_iter % 2 == 0
        want = {}
        for part in spec["per_step"] + ([spec["gate"]] if gate and "gate"
                                        in spec else []) + (
                [spec["critics"]] if d_update else []):
            for name, v in part.items():
                want[name] = want.get(name, 0) + v
        got = delta(c0, c1)
        expect(got, want, f"{spec['phase']} step {n_iter}")
        for name, v in metrics.items():
            if not np.isfinite(v):
                raise AssertionError(f"{spec['phase']} {n_iter}: {name} = {v}")
        mv = moved[n_iter]
        if any(mv[f"{n}_param"] != d_update for n in ("tempo", "spatial")):
            raise AssertionError(f"{spec['phase']} {n_iter}: critic params "
                                 f"moved {mv}, critic update {d_update}")
        steps.append(dict(iteration=n_iter, **metrics, critic_update=d_update,
                          launches=got, moved=mv,
                          ms=ev["start"].elapsed_time(ev["critics"]),
                          generator_ms=ev["start"].elapsed_time(
                              ev["generator"]),
                          critics_ms=ev["generator"].elapsed_time(
                              ev["critics"]), wall_ms=wall))
        emit({"phase": spec["phase"], **steps[-1]})
        prev, prev_iter = c1, n_iter
    expect(delta(prev, launches), spec["between"],
           f"{spec['phase']} after the last step")
    if [s["iteration"] for s in steps] != list(range(20001, FAST_D_ITERS + 1)):
        raise AssertionError(f"{spec['phase']} ran "
                             f"{[s['iteration'] for s in steps]}")
    if not any(s["critic_update"] for s in steps):
        raise AssertionError(f"{spec['phase']}: no critic update ran")
    back = spec["load"](out["checkpoint"], spec["cfg"], dev)
    differs = _state_equal(out["state"], back)
    if differs is not None:
        raise AssertionError(f"{spec['phase']} checkpoint read back differs: "
                             f"{differs}")
    test_cd = out["test_chamfer"]
    if len(test_cd) != 2 or not all(np.isfinite(test_cd)):
        raise AssertionError(f"{spec['phase']} test Chamfer {test_cd}")
    emit({"phase": spec["phase"],
          "resumed_from": os.path.relpath(spec["checkpoint"], ROOT),
          "checkpoint": os.path.relpath(out["checkpoint"], ROOT),
          "checkpoint_read_back_equal": True, "test_chamfer": test_cd,
          "steps": len(steps), "cli_s": total_s, "launches": launches,
          "g_only_ms": [s["ms"] for s in steps if not s["critic_update"]],
          "g_and_d_ms": [s["ms"] for s in steps if s["critic_update"]],
          "peak_memory_gib": peak_gib})
    fast_d_turns(torch, dev, spec, action, profile_dir)
    return launches


def _fast_d_batches(torch, dev, spec, action, count, seed):
    if action:
        root = os.path.join(spec["log_dir"], "synthetic_msr")
        return action_batches(torch, dev, root, spec["cfg"], count, seed=seed)
    cfg = spec["cfg"]
    return fluid_batches(torch, dev, cfg.patch_size, cfg.batch_size, count)


def _draws(torch, cfg, batch, state, action, seed):
    """One step's draws for ``state``'s critics under ``cfg`` (a fast-d cfg
    draws the stacked multipliers too: the same draws serve both paths)."""
    from tpugan_tpu_torch.models.discriminator import (dropout_layers,
                                                       dropout_widths)
    from tpugan_tpu_torch.train.step import ActionStepDraws, StepDraws

    gen = torch.Generator().manual_seed(seed)
    shape = tuple(batch["highres_pos"].shape[:3])
    if action:
        return ActionStepDraws.draw(gen, cfg, shape,
                                    dropout_layers(state.spatial.module),
                                    dropout_layers(state.tempo.module))
    return StepDraws.draw(gen, cfg, shape[2],
                          dropout_widths(state.spatial.module))


def fast_d_turns(torch, dev, spec, action, profile_dir=None, steps=4):
    """Fast-d and sequential steps in turns from the same checkpoint state
    and the same draws in one process (the fused switch on, the fluid gate
    held open): ms per step of each, G only (odd iterations) and G+D
    (even), in CUDA events; then 2 more steps of each under torch.profiler
    (device time, idle share); then one fast-d step on the card and on the
    CPU (:func:`fast_d_card_vs_cpu`)."""
    import dataclasses

    cfg = spec["cfg"]
    if not action:
        cfg = dataclasses.replace(cfg, ml_gate=1e9)
    cfgs = {"fast_d": cfg, "sequential": dataclasses.replace(cfg,
                                                             fast_d=False)}
    states = {k: spec["load"](spec["checkpoint"], c, dev, fused_train=True)
              for k, c in cfgs.items()}
    batches = _fast_d_batches(torch, dev, spec, action, steps + 2, seed=3)
    draws = [_draws(torch, cfg, batches[i], states["fast_d"], action, 30 + i)
             for i in range(steps)]
    run = {k: spec["step"](c) for k, c in cfgs.items()}
    ms = {k: [] for k in cfgs}
    for i in range(steps):
        for k in ("sequential", "fast_d"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = run[k](states[k], batches[i], draws[i])
            end.record()
            end.synchronize()
            for name, v in metrics.items():
                if not np.isfinite(v):
                    raise AssertionError(f"{spec['phase']} turns {k}: "
                                         f"{name} = {v}")
            ms[k].append((states[k].n_iter, start.elapsed_time(end)))
    emit({"phase": spec["phase"] + "_turns", "steps": steps,
          **{f"{k}_ms": {"g_only": [t for n, t in v if n % 2],
                         "g_and_d": [t for n, t in v if n % 2 == 0]}
             for k, v in ms.items()}})
    for k in ("sequential", "fast_d"):
        train_profile(torch, run[k], states[k], batches[steps:], profile_dir,
                      of=f"{spec['phase']}_{k}")
    fast_d_card_vs_cpu(torch, dev, spec, action)


def fast_d_card_vs_cpu(torch, dev, spec, action):
    """One fast-d step (B = FAST_D_CPU_BATCH; 1,024-point patches or
    ACTION_CPU_POINTS-point frames; iteration 20,002, so both critics
    update) from the checkpoint's state and the same draws on the card and
    on the CPU (plain versions), the card's generator graphs and flow kNN
    replayed on the CPU (StepReplay): held as the sequential card-vs-CPU
    steps are (:func:`hold_card_to_cpu`), with the card's step without the
    generator's adversarial losses as the control that must fail."""
    import dataclasses

    import tpugan_tpu_torch.train.step as step_mod

    if action:
        cfg = dataclasses.replace(spec["cfg"], num_points=ACTION_CPU_POINTS)
        batch = action_batches(torch, "cpu", os.path.join(
            spec["log_dir"], "synthetic_msr"), cfg, 1, seed=5)[0]
        loss_tol, change_tol = (ACTION_CARD_CPU_LOSS_TOL,
                                ACTION_CARD_CPU_CHANGE_TOL)
    else:
        cfg = dataclasses.replace(spec["cfg"], batch_size=FAST_D_CPU_BATCH,
                                  patch_size=1024, ml_gate=1e9)
        batch = fluid_batches(torch, "cpu", cfg.patch_size, cfg.batch_size,
                              1)[0]
        loss_tol, change_tol = CARD_CPU_LOSS_TOL, CARD_CPU_CHANGE_TOL
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    states = {d: spec["load"](spec["checkpoint"], cfg, d)
              for d in (dev, "cpu")}
    states["no_adv"] = spec["load"](spec["checkpoint"], cfg, dev)
    nets = ("sr", "tempo", "spatial")
    for s in states.values():
        s.n_iter += 1                                   # the step is even
    before = {n: {k: v.detach().clone() for k, v in
                  getattr(states["cpu"], n).module.named_parameters()}
              for n in nets}
    mu_before = {d: {n: {k: v.clone() for k, v in
                         getattr(states[d], n).opt.mu.items()} for n in nets}
                 for d in (dev, "cpu")}
    draws = _draws(torch, cfg, batch, states["cpu"], action, 2)
    step = spec["step"](cfg)
    replay = StepReplay(torch)
    t0 = time.perf_counter()
    m_card = replay.record(step, states[dev], card_batch, draws)
    t1 = time.perf_counter()
    m_cpu = replay.replay(step, states["cpu"], batch, draws)
    t2 = time.perf_counter()
    own = step_mod.lsgan_generator_loss
    step_mod.lsgan_generator_loss = lambda score, target: 0.0 * score.sum()
    try:
        step(states["no_adv"], card_batch, draws)
    finally:
        step_mod.lsgan_generator_loss = own
    out = {"phase": spec["phase"] + "_cpu", "batch": cfg.batch_size,
           "points": batch["highres_pos"].shape[2],
           "iteration": states["cpu"].n_iter, "knn_tie_swaps": replay.swaps,
           "card_s": t1 - t0, "cpu_s": t2 - t1}
    hold_card_to_cpu(out, states, dev, m_card, m_cpu, before, mu_before,
                     loss_tol, change_tol)


def add_fast_d_units(line, rows, launches):
    """Into the kernel line's fps, ball_query and knn entries: their times
    at the shapes stacking gives them (the rows of check_fast_d_kernels),
    per fast-d G+D step of each workload, under "fast_d"; their errors in
    max_abs_err; and each fast-d path's launches (``launches``: path ->
    the phase's counts)."""
    for entry in line["kernels"]:
        rs = rows.get(entry["name"])
        if not rs:
            continue
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   max(r["max_abs_err"] for r in rs))
        keys = [k for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                            "library_ms") if all(r.get(k) is not None
                                                 for r in rs)]
        entry["fast_d"] = {
            "times_are": "the stacked shapes of one fast-d G+D step (fluid: "
                         "train_vel, B = 4; action: train_dir, B = 4); the "
                         "shapes it shares with the sequential step are in "
                         "the entry's own times",
            **{path: {k: sum(r[k] * r[w] for r in rs) for k in keys}
               for path, w in (("fluid", "per_fast_d_step"),
                               ("action", "per_action_fast_d_step"))},
            "launches": {p: c[entry["name"]] for p, c in launches.items()}}


# ------------------------------------- the fluid serving and data surfaces

ROLLOUT_CLI_DIR = os.path.join(ROOT, "runs", "chip_smoke_rollout_cli")  # gitignored
FLUID_DEMO_DIR = os.path.join(ROOT, "runs", "chip_smoke_fluid_demo")    # gitignored
ROLLOUT_CLI_FRAMES = 25
# The rollout CLI's three runs on its synthetic sequence of N_POINTS
# particles a frame (a multiple of the rollout's ALIGN: no padding rows),
# one frame of input a forward: (name, flags, the mode's launches a frame,
# of which tensor-core and f32 register-tiled EdgeConvs), read off
# models/generator.py: the f32 dynamic forward's 7 graphs and 9 EdgeConvs,
# every one on the f32 register-tiled kernel; the bf16 static forward's one
# graph and 9 EdgeConvs, every one on the tensor-core kernel. With
# --approx_graph every graph of the f32 dynamic forward takes the
# approximate kNN (a frame's 10,240 rows are a multiple of 128).
ROLLOUT_CLI_RUNS = [
    ("f32_dynamic", [], {"knn": 7, "edgeconv": 9}, 0, 9),
    ("bf16_static", ["--compute_dtype", "bf16", "--graph_mode", "static"],
     {"knn": 1, "edgeconv": 9}, 9, 0),
    ("bf16_static_host", ["--compute_dtype", "bf16", "--graph_mode",
                          "static", "--host_pipeline", "--export_bgeo"],
     {"knn": 1, "edgeconv": 9}, 9, 0),
    ("f32_dynamic_approx", ["--approx_graph"],
     {"knn_approx": 7, "edgeconv": 9}, 0, 9),
]
# bench_metrics at its defaults: 8 x 79,872 points, 10 reps, 100 auction
# rounds. The Chamfer's nn1 launches: 2 a call, a warm-up and max(3, reps)
# timed calls; the EMD's: one nearest-target nn1 over the batch a call (the
# one-phase auction's fallback), a warm-up and EMD_REPS timed calls.
BENCH_BATCH, BENCH_POINTS, BENCH_REPS = 8, 79872, 10
BENCH_EMD_POINTS = 79872
# Launches per fluid demo frame (f32 dynamic SRNet on 512 FPS inputs of a
# 4,096-particle frame): 7 graphs, 9 EdgeConvs (all f32 register-tiled),
# the normalised Chamfer (2 nn1).
FLUID_DEMO_FRAMES = 24
FLUID_DEMO_POINTS = 4096
FLUID_DEMO_FRAME = {"knn": 7, "edgeconv": 9, "nn1": 2}


def check_surface_kernels(torch, dev):
    """The kernels at the fluid demo's shapes, each against its plain version
    by the limits of its serving rows: kNN at the f32 dynamic forward's five
    graph shapes over 512 inputs, the f32 EdgeConv forward at its six
    classes over 512 points, nn1 at the demo's Chamfer (4,096 points both
    ways, the most a frame keeps). Weighted per demo frame. Its own
    generator keeps the other checks' data. Returns {kernel: rows}."""
    rng = np.random.default_rng(21)
    n = FLUID_DEMO_POINTS // 8
    out = {"knn": [], "edgeconv": [], "nn1": []}
    for path, b, _, _, d, k, own, per, *_ in KNN_SHAPES:
        if path != "serving":
            continue
        row = _knn_row(torch, dev, rng, "fluid_demo", b, n, n, d, k, own,
                       0.3 if d == 3 else 1.0)
        out["knn"].append(dict(path="fluid_demo", per_demo_frame=per, **row))
        emit({"phase": "kernel", "kernel": "knn", **out["knn"][-1]})
    for name, c, h, o, k, agg, mlp, per in EDGECONV_SHAPES:
        row = _edgeconv_row(torch, dev, rng, name, torch.float32, "f32", n,
                            c, h, o, k, agg, mlp)
        out["edgeconv"].append(dict(config=f"fluid_demo {name}", N=n,
                                    per_forward=0, per_demo_frame=per, **row))
        emit({"phase": "kernel", "kernel": "edgeconv", **out["edgeconv"][-1]})
    out["nn1"].append(dict(_nn1_row(torch, dev, rng, "fluid_demo", 1,
                                    FLUID_DEMO_POINTS, FLUID_DEMO_POINTS),
                           per_demo_frame=2))
    emit({"phase": "kernel", "kernel": "nn1", **out["nn1"][-1]})
    return out


def rollout_cli(torch, dev, kernels):
    """With the counts reset by the caller: the rollout CLI twin
    (cli/rollout.main, called as a function) on the trained checkpoint
    (--use_vel --in_node_feats 6) over its synthetic sequence of 25 frames
    of N_POINTS particles, four runs (ROLLOUT_CLI_RUNS: f32 dynamic and
    bf16 static through the device-resident rollout, bf16 static through
    the host pipeline with bgeo, f32 dynamic with --approx_graph), outputs
    under runs/chip_smoke_rollout_cli/; each run's launches against its
    mode's a frame, and the approximate switch off after every run; the
    host pipeline's frames equal to the device path's bit for bit; each
    bf16 static and each approximate frame against the f32 dynamic one
    under GATE (the Chamfer over the f32 frame's points times their mean
    squared distance to their centroid: the serving gate's normalisation
    for a cloud not centred at 0); every pred_{i}.bgeo read back equal to
    pred_{i}.npy. Then, past the counted runs, ms a frame of each device
    run's rollout (the CLI's dispatch, copies included) in CUDA events and
    in device time. Returns the phase's launches."""
    import shutil

    from tpugan_tpu_torch.cli import rollout as cli
    from tpugan_tpu_torch.data.bgeo import read_bgeo
    from tpugan_tpu_torch.ops import neighbors
    from tpugan_tpu_torch.ops.kernels import edgeconv as E
    from tpugan_tpu_torch.ops.metrics import chamfer

    frames = ROLLOUT_CLI_FRAMES
    base = ["--ckpt", CHECKPOINT, "--use_vel", "--in_node_feats", "6",
            "--synthetic", "--synthetic_particles", str(N_POINTS),
            "--num_frames", str(frames)]
    line = {"phase": "rollout_cli", "frames": frames, "points": N_POINTS}
    preds, c_start = {}, counts(kernels)
    for name, extra, per, tc, ft in ROLLOUT_CLI_RUNS:
        out_dir = os.path.join(ROLLOUT_CLI_DIR, name)
        shutil.rmtree(out_dir, ignore_errors=True)
        c0, tc0, ft0 = counts(kernels), E.TC_LAUNCHES, E.F32_TILED_LAUNCHES
        res = cli.main(base + extra + ["--out_dir", out_dir])
        torch.cuda.synchronize()
        if neighbors.APPROX_GRAPH_KNN:
            raise AssertionError(f"rollout CLI {name}: the approximate "
                                 "graph kNN left on")
        got = delta(c0, counts(kernels))
        expect(got, {k: v * frames for k, v in per.items()},
               f"rollout CLI {name}")
        expect({"tc": E.TC_LAUNCHES - tc0, "f32t": E.F32_TILED_LAUNCHES - ft0},
               {"tc": tc * frames, "f32t": ft * frames},
               f"rollout CLI {name} EdgeConv variants")
        preds[name] = [np.load(os.path.join(out_dir, f"pred_{i}.npy"))
                       for i in range(frames)]
        for p in preds[name]:
            if not (N_POINTS <= p.shape[0] <= 8 * N_POINTS
                    and np.isfinite(p).all()):
                raise AssertionError(f"rollout CLI {name}: a frame of "
                                     f"{p.shape}")
        line[name] = {"launches": got, "frames_per_s": res["frames_per_s"],
                      "seconds": res["seconds"], "device": res["device"],
                      "points_out_first_last": [int(preds[name][0].shape[0]),
                                                int(preds[name][-1].shape[0])]}
    launches = delta(c_start, counts(kernels))

    host_equal = all(np.array_equal(a, b) for a, b in
                     zip(preds["bf16_static"], preds["bf16_static_host"]))
    gates = {"bf16_static": [], "f32_dynamic_approx": []}
    for name, got in gates.items():
        for a, b in zip(preds["f32_dynamic"], preds[name]):
            ta = torch.from_numpy(a).to(dev)[None]
            tb = torch.from_numpy(b).to(dev)[None]
            scale = float(((ta - ta.mean(1, keepdim=True)) ** 2).sum(-1)
                          .mean())
            with torch.no_grad():
                got.append(float(chamfer(ta, tb)[0]) / (a.shape[0] * scale))
    bgeo_equal = True
    for i, p in enumerate(preds["bf16_static_host"]):
        pos, attrs = read_bgeo(os.path.join(ROLLOUT_CLI_DIR,
                                            "bf16_static_host",
                                            f"pred_{i}.bgeo"))
        bgeo_equal &= bool(np.array_equal(pos, p) and attrs == {})
    worst = {f"{name}_vs_f32_dynamic_max": max(g) for name, g in gates.items()}
    line.update(host_pipeline_equals_device=host_equal, gate=GATE,
                bgeo_reads_back_equal=bgeo_equal, **worst)
    if not (host_equal and max(worst.values()) < GATE and bgeo_equal):
        raise AssertionError(f"rollout CLI: {line}")

    for name, extra, *_ in ROLLOUT_CLI_RUNS:
        if "--host_pipeline" in extra:
            continue
        opt = cli.parser().parse_args(base + extra)
        model, _ = cli.build_model(opt, dev)
        seq = cli.load_frames(opt)
        run = lambda: cli.run_rollout(model, seq, opt)
        ms = time_ms(run, torch, reps=3, warmup=1) / frames
        dev_ms = device_ms(run, torch, reps=1) / frames
        line[name].update(ms_per_frame=ms, device_ms_per_frame=dev_ms,
                          device_idle_share=1.0 - dev_ms / ms)
    emit(line)
    return launches


def bench_metrics_phase(torch, dev, kernels):
    """With the counts reset by the caller: the bench_metrics twin at its
    defaults (BENCH_BATCH x BENCH_POINTS, 100 auction rounds; the EMD at
    BENCH_EMD_POINTS), its launches against the counts above, the rounds
    its auctions bid (ops/metrics.py : auction_rounds); then, past the
    counted run, nn1 on the harness's own clouds against its plain version
    both ways (to 1e-5 of 2 max |p|^2 a distance, the tie rule of the nn1
    rows; the Chamfer of each item to the sum of those limits), and an nn1
    row at this shape for the kernel line. Returns (launches, nn1 row)."""
    import tpugan_tpu_torch.ops.metrics as metrics
    from tpugan_tpu_torch.cli import bench_metrics
    from tpugan_tpu_torch.ops.kernels import nn1 as N1

    c0 = counts(kernels)
    metrics.auction_rounds = 0
    t0 = time.perf_counter()
    lines = bench_metrics.main([
        "--batch", str(BENCH_BATCH), "--points", str(BENCH_POINTS),
        "--emd_points", str(BENCH_EMD_POINTS), "--reps", str(BENCH_REPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = delta(c0, counts(kernels))
    calls = 1 + bench_metrics.EMD_REPS
    expect(launches, {"nn1": 2 * (1 + max(3, BENCH_REPS)) + calls},
           "bench_metrics")

    x, y = bench_metrics.clouds(BENCH_BATCH, BENCH_POINTS, dev)
    bias = torch.zeros((BENCH_BATCH, BENCH_POINTS), device=dev)
    tol = 1e-5 * 2 * float(max((x * x).sum(-1).max(), (y * y).sum(-1).max()))
    cd_k = cd_p = 0
    errs, gaps = [], []
    with torch.no_grad():
        for q, c in ((x, y), (y, x)):
            dk, ik = N1.nn1_kernel(q, c, bias)
            dp, ip = N1.nn1_plain(q, c, bias)
            errs.append(float((dk - dp).abs().max()))
            gaps.append(index_gaps(q.cpu().numpy(), c.cpu().numpy(), ik, ip)[1])
            cd_k = cd_k + dk.double().sum(-1)
            cd_p = cd_p + dp.double().sum(-1)
    cd_err = float((cd_k - cd_p).abs().max())
    cd_tol = 2 * BENCH_POINTS * tol
    line = {"phase": "bench_metrics", "batch": BENCH_BATCH,
            "points": BENCH_POINTS, "emd_points": BENCH_EMD_POINTS,
            "metrics": lines, "wall_s": wall, "launches": launches,
            "auction_calls": calls,
            "auction_rounds_per_call": metrics.auction_rounds / calls,
            "nn1_max_abs_err": max(errs), "nn1_tol": tol,
            "nn1_max_tie_gap": max(gaps), "chamfer_max_abs_err": cd_err,
            "chamfer_tol": cd_tol,
            "chamfer_rel_err": float(((cd_k - cd_p).abs() / cd_p).max())}
    if not (max(errs) <= tol and max(gaps) <= 2 * tol and cd_err <= cd_tol):
        raise AssertionError(f"bench_metrics Chamfer vs plain: {line}")
    emit(line)
    row = dict(_nn1_row(torch, dev, None, "bench_metrics", BENCH_BATCH,
                        BENCH_POINTS, BENCH_POINTS,
                        clouds=(x.cpu().numpy(), y.cpu().numpy())),
               per_bench_chamfer=2)
    emit({"phase": "kernel", "kernel": "nn1", **row})
    return launches, row


def fluid_demo_phase(torch, kernels):
    """With the counts reset by the caller: the fluid demo twin
    (cli/fluid_demo.main, called as a function) with the trained checkpoint
    and --use_vel at its defaults (24 synthetic frames of 4,096 particles,
    seed 7; outputs under runs/chip_smoke_fluid_demo/), its launches
    against FLUID_DEMO_FRAME a frame, every Chamfer finite. Returns the
    phase's launches."""
    from tpugan_tpu_torch.cli import fluid_demo
    from tpugan_tpu_torch.ops.kernels import edgeconv as E

    c0, tc0, ft0 = counts(kernels), E.TC_LAUNCHES, E.F32_TILED_LAUNCHES
    t0 = time.perf_counter()
    res = fluid_demo.main(["--ckpt", CHECKPOINT, "--use_vel", "--num_frames",
                           str(FLUID_DEMO_FRAMES), "--out_dir",
                           FLUID_DEMO_DIR])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = delta(c0, counts(kernels))
    expect(launches, {k: v * FLUID_DEMO_FRAMES
                      for k, v in FLUID_DEMO_FRAME.items()}, "fluid demo")
    expect({"tc": E.TC_LAUNCHES - tc0, "f32t": E.F32_TILED_LAUNCHES - ft0},
           {"f32t": FLUID_DEMO_FRAME["edgeconv"] * FLUID_DEMO_FRAMES},
           "fluid demo EdgeConv variants")
    line = {"phase": "fluid_demo", "frames": res["frames"],
            "rollout_s": res["seconds"], "wall_s": wall,
            "chamfer_mean": res["chamfer_mean"],
            "chamfer_min_max": [min(res["chamfers"]), max(res["chamfers"])],
            "launches": launches}
    if not (res["frames"] == FLUID_DEMO_FRAMES
            and np.isfinite(res["chamfers"]).all()):
        raise AssertionError(f"fluid demo: {line}")
    emit(line)
    return launches


def add_surface_units(line, rows, bench_row):
    """Into the kernel line's entries: each kernel's times per fluid demo
    frame (the rows of check_surface_kernels, weighted by per_demo_frame)
    under "fluid_demo", nn1's per bench_metrics Chamfer under
    "bench_metrics", their errors in max_abs_err; the rollout CLI's frames
    are serving forwards at N_POINTS (the serving rows' shapes)."""
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")

    def totals(rs, weight, per):
        return {"times_are": per, **{
            k: sum(r[k] * r[weight] for r in rs) for k in keys
            if all(r.get(k) is not None for r in rs)}}

    for entry in line["kernels"]:
        rs = rows.get(entry["name"])
        if rs:
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       max(r["max_abs_err"] for r in rs))
            entry["fluid_demo"] = totals(
                rs, "per_demo_frame", "one fluid demo frame (f32 dynamic, "
                "512 inputs -> 4,096 slots, and its 4,096-point Chamfer)")
        if entry["name"] == "nn1":
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       bench_row["max_abs_err"])
            entry["bench_metrics"] = totals(
                [bench_row], "per_bench_chamfer", "one bench_metrics Chamfer "
                "(8 x 79,872 points, both directions)")
        if entry["name"] in ("knn", "edgeconv"):
            entry["rollout_cli_shapes"] = ("the serving rows (frames of "
                                           f"{N_POINTS} points)")


def add_action_units(line, act_rows, af_rows):
    """Into the kernel line's entries: each kernel's times per action demo
    frame and per ActionCls.infer batch at the action shapes (the rows of
    check_action_kernels) under "action", their errors in max_abs_err; the
    affine form's fluid-shape checks under "fluid_shape_checks"."""
    def totals(rows, weight, per):
        keys = [k for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                            "library_ms") if rows[0].get(k) is not None]
        return {"times_are": per, **{
            k: sum(r[k] * r.get(weight, 0) for r in rows) for k in keys}}

    frame = "one action demo frame (NoMaskSRNet, 128 -> 2,048 points)"
    infer = "one ActionCls.infer batch (24 clips x 3 frames x 2,048 points)"
    units = {"knn": [("per_action_frame", frame), ("per_infer", infer)],
             "edgeconv": [("per_action_frame", frame)],
             "fps": [("per_infer", infer)],
             "ball_query": [("per_infer", infer)]}
    for entry in line["kernels"]:
        rows = act_rows.get(entry["name"])
        if not rows:
            continue
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   max(r["max_abs_err"] for r in rows))
        for weight, per in units.get(entry["name"], []):
            entry.setdefault("action", {})[weight] = totals(rows, weight, per)
        if entry["name"] == "pooled_mlp_affine":
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       max(r["max_abs_err"] for r in af_rows))
            entry["fluid_shape_checks"] = totals(
                af_rows, "per_check", "one call at each of sa_0 and group_all "
                "(the fluid critics' shapes; no fluid path runs the affine "
                "form)")


def add_action_train_units(line, rows, launches):
    """Into the kernel line's entries: each kernel's times per action G+D
    train step with the fused switch (the rows of
    check_action_train_kernels, weighted by ``per_action_step``) under
    "action_train", their errors in max_abs_err; the EdgeConv entries'
    action-train launches by variant (``launches``: the train_action
    phase's)."""
    per = ("one action G+D train step with the fused switch (4 clips x 3 "
           "frames x 2,048 points)")
    for entry in line["kernels"]:
        rs = rows.get(entry["name"])
        if not rs:
            continue
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   max(r["max_abs_err"] for r in rs))
        keys = [k for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                            "library_ms") if all(r.get(k) is not None
                                                 for r in rs)]
        entry["action_train"] = {"times_are": per, **{
            k: sum(r[k] * r["per_action_step"] for r in rs) for k in keys}}
        if entry["name"] == "edgeconv":
            entry["train_action_launches_by_variant"] = {
                "f32t": launches["edgeconv_f32t"],
                "simt": launches["edgeconv"] - launches["edgeconv_f32t"]}
        if entry["name"] == "edgeconv_bwd":
            entry["train_action_tiled_launches"] = launches["edgeconv_bwd_tiled"]
            entry["train_action_general_launches"] = (
                launches["edgeconv_bwd"] - launches["edgeconv_bwd_tiled"])


# ------------------------------------------ parallelism over torch.distributed

PARALLEL_DIR = os.path.join(ROOT, "runs", "chip_smoke_parallel")   # gitignored
SHARD_POINTS = 40960      # four times the serving frame
SHARD_FRAMES = 5
SHARD_RUNS = [  # (name, the rollout CLI's flags, launches a frame on a rank)
    ("f32_dynamic", [], {"knn": 7, "edgeconv": 9}),
    ("bf16_static", ["--compute_dtype", "bf16", "--graph_mode", "static"],
     {"knn": 1, "edgeconv": 9}),
]
# Limit of the normalised Chamfer (as GATE takes it) of every sharded frame
# against the unsharded CLI's. On an NVIDIA H100 80GB HBM3 at 700 W it read
# 1.2e-7 to 3.5e-7 at one and two ranks (PERF.md section 6), 1.2e-7 where
# the frames were equal bit for bit (the measure's own f32 noise); the
# limit lies about 30x above the largest reading.
SHARD_GATE = 1e-5
DP_ITERS = 20004          # the fluid DP runs: iterations 20001-20004
DP_PLAIN_STACK_ITERS = 20002   # its plain-stack twin: 20001-20002
DP_ACTION_ITERS = 20002   # the action DP run: iterations 20001-20002
DP_TURNS = ("dp", "plain") * 3   # world size 1, in turns
# Every run's first step starts from the checkpoint with the same draws, so
# its losses repeat: bit for bit at one rank, to the order of the
# cross-rank sums at two (relative). Later steps differ from run to run:
# the plain versions' atomic scatter-adds change the gradients' last bits
# and the GAN steps amplify them (on an H100, two plain runs'
# spatial_G_loss read 0.051 and 0.073 at the fourth step). So a two-rank step
# after the first must lie within the one-rank runs' spread at that step
# widened by DP_SPREAD_WIDEN times that spread on each side (six runs'
# spread understates the run-to-run range; a two-rank step that lost or
# doubled a rank's gradient moves the second step's losses by far more).
DP_LOSS_TOL_FIRST = 1e-4
DP_SPREAD_WIDEN = 3.0
RANK_TIMEOUT_S = 600


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(nproc: int, backend: str, out_dir: str) -> list:
    """``torchrun --nproc_per_node nproc chip_smoke.py --rank-worker
    out_dir``: each rank runs :func:`rank_worker` over ``backend`` and
    writes ``out_dir/rank{r}.json``, returned in rank order. Output of the
    ranks goes to ``out_dir/ranks.log``; a failed rank raises with its
    tail."""
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    with open(os.path.join(out_dir, "spec.json"), "w") as fh:
        json.dump({"backend": backend, "world": nproc}, fh)
    log = os.path.join(out_dir, "ranks.log")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(nproc), "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()), os.path.abspath(__file__),
           "--rank-worker", out_dir]
    with open(log, "w") as fh:
        rc = subprocess.run(cmd, cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT,
                            timeout=RANK_TIMEOUT_S).returncode
    if rc != 0:
        with open(log) as fh:
            raise AssertionError(f"{nproc} rank(s) over {backend}: exit {rc}\n"
                                 + fh.read()[-6000:])
    outs = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            outs.append(json.load(fh))
    return outs


def _kernels():
    """Every kernel's launch counter, by name."""
    from tpugan_tpu_torch.ops.kernels import (ball_query, binned_interp,
                                              edgeconv, fps, interp, knn, nn1,
                                              pooled_mlp)

    return {"knn": knn.KERNEL, "edgeconv": edgeconv.KERNEL,
            "edgeconv_bwd": edgeconv.BWD, "nn1": nn1.KERNEL,
            "fps": fps.KERNEL, "ball_query": ball_query.KERNEL,
            "pooled_mlp_fwd": pooled_mlp.FWD, "pooled_mlp_bwd": pooled_mlp.BWD,
            "pooled_mlp_affine": pooled_mlp.AFFINE_FWD,
            "pooled_mlp_affine_bwd": pooled_mlp.AFFINE_BWD,
            "interp": interp.KERNEL, "binned_interp": binned_interp.KERNEL,
            "knn_approx": knn.APPROX}


def _shard_argv(name, extra, out_dir, shard, world=1):
    argv = ["--ckpt", CHECKPOINT, "--use_vel", "--in_node_feats", "6",
            "--synthetic", "--synthetic_particles", str(SHARD_POINTS),
            "--num_frames", str(SHARD_FRAMES), "--out_dir", out_dir] + extra
    if shard:
        argv += ["--shard_points", "--mesh_devices", str(world),
                 "--device", "cuda:0"]
    return argv


# the kernels whose wrappers' call sites _record_shapes patches
RECORDED = ("knn", "fps", "ball_query", "nn1", "interp", "edgeconv",
            "pooled_mlp_fwd")


def _record_shapes(torch):
    """Patch the kernel wrappers' call sites (ops/neighbors.py: the exact
    kNN, FPS, the ball query; ops/metrics.py: nn1; ops/interpolate.py: the
    dense interp; nn/edgeconv.py: the fused EdgeConv; nn/layers.py: the
    pooled-MLP batch-norm kernel, with the world its moments are summed
    over) to count their calls by shape, from host metadata only (no
    sync). Returns (counts, undo): counts maps a key (kernel name, then the
    shape the row of that kernel is made from) to its calls."""
    import collections

    import tpugan_tpu_torch.nn.edgeconv as EC
    import tpugan_tpu_torch.nn.layers as L
    from tpugan_tpu_torch.ops import interpolate, metrics, neighbors

    seen, own = collections.Counter(), []

    def wrap(mod, attr, key):
        fn = getattr(mod, attr)

        def recorded(*a, **k):
            seen[key(*a, **k)] += 1
            return fn(*a, **k)

        own.append((mod, attr, fn))
        setattr(mod, attr, recorded)

    def edgeconv(nbr, ctr, wn, we, w1=None, w2=None, aggregate="max",
                 compute_dtype=torch.float32):
        grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (nbr, ctr, wn, we, w1, w2))
        b, k, n, c = nbr.shape
        h = wn.shape[1]
        return ("edgeconv", b, k, n, c, h, h if w2 is None else w2.shape[1],
                aggregate, w1 is not None,
                "bf16" if compute_dtype == torch.bfloat16 else "f32", grad)

    wrap(neighbors, "knn_kernel", lambda q, c, bias, k: (
        "knn", q.shape[0], q.shape[1], c.shape[1], q.shape[2], k,
        q.data_ptr() == c.data_ptr()))
    wrap(neighbors, "fps_kernel", lambda pos, m, pen, start, plan=None: (
        "fps", pos.shape[0], pos.shape[1], m))
    wrap(neighbors, "ball_query_kernel", lambda q, c, r, ns, bias: (
        "ball_query", q.shape[0], q.shape[1], c.shape[1], float(r), ns))
    wrap(metrics, "nn1_kernel", lambda q, c, bias: (
        "nn1", q.shape[0], q.shape[1], c.shape[1]))
    wrap(interpolate, "interp_kernel",
         lambda q, c, v, cutoff, bias, kind="bicubic": (
             "interp", q.shape[0], q.shape[1], c.shape[1], v.shape[-1],
             float(cutoff), kind))
    wrap(EC, "edgeconv_fused", edgeconv)
    wrap(L, "pooled_mlp_bn_train",
         lambda table, ws, gammas, betas, slope=0.0, eps=1e-5, reduce=None,
         world=1: ("pooled_mlp_fwd", *table.shape,
                   "x".join(str(w.shape[1]) for w in ws), float(slope),
                   world))

    def undo():
        for mod, attr, fn in own:
            setattr(mod, attr, fn)

    return seen, undo


def _calls_match(shapes: list, launches: dict, what: str) -> None:
    """The recorded calls (``[[key, calls], ...]``) of each kernel of
    RECORDED add up to its launches in the run (each wrapper launches once
    a call): every launch ran at a recorded shape."""
    for name in RECORDED:
        calls = sum(n for key, n in shapes if key[0] == name)
        if calls != launches.get(name, 0):
            raise AssertionError(f"{what}: {calls} recorded {name} calls, "
                                 f"{launches.get(name, 0)} launches")


def _graph_ties(torch, model, pos, vel) -> dict:
    """Every kNN graph of the sharded rollout of these frames on this rank
    against the unsharded kNN of the same gathered cloud and valid mask:
    indices may differ only between candidates whose exact (float64)
    distances tie within 1e-5 of 2 max |x|^2 over the valid rows (as
    tests/test_torch_sharded_serving.py holds the CPU's graphs). Returns
    the graphs, the slots that differ and the largest gap over its
    limit."""
    import tpugan_tpu_torch.models.generator as G
    import tpugan_tpu_torch.nn.edgeconv as EC
    from tpugan_tpu_torch.ops.neighbors import _gather_points, graph_knn, knn
    from tpugan_tpu_torch.parallel import mesh
    from tpugan_tpu_torch.parallel.sharded_serving import \
        rollout_sequence_sharded

    graphs = []

    def recording(x, k, c_valid=None):
        d2, idx = graph_knn(x, k, c_valid)
        graphs.append((_gather_points(x), idx, None if c_valid is None
                       else _gather_points(c_valid)))
        return d2, idx

    G.graph_knn = EC.graph_knn = recording
    try:
        rollout_sequence_sharded(model, pos, vel, use_vel=True)
    finally:
        G.graph_knn = EC.graph_knn = graph_knn
    world, r = mesh.world_size(), mesh.rank()
    differ, ratio = 0, 0.0
    for x, idx, cv in graphs:
        rows = mesh.rows_of(x.shape[1], world, r)
        own = knn(x, k=idx.shape[-1], c_valid=cv)[1][:, rows]
        b, q, s = torch.nonzero(idx != own, as_tuple=True)
        differ += int(b.numel())
        if b.numel():
            xd = x.double()
            live = xd if cv is None else xd[cv]
            tol = 1e-5 * 2 * float((live ** 2).sum(-1).max())
            qi = q + rows.start
            gap = (((xd[b, qi] - xd[b, idx[b, q, s]]) ** 2).sum(-1)
                   - ((xd[b, qi] - xd[b, own[b, q, s]]) ** 2).sum(-1))
            ratio = max(ratio, float(gap.abs().max()) / tol)
    return {"graphs": len(graphs), "differing_slots": differ,
            "max_gap_over_limit": ratio}


def _worker_sharded(torch, kernels, spec, out_dir):
    """On each rank: the rollout CLI with --shard_points for each mode of
    SHARD_RUNS (counts reset before, read after, the kernels' shapes
    recorded; rank 0 writes the frames), then, past the counted run, ms a
    frame of the sharded rollout in CUDA events and on the host clock, and
    the f32 dynamic rollout's graphs against the unsharded kNN
    (:func:`_graph_ties`)."""
    from tpugan_tpu_torch.cli import rollout as cli
    from tpugan_tpu_torch.parallel import mesh
    from tpugan_tpu_torch.parallel.sharded_serving import \
        rollout_sequence_sharded

    res = {}
    for name, extra, _ in SHARD_RUNS:
        argv = _shard_argv(name, extra, os.path.join(out_dir, name), True,
                           spec["world"])
        shapes, undo = _record_shapes(torch)
        for k in kernels.values():
            k.launches = 0
        try:
            cli.main(argv)
        finally:
            undo()
        torch.cuda.synchronize()
        launches = counts(kernels)
        for k in kernels.values():
            k.launches = 0
        opt = cli.parser().parse_args(argv)
        model, _ = cli.build_model(opt, torch.device("cuda", 0))
        frames = cli.load_frames(opt)
        pos = np.stack([p for p, _ in frames])
        vel = np.stack([v for _, v in frames])
        run = lambda: rollout_sequence_sharded(model, pos, vel, use_vel=True)
        run()
        mesh_sync = lambda: mesh.all_reduce_(torch.zeros(1, device="cuda"))
        torch.cuda.synchronize()
        mesh_sync()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res[name] = {"launches": launches,
                     "shapes": [[list(k), n] for k, n in shapes.items()],
                     "ms_per_frame": e0.elapsed_time(e1) / SHARD_FRAMES,
                     "wall_ms_per_frame": wall * 1e3 / SHARD_FRAMES}
        if name == "f32_dynamic":
            res[name]["graph_ties"] = _graph_ties(torch, model, pos, vel)
    return res


def _digest(torch, state) -> str:
    """sha1 of every parameter and buffer of the trainer state's three
    networks (bit for bit)."""
    import hashlib

    h = hashlib.sha1()
    for name in ("sr", "tempo", "spatial"):
        for k, v in sorted(getattr(state, name).module.state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_cli(torch, kernels, cli, argv, step_cls, timed_collectives=False,
            record=False):
    """One train CLI run called as a function: each step's launches, metrics,
    ms (G only and G+D, CUDA events), the state's digest after it, the
    seconds in collectives and their number (with ``timed_collectives``:
    every collective synchronised and timed on the host clock), the peak
    memory, and with ``record`` the kernels' shapes (:func:`_record_shapes`)
    and the whole run's launches."""
    from tpugan_tpu_torch.parallel import mesh

    marks, digests, coll = [], [], [0.0, 0]
    own_call = step_cls.__call__

    def call(self, state, *a, **k):
        out = own_call(self, state, *a, **k)
        digests.append(_digest(torch, state))
        return out

    own = {f: getattr(mesh, f) for f in ("all_reduce_", "gather_cat")}

    def timed(f):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = own[f](*a, **k)
            torch.cuda.synchronize()
            coll[0] += time.perf_counter() - t0
            coll[1] += 1
            return out
        return wrapped

    def hook(event, n_iter, metrics):
        if event in ("start", "end"):
            torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((event, n_iter, counts(kernels), ev, metrics,
                      tuple(coll)))

    step_cls.__call__ = call
    if timed_collectives:
        for f in own:
            setattr(mesh, f, timed(f))
    shapes, undo = _record_shapes(torch) if record else ({}, lambda: None)
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    os.environ["TPUGAN_FUSED_EDGECONV_TRAIN"] = "1"
    try:
        out = cli.main(argv, hook=hook)
    finally:
        del os.environ["TPUGAN_FUSED_EDGECONV_TRAIN"]
        step_cls.__call__ = own_call
        for f, fn in own.items():
            setattr(mesh, f, fn)
        undo()
    torch.cuda.synchronize()
    run_launches = counts(kernels)
    by = {}
    for event, n_iter, c, ev, metrics, cs in marks:
        by.setdefault(n_iter, {})[event] = (c, ev, metrics, cs)
    steps = []
    for (n_iter, m), dig in zip(sorted(by.items()), digests):
        start, gen, end = m["start"], m["generator"], m["end"]
        ms = start[1].elapsed_time(end[1])
        steps.append({"iteration": n_iter, "metrics": m["end"][2],
                      "launches": delta(start[0], end[0]), "digest": dig,
                      "ms": ms, "generator_ms": start[1].elapsed_time(gen[1]),
                      "collective_share": ((end[3][0] - start[3][0]) * 1e3
                                           / ms if timed_collectives
                                           else None),
                      "collectives": (end[3][1] - start[3][1]
                                      if timed_collectives else None)})
    return {"steps": steps, "checkpoint": out["checkpoint"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "state": out["state"], "run_launches": run_launches,
            "shapes": [[list(k), n] for k, n in shapes.items()]}


def _worker_dp(torch, kernels, spec, out_dir):
    """On each rank: the fluid train CLI twin (--preset train_vel
    --device_sampling --synthetic, resumed from the checkpoint, the fused
    switch on) with --data_parallel; at world size 1 in turns with the
    same run without it (DP_TURNS); at world size 2 also the action twin
    with --data_parallel --fast_d, the pooled-MLP kernel's rows at the
    fluid run's recorded shapes (:func:`_pooled_dp_rows`) and the fluid run
    again for DP_PLAIN_STACK_ITERS with every SetConv on the plain stack
    (the rule before the kernel took cross-rank moments: its collectives
    a step); the kernels' shapes recorded at world size 2. Rank 0 reads
    its last fluid checkpoint back."""
    from tpugan_tpu_torch.checkpoint import load_trainer_state
    from tpugan_tpu_torch.cli import train_action, train_fluid
    from tpugan_tpu_torch.train.step import (ActionGanStep, FluidGanStep,
                                             FluidTrainConfig)

    world = spec["world"]
    par = ["--device", "cuda:0"]
    log = lambda n: os.path.join(out_dir, n)
    fluid = ["--preset", "train_vel", "--device_sampling", "--synthetic",
             "--resume", "--path_to_resume", CHECKPOINT, "--iters",
             str(DP_ITERS), "--ckpt_every", "100000"]
    res = {}
    turns = DP_TURNS if world == 1 else ("dp",)
    for i, turn in enumerate(turns):
        argv = fluid + ["--log_dir", log(f"fluid_{i}")]
        if turn == "dp":
            argv += ["--data_parallel"] + par
        else:
            argv += ["--device", "cuda:0"]
        got = _dp_cli(torch, kernels, train_fluid, argv, FluidGanStep,
                      timed_collectives=world > 1, record=world > 1)
        state = got.pop("state")
        if turn == "dp" and i == 0:
            from tpugan_tpu_torch.parallel import mesh

            if mesh.rank() == 0:
                back = load_trainer_state(got["checkpoint"],
                                          FluidTrainConfig(), "cuda:0")
                got["checkpoint_read_back_equal"] = (
                    _digest(torch, back) == _digest(torch, state))
        res[f"fluid_{i}_{turn}"] = got
    if world > 1:
        argv = ["--preset", "train_dir", "--device_sampling", "--synthetic",
                "--fast_d", "--resume", "--path_to_resume", ACTION_CHECKPOINT,
                "--iters", str(DP_ACTION_ITERS), "--ckpt_every", "100000",
                "--log_dir", log("action"), "--data_parallel"] + par
        got = _dp_cli(torch, kernels, train_action, argv, ActionGanStep,
                      timed_collectives=True, record=True)
        got.pop("state")
        res["action_dp"] = got
        res["pooled_rows"] = _pooled_dp_rows(
            torch, res["fluid_0_dp"]["shapes"], world)
        argv = fluid[:-3] + [str(DP_PLAIN_STACK_ITERS), "--ckpt_every",
                             "100000", "--log_dir", log("fluid_plain_stack"),
                             "--data_parallel"] + par
        with plain_stack_under_cross_rank_stats():
            got = _dp_cli(torch, kernels, train_fluid, argv, FluidGanStep,
                          timed_collectives=True)
        got.pop("state")
        res["fluid_plain_stack"] = got
    return res


class plain_stack_under_cross_rank_stats:
    """Every SetConv on the plain stack under ``cross_rank_stats``: the
    port's rule before the pooled-MLP kernel took cross-rank moments."""

    def __enter__(self):
        import tpugan_tpu_torch.nn.layers as L
        import tpugan_tpu_torch.nn.setconv as S

        self.own = own = S.fusable_stats
        S.fusable_stats = lambda: own() and L._STAT_REDUCE is None

    def __exit__(self, *exc):
        import tpugan_tpu_torch.nn.setconv as S

        S.fusable_stats = self.own


def _pooled_dp_rows(torch, shapes, world):
    """On each rank, the pooled-MLP batch-norm kernel at every shape the
    data-parallel fluid run called it at (``shapes``: _record_shapes'
    [key, calls] pairs), forward and backward against the plain versions
    under the same real sum over the ranks (each rank its own table, the
    moments every rank's): :func:`_pooled_row`'s rows with the path, world
    and this rank's calls. Every rank calls the same shapes in the same
    order, so their collectives pair up; each device profile is taken
    once (a retry on one rank only would leave the other waiting)."""
    from tpugan_tpu_torch.parallel import mesh

    rng = np.random.default_rng(31 + mesh.rank())
    reduce = lambda t: mesh.all_reduce_(t.clone())
    fwd, bwd = [], []
    for key, calls in sorted(shapes, key=str):
        if key[0] != "pooled_mlp_fwd":
            continue
        _, b, m, ns, c0, widths, slope, w = key
        if w != world:
            raise AssertionError(f"pooled call at world {w} in a {world}-rank "
                                 f"run")
        widths = tuple(int(h) for h in widths.split("x"))
        f, g = _pooled_row(torch, torch.device("cuda", 0), rng,
                           f"data_parallel world {world}", (b, m, ns, c0),
                           widths, slope, 0, "positive", reduce=reduce,
                           world=world, tries=1)
        for rows, row in ((fwd, f), (bwd, g)):
            rows.append(dict(row, path="data_parallel", world=world,
                             calls=calls))
    return {"pooled_mlp_fwd": fwd, "pooled_mlp_bwd": bwd}


def rank_worker(out_dir: str) -> int:
    """A rank of :func:`launch_ranks`: joins the group (the backend the
    port picks for ranks on cuda:0 must be the spec's), runs the sharded
    rollout and the data-parallel runs, writes its results."""
    import torch
    import torch.distributed as dist

    from tpugan_tpu_torch.parallel import mesh

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(out_dir, "spec.json")) as fh:
        spec = json.load(fh)
    mesh.initialize_distributed(device="cuda:0")
    if (mesh.world_size(), dist.get_backend()) != (spec["world"],
                                                   spec["backend"]):
        raise AssertionError(f"world {mesh.world_size()} over "
                             f"{dist.get_backend()}, spec {spec}")
    kernels = _kernels()
    res = {"rank": mesh.rank(), "world": mesh.world_size(),
           "backend": spec["backend"],
           "sharded": _worker_sharded(torch, kernels, spec, out_dir),
           "dp": _worker_dp(torch, kernels, spec, out_dir)}
    with open(os.path.join(out_dir, f"rank{mesh.rank()}.json"), "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()
    return 0


def path_shapes(ranks) -> dict:
    """{(path, world, key): rank 0's calls} of the kernels' shapes in the
    ranks' counted runs: the sharded rollout's at every world size, the
    data-parallel runs' at two ranks (at one they are the train phases'
    shapes). Each run's recorded calls must add up to its launches on
    every rank."""
    out = {}

    def add(path, world, rank, run, launches, what):
        _calls_match(run, launches, what)
        if rank == 0:
            for key, n in run:
                k = (path, world, tuple(key))
                out[k] = out.get(k, 0) + n

    for world, outs in sorted(ranks.items()):
        for r, o in enumerate(outs):
            for name, _, _ in SHARD_RUNS:
                sh = o["sharded"][name]
                add("sharded_rollout", world, r, sh["shapes"], sh["launches"],
                    f"sharded rollout {name}, world {world}, rank {r}")
            if world > 1:
                for run_name in ("fluid_0_dp", "action_dp"):
                    run = o["dp"][run_name]
                    add("data_parallel", world, r, run["shapes"],
                        run["run_launches"],
                        f"{run_name}, world {world}, rank {r}")
    return out


def _interp_case(torch, dev, rng, b, nq, m, c):
    """(query, cand, values, bias) as check_interp's random layout: queries
    near random candidates, a tenth of them at the 999 sentinel."""
    cand = _cloud(torch, dev, rng, b, m, 3)
    pick = torch.from_numpy(rng.integers(0, m, (b, nq))).to(dev)
    query = (torch.gather(cand, 1, pick[..., None].expand(b, nq, 3))
             + _cloud(torch, dev, rng, b, nq, 3, scale=0.01))
    query[:, -nq // 10:] = 999.0
    vals = _cloud(torch, dev, rng, b, m, c, scale=0.025)
    return query, cand, vals, torch.zeros((b, m), device=dev)


def check_path_kernels(torch, dev, shapes) -> dict:
    """Each kernel at each shape of :func:`path_shapes` against its plain
    version by the limits of its own rows above (random data of the
    recorded shape: a kNN graph over itself where the run's was, a
    sharded graph's queries the first rows of its candidates; FPS with a
    hard-masked tail; the ball query with every ninth candidate masked;
    an EdgeConv called with gradients also backward). Returns {kernel:
    rows}, each row with its path, world size and rank 0's calls."""
    from tpugan_tpu_torch.ops.kernels import edgeconv as E
    from tpugan_tpu_torch.ops.kernels import fps as F

    rng = np.random.default_rng(23)
    out = {}

    def add(kernel, row, path, world, calls):
        out.setdefault(kernel, []).append(
            dict(row, path=path, world=world, calls=calls))
        if kernel != "interp":      # _interp_row prints its own row
            emit({"phase": "kernel", "kernel": kernel, **out[kernel][-1]})

    for (path, world, key), calls in sorted(shapes.items(), key=str):
        name, *shape = key
        what = f"{path} world {world}"
        if name == "knn":
            b, nq, nc, d, k, own = shape
            own = "rows" if path == "sharded_rollout" else own
            add(name, _knn_row(torch, dev, rng, what, b, nq, nc, d, k, own,
                               0.3 if d == 3 else 1.0), path, world, calls)
        elif name == "fps":
            b, n, m = shape
            pos, pen, start = _fps_case(torch, dev, rng, b, n,
                                        m <= n - n // 8)
            add(name, _fps_row(torch, F, what, b, n, m, pos, pen, start),
                path, world, calls)
        elif name == "ball_query":
            b, nq, nc, r, ns = shape
            add(name, _ball_row(torch, dev, rng, what, b, nq, nc, r, ns),
                path, world, calls)
        elif name == "nn1":
            b, nq, m = shape
            add(name, _nn1_row(torch, dev, rng, what, b, nq, m), path, world,
                calls)
        elif name == "interp":
            b, nq, m, c, cutoff, kind = shape
            query, cand, vals, bias = _interp_case(torch, dev, rng, b, nq, m,
                                                   c)
            add(name, _interp_row(torch, what, query, cand, vals, bias,
                                  cutoff, kind, 0), path, world, calls)
        elif name == "edgeconv":
            b, k, n, c, h, o, agg, mlp, kind, grad = shape
            cdt = torch.float32 if kind == "f32" else torch.bfloat16
            add(name, dict(config=what, B=b, N=n, **_edgeconv_row(
                torch, dev, rng, what, cdt, kind, n, c, h, o, k, agg, mlp,
                b=b)), path, world, calls)
            if grad:
                add("edgeconv_bwd", _edgeconv_bwd_row(
                    torch, dev, rng, what, c, h, o, k, agg, mlp, kind, False,
                    b, n, E.takes_f32_tiled_bwd(cdt, mlp, c, h, o)),
                    path, world, calls)
        elif name == "pooled_mlp_fwd":
            continue    # held in the ranks, on the real two-rank sum
        else:
            raise AssertionError(f"no kernel row for {key}")
    return out


def _frames_close(torch, dev, got, want):
    """(normalised Chamfer as rollout_cli's gate takes it, max abs error
    where the shapes agree else None, bit for bit) of two frames."""
    from tpugan_tpu_torch.ops.metrics import chamfer

    ta = torch.from_numpy(want).to(dev)[None]
    tb = torch.from_numpy(got).to(dev)[None]
    scale = float(((ta - ta.mean(1, keepdim=True)) ** 2).sum(-1).mean())
    with torch.no_grad():
        cd = float(chamfer(ta, tb)[0]) / (want.shape[0] * scale)
    same = got.shape == want.shape
    err = float(np.abs(got - want).max()) if same else None
    return cd, err, bool(same and np.array_equal(got, want))


def _unsharded_ms(torch, cli, argv) -> dict:
    """ms a frame of the unsharded device rollout of the CLI's frames, warm,
    in CUDA events and on the host clock (as the ranks time theirs)."""
    from tpugan_tpu_torch.eval.rollout import rollout_sequence_device

    opt = cli.parser().parse_args(argv)
    model, _ = cli.build_model(opt, torch.device("cuda", 0))
    frames = cli.load_frames(opt)
    pos = np.stack([p for p, _ in frames])
    vel = np.stack([v for _, v in frames])
    run = lambda: rollout_sequence_device(model, pos, vel, use_vel=True)
    run()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    return {"ms_per_frame": e0.elapsed_time(e1) / SHARD_FRAMES,
            "wall_ms_per_frame": (time.perf_counter() - t0) * 1e3
            / SHARD_FRAMES}


def sharded_rollout(torch, dev, ranks):
    """The phase line of the point-sharded rollout: each world's frames
    (rank 0's files) against the unsharded rollout CLI's of the same
    frames (SHARD_GATE on the normalised Chamfer; the largest error where
    the frame shapes agree), its launches a frame on each rank against
    SHARD_RUNS', ms a frame, the f32 dynamic graphs' ties
    (:func:`_graph_ties`, every gap within its limit). ``ranks``: world
    size -> the ranks' results (world size 1 over NCCL, 2 over gloo on the
    one card)."""
    from tpugan_tpu_torch.cli import rollout as cli

    line = {"phase": "sharded_rollout", "frames": SHARD_FRAMES,
            "points": SHARD_POINTS}
    launches = {n: 0 for n in ranks[1][0]["sharded"]["f32_dynamic"]["launches"]}
    for name, extra, per in SHARD_RUNS:
        ref_dir = os.path.join(PARALLEL_DIR, "unsharded", name)
        cli.main(_shard_argv(name, extra, ref_dir, False))
        ref = [np.load(os.path.join(ref_dir, f"pred_{i}.npy"))
               for i in range(SHARD_FRAMES)]
        entry = {"unsharded": _unsharded_ms(torch, cli, _shard_argv(
            name, extra, ref_dir, False))}
        for world, outs in sorted(ranks.items()):
            wdir = os.path.join(PARALLEL_DIR, f"world{world}", name)
            got = [np.load(os.path.join(wdir, f"pred_{i}.npy"))
                   for i in range(SHARD_FRAMES)]
            close = [_frames_close(torch, dev, g, w) for g, w in zip(got, ref)]
            errs = [e for _, e, _ in close if e is not None]
            for r, o in enumerate(outs):
                sh = o["sharded"][name]
                expect(sh["launches"], {k: v * SHARD_FRAMES
                                        for k, v in per.items()},
                       f"sharded rollout {name}, world {world}, rank {r}")
                for k, v in sh["launches"].items():
                    launches[k] += v
            entry[f"world{world}"] = {
                "backend": outs[0]["backend"],
                "chamfer_norm_max": max(c for c, _, _ in close),
                "max_abs_err": max(errs) if errs else None,
                "frames_same_shape": len(errs),
                "bit_for_bit": all(b for _, _, b in close),
                "launches_per_frame_per_rank": per,
                "ms_per_frame": [o["sharded"][name]["ms_per_frame"]
                                 for o in outs],
                "wall_ms_per_frame": [o["sharded"][name]["wall_ms_per_frame"]
                                      for o in outs]}
            ties = [o["sharded"][name].get("graph_ties") for o in outs]
            if ties[0] is not None:
                entry[f"world{world}"]["graph_ties"] = ties
            if not (entry[f"world{world}"]["chamfer_norm_max"] < SHARD_GATE
                    and all(t is None or t["max_gap_over_limit"] <= 1.0
                            for t in ties)):
                raise AssertionError(f"sharded rollout {name}, world {world}: "
                                     f"{entry[f'world{world}']}")
        line[name] = entry
    line["gate"] = SHARD_GATE
    emit(line)
    return launches


def _rel_errs(got: dict, want: dict) -> list:
    """Relative errors of every loss (the gate left out)."""
    return [abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items()
            if k != "gate"]


def _outside_spread(value: float, seen: list) -> float:
    """How far ``value`` lies outside [min, max] of ``seen``, in units of
    that spread (0 inside; a spread of 0 counts as 1e-12)."""
    lo, hi = min(seen), max(seen)
    return max(0.0, lo - value, value - hi) / max(hi - lo, 1e-12)


def data_parallel(torch, ranks):
    """The phase lines of the data-parallel runs (the module docstring's
    data_parallel). ms a step (G only and G+D), the collectives' share and
    count a step at world size 2 (and the plain-stack run's count, which
    the kernel's must not exceed), peak memory a rank. Returns (the runs'
    launches, rank 0's pooled-MLP rows at the two-rank shapes)."""
    one, two = ranks[1][0]["dp"], ranks[2]
    keys = sorted(one)
    runs1 = [one[k] for k in keys]
    dp_runs = [one[k] for k in keys if k.endswith("_dp")]
    plain_runs = [one[k] for k in keys if k.endswith("_plain")]
    ref = dp_runs[0]["steps"]
    for run in runs1:
        if run["steps"][0]["metrics"] != ref[0]["metrics"]:
            raise AssertionError(f"world 1: first step {run['steps'][0]} vs "
                                 f"{ref[0]}")
        for s, r in zip(run["steps"], ref):
            if (s["launches"] != r["launches"]
                    or s["metrics"]["gate"] != r["metrics"]["gate"]):
                raise AssertionError(f"world 1: iteration {s['iteration']} "
                                     f"{s['metrics']} {s['launches']} vs "
                                     f"{r['metrics']} {r['launches']}")
    if not dp_runs[0].get("checkpoint_read_back_equal"):
        raise AssertionError("world 1: the DP checkpoint read back differs")
    fl = [o["dp"]["fluid_0_dp"] for o in two]
    first = max(_rel_errs(fl[0]["steps"][0]["metrics"], ref[0]["metrics"]))
    outside, worst = [], []
    for i, (a, b, r) in enumerate(zip(fl[0]["steps"], fl[1]["steps"], ref)):
        if a["digest"] != b["digest"] or a["metrics"] != b["metrics"]:
            raise AssertionError(f"world 2, iteration {a['iteration']}: the "
                                 f"ranks differ")
        for o in fl:
            expect(o["steps"][i]["launches"], r["launches"],
                   f"world 2 step {a['iteration']}")
        if a["metrics"]["gate"] != r["metrics"]["gate"]:
            raise AssertionError(f"world 2 iteration {a['iteration']}: gate")
        if i:
            seen = {k: [run["steps"][i]["metrics"][k] for run in runs1]
                    for k in a["metrics"] if k != "gate"}
            k = max(seen, key=lambda k: _outside_spread(a["metrics"][k],
                                                        seen[k]))
            outside.append(_outside_spread(a["metrics"][k], seen[k]))
            worst.append({"iteration": a["iteration"], "metric": k,
                          "world2": a["metrics"][k],
                          "world1": [min(seen[k]), max(seen[k])]})
    if not (first <= DP_LOSS_TOL_FIRST and max(outside) <= DP_SPREAD_WIDEN):
        raise AssertionError(f"world 2 vs 1: first step off by {first}, "
                             f"later steps outside the spread by {outside}"
                             f" (the farthest metric a step: {worst})")
    act = [o["dp"]["action_dp"] for o in two]
    for a, b in zip(act[0]["steps"], act[1]["steps"]):
        if a["digest"] != b["digest"] or not all(
                np.isfinite(v) for v in a["metrics"].values()):
            raise AssertionError(f"action world 2 iteration {a['iteration']}")
    if len(act[0]["steps"]) != DP_ACTION_ITERS - 20000:
        raise AssertionError("action world 2: steps")
    stack = [o["dp"]["fluid_plain_stack"] for o in two]
    coll = [s["collectives"] for s in fl[0]["steps"]]
    coll_stack = [s["collectives"] for s in stack[0]["steps"]]
    if (len(coll_stack) != DP_PLAIN_STACK_ITERS - 20000
            or any(a > b for a, b in zip(coll, coll_stack))
            or any(s["launches"].get("pooled_mlp_fwd", 0)
                   for s in stack[0]["steps"])):
        raise AssertionError(f"world 2: {coll} collectives a step with the "
                             f"pooled kernel, {coll_stack} on the plain stack")
    summary = lambda runs: {
        "ms": [s["ms"] for r in runs for s in r["steps"]],
        "generator_ms": [s["generator_ms"] for r in runs for s in r["steps"]]}
    spread = [{k: [min(run["steps"][i]["metrics"][k] for run in runs1),
                   max(run["steps"][i]["metrics"][k] for run in runs1)]
               for k in ref[i]["metrics"] if k != "gate"}
              for i in range(len(ref))]
    emit({"phase": "data_parallel", "world": 1, "backend": "nccl",
          "iterations": [s["iteration"] for s in ref],
          "turns": list(DP_TURNS), "dp": summary(dp_runs),
          "plain": summary(plain_runs), "first_step_equal": True,
          "loss_spread_by_step": spread,
          "launches": [s["launches"] for s in ref],
          "peak_gib": [r["peak_gib"] for r in runs1]})
    emit({"phase": "data_parallel", "world": 2, "backend": "gloo",
          "ranks_equal_every_step": True, "first_step_rel_err": first,
          "first_step_tol": DP_LOSS_TOL_FIRST,
          "outside_spread_by_step": outside, "outside_spread_worst": worst,
          "spread_widen": DP_SPREAD_WIDEN,
          "fluid": {**summary([fl[0]]),
                    "metrics": [s["metrics"] for s in fl[0]["steps"]],
                    "collective_share": [s["collective_share"]
                                         for s in fl[0]["steps"]],
                    "collectives_per_step": coll,
                    "plain_stack": {
                        **summary([stack[0]]),
                        "collectives_per_step": coll_stack,
                        "collective_share": [s["collective_share"]
                                             for s in stack[0]["steps"]],
                        "launches": [s["launches"]
                                     for s in stack[0]["steps"]]},
                    "launches": [s["launches"] for s in fl[0]["steps"]],
                    "peak_gib": [o["peak_gib"] for o in fl]},
          "action_fast_d": {**summary([act[0]]),
                            "collective_share": [s["collective_share"]
                                                 for s in act[0]["steps"]],
                            "launches": [s["launches"] for s in act[0]["steps"]],
                            "peak_gib": [o["peak_gib"] for o in act]}})
    launches = {}
    for run in dp_runs:
        for s in run["steps"]:
            for k, v in s["launches"].items():
                launches[k] = launches.get(k, 0) + v
    for o in two:
        for run in (o["dp"]["fluid_0_dp"], o["dp"]["action_dp"]):
            for s in run["steps"]:
                for k, v in s["launches"].items():
                    launches[k] = launches.get(k, 0) + v
    rows = two[0]["dp"]["pooled_rows"]
    for kernel, rs in rows.items():
        for r in rs:
            emit({"phase": "kernel", "kernel": kernel, **r})
    return launches, rows


def add_parallel_units(line, rows, launches):
    """Into the kernel line's entries: the largest f32 error of the rows
    at the parallel paths' shapes (:func:`check_path_kernels`), their
    times summed over rank 0's calls at two ranks under "sharded_rollout"
    and "data_parallel", and every entry's launches on the two new paths
    (``launches``: path -> counts)."""
    per = {"sharded_rollout": "the counted runs' calls on rank 0 of two: 5 "
                              "frames of 40,960 points in each of f32 "
                              "dynamic and bf16 static",
           "data_parallel": "the counted runs' calls on rank 0 of two: the "
                            "fluid run's 4 steps and the action --fast_d "
                            "run's 2, each rank on its half of the batch"}
    for entry in line["kernels"]:
        rs = rows.get(entry["name"], [])
        f32 = [r for r in rs if r.get("dtype", "f32") == "f32"]
        if f32:
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       max(r["max_abs_err"] for r in f32))
        for path, what in per.items():
            prs = [r for r in rs if r["path"] == path and r["world"] == 2]
            if not prs:
                continue
            keys = [k for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                "library_ms") if all(r.get(k) is not None
                                                     for r in prs)]
            entry[path] = {"times_are": what, "shapes": len(prs),
                           **{k: sum(r[k] * r["calls"] for r in prs)
                              for k in keys}}
        entry["launches_by_path"].update(
            {p: c.get(entry["name"], 0) for p, c in launches.items()})
        entry["launches"] = sum(entry["launches_by_path"].values())


def kernel_line(groups):
    """One entry per kernel. ``groups``: (name, source, replaces, rows,
    weight keys, what the times sum over, launches by path); times are sums
    over the shapes, each weighted by the sum of its weight keys (how often
    it runs in the unit the times are given for); launches are those of
    every counted path."""
    def total(rows, key, weights):
        if any(r[key] is None for r in rows):
            return None
        return sum(r[key] * sum(r.get(w, 0) for w in weights) for r in rows)

    entries = []
    for name, source, replaces, rows, weights, per, by_path in groups:
        by = {r["bound_by"] for r in rows}
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total(rows, "ms", weights),
            "plain_ms": total(rows, "plain_ms", weights),
            "bound_ms": total(rows, "bound_ms", weights),
            "bound_by": by.pop() if len(by) == 1 else "operations",
            "library_ms": total(rows, "library_ms", weights),
            "times_are": per, "launches_by_path": by_path})
    return {"kernels": entries}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one forward of each serving mode, and "
                         "write the profile tables into DIR")
    ap.add_argument("--rank-worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_worker:
        return rank_worker(args.rank_worker)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    from tpugan_tpu_torch import _build
    from tpugan_tpu_torch.ops.kernels import edgeconv

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    build_s = _build.build_all()
    tc_ptxas = ptxas_summary("edgeconv", "edgeconv_tc_kernel")
    f32t_ptxas = ptxas_summary("edgeconv", "edgeconv_f32t_kernel")
    # the redesigned f32 EdgeConv backward (csrc/edgeconv.cu : bwdt on GEMM
    # tiles, rowf one plane-row a thread), and every instance of it
    bwdt_kernels = ("bwd_rows", "dw_gemm", "bwd_ties", "bwd_gctr", "bwd_edge",
                    "bwd_narrow", "rowf_fwd", "rowf_bwd")
    bwdt_ptxas = {f: ptxas_summary("edgeconv", f) for f in bwdt_kernels}
    bwdt_instances = ptxas_instances("edgeconv", bwdt_kernels)
    spilled = {n: v for n, v in bwdt_instances.items() if v[1]}
    if spilled:
        raise AssertionError(f"edgeconv backward instances spill: {spilled}")
    # the pooled-MLP GEMM blocks, every instance of both forms (the
    # affine form's dz operand: kScale)
    pmlp_ptxas = {f: ptxas_summary("pooled_mlp", f)
                  for f in ("rows_gemm", "dw_gemm", "top_kernel")}
    pmlp_instances = ptxas_instances("pooled_mlp", ("rows_gemm", "dw_gemm",
                                                    "top_kernel",
                                                    "pool_extremes"))
    # the cell-grid interp's walk (every kind and value-width instance), its
    # tiles and its keys
    binned_ptxas = {f: ptxas_summary("binned_interp", f)
                    for f in ("binned_walk", "make_tiles", "query_keys")}
    binned_instances = ptxas_instances("binned_interp", ("binned_walk",))
    spilled = {n: v for n, v in {**pmlp_instances, **binned_instances}.items()
               if v[1]}
    if spilled:
        raise AssertionError(f"pooled_mlp / binned_interp instances spill: "
                             f"{spilled}")
    # the FPS kernel's two variants, every points-per-thread instance
    fps_ptxas = {f: ptxas_summary("fps", f) for f in ("fps_warp", "fps_cluster")}
    # nn1's and the dense interp's split kernels (every C instance) and
    # their merge passes
    nn1_ptxas = {f: ptxas_summary("nn1", f)
                 for f in ("nn1_split_kernel", "nn1_finish")}
    interp_ptxas = {f: ptxas_summary("interp", f)
                    for f in ("interp_split_kernel", "interp_finish")}
    # the approximate kNN's every (DK, KP, WQ) instance and its row
    # preparation, and the ball query's kernel
    approx_ptxas = {f: ptxas_summary("knn", f)
                    for f in ("approx_kernel", "approx_prep")}
    ball_ptxas = {"ball_query_kernel": ptxas_summary("ball_query",
                                                     "ball_query_kernel")}
    for name, rep in [("edgeconv_tc_kernel", tc_ptxas),
                      ("edgeconv_f32t_kernel", f32t_ptxas),
                      *bwdt_ptxas.items(), *pmlp_ptxas.items(),
                      *fps_ptxas.items(), *nn1_ptxas.items(),
                      *interp_ptxas.items(), *approx_ptxas.items(),
                      *ball_ptxas.items(), *binned_ptxas.items()]:
        if rep["functions"] == 0 or rep["spill_store_bytes"]:
            raise AssertionError(f"{name} ptxas: {rep}")
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s,
          "ptxas": {n: ptxas_summary(n) for n in _build.sources()},
          "ptxas_edgeconv_tc": tc_ptxas,
          "ptxas_edgeconv_f32t": f32t_ptxas,
          "ptxas_edgeconv_bwd_tiled": bwdt_ptxas,
          "ptxas_edgeconv_bwd_instances": bwdt_instances,
          "ptxas_pooled_mlp": pmlp_ptxas,
          "ptxas_pooled_mlp_instances": pmlp_instances,
          "ptxas_binned_interp": binned_ptxas,
          "ptxas_binned_interp_instances": binned_instances,
          "ptxas_fps": fps_ptxas,
          "ptxas_nn1": nn1_ptxas,
          "ptxas_interp": interp_ptxas,
          "ptxas_knn_approx": approx_ptxas,
          "ptxas_ball_query": ball_ptxas})

    kernels = _kernels()
    rng = np.random.default_rng(0)
    knn_rows = check_knn(torch, dev, rng)
    approx_rows = check_knn_approx(torch, dev, rng)
    ec_rows = check_edgeconv(torch, dev, rng)
    nn1_rows = check_nn1(torch, dev, rng)
    fps_rows = check_fps(torch, dev, rng)
    bq_rows = check_ball_query(torch, dev, rng)
    pf_rows, pb_rows = check_pooled_mlp(torch, dev, rng)
    ip_rows = check_interp(torch, dev, rng)
    eb_rows = check_edgeconv_bwd(torch, dev, rng)
    af_rows, ab_rows = check_pooled_affine_bwd(torch, dev, rng)
    act_rows = check_action_kernels(torch, dev)
    act_train_rows = check_action_train_kernels(torch, dev)
    surface_rows = check_surface_kernels(torch, dev)
    fast_d_rows = check_fast_d_kernels(torch, dev)

    # the serving path: counts start at 0 here and are read after the rollout
    for k in kernels.values():
        k.launches = 0
    edgeconv.TC_LAUNCHES = edgeconv.F32_TILED_LAUNCHES = 0
    (f32, bf16), (feat, pos, pos_np) = serving(torch, dev, kernels)
    rollout(torch, bf16, kernels)
    serving_launches = counts(kernels)
    serving_variants = {"tc": edgeconv.TC_LAUNCHES,
                        "f32t": edgeconv.F32_TILED_LAUNCHES}

    # checks and timings past the counted run
    result = cpu_reference(torch, dev, pos_np)
    with torch.no_grad():
        result["f32_dynamic_ms_per_frame"] = time_ms(lambda: f32(feat, pos),
                                                     torch)
        result["bf16_static_ms_per_frame"] = time_ms(lambda: bf16(feat, pos),
                                                     torch)
    emit({"phase": "timing", **result})
    if args.profile:
        profile(torch, "f32_dynamic", f32, feat, pos, args.profile)
        profile(torch, "bf16_static", bf16, feat, pos, args.profile)

    # the approximate serving path: counts start at 0 here and are read
    # after its rollout
    for k in kernels.values():
        k.launches = 0
    approx_line = serving_approx(torch, (f32, bf16), feat, pos, kernels)
    rollout(torch, bf16, kernels, approx=True)
    serving_approx_launches = counts(kernels)
    for name, model in (("f32_dynamic", f32), ("bf16_static", bf16)):
        approx_line[name]["ms_per_frame"] = approx_ms(torch, model, feat, pos)
    emit(approx_line)
    del f32, bf16

    # the train path: counts reset to 0 inside, read after its 4 steps; its
    # peak memory from here (resuming the trainer state included)
    torch.cuda.reset_peak_memory_stats()
    train_launches, _ = train(torch, dev, kernels, args.profile)
    train_card_vs_cpu(torch, dev)

    # the fused-train path: the CLI twin with the switch on (counts reset
    # inside, read after each step and after the CLI returns)
    fused_launches = fused_train(torch, dev, kernels)
    fused_vs_grouped(torch, dev, args.profile)

    # the eval path (counts reset inside, read after each sample), then the
    # densities (reset inside, read before the kernel comparisons)
    eval_launches = eval_phase(torch, kernels)
    eval_approx_launches = eval_approx(torch, kernels)
    density_launches, bi_rows = density_phase(torch, dev, kernels)
    eval_card_vs_cpu(torch, dev)

    # the library functions (counts reset inside, read after their drive)
    library_launches = library_phase(torch, dev, kernels)

    # the action paths: the demo's clip, then ActionCls inference and the
    # eval_tempo_feat CLI (counts reset before each, read inside)
    for k in kernels.values():
        k.launches = 0
    edgeconv.TC_LAUNCHES = edgeconv.F32_TILED_LAUNCHES = 0
    action_launches = action_serving(torch, dev, kernels)
    for k in kernels.values():
        k.launches = 0
    tempo_launches = tempo_feat(torch, dev, kernels)

    # the action GAN training: the CLI twin with the fused switch (counts
    # reset inside, read after each step and after the CLI returns), then
    # the switch's and the card-vs-CPU checks
    action_train_launches = action_train(torch, dev, kernels, args.profile)
    action_fused_vs_grouped(torch, dev)
    action_card_vs_cpu(torch, dev)

    # both train recipes as their scripts run them: host sampling through
    # the native library, no fused switch (counts and the library's calls
    # reset before each CLI run, read after it), then the loader alone
    recipe_launches, native_line = train_recipes(torch, dev, kernels, smi)

    # the fluid serving and data surfaces: the rollout CLI, bench_metrics
    # and the fluid demo (counts reset before each, read inside)
    for k in kernels.values():
        k.launches = 0
    rollout_cli_launches = rollout_cli(torch, dev, kernels)
    for k in kernels.values():
        k.launches = 0
    bench_launches, bench_row = bench_metrics_phase(torch, dev, kernels)
    for k in kernels.values():
        k.launches = 0
    demo_launches = fluid_demo_phase(torch, kernels)

    # the stacked-critic train path (--fast_d): the critics' stacked applies
    # against their sequential ones, then both CLI twins with --fast_d
    # (counts reset inside, read after each step and after the CLI returns)
    fast_d_critics(torch, dev)
    fast_d_launches = train_fast_d(torch, dev, kernels, False, args.profile)
    action_fast_d_launches = train_fast_d(torch, dev, kernels, True,
                                          args.profile)

    # the parallel paths: one rank over NCCL and two ranks over gloo on the
    # one card, each running the sharded rollout CLI and the data-parallel
    # train CLIs (counts reset inside each rank before each run, read
    # after), then every kernel at the shapes the ranks recorded
    ranks = {w: launch_ranks(w, b, os.path.join(PARALLEL_DIR, f"world{w}"))
             for w, b in ((1, "nccl"), (2, "gloo"))}
    sharded_launches = sharded_rollout(torch, dev, ranks)
    dp_launches, dp_pooled_rows = data_parallel(torch, ranks)
    parallel_launches = {"sharded_rollout": sharded_launches,
                         "data_parallel": dp_launches}
    path_rows = check_path_kernels(torch, dev, path_shapes(ranks))
    path_rows.update(dp_pooled_rows)

    by_path = {n: {"serving": serving_launches[n], "train": train_launches[n],
                   "train_fused": fused_launches[n], "eval": eval_launches[n],
                   "density": density_launches[n],
                   "serving_approx": serving_approx_launches[n],
                   "eval_approx": eval_approx_launches[n],
                   "action_serving": action_launches[n],
                   "tempo_feat": tempo_launches[n],
                   "train_action": action_train_launches[n],
                   "train_recipe_fluid": recipe_launches["fluid"][n],
                   "train_recipe_action": recipe_launches["action"][n],
                   "rollout_cli": rollout_cli_launches[n],
                   "bench_metrics": bench_launches[n],
                   "fluid_demo": demo_launches[n],
                   "train_fast_d": fast_d_launches[n],
                   "train_action_fast_d": action_fast_d_launches[n],
                   "library": library_launches[n]}
               for n in kernels}
    ec_f32 = [r for r in ec_rows if r["dtype"] == "f32"]
    pallas = "tpugan_tpu/ops/pallas/"
    step = ("per_step",), "one G+D train step"
    line = kernel_line([
        ("knn", "tpugan_tpu_torch/csrc/knn.cu", pallas + "knn_kernel.py:351",
         knn_rows, ("per_forward", "per_step", "per_sample", "per_density"),
         "one f32 dynamic forward (7 graphs) plus one G+D train step "
         "(7 generator graphs, 9 flow embeddings) plus the eval sample's "
         "capped interpolation plus the capped density", by_path["knn"]),
        ("knn_approx", "tpugan_tpu_torch/csrc/knn.cu",
         pallas + "knn_kernel.py:351 (approx=True)", approx_rows,
         ("per_forward", "per_static", "per_frame"),
         "one f32 dynamic forward (7 graphs) plus one bf16 static forward "
         "(1) plus one rollout frame (1), with the approximate graph kNN on",
         by_path["knn_approx"]),
        ("edgeconv", "tpugan_tpu_torch/csrc/edgeconv.cu",
         pallas + "edgeconv_kernel.py:358", ec_f32, ("per_forward",),
         "one f32 dynamic forward (9 EdgeConvs)", by_path["edgeconv"]),
        ("edgeconv_bwd", "tpugan_tpu_torch/csrc/edgeconv.cu",
         pallas + "edgeconv_kernel.py:277", eb_rows, ("per_step",),
         "one fused train step (9 EdgeConv backwards, f32)",
         by_path["edgeconv_bwd"]),
        ("nn1", "tpugan_tpu_torch/csrc/nn1.cu", pallas + "nn1_kernel.py:124",
         nn1_rows, ("per_gate", "per_step", "per_sample"),
         "one Chamfer gate (2 directions) plus one train step (Chamfer, "
         "masking target) plus one eval sample (4 directions)",
         by_path["nn1"]),
        ("fps", "tpugan_tpu_torch/csrc/fps.cu", pallas + "fps_kernel.py:152",
         fps_rows, *step, by_path["fps"]),
        ("ball_query", "tpugan_tpu_torch/csrc/ball_query.cu",
         pallas + "ball_query_kernel.py:57", bq_rows, *step,
         by_path["ball_query"]),
        ("pooled_mlp_fwd", "tpugan_tpu_torch/csrc/pooled_mlp.cu",
         pallas + "pooled_mlp_kernel.py:624", pf_rows, *step,
         by_path["pooled_mlp_fwd"]),
        ("pooled_mlp_bwd", "tpugan_tpu_torch/csrc/pooled_mlp.cu",
         pallas + "pooled_mlp_kernel.py:519", pb_rows, *step,
         by_path["pooled_mlp_bwd"]),
        ("pooled_mlp_affine", "tpugan_tpu_torch/csrc/pooled_mlp.cu",
         pallas + "pooled_mlp_kernel.py:684", act_rows["pooled_mlp_affine"],
         ("per_infer",), "one ActionCls.infer batch (24 clips x 3 frames x "
         "2,048 points: 3 sa1, 3 sa2 and 1 sa_pooling forwards)",
         by_path["pooled_mlp_affine"]),
        ("pooled_mlp_affine_bwd", "tpugan_tpu_torch/csrc/pooled_mlp.cu",
         pallas + "pooled_mlp_kernel.py:499", ab_rows, ("per_check",),
         "one call at each of sa_0 and group_all (no main path runs it)",
         by_path["pooled_mlp_affine_bwd"]),
        ("interp", "tpugan_tpu_torch/csrc/interp.cu",
         pallas + "interp_kernel.py:89", ip_rows, *step, by_path["interp"]),
        ("binned_interp", "tpugan_tpu_torch/csrc/binned_interp.cu",
         pallas + "binned_interp_kernel.py:333", bi_rows, ("per_density",),
         "one density phase (the frame's and the grid's exact densities)",
         by_path["binned_interp"]),
    ])
    # the pooled-MLP, FPS, ball query and dense interp rows' device time
    # (torch.profiler) per G+D step, the EdgeConv backward's per fused step,
    # nn1's per gate + step + eval sample, the approximate kNN's per f32
    # dynamic + bf16 static forward + rollout frame, and the EdgeConv
    # backward's launches on GEMM tiles
    device_rows = {"knn_approx": (approx_rows, ("per_forward", "per_static",
                                                "per_frame")),
                   "ball_query": (bq_rows, ("per_step",)),
                   "pooled_mlp_fwd": (pf_rows, ("per_step",)),
                   "pooled_mlp_bwd": (pb_rows, ("per_step",)),
                   "edgeconv_bwd": (eb_rows, ("per_step",)),
                   "fps": (fps_rows, ("per_step",)),
                   "interp": (ip_rows, ("per_step",)),
                   "nn1": (nn1_rows, ("per_gate", "per_step", "per_sample")),
                   "pooled_mlp_affine": (act_rows["pooled_mlp_affine"],
                                         ("per_infer",)),
                   "pooled_mlp_affine_bwd": (ab_rows, ("per_check",)),
                   "binned_interp": (bi_rows, ("per_density",))}
    for entry in line["kernels"]:
        if entry["name"] in device_rows:
            rows, weights = device_rows[entry["name"]]
            entry["device_ms"] = sum(r["device_ms"] * sum(r[w] for w in weights)
                                     for r in rows)
        if entry["name"] == "edgeconv_bwd":
            entry["train_fused_tiled_launches"] = fused_launches[
                "edgeconv_bwd_tiled"]
            entry["train_fused_general_launches"] = (
                fused_launches["edgeconv_bwd"]
                - fused_launches["edgeconv_bwd_tiled"])
    add_action_units(line, act_rows, af_rows)
    add_action_train_units(line, act_train_rows, action_train_launches)
    add_surface_units(line, surface_rows, bench_row)
    add_fast_d_units(line, fast_d_rows,
                     {"train_fast_d": fast_d_launches,
                      "train_action_fast_d": action_fast_d_launches})
    add_parallel_units(line, path_rows, parallel_launches)
    # the EdgeConv forward's times per bf16 static forward beside the f32's
    ec_bf16 = [r for r in ec_rows if r["dtype"] == "bf16"]
    ec_entry = next(e for e in line["kernels"] if e["name"] == "edgeconv")
    ec_entry["bf16_static"] = {
        key: sum(r[key] * r["per_forward"] for r in ec_bf16)
        for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
    ec_entry["bf16_static"]["times_are"] = (
        "one bf16 static forward (9 EdgeConvs, all on the tensor-core kernel)")
    # of which the six launches at EdgeConv_0's, the IDGCN's and the mask
    # head's sum classes
    narrow = [r for r in ec_bf16 if (r["C"], r["H"], r["O"]) != (64, 128, 256)]
    ec_entry["bf16_static"]["narrow_classes"] = {
        key: sum(r[key] * r["per_forward"] for r in narrow)
        for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
    ec_entry["bf16_static"]["narrow_classes"]["launches"] = sum(
        r["per_forward"] for r in narrow)
    # of the serving path's EdgeConv launches, those of each kernel variant
    ec_entry["serving_launches_by_variant"] = {
        **serving_variants,
        "simt": by_path["edgeconv"]["serving"] - sum(serving_variants.values())}
    ec_entry["action_serving_launches_by_variant"] = {
        "f32t": ACTION_FRAME_F32T * ACTION_FRAMES,
        "simt": by_path["edgeconv"]["action_serving"]
        - ACTION_FRAME_F32T * ACTION_FRAMES}
    # the native host library is host code, not a TPU kernel: its own line
    emit(native_line)
    emit(line)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
