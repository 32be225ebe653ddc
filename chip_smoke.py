#!/usr/bin/env python3
"""Checks the PyTorch port of the CEM planner on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. card       name and power limit from nvidia-smi;
  2. build      nvcc builds the kernel sources of csrc/ in parallel (timed,
                with each cell kernel's registers and spills from ptxas);
  3. masks      capsule-mask kernel == its plain version, bit for bit, on
                the cases of tests/torch_mask_cases.py that the GPU tests
                run: 500 planner poses through the port's renderer and
                2000 (four requests planned together), other
                counts and sizes (M = 1, 37 and 0; S = 1, 8 and 13; 48x64,
                48x62 whose rows take 4-byte stores, and 5x7), capsules off
                the image, degenerate, with zero and negative radii, covering
                the image, near +-1e6, ending on a tile's edge, non-finite;
  4. cell       the ConvLSTM-cell kernels vs their plain version at the
                planner's shapes (B=100, 6x8, Cx=C=256, k=5 and k=3), the
                trainer's eval shapes (B=16, the same otherwise) and those
                of 2 and 4 requests planned together (B=200, 400): the
                wgmma/TMA kernel in bf16 and the float32 kernel
                (csrc/conv_lstm_cell_f32.cu); then the shapes that took the
                retired WMMA kernel before, every bf16 one
                through the wgmma/TMA kernel, one launch each, with what it
                cannot read in place staged (kernels.stage_cell): 13/20, odd
                C 13/21, det's 260 and 258 contiguous and in padded views
                with NaN pad lanes, g_dims 252 and 100 at B=100 (x
                contiguous, h and c padded views), 260 channels on a
                262-channel pixel stride, and a misaligned x;
  5. parity     a small float32 CEM plan on the GPU (kernels) equals the
                same plan on the CPU (plain versions) for injected noise;
  6. plan       the canonical planner of bench.py (svg, g_dim 256, z_dim 64,
                bf16, dontcare, N=100, horizon 5, opt_iter 10, topk 5) with
                weights initialised from a seed: one warm-up plan and three
                timed plans, each of which must launch the cell 160 times,
                every time through the wgmma/TMA kernel, and the mask
                kernel 10 times; then the same config with compute_dtype
                float32 (seed-0 weights, TF32 off): one warm-up and three
                timed plans, each finite and shaped (4, 2), each launching
                the cell 160 times, every time through the float32 kernel
                and never through sm90, and the mask kernel 10 times;
  7. profile    one more canonical plan under torch.profiler, bf16 and
                float32: device time by kernel, the share of the plan the
                device was busy, and (float32) the cell kernel's share;
  8. train      SVG training (training/step.py, training/trainer.py):
                GPU-vs-CPU parity of one small float32 train step (loss,
                metrics, gradients, BatchNorm statistics; TF32 off) and of
                one eval step through the float32 cell kernel; the
                trainer's full-width bf16 eval step (B=16) with the cell
                kernel against the same step with its plain version; at the
                training config of bench.py:136-156 (g_dim 256, z_dim 64,
                batch 128, window 6, bf16) 2 warm-up and 5 timed steps for
                each of remat none, full and conv (median step time,
                frames/s = 128 x 6 / step, peak memory, no kernel
                launched, one profiled step), the step's FLOP count and
                bound; then PredictionTrainer at full width on the
                synthetic experiment: it trains, runs its eval epoch
                through the wgmma/TMA cell kernel and its eval gif's
                rollout (launches counted), writes a checkpoint, and a
                second trainer resumes from it;
  9. kernels    per kernel: launches in phase 6 (the cell at det's shapes:
                in phase 11's det plans), device time per launch
                (CUDA events) at the planner's shapes, its plain version's
                time, the least time the card could take (bound), and a
                PyTorch library call's time (for the cell also at the eval
                shapes, reported apart); for the
                mask kernel also the operations dense and those its inputs
                need, its time with every tile culled and with none culled,
                the share of tests its skip rule keeps (the rule replayed in
                PyTorch) and its registers and spills; for the cell per
                planner shape the GFLOP it multiplies and its schedule
                (tiles, k-steps, blocks in clusters of two, waves, fill,
                workspace); the cell is also timed at B = 16, 200 and 400,
                and at g_dims 252 and 100 and at 13/20 (B = 100): the call
                with its staging copies in turns with the kernel alone on
                staged inputs, the copies alone, the plain version, cuDNN's
                gate conv and the bound;
                the float32 kernel (launches: the float32 plans of phase
                6) at B = 16, 100, 200 and 400 (256 channels, k = 5 and 3)
                and at det's shapes (B = 100, 260 channels in padded
                views), each held to its plain version (1e-4) and timed
                beside it, cuDNN's float32 gate conv (TF32 off) and its
                bound at 67 TFLOP/s, with its schedule (tile shape chosen
                per launch, tiles, blocks an SM) and registers;
 10. serve      plan serving (control/plan_server.py) at the planning
                config of phase 6: the cell kernel returns identical bits
                over 50 launches of identical inputs at B = 16, 100, 200
                and 400 (k = 5 and 3), and for rows of a B = 100 launch
                placed at offsets 0 and 100 of B = 200 launches and 0, 100,
                200 and 300 of B = 400 launches, at 256 channels and at
                det's 260 (padded views, NaN pad lanes; the wgmma/TMA
                kernel at 13/20 in padded views and staged, and the float32
                kernel, at small shapes); one request
                planned 3 times gives one plan, and get_action_batched of
                R = 2, 3 (padded to 4) and 4 requests equals their single
                plans bit for bit; a batched plan of 4 requests launches
                the cell 160 times, all through sm90 at B = 400, and the
                mask kernel 10 times; one profiled batched plan; then a
                PlanServer on a thread at 127.0.0.1, port 0: one request
                twice, then 3 rounds of 1 client and of 4 concurrent
                clients with distinct requests, every served plan equal to
                its local plan, a micro-batch seen, the launches of the
                served plans counted (160 cells a plan program, all sm90,
                10 masks); latency per request at 1 and 4 clients and plans
                per second at 4 (medians of the 3 rounds).
 11. variants   the model variants a JAX checkpoint can carry, at the
                canonical planning config with weights from a seed:
                (a) heatmap and future-heatmap conditioning, (b) the
                inpaint-blur cost at its defaults (img_dim 128, sigma 10,
                unblur_timestep 1), (c) GroupNorm ConvLSTM cells, (d) the det
                model; for each, one warm-up and three timed plans, finite
                and shaped, launching the cell 160 times through sm90 (a,
                b), 0 times (c) or 80 times through sm90 (d, 260 channels
                in padded views, read in place), and the mask kernel 10
                times; a profiled plan (device time; for (b) the blur's
                share of it, the blur timed by CUDA events, beside a
                255-tap cuDNN depthwise convolution of the same sums); the
                sm90 cell against its plain version at det's shapes (B=16,
                100, 200 and 400, 6x8, Cx=C=260, k=5 and 3; pad lanes of
                x, h and c NaN, one sm90 launch each, finite outputs), and
                det's row of the kernels line: the sm90 kernel, the plain
                version and cuDNN's gate conv, beside the bound;
                GPU-vs-CPU parity of small float32 plans (a, c, d) and
                rollout costs (all four; the blur's within one 1/255 step a
                pixel on another step); each variant's batched plans (R =
                2, 4) equal its single plans bit for bit; GPU-vs-CPU parity
                of a small float32 train step for
                GroupNorm + heatmaps and for det; one train step at the
                training config of bench.py:136-156 for each of those two
                (heatmaps from the batch's states by create_heatmaps); the
                trainer's --model copy baseline on the synthetic experiment;
                a det trainer whose eval epoch runs its cells through sm90
                (launches counted), and a second loading its checkpoint
                through --dynamics_model_ckpt and training on from its step.
 12. data       the data path (data/, training/trainer.py): the port's C++
                resize built with c++ and held against a float64 bilinear
                reference at 64x85 -> 48x64 (1e-5), with its host time a
                frame; whether h5py, cv2 and imageio import here, and the
                HDF5 reader's resize route; record shards of 512 train
                episodes (8 shards of 64) and 32 test episodes
                (data/synthetic.py, 31 frames at 48x64, masks, states,
                actions, qpos) written with numpy alone; a shuffled epoch
                of DataLoader(RecordDataset) with 5 threads timed on the
                host, each shard decoded once; another of 8 batches of 64
                through device_prefetch equal to the host batches bit for
                bit while the consumer's stream sleeps before each read;
                PredictionTrainer at the training
                config of bench.py:136-156 (batch 128, window 6, bf16,
                remat conv) fed by those loaders: niter 1, epoch_size 2,
                its eval epoch and eval gif through sm90 (launches
                counted), a checkpoint and a resume; frames/s and the
                share of the epoch spent waiting in next(train_iter),
                beside the synthetic trainer's at the same batch.
 13. robots     the chain robots and the robot models
                (robot/kinematic_chain.py, robot/analytical.py,
                training/robot_trainer.py, the finetune path of
                training/trainer.py): (a) for each of the 8 chain keys, FK
                on the card against the CPU (1e-5 m), IK to FK-made targets
                (valid; each tip within 1e-5 m of its target where the
                CPU's is and of the CPU's distance), the thin and thick masks
                of the same joints differing only within 1e-3 px of an edge
                (fetch occluded); (b) control_franka and control_wx250s at
                the canonical planning config of phase 6 with seed-0
                weights: one warm-up and three timed plans, each finite,
                shaped (4, 2), clamped, launching the cell 160 times, all
                through sm90, and the mask kernel never; the latency
                (median), the device kernels and host syncs of a plan, a
                profiled plan's busy share, the IK's and the chain
                render's device time at a rollout's shapes (CUDA events),
                the peak memory of a plan; the plan's warm-started IK at a
                rollout's shapes against the CPU's (tips within 1e-5 m) and
                the chain masks of its joints against the CPU env's (equal
                but within 1e-3 px of an edge); get_action_batched of 2 chain
                requests equal to their single plans bit for bit; a small
                float32 chain plan on the card equal to the CPU's with
                injected noise at the CPU's robot trajectory (the IK's
                choice between starts that tie at rounding differs between
                devices); (c) RobotPredictionTrainer at its defaults (hidden
                512, 256 sequences of 8 steps, batch 32, 3 epochs): one
                train step on the card against the CPU's (losses,
                parameters; float32, TF32 off), the state rollout MSE
                falls, the mask IoU in [0, 1], the mask kernel's launches
                in its evals counted and the kernel held bit for bit to its
                plain version on an eval's own segments, the {joint_model,
                gripper_model} checkpoint written; (d) finetune_locobot at
                the training config of bench.py:136-156 (batch 128, window
                6, bf16, remat conv) fed by record shards with the locobot
                bounds attached, starting from a full-width svg checkpoint
                through --dynamics_model_ckpt (step 0, a fresh optimizer),
                once with the analytical robot model and once with
                --learned_robot_model from (c)'s checkpoint: it trains, its
                eval epoch keeps the best of 3 prior samples, the mask
                kernel's and the sm90 cell's launches counted, the mask
                kernel held bit for bit to its plain version on the first
                train window's and eval window's joints of each renderer
                the robot model used; frames/s and
                the data-wait share beside phase 12's records trainer.
 14. families   the other model families (models/svg_vector.py,
                models/cdna.py), the inverse model and the debug_cem plots:
                (a) a small float32 plan of svg_vec, det_vec, cdna_det and
                cdna_robonet on the card equal to the CPU's (1e-4; injected
                action noise), with its launches; (b) each at the canonical
                planning config of phase 6 (the JAX defaults' fc-LSTM
                stacks: rnn_size 256, 2 layers) with seed-0 weights: one
                warm-up and three timed plans, each finite and shaped,
                launching the cell 80 times through sm90 (CDNA: 2 cells a
                model step, g_dim -> g_dim) or never (the vector models),
                and the mask kernel 10 times; a profiled plan; batched ==
                single bit for bit at R = 2 and 4 for cdna_det and svg_vec;
                the sm90 cell held to its plain version on a cdna_det plan's
                own cell inputs (its second model step, k = 5 and 3) and
                timed beside it; (c) one canonical cdna_det plan with
                debug_cem on: the frames its rollout hands save_gif are
                finite and (48, 128, 3), the gif skipped without imageio;
                (d) a small float32 train and eval step of each family on
                the card against the CPU (the vector models with channel
                dropout, the same keep masks on both), one train step at
                the training config of bench.py:136-156 for svg_vec and
                cdna_det (frames/s), and the full-width cdna_det eval step
                (B = 16) with the cell kernel against its plain version
                (1.5e-2, sm90 launches counted); (e) the inverse model: one
                Adam step on the card against the CPU (continuous and
                discretized heads) and 20 steps at batch 128 whose loss
                falls.
 15. sim        the simulated envs, ground-truth CEM, the episode runner
                and the bridge to the reference's checkpoints (envs/,
                planning/gt_rollout.py, control/episode_runner.py,
                models/torch_import.py, torch_export.py; cases in
                tests/torch_sim_cases.py): (a) LocobotPush (contact),
                LocobotPick (grab, carry, release, drop) and ClutterPush (a
                chain of three blocks), 20 scripted steps each on the card
                against the CPU: positions and joints within 1e-5, images
                within 1e-5, masks bit-equal; (b) the mask kernel at one GT
                iteration's launch (M = 100 x 4 thin capsules) and at one
                observation's (M = 1) equal to its plain version bit for
                bit, timed by CUDA events beside its plain version and its
                bound; (c) GT CEM plans in LocobotPush at N = 100, horizon
                5, opt_iter 10, topk 5: a warm-up and three timed plans
                (median), each launching the mask kernel 10 times and the
                cell never, a profiled plan's device time and busy share,
                its host syncs; a small GT plan on the card equal to the
                CPU's within 1e-5 with injected noise; one env step's host
                syncs and mask launches; (d) one 4-step PushEpisodeRunner
                episode with GT dynamics and one with the canonical svg
                (bf16, seed-0 weights), each following a demo made in
                memory by demo_from_history: plan latency a step, env step
                time, the sm90 cell's and the mask kernel's launches, a
                finite summary; (e) a reference-layout state dict built on
                the host, loaded on the card through torch_import, plans bit
                for bit as the same weights loaded through convert.py.
 16. experiments the paper's pick and transfer experiments on the card
                through the record route (h5py hidden if installed), at the
                Config defaults' widths (svg, g_dim 128, z_dim 10, rnn_size
                256, bf16; pick's plans at N = 30, horizon 5, opt_iter 10,
                topk 5), cut in depth only (tests/torch_experiment_cases.py:
                EXPERIMENT_CUTS, TRANSFER_CUTS): (a) 8 LocobotPick episodes
                collected on the card into record shards: episodes/s, the
                shards, the train/test split; (b) experiments.pick.main end
                to end: collection, shards, training frames/s, the learned
                pick episodes' plan latency a step (median) and env step
                time, one plan's host syncs, the mask kernel's and the sm90
                cell's launches over the run (each > 0), a finite
                pick_results.json; (c) experiments.transfer.main end to
                end: transfer_results.json (finite; its ratio printed, not
                asserted) and the sm90 cell's launches, all of them in
                eval_transfer; (d) the random-init I3D and the random FVD
                embedder on the card against the CPU on the same weights
                (1e-4 of the largest |output|, TF32 off), the I3D's embed
                time for 16 videos of 10 frames at 48x64, evaluate_fvd of
                (c)'s robot-aware checkpoint (finite, its caveat beside
                it); (e) the runner's default CycleGAN translating on the
                card as on the CPU (1e-4), one train_step on the card, and
                a 2-step PushEpisodeRunner episode with --cyclegan (GT
                dynamics) following a demo made by demo_from_history.
 17. raw        the public RoboNet raw layout (data/raw_robonet.py, the
                raw route of data/robonet_hdf5.py; cases in
                tests/torch_raw_cases.py), h5py hidden if installed:
                whether cv2 writes and reads an mp4 stream; trajectories
                built in memory (raw_robonet_tree) at RoboNet's stored
                240x320, 31 jpg frames each: sawyer sudri0_c0 x 3,
                sudri0_c1 x 2, sudri2_c1 x 1, locobot_c0 x 2, and one more
                sudri0_c0 as mp4 where cv2 writes it; decode ms a frame
                to 64x85 by encoding; the raw route to record shards
                (write_training_records, masks on the card: the chains for
                sawyer, the mask kernel at M = 31, 64x85 for locobot) and
                the converter's trees at locobot_c0, every mask launch held
                bit for bit to its plain version on its own segments;
                episodes/s with the time in decode and masks and in the
                shard's write; mask ms a trajectory by robot;
                train_sawyer_multiview on the shards at the Config
                defaults' widths (svg, g_dim 128, 48x64, bf16,
                dontcare_l1): 2 epochs of 2 batches (the record split of
                the HDF5 loaders: train, test, the sudri2_c1 transfer
                view), one eval epoch on test and transfer through sm90
                (launches counted), utils/profiling.trace around its
                second step (the chrome trace read back); frames/s of the
                second epoch; every trajectory read on the card against
                the CPU (chain masks but within 1e-3 px of an edge); the
                mask kernel timed at the route's own launch beside its
                plain version and bound.
 18. int8       int8 planning (ops/quant.py) at the canonical planning
                config of phase 6 with --plan_quantize int8 on the same
                seed-0 weights: one warm-up and three timed plans, each
                finite and shaped, launching the mask kernel 10 times and
                the cell kernels never (the int8 cell is plain PyTorch
                math around int8 GEMMs: torch._int_mm on an im2col, whose
                launches are counted, more than 0 a plan); the latency
                (median) beside phase 6's bf16 latency; the host syncs of
                an int8 plan, not more than a bf16 plan's; the int8 plan's
                largest difference from the bf16 plan; a profiled int8
                plan (device time, busy share) beside phase 7's profiled
                bf16 plan; at the two gate
                convolutions' shapes (B = 100, 6x8, 512 -> 1024 channels,
                k = 5 and 3) the card's int32 sums equal to the CPU's plain
                float64 version on the same int8 inputs (20 rows of the
                launch, asserted), the whole Int8Conv2d's largest
                difference from the CPU's, and
                per launch by CUDA events the im2col + GEMM, the GEMM
                alone, the whole Int8Conv2d on bf16 input and cuDNN's bf16
                gate conv, beside the int8 product's bound (1979 TOP/s).
 19. mesh       the parallel layouts (parallel/mesh.py) on an NCCL world
                of one card (a FileStore rendezvous): two float32 train
                steps of tests/torch_mesh_cases.py's small config under
                DDP, FSDP2 and the model-axis layout, each against the
                plain step (tests/test_multichip.py's tolerances); a DCP
                checkpoint of the FSDP2 model and Adam restored into a
                plain model on the card, parameters bit for bit; a mesh
                plan at the canonical config equal to the unsharded plan
                bit for bit in bf16 (launches counted: 160 cells through
                sm90, 10 masks) and in int8.
 20. widths     models whose g_dim is not a multiple of 8: a small
                float32 plan at g_dim 12 on the card equal to the CPU's
                (1e-4); the same plan in bf16, every cell through sm90 with
                each stack's first x staged, every recorded cell held to
                its plain version (1e-2), its difference from the CPU's bf16
                plan printed; the canonical planner at g_dim 252: 160 sm90
                cells a plan and no other cell kernel, the inputs staged a
                plan, latency, and one profiled plan beside one of phase
                6's g_dim 256 planner (device time, the cells' part).

Prints the card line, one JSON line each of the train, serve, variants,
data, robots, families, sim, experiments, raw, int8, mesh and widths
phases and one of kernels
(the mask kernel, the sm90 cell at the planner's shapes, at the staged
widths and at det's, and the float32 kernel, each with its launches on its own path,
and the mask kernel at the raw route's 64x85), then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import svg
from robot_aware_control_tpu_torch.models.registry import get_model
from robot_aware_control_tpu_torch.ops import kernels, quant
from robot_aware_control_tpu_torch.control.plan_server import PlanServer
from robot_aware_control_tpu_torch.data import native, robonet_hdf5
from robot_aware_control_tpu_torch.data.loader import DataLoader
from robot_aware_control_tpu_torch.data.records import RecordDataset
from robot_aware_control_tpu_torch.envs.variants import make
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.planning.cost import InpaintBlurCost, gaussian_blur
from robot_aware_control_tpu_torch.training import checkpoint as ckpt
from robot_aware_control_tpu_torch.training.robot_trainer import (
    JointPosDataset,
    RobotPredictionTrainer,
    rollout,
)
from robot_aware_control_tpu_torch.training.step import make_train_step
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer

# the mask kernel's cases, shared with its GPU and CPU tests
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from torch_family_cases import (  # noqa: E402
    FAMILIES,
    debug_cem_frames,
    family_fields,
    inverse_learns,
    inverse_step_parity,
)
from torch_family_cases import small_plan_parity as family_plan_parity  # noqa: E402
from torch_family_cases import train_step_parity as family_train_parity  # noqa: E402
from torch_mask_cases import MASK_CASES, mask_case  # noqa: E402
import torch_mesh_cases as mesh_cases  # noqa: E402
from torch_serve_cases import (  # noqa: E402
    cell_invariance,
    plan_checks,
    requests,
    serve_checks,
    small_cell_invariance,
)
from torch_train_small import (  # noqa: E402
    EVAL_TOL,
    GRAD_TOL_DEVICES,
    TRAIN,
    TRAIN_TOL,
    bench_batch,
    eval_kernel_vs_plain,
    train_step_parity,
)
from torch_experiment_cases import (  # noqa: E402
    CYCLEGAN_TOL,
    EMBED_TOL,
    EXPERIMENT_CUTS,
    I3D_TOL,
    TRANSFER_CUTS,
    cyclegan_card_vs_cpu,
    cyclegan_episode,
    flags,
    i3d_card_vs_cpu,
    random_embed_card_vs_cpu,
    record_route,
    videos,
)
from torch_data_cases import (  # noqa: E402
    RESIZE_TOL,
    RecordTrainer,
    bilinear_reference,
    eval_cells,
    prefetch_check,
    write_record_split,
)
from torch_raw_cases import (  # noqa: E402
    NATIVE_HW,
    RAW_LAYOUT,
    RAW_TRAIN,
    STORED_HW,
    MaskLaunches,
    mp4_probe,
    raw_card_vs_cpu,
    raw_trees,
)
from torch_chain_cases import (  # noqa: E402
    CHAIN_EXPERIMENTS,
    chain_batched_diff,
    chain_geometry,
    chain_joints_parity,
    chain_start_goal,
    small_chain_plan_parity,
)
from torch_robot_cases import (  # noqa: E402
    ROBOT,
    FinetuneRecordTrainer,
    finetune_launches,
    record_renders,
    recorded_kernel_vs_plain,
    robot_step_parity,
)
from torch_sim_cases import (  # noqa: E402
    GT_EPISODE,
    GT_PLAN_TOL,
    IMG_TOL,
    LEARNED_EPISODE,
    POS_TOL,
    SIM_ENVS,
    STEPS,
    bridge_plan_check,
    gt_mask_kernel_vs_plain,
    gt_plans,
    gt_scenes,
    physics_card_vs_cpu,
    run_push_episode,
    small_gt_plan_parity,
)
from torch_variant_cases import (  # noqa: E402
    CANONICAL,
    CELL_RTOL,
    COST_RTOL,
    PLAN_TOL,
    SMALL,
    TRAIN_VARIANTS,
    VARIANTS,
    plan_launches,
    small_cost_parity,
    small_plan_parity,
    start_goal,
)

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, float32 CUDA cores,
# HBM3 bandwidth (at the full 700 W power limit)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# tolerances of kernel vs plain: bf16 outputs may differ by one bf16
# rounding step (2^-8 relative) where the float32 gate sums, taken in
# another order, straddle a rounding boundary; float32 by sum order only
CELL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
MASK_SRC = "robot_aware_control_tpu_torch/csrc/capsule_mask.cu"
CELL_SRC = "robot_aware_control_tpu_torch/csrc/conv_lstm_cell_sm90.cu"
CELL_REPLACES = "robot_aware_control_tpu/ops/pallas_kernels.py:146"
PLANNER_CELLS = [(100, 6, 8, 256, 256, 5), (100, 6, 8, 256, 256, 3)]
# the trainer's eval epoch: B = test_batch_size = 16, 24 output tiles
# for 132 persistent blocks
EVAL_CELLS = [(16, 6, 8, 256, 256, 5), (16, 6, 8, 256, 256, 3)]
# two and four requests planned together: B = 2 x 100 and 4 x 100
SERVE_CELLS = [(B, 6, 8, 256, 256, k) for B in (200, 400) for k in (5, 3)]
# the det model's plan cells: g_dim 256 + 2 action + 2 state maps = 260
# channels, in views of 264-channel buffers (the layout models/det.py gives
# them), which the wgmma/TMA kernel takes on its gate-packed copy of the
# weights (ops/kernels.py:sm90_weights)
DET_CELLS = [(100, 6, 8, 260, 260, 5), (100, 6, 8, 260, 260, 3)]
# det planned for two and four requests together (B = 2 x 100 and 4 x 100)
# and the det trainer's eval epoch (B = 16)
DET_SERVE_CELLS = [(B, 6, 8, 260, 260, k) for B in (16, 200, 400) for k in (5, 3)]
# widths that are not multiples of 8 (the retired WMMA kernel took them before),
# at the planner's B = 100: a model of g_dim 252 or 100 steps its first
# cell on a contiguous x (a *_in convolution's output, staged) and the
# padded h and c of lstm.zero_state ("model" layout); 13/20 (odd Cx) on
# contiguous tensors, all three staged
STAGED_CELLS = ([((100, 6, 8, C, C, k), "model")
                 for C in (252, 100) for k in (5, 3)]
                + [((100, 6, 8, 13, 20, k), "contiguous") for k in (5, 3)])
F32_SRC = "robot_aware_control_tpu_torch/csrc/conv_lstm_cell_f32.cu"


def cuda_ms(fn, n: int = 20, sleep_cycles: int = 200_000_000) -> float:
    """Mean device milliseconds per call over n calls after a warm-up, by
    CUDA events. The calls are queued behind a sleeping kernel, so that the
    events time the device and not the host's launch overhead (which is
    longer than a small kernel); raises if the queue ran dry."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(sleep_cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        raise AssertionError(f"launches took {host_ms:.1f} ms on the host, "
                             "longer than the sleep ahead of them")
    return ev[1].elapsed_time(ev[2]) / n


def bound_ms(ops: float, peak: float, nbytes: float):
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


# --------------------------------------------------------------- kernels
def check_masks(dev):
    for name in MASK_CASES:
        segs, h, w = mask_case(name, dev)
        got = kernels.capsule_mask_render(segs, h, w)
        want = kernels.capsule_mask_render_plain(segs, h, w)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        M, S = segs.shape[:2]
        print(f"masks {name} M={M} S={S} {h}x{w}: {differ} pixels differ, "
              f"{float(want.mean()) if M else 0.0:.4f} of pixels inside")
        if differ or got.shape != (M, h, w):
            raise AssertionError(f"mask kernel differs from plain on {name}")
    return 0.0


def cell_inputs(B, H, W, Cx, C, k, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    x, h, c = (torch.randn(B, H, W, n, generator=g) for n in (Cx, C, C))
    w = torch.randn(k, k, Cx + C, 4 * C, generator=g) * 0.02
    b = torch.randn(4 * C, generator=g) * 0.1
    return ([t.to(dev, dtype) for t in (x, h, c, w)] + [b.to(dev)])


def det_layout(x, h, c, w, b):
    """The same cell in det's layout: x, h and c as views of buffers padded
    to a multiple of 8 channels a pixel whose pad lanes hold NaN (the
    kernels must never read them), as models/det.py and ops/lstm.py give
    them."""
    def padded(t):
        B, H, W, C = t.shape
        buf = torch.full((B, H, W, kernels.round_up(C)), float("nan"),
                         dtype=t.dtype, device=t.device)
        return buf[..., :C].copy_(t)

    return [padded(x), padded(h), padded(c), w, b]


def cell_err(got, want, tol):
    err = 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
        err = max(err, float((g.float() - w.float()).abs().max()))
    return err


def laid_out(args, layout):
    """The cell's inputs in `layout`: "contiguous" as made, "padded"
    (`det_layout`: x, h and c as views of padded buffers, NaN pad lanes),
    "model" x contiguous and h, c such views (lstm.zero_state's)."""
    if layout == "contiguous":
        return args
    padded = det_layout(*args)
    return padded if layout == "padded" else [args[0]] + padded[1:]


def one_launch(fn, path):
    """fn() with the cell counts read around it: raises unless it made one
    cell launch, through the kernel of `path` ("sm90" or "f32"), and no
    other. Returns (fn's result, the inputs staged)."""
    before, staged = dict(kernels.launches), kernels.staged["inputs"]
    got = fn()
    launched = [kernels.launches[n] - before[n] for n in
                ("conv_lstm_cell", "conv_lstm_cell_sm90", "conv_lstm_cell_f32")]
    if launched != [1, int(path == "sm90"), int(path == "f32")]:
        raise AssertionError(f"{path} expected, launched {launched}")
    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise AssertionError(f"{path}: non-finite outputs")
    return got, kernels.staged["inputs"] - staged


def check_cells(dev):
    """Max |kernel - plain| by (shape, path): every bf16 cell through the
    wgmma/TMA kernel ("sm90"), read in place or staged
    (kernels.stage_cell), every float32 cell through the float32 kernel
    ("f32"), one launch each."""
    errs = {}
    # the planner's two cells, the trainer's eval cells, the served cells;
    # then odd shapes: 24/40 (a partial channel tile, a 5x7 map), 13/20
    # (odd Cx, 26- and 40-byte rows), odd C 13/21, det's 260 and 258,
    # contiguous (bf16: staged) and in padded views with NaN pad lanes (read
    # in place), and the model widths 252 and 100 at B = 100 in the model's
    # layout too; float32 cells of every shape take the float32 kernel
    shapes = [(s, "contiguous") for s in
              PLANNER_CELLS + EVAL_CELLS + SERVE_CELLS + [
                  (3, 5, 7, 24, 40, 5), (2, 6, 8, 13, 20, 3), (2, 6, 8, 13, 21, 3),
                  (4, 6, 8, 260, 260, 5), (4, 6, 8, 258, 258, 3)]]
    shapes += [(s, "padded") for s, _ in shapes if s[4] % 8]
    shapes += [(s, layout) for s, layout in STAGED_CELLS if layout == "model"]
    tol = CELL_TOL[torch.bfloat16]
    # 260 channels on a 262-channel pixel stride (not a multiple of 8) and
    # 16 channels with x one element off a 16-byte boundary: staged
    x, h, c, w, b = cell_inputs(2, 6, 8, 260, 260, 3, torch.bfloat16, dev, 3)
    views = [torch.full((2, 6, 8, 262), float("nan"), dtype=t.dtype,
                        device=dev)[..., :260].copy_(t) for t in (x, h, c)]
    small = cell_inputs(2, 6, 8, 16, 16, 3, torch.bfloat16, dev, 4)
    off = small[0]
    off = torch.empty(off.numel() + 1, dtype=off.dtype, device=dev)[1:].view(
        off.shape).copy_(off)
    for name, ins, raw in (("ld262", views + [w, b], (x, h, c, w, b)),
                           ("misaligned x", [off] + small[1:], small)):
        got, staged = one_launch(lambda: kernels.conv_lstm_cell(*ins), "sm90")
        err = errs[(name, "sm90")] = cell_err(
            got, kernels.conv_lstm_cell_plain(*raw), tol)
        print(f"cell {name} B,H,W,Cx,C,k={tuple(raw[0].shape[:3])} + "
              f"{raw[0].shape[-1]}, {raw[1].shape[-1]}, {raw[3].shape[0]} bf16 "
              f"sm90 ({staged} inputs staged): max |kernel - plain| = "
              f"{err:.3g} (tolerance {tol} abs + rel)")
    for shape, layout in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            args = cell_inputs(*shape, dtype, dev, seed=sum(shape))
            want = kernels.conv_lstm_cell_plain(*args)
            ins = laid_out(args, layout)
            path = "sm90" if dtype == torch.bfloat16 else "f32"
            got, staged = one_launch(lambda: kernels.conv_lstm_cell(*ins), path)
            tol = CELL_TOL[dtype]
            key = shape if layout == "contiguous" else shape + (f" {layout}",)
            err = errs[(key, path)] = cell_err(got, want, tol)
            print(f"cell B,H,W,Cx,C,k={shape} {layout} {dtype} {path} "
                  f"({staged} inputs staged): max |kernel - plain| = "
                  f"{err:.3g} (tolerance {tol} abs + rel)")
    return errs


# ----------------------------------------------------------------- plans
def check_small_plan_parity():
    cfg = Config(**SMALL)
    start, goal = start_goal(np.random.RandomState(1))
    noise = np.random.RandomState(2).randn(
        cfg.opt_iter, cfg.action_candidates, cfg.horizon - 1, 2)
    plans = {}
    for dev in ("cpu", "cuda"):
        model = svg.init(cfg, seed=3, device=dev)
        plans[dev] = CEMPolicy(cfg, model, device=dev).get_action(
            start, goal, noise=noise)
    err = float(np.abs(plans["cuda"] - plans["cpu"]).max())
    print(f"small f32 plan, GPU vs CPU: max |diff| = {err:.3g} "
          f"(tolerance {PLAN_TOL})")
    if not err <= PLAN_TOL:
        raise AssertionError("GPU plan differs from CPU plan")


def canonical_plans(n_timed: int = 3, compute_dtype: str = "bfloat16",
                    g_dim: int = 256):
    """The canonical planner at `g_dim` in `compute_dtype`: one warm-up and
    n_timed timed plans, each finite, shaped and launching `plan_launches`
    (160 cells, all through sm90 in bf16 and all through the float32 kernel
    in float32, and 10 masks); the counts are zeroed just before them."""
    cfg = Config(**dict(CANONICAL, compute_dtype=compute_dtype, g_dim=g_dim))
    model = svg.init(cfg, seed=0, device="cuda")
    policy = CEMPolicy(cfg, model)
    start, goal = start_goal(np.random.RandomState(0))
    want = plan_launches(cfg)
    kernels.reset_launches()
    seconds = []
    for i in range(n_timed + 1):
        before = dict(kernels.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = policy.get_action(start, goal, ep_num=1, step=i)
        torch.cuda.synchronize()
        if i:  # the first plan warms up
            seconds.append(time.perf_counter() - t0)
        got = {k: kernels.launches[k] - before[k] for k in want}
        if got != want:
            raise AssertionError(f"plan {i} launched {got}, expected {want}")
        if plan.shape != (cfg.horizon - 1, 2) or not np.all(np.isfinite(plan)):
            raise AssertionError(f"bad plan {plan!r}")
    launches = dict(kernels.launches)
    rollouts = cfg.opt_iter * cfg.action_candidates
    label = compute_dtype + ("" if g_dim == 256 else f" g_dim {g_dim}")
    print(f"{label} plan seconds: "
          + ", ".join(f"{s:.4f}" for s in seconds))
    latency = float(np.median(seconds))
    print(f"{label} plan latency {np.median(seconds):.4f} s (median of {n_timed}), "
          f"{rollouts / np.median(seconds):.1f} rollouts/s "
          f"({cfg.opt_iter} iterations x {cfg.action_candidates} candidates, "
          f"horizon {cfg.horizon}); kernel launches per plan {want}")
    return launches, policy, start, goal, latency


def device_busy_ms(prof) -> float:
    """The time in which at least one device activity of the profile ran:
    the union of their intervals (kernels on other streams, as cuDNN's
    FFT convolutions launch them, overlap)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def profile_plan(plan, label="plan"):
    """`plan()` under torch.profiler: device time by kernel, and the share
    of its wall time in which the device was busy (`device_busy_ms`).
    Returns (busy ms, wall ms, [(ms, count, kernel name), ...] largest
    first) or None."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plan()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = device_busy_ms(prof)
    if not busy:
        print(f"profiler recorded no device time: {label} busy share not "
              "measured")
        return None
    print(f"profiled {label}: {wall:.1f} ms wall (profiler on), device busy "
          f"{busy:.1f} ms = {busy / wall:.1%}, idle {1 - busy / wall:.1%} "
          f"(kernel time summed over streams {sum(r[0] for r in rows):.1f} ms)")
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.2f} ms {ms / busy:6.1%} {n:5d}x  {key[:100]}")
    return busy, wall, rows


# ----------------------------------------------------------------- serve
def check_serve(local_latency):
    """The cell kernel's invariance, batched == single plans at the
    canonical config, the launches of a batched plan, a profiled batched
    plan, and a PlanServer with concurrent clients
    (tests/torch_serve_cases.py)."""
    dev = torch.device("cuda")
    inv = {C: cell_invariance(dev, channels=C) for C in (256, 260)}
    small = small_cell_invariance(dev)
    print("cell kernel, identical bits: 50 launches of identical inputs at "
          "B = 16, 100, 200 and 400, and rows of B = 100 at offsets 0 and "
          "100 of B = 200 and 0, 100, 200 and 300 of B = 400, for k = 5 and "
          "3, at 256 channels and at det's 260 (padded views, NaN pad "
          "lanes); also " + ", ".join(small)
          + " at small shapes")
    cfg = Config(**CANONICAL)
    model = svg.init(cfg, seed=0, device="cuda")
    policy = CEMPolicy(cfg, model)
    checks = plan_checks(policy)
    print("canonical plans: one request 3 times, one plan; batched == single "
          "bit for bit at R = " + ", ".join(map(str, checks["batched"]))
          + " (3 padded to 4)")

    # one batched plan of 4 requests: its cells all run at B = 400
    reqs = requests(4)
    batched = lambda: policy.get_action_batched(
        [r[0] for r in reqs], [r[1] for r in reqs],
        ep_nums=[r[2] for r in reqs], steps=[r[3] for r in reqs])
    cell, rows = kernels.conv_lstm_cell, []

    def recording(x, *args):
        rows.append(x.shape[0])
        return cell(x, *args)

    kernels.conv_lstm_cell = recording
    try:
        kernels.reset_launches()
        batched()
        launched = dict(kernels.launches)
    finally:
        kernels.conv_lstm_cell = cell
    want = plan_launches(cfg)
    if launched != want or set(rows) != {4 * cfg.action_candidates}:
        raise AssertionError(f"batched plan of 4 launched {launched} at B = "
                             f"{sorted(set(rows))}, expected {want} at 400")
    print(f"batched plan of 4 requests: launches {launched}, every cell at "
          f"B = {rows[0]}")
    prof = profile_plan(batched, "batched plan of 4 requests")

    server = PlanServer(cfg, model)
    thread = server.start()
    try:
        kernels.reset_launches()
        served = serve_checks(server, checks["singles"])
        served_launches = dict(kernels.launches)
        info = server.info()
    finally:
        server.close()
        thread.join(timeout=10)
    programs = served["plan_programs"]
    want = {name: n * programs for name, n in plan_launches(cfg).items()}
    if served_launches != want:
        raise AssertionError(f"served plans launched {served_launches}, "
                             f"expected {want} for {programs} plan programs")
    print(f"served: {served['requests']} requests in {programs} plan "
          f"programs (batches seen {served['batched_seen']}), launches "
          f"{served_launches}; every served plan equals its local plan")
    print(f"serving latency per request: local single plan "
          f"{local_latency:.4f} s; served, 1 client "
          f"{served['latency_1_client_s']:.4f} s (runs "
          + ", ".join(f"{v:.4f}" for v in served["latency_1_client_runs"])
          + f"), 4 concurrent clients {served['latency_4_clients_s']:.4f} s; "
          f"{served['plans_per_s_4_clients']:.2f} plans/s at 4 clients (runs "
          + ", ".join(f"{v:.2f}" for v in served["plans_per_s_runs"]) + ")")
    out = dict(served, info=info, launches=served_launches,
               batched_plan_launches=launched, invariance=inv,
               small_invariance=small, batched_diff=checks["batched"],
               local_single_plan_s=local_latency)
    if prof:
        out["batched_plan_busy_ms"], out["batched_plan_wall_ms"] = prof[:2]
        out["batched_plan_busy_share"] = prof[0] / prof[1]
    return out


# ---------------------------------------------------------------- timing
def valid_taps(H, W, k):
    """Taps of a SAME k x k window that land inside an H x W map, summed
    over its pixels: the work of the convolution without its zero border."""
    p = k // 2
    rows = sum(min(y + p, H - 1) - max(y - p, 0) + 1 for y in range(H))
    cols = sum(min(x + p, W - 1) - max(x - p, 0) + 1 for x in range(W))
    return rows * cols


def mask_bound(segs, h, w):
    """The mask kernel's least time on `segs` (M, S, 6): 24 float32
    operations per pixel and capsule (one of them a division) plus 5 per
    capsule, counting the tests of the pixel centres inside a capsule's box
    grown by its larger radius (no margin, no tiles; outside it every test
    misses), against the segments read once and the masks written once.
    Returns (tests needed, operations, operations dense, bound ms, bound
    by)."""
    M, S = segs.shape[:2]
    au, av, bu, bv, ra, rb = segs.unbind(-1)
    grow = torch.maximum(ra.abs(), rb.abs())
    px = torch.arange(w, device=segs.device) + 0.5
    py = torch.arange(h, device=segs.device) + 0.5

    def inside(p, a, b):
        lo = (torch.minimum(a, b) - grow)[..., None]
        hi = (torch.maximum(a, b) + grow)[..., None]
        return ((p >= lo) & (p <= hi)).sum(-1)

    needed = int((inside(px, au, bu) * inside(py, av, bv)).sum())
    ops = 24 * needed + 5 * M * S
    dense = 24 * M * S * h * w + 5 * M * S
    bound, by = bound_ms(ops, PEAK_F32, segs.numel() * 4 + M * h * w * 4)
    return needed, ops, dense, bound, by


def time_mask(dev, launches, err):
    segs, h, w = mask_case("planner_500", dev)
    M, S = segs.shape[:2]
    # the same launch with every (tile, capsule) test culled (the capsules
    # moved 1000 px right of the image) and with none culled (radii of
    # 1000 px): the kernel's cost without its tests and with all of them
    culled, dense_segs = segs.clone(), segs.clone()
    culled[..., 0] += 1000.0
    culled[..., 2] += 1000.0
    dense_segs[..., 4:] = 1000.0
    for s, value in ((culled, 0.0), (dense_segs, 1.0)):
        got = kernels.capsule_mask_render(s, h, w)
        if not (torch.equal(got, kernels.capsule_mask_render_plain(s, h, w))
                and bool((got == value).all())):
            raise AssertionError("mask kernel wrong on the timing variants")
    render = lambda s: (lambda: kernels.capsule_mask_render(s, h, w))
    # turns: planner, every tile culled, none culled, planner
    ms = [cuda_ms(render(segs), n=200)]
    all_culled = cuda_ms(render(culled), n=200)
    none_culled = cuda_ms(render(dense_segs), n=200)
    ms.append(cuda_ms(render(segs), n=200))
    plain = cuda_ms(lambda: kernels.capsule_mask_render_plain(segs, h, w))
    # a yardstick for the write alone: PyTorch filling an output of this size
    out = torch.empty(M, h, w, device=dev)
    fill = cuda_ms(lambda: out.fill_(0.0), n=200)
    needed, ops, dense, bound, by = mask_bound(segs, h, w)
    rows, cols = kernels.MASK_TILE
    # the kernel's skip rule replayed in PyTorch, not counted on the card
    kept = kernels.capsule_mask_tests_kept(segs, h, w).float().mean().item()
    ptxas = ptxas_info("capsule_mask")
    print(f"mask M={M} S={S} {h}x{w}: kernel {np.mean(ms):.5f} ms "
          f"({', '.join(f'{v:.5f}' for v in ms)}), every tile culled "
          f"{all_culled:.5f} ms, none culled {none_culled:.5f} ms, plain "
          f"{plain:.4f} ms, fill_ of the output {fill:.5f} ms, bound "
          f"{bound:.5f} ms ({by}; {ops / 1e9:.4f} G operations the inputs "
          f"need, {dense / 1e9:.4f} G dense); share of the tests the skip "
          f"rule keeps on {rows}x{cols} tiles, replayed in PyTorch: "
          f"{kept:.4f} (pixel centres inside a capsule's box: "
          f"{needed / (M * S * h * w):.4f})")
    print("ptxas, capsule_mask.cu: " + ptxas)
    return dict(name="capsule_mask_render", route="cuda", source=MASK_SRC,
                replaces="robot_aware_control_tpu/ops/pallas_kernels.py:57",
                launches=launches, max_abs_err=err, ms=float(np.mean(ms)),
                ms_runs=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, fill_ms=fill, ms_all_culled=all_culled,
                ms_none_culled=none_culled, gops=ops / 1e9,
                gops_dense=dense / 1e9, ptxas=ptxas)


def ptxas_info(lib: str) -> str:
    """Registers and spills of each kernel in `lib`, from ptxas -v output
    captured by this process's build ("" if it did not build here)."""
    out = kernels.build_log.get(lib, {}).get("output", "")
    regs = [l.split("info    : ")[-1] for l in out.splitlines()
            if "Used" in l and "registers" in l]
    spills = [l.strip() for l in out.splitlines() if "spill stores" in l]
    losses = [l.split("info    : ")[-1][:90] for l in out.splitlines()
              if "Performance Loss" in l]
    return "; ".join([f"{r} ({sp})" for r, sp in zip(regs, spills)] + losses)


def time_cell(dev, launches, errs):
    """The planner launches cell0 (k=5) and cell1 (k=3) equally often, so
    the per-launch numbers are the mean of the two shapes. The trainer's
    eval shapes (B = 16) and those of 2 and 4 requests planned together
    (B = 200 and 400) are timed and reported apart, and so are the widths
    that are not multiples of 8 (`time_staged_cells`)."""
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in PLANNER_CELLS + EVAL_CELLS + SERVE_CELLS:
        B, H, W, Cx, C, k = shape
        x, h, c, w, b = cell_inputs(B, H, W, Cx, C, k, torch.bfloat16, dev, 7)
        run = lambda fn: (lambda: fn(x, h, c, w, b))
        ms = [cuda_ms(run(kernels.conv_lstm_cell)) for _ in range(3)]
        plain = cuda_ms(run(kernels.conv_lstm_cell_plain))
        lib = gate_conv_ms(x, h, w, b)
        ops, (bound, by) = cell_bound(x, h, c, w, b, PEAK_BF16)
        s = kernels.sm90_schedule(B, H, W, Cx, C, k, dev)
        multiplied = s["steps"] * 2.0 * 128 * 256 * 64
        per_block = -(-s["steps"] // s["grid"])
        row = dict(B=B, k=k, ms=float(np.mean(ms)), ms_runs=ms,
                   plain_ms=plain, library_ms=lib,
                   bound_ms=bound, bound_by=by, gflop=ops / 1e9,
                   gflop_multiplied=multiplied / 1e9,
                   gflop_dense=2.0 * B * H * W * k * k * (Cx + C) * 4 * C / 1e9,
                   tiles=s["tiles"], blocks=s["grid"], steps=s["steps"],
                   slots=s["slots"], waves=s["grid"] / sms,
                   fill=s["steps"] / (s["grid"] * per_block),
                   max_abs_err=errs[(shape, "sm90")])
        rows.append(row)
        print(f"cell B={B} k={k} bf16: wgmma/TMA kernel {row['ms']:.4f} ms "
              f"({', '.join(f'{v:.4f}' for v in ms)}), "
              f"plain {plain:.4f} ms, cuDNN gate conv {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by}, {row['gflop']:.1f} GFLOP without the "
              f"zero border, {row['gflop_dense']:.1f} dense, "
              f"{row['gflop_multiplied']:.1f} multiplied = "
              f"{multiplied / row['ms'] / 1e9:.0f} TFLOP/s); {s['tiles']} "
              f"tiles, {s['steps']} k-steps on {s['grid']} blocks over {sms} "
              f"SMs ({row['waves']:.2f} waves, fill {row['fill']:.4f}), "
              f"{s['slots']} workspace slots of 128 KB")
    ptxas = ptxas_info("conv_lstm_cell_sm90")
    print("ptxas, wgmma/TMA kernel: " + ptxas)
    n = len(PLANNER_CELLS)
    plan = rows[:n]
    mean = lambda key, rs=plan: sum(r[key] for r in rs) / len(rs)
    apart = lambda rs: dict(
        B=rs[0]["B"], ms=mean("ms", rs), bound_ms=mean("bound_ms", rs),
        plain_ms=mean("plain_ms", rs), library_ms=mean("library_ms", rs),
        max_abs_err=max(r["max_abs_err"] for r in rs))
    by_b = lambda B: apart([r for r in rows if r["B"] == B])
    return dict(name="conv_lstm_cell_sm90", route="cuda", source=CELL_SRC,
                replaces=CELL_REPLACES, launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=mean("ms"), plain_ms=mean("plain_ms"),
                bound_ms=mean("bound_ms"),
                bound_by=rows[0]["bound_by"], library_ms=mean("library_ms"),
                ptxas=ptxas, per_shape=rows,
                eval_shapes=by_b(EVAL_CELLS[0][0]),
                serve_shapes=[by_b(B) for B in
                              sorted({shape[0] for shape in SERVE_CELLS})],
                staged_shapes=time_staged_cells(dev))


def time_staged_cells(dev):
    """The wgmma/TMA kernel at STAGED_CELLS' widths, each first held to its
    plain version (one sm90 launch): the call as a model makes it, staging
    copies included, in turns with the kernel alone on inputs staged
    beforehand (call, kernel, call, kernel, call); the copies alone (for
    g_dim 252 the copy of x into its padded view); the plain version,
    cuDNN's gate conv and the bound (operations without zero-border taps,
    the bytes of the inputs as the caller holds them)."""
    rows = []
    tol = CELL_TOL[torch.bfloat16]
    for shape, layout in STAGED_CELLS:
        B, H, W, Cx, C, k = shape
        raw = cell_inputs(*shape, torch.bfloat16, dev, 7)
        args = laid_out(raw, layout)
        got, staged = one_launch(lambda: kernels.conv_lstm_cell(*args), "sm90")
        err = cell_err(got, kernels.conv_lstm_cell_plain(*raw), tol)
        xs, hs, cs, wk, cw = kernels.stage_cell(*args[:4])
        call = lambda: kernels.conv_lstm_cell(*args)
        alone = lambda: kernels.launch_sm90(shape, xs, hs, cs, wk, cw, args[4])
        ms, kernel_ms = [cuda_ms(call)], []
        for _ in range(2):
            kernel_ms.append(cuda_ms(alone))
            ms.append(cuda_ms(call))
        copies = [t for t, s_ in zip(args[:3], (xs, hs, cs)) if t is not s_]
        stage = cuda_ms(lambda: [
            kernels.padded_nhwc(*t.shape, device=dev).copy_(t) for t in copies])
        plain = cuda_ms(lambda: kernels.conv_lstm_cell_plain(*args))
        lib = gate_conv_ms(*raw[:2], raw[3], raw[4])
        ops, (bound, by) = cell_bound(*raw, PEAK_BF16)
        row = dict(B=B, k=k, Cx=Cx, C=C, layout=layout, staged=staged,
                   ms=float(np.mean(ms)), ms_runs=ms,
                   kernel_ms=float(np.mean(kernel_ms)), kernel_ms_runs=kernel_ms,
                   stage_ms=stage, plain_ms=plain, library_ms=lib,
                   bound_ms=bound, bound_by=by, gflop=ops / 1e9, max_abs_err=err)
        rows.append(row)
        print(f"cell B={B} k={k} Cx={Cx} C={C} bf16 {layout} ({staged} inputs "
              f"staged): call {row['ms']:.4f} ms ("
              + ", ".join(f"{v:.4f}" for v in ms) + f"), kernel alone "
              f"{row['kernel_ms']:.4f} ms, the staging copies alone "
              f"{stage:.4f} ms, plain {plain:.4f} ms, cuDNN gate conv "
              f"{lib:.4f} ms (call {row['ms'] / lib:.3f}x it), bound "
              f"{bound:.4f} ms ({by}, {row['gflop']:.2f} GFLOP without the "
              f"zero border), max |kernel - plain| {err:.3g}")
    return rows


# ----------------------------------------------------------------- train
def check_train_parity():
    """One small float32 train step and one eval step on the GPU against
    the same on the CPU (tests/torch_train_small.py:train_step_parity)."""
    errs, launched = train_step_parity()
    print("small f32 train step, GPU vs CPU: " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tolerance {TRAIN_TOL}; gradients {GRAD_TOL_DEVICES} of each "
        f"leaf's norm); GPU eval step: {launched['cuda'][1]['conv_lstm_cell']}"
        " float32 cell launches, train step none")
    return errs


def check_eval_kernel():
    """The trainer's full-width bf16 eval step (B = 16) with the cell
    kernel against the same step with the kernel's plain version
    (tests/torch_train_small.py:eval_kernel_vs_plain)."""
    result = eval_kernel_vs_plain()
    for mode, r in result.items():
        print(f"full-width bf16 eval step ({mode}), kernel vs plain cell: "
              f"predictions {r['preds']:.3g}, metrics {r['metrics']:.3g} of "
              f"their max (tolerance {EVAL_TOL}); "
              f"{r['launched']['conv_lstm_cell_sm90']} sm90 launches")
    return result


def train_step_timing(dev):
    """The bench.py training config at batch 128 for each remat mode: 2
    warm-up and 5 timed steps (host clock, each ending in a sync), peak
    memory, 0 kernel launches, one profiled step; the FLOP count of a step (torch's FlopCounterMode: convolutions forward
    and backward, counted from their shapes)."""
    from torch.utils.flop_counter import FlopCounterMode

    rows, profiles = {}, {}
    flops = None
    for mode in ("none", "full", "conv"):
        cfg = Config(**dict(TRAIN, remat=mode != "none",
                            remat_policy="full" if mode == "none" else mode))
        model = svg.init(cfg, seed=0, device=dev, train=True)
        step, _ = make_train_step(cfg, model)
        batch = bench_batch(cfg, cfg.batch_size, 0, dev)
        gen = torch.Generator(dev).manual_seed(0)
        kernels.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seconds, losses = [], []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(batch, 1.0, gen)["loss"]))
            torch.cuda.synchronize()
            if i >= 2:
                seconds.append(time.perf_counter() - t0)
        if any(kernels.launches.values()):
            raise AssertionError(f"train steps launched {kernels.launches}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"remat {mode}: loss {losses}")
        med = statistics.median(seconds)
        window = cfg.n_past + cfg.n_future
        rows[mode] = dict(step_s=med, step_s_runs=seconds,
                          frames_per_s=cfg.batch_size * window / med,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          loss=losses[-1])
        print(f"train remat {mode}: step {med:.4f} s (median of 5: "
              + ", ".join(f"{v:.4f}" for v in seconds)
              + f"), {rows[mode]['frames_per_s']:.1f} frames/s, peak "
              f"{rows[mode]['peak_gb']:.2f} GB, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, 0 kernel launches")
        if mode == "none":
            with FlopCounterMode(display=False) as fc:
                step(batch, 1.0, gen)
            flops = fc.get_total_flops()
        profiles[mode] = profile_train_step(step, batch, gen, mode)
        del model, step, batch
        torch.cuda.empty_cache()
    bound = flops / PEAK_BF16 * 1e3
    print(f"train step: {flops / 1e12:.3f} TFLOP (convolutions and cells, "
          f"forward and backward) = bound {bound:.2f} ms at "
          f"{PEAK_BF16 / 1e12:.0f} TFLOP/s bf16; the steps take "
          + ", ".join(f"{m} {r['step_s'] * 1e3 / bound:.1f}x"
                      for m, r in rows.items()) + " of it")
    for mode, r in rows.items():
        r["profile"] = profiles[mode]
    return rows, dict(tflop=flops / 1e12, bound_ms=bound)


def profile_train_step(step, batch, gen, mode):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, 1.0, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    if not busy:
        print("profiler recorded no device time: busy share not measured")
        return None
    print(f"profiled train step (remat {mode}): {wall:.1f} ms wall (profiler "
          f"on), device busy {busy:.1f} ms = {busy / wall:.1%}")
    for ms, n, key in rows[:10]:
        print(f"  {ms:9.2f} ms {ms / busy:6.1%} {n:5d}x  {key[:100]}")
    return dict(wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                top=[dict(ms=ms, count=n, kernel=key[:100])
                     for ms, n, key in rows[:10]])


def check_trainer():
    """PredictionTrainer at full width (g_dim 256, z_dim 64, bf16) on the
    synthetic experiment: one epoch of 2 videos, its eval epoch through
    the wgmma/TMA cell kernel, a checkpoint, and a resume from it."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as d:
        cfg = Config(**dict(TRAIN, experiment="synthetic", batch_size=32,
                            test_batch_size=16, niter=1, epoch_size=2,
                            video_length=31, n_eval=10, eval_interval=1,
                            checkpoint_interval=1, log_dir=d, jobname="smoke"))
        tr = PredictionTrainer(cfg)
        kernels.reset_launches()
        t0 = time.perf_counter()
        tr.train()
        seconds = time.perf_counter() - t0
        launched = dict(kernels.launches)
        # the synthetic test set's 2 batches (cfg.eval_batches = 0), then
        # the eval gif's rollout
        cells = eval_cells(cfg, 2)
        if launched != {"conv_lstm_cell": cells, "conv_lstm_cell_sm90": cells,
                        "conv_lstm_cell_f32": 0, "capsule_mask_render": 0}:
            raise AssertionError(f"trainer launched {launched}, expected "
                                 f"{cells} cells, all through sm90")
        path = ckpt.latest_checkpoint(tr.log_dir)
        windows = cfg.epoch_size * (cfg.video_length // 6)
        if tr._step != windows or not path.endswith(f"ckpt_{windows}.npz"):
            raise AssertionError(f"trainer at step {tr._step}, saved {path}")
        tr2 = PredictionTrainer(cfg)
        tr2._resume()
        if tr2._step != tr._step:
            raise AssertionError(f"resumed at {tr2._step}, saved {tr._step}")
        with open(os.path.join(tr.log_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        tr.logger.close()
        tr2.logger.close()
    train = next(r for r in recs if "train/loss" in r)
    ev = next(r for r in recs if "eval/autoreg_psnr" in r)
    if not all(np.isfinite(v) for r in (train, ev) for v in r.values()):
        raise AssertionError(f"non-finite trainer metrics {train} {ev}")
    out = dict(seconds=seconds, steps=tr._step, checkpoint=os.path.basename(path),
               resumed_step=tr2._step, cell_launches=launched["conv_lstm_cell"],
               sm90_launches=launched["conv_lstm_cell_sm90"],
               frames_per_s=train["train/frames_per_sec"],
               loss=train["train/loss"],
               autoreg_psnr=ev["eval/autoreg_psnr"],
               autoreg_ssim=ev["eval/autoreg_ssim"])
    print(f"trainer: {out['steps']} steps and an eval epoch in {seconds:.1f} s "
          f"({out['frames_per_s']:.1f} frames/s over the epoch, data "
          f"generation included), {cells} cell launches in the eval epoch "
          f"and its gif, all through sm90; wrote {out['checkpoint']}, resumed at step "
          f"{tr2._step}; loss {out['loss']:.4f}, autoregressive PSNR "
          f"{out['autoreg_psnr']:.2f}, SSIM {out['autoreg_ssim']:.4f}")
    return out


# -------------------------------------------------------------- variants
def check_det_cells(dev):
    """The wgmma/TMA kernel against its plain version at det's shapes (one
    request, 2 and 4 planned together, the eval epoch's B = 16), in det's
    layout with NaN in the pad lanes (`det_layout`): one sm90 launch each,
    finite outputs. Returns max |kernel - plain| by shape."""
    errs = {}
    for shape in DET_CELLS + DET_SERVE_CELLS:
        raw = cell_inputs(*shape, torch.bfloat16, dev, seed=sum(shape))
        args = det_layout(*raw)
        before = dict(kernels.launches)
        got = kernels.conv_lstm_cell(*args)
        launched = {k: kernels.launches[k] - before[k] for k in before}
        if launched != {"conv_lstm_cell": 1, "conv_lstm_cell_sm90": 1,
                        "conv_lstm_cell_f32": 0, "capsule_mask_render": 0}:
            raise AssertionError(f"{shape}: launched {launched}, expected one "
                                 "sm90 launch")
        if not all(bool(torch.isfinite(t).all()) for t in got):
            raise AssertionError(f"{shape}: non-finite outputs")
        tol = CELL_TOL[torch.bfloat16]
        errs[shape] = cell_err(got, kernels.conv_lstm_cell_plain(*raw), tol)
        print(f"cell B,H,W,Cx,C,k={shape} bf16 sm90 (det: padded views, NaN "
              f"pad lanes): max |kernel - plain| = "
              f"{errs[shape]:.3g} (tolerance {tol} abs + rel), outputs finite")
    return errs


def variant_plans(name, n_timed=3, fields=None):
    """The canonical planner with the variant's fields (`fields`, else
    VARIANTS[name]): one warm-up and n_timed timed plans, each finite,
    shaped and launching `plan_launches`; then one profiled plan. Returns
    the config, the policy and the timings, the launches of the plans
    (counts zeroed just before them) and the profile."""
    cfg = Config(**dict(CANONICAL, **(VARIANTS[name] if fields is None
                                      else fields)))
    policy = CEMPolicy(cfg, get_model(cfg).init(cfg, seed=0, device="cuda"))
    start, goal = start_goal(np.random.RandomState(0))
    want = plan_launches(cfg)
    seconds = []
    kernels.reset_launches()
    for i in range(n_timed + 1):
        before = dict(kernels.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = policy.get_action(start, goal, ep_num=1, step=i)
        torch.cuda.synchronize()
        if i:
            seconds.append(time.perf_counter() - t0)
        got = {k: kernels.launches[k] - before[k] for k in want}
        if got != want:
            raise AssertionError(f"{name} plan {i} launched {got}, expected "
                                 f"{want}")
        if plan.shape != (cfg.horizon - 1, 2) or not np.all(np.isfinite(plan)):
            raise AssertionError(f"{name}: bad plan {plan!r}")
    launches = dict(kernels.launches)
    latency = statistics.median(seconds)
    print(f"variant {name}: plan latency {latency:.4f} s (median of "
          f"{n_timed}: " + ", ".join(f"{v:.4f}" for v in seconds)
          + f"), {cfg.opt_iter * cfg.action_candidates / latency:.1f} "
          f"rollouts/s; launches per plan {want}")
    prof = profile_plan(lambda: policy.get_action(start, goal, ep_num=2, step=0),
                        f"{name} plan")
    out = dict(latency_s=latency, latency_runs=seconds, launches=launches,
               launches_per_plan=want)
    if prof:
        out["busy_ms"], out["wall_ms"] = prof[:2]
        out["busy_share"] = prof[0] / prof[1]
    return cfg, policy, out


def time_blur(cfg, dev, busy_ms):
    """The inpaint-blur cost's blur at a plan's shapes by CUDA events: the
    N candidates' predicted frames and the goal, on each blurred step of
    each iteration; its device time a plan against the profiled plan's.
    Beside it, the same sums as cuDNN depthwise convolutions (the JAX
    package's formulation: a (2 radius + 1)-tap column pass, then a row
    pass, float32 with TF32 off), which the port does not run."""
    cost = InpaintBlurCost(cfg)
    T = cfg.horizon - 1
    blurred = sum(t < T - cfg.unblur_timestep for t in range(T))
    h, w = cfg.image_height, cfg.image_width
    frames = torch.rand(cfg.action_candidates, h, w, 3, device=dev)
    goal = torch.rand(1, h, w, 3, device=dev)
    ms_n = cuda_ms(lambda: gaussian_blur(frames, cost.sigma, cost.radius))
    ms_1 = cuda_ms(lambda: gaussian_blur(goal, cost.sigma, cost.radius))
    per_plan = cfg.opt_iter * blurred * (ms_n + ms_1)
    k = torch.exp(-torch.arange(-cost.radius, cost.radius + 1, device=dev,
                                dtype=torch.float32) ** 2 / (2 * cost.sigma ** 2))
    k = (k / k.sum()).expand(3, 1, -1)
    x = frames.permute(0, 3, 1, 2)
    conv = lambda: F.conv2d(F.conv2d(x, k[..., None], padding=(cost.radius, 0),
                                     groups=3),
                            k[:, :, None], padding=(0, cost.radius), groups=3)
    ref = gaussian_blur(frames, cost.sigma, cost.radius).permute(0, 3, 1, 2)
    err = float((conv() - ref).abs().max())
    ms_conv = cuda_ms(conv)
    share = per_plan / busy_ms if busy_ms else None
    print(f"blur ({cfg.action_candidates} frames of {h}x{w}x3, radius "
          f"{cost.radius}): {ms_n:.4f} ms, the goal {ms_1:.4f} ms; "
          f"{cfg.opt_iter} x {blurred} blurred steps = {per_plan:.2f} ms of "
          "device time a plan"
          + (f" = {share:.1%} of the profiled plan's {busy_ms:.1f} ms"
             if share is not None else "")
          + f"; as two 255-tap cuDNN depthwise convolutions {ms_conv:.4f} ms "
          f"(max |conv - product| {err:.2g})")
    return dict(ms_frames=ms_n, ms_goal=ms_1, blurred_steps=blurred,
                ms_per_plan=per_plan, share_of_device_time=share,
                cudnn_depthwise_ms=ms_conv, cudnn_depthwise_max_diff=err)


def cell_bound(x, h, c, w, b, peak):
    """The least time of a cell launch: its operations without the taps on
    the zero border at `peak`, against each input read once and each output
    written once (x, h, c and the (k, k, Cx + C, 4C) weights; h', c')."""
    B, H, W, Cx = x.shape
    C, k = h.shape[-1], w.shape[0]
    e = x.element_size()
    ops = 2.0 * B * valid_taps(H, W, k) * (Cx + C) * 4 * C
    nbytes = (e * (x.numel() + 4 * h.numel() + k * k * (Cx + C) * 4 * C)
              + 4 * b.numel())
    return ops, bound_ms(ops, peak, nbytes)


def gate_conv_ms(x, h, w, b):
    """cuDNN's gate convolution alone: one F.conv2d over cat(x, h),
    channels-last, in x's type (never called by the port)."""
    k = w.shape[0]
    xh = torch.cat([x, h], -1).permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return cuda_ms(lambda: F.conv2d(xh, w_oihw, b.to(x.dtype), padding=k // 2))


def time_det_cells(dev, launches, errs):
    """The kernels line's entry for det's cells: the wgmma/TMA kernel in
    det's layout (padded views). At det's two plan shapes (the mean of the
    two, as the plan launches each equally often), three timings each, with
    the plain version's time, cuDNN's gate convolution and the bound
    (operations at 260 channels without the zero-border taps)."""
    rows = []
    for shape in DET_CELLS:
        B, H, W, Cx, C, k = shape
        raw = cell_inputs(B, H, W, Cx, C, k, torch.bfloat16, dev, 7)
        args = det_layout(*raw)
        if not all(kernels.tma_ready(t) for t in args[:3]):
            raise AssertionError(f"{shape}: det's layout would be staged")
        sm90 = lambda: kernels.conv_lstm_cell(*args)
        ms = [cuda_ms(sm90) for _ in range(3)]
        plain = cuda_ms(lambda: kernels.conv_lstm_cell_plain(*args))
        lib = gate_conv_ms(*raw[:2], raw[3], raw[4])
        ops, (bound, by) = cell_bound(*raw, PEAK_BF16)
        s = kernels.sm90_schedule(B, H, W, Cx, C, k, dev)
        row = dict(B=B, k=k, Cx=Cx, C=C, ms=float(np.mean(ms)), ms_runs=ms,
                   plain_ms=plain, library_ms=lib,
                   bound_ms=bound, bound_by=by, gflop=ops / 1e9,
                   gflop_multiplied=2.0 * s["macs"] / 1e9, tail=s["tail"],
                   tiles=s["tiles"], blocks=s["grid"], steps=s["steps"],
                   max_abs_err=errs[shape])
        rows.append(row)
        print(f"cell B={B} k={k} Cx=C={C} bf16 (det): wgmma/TMA kernel "
              f"{row['ms']:.4f} ms ({', '.join(f'{v:.4f}' for v in ms)}), "
              f"plain {plain:.4f} ms, "
              f"cuDNN gate conv {lib:.4f} ms (kernel {row['ms'] / lib:.3f}x "
              f"it), bound {bound:.4f} ms ({by}, {row['gflop']:.1f} GFLOP "
              f"without the zero border, {row['gflop_multiplied']:.1f} "
              f"multiplied) = {row['ms'] / bound:.2f}x the bound; tail layout "
              f"{s['tail']}, {s['tiles']} tiles, {s['steps']} k-steps")
    mean = lambda key: sum(r[key] for r in rows) / len(rows)
    return [dict(name="conv_lstm_cell_sm90_det", source=CELL_SRC,
                 replaces=CELL_REPLACES, route="cuda", launches=launches,
                 max_abs_err=max(r["max_abs_err"] for r in rows),
                 ms=mean("ms"), plain_ms=mean("plain_ms"),
                 bound_ms=mean("bound_ms"), bound_by=rows[0]["bound_by"],
                 library_ms=mean("library_ms"), per_shape=rows)]


def time_f32_cell(dev, launches, launches_parity):
    """The kernels line's entry for the float32 kernel of
    csrc/conv_lstm_cell_f32.cu: at the planner's, the eval epoch's and the
    served shapes (256 channels) and at det's plan shapes (260 channels in
    padded views, NaN pad lanes), each first held to the plain version
    (1e-4, TF32 off) with one launch through the kernel, then timed in
    turns (kernel, plain, cuDNN's float32 gate conv, kernel, kernel) beside
    its bound at 67 TFLOP/s and its schedule. ms, plain_ms, library_ms and
    bound_ms are the means of the planner's two shapes (B = 100, k = 5 and
    3), which a float32 plan launches equally often; `launches` are the
    float32 plans' (phase 6), `launches_parity` the small parity plans'."""
    rows = []
    cases = ([(shape, False) for shape in PLANNER_CELLS + EVAL_CELLS + SERVE_CELLS]
             + [(shape, True) for shape in DET_CELLS])
    for shape, det in cases:
        B, H, W, Cx, C, k = shape
        raw = cell_inputs(*shape, torch.float32, dev, 7)
        args = det_layout(*raw) if det else raw
        before = kernels.launches["conv_lstm_cell_f32"]
        got = kernels.conv_lstm_cell(*args)
        if kernels.launches["conv_lstm_cell_f32"] != before + 1:
            raise AssertionError(f"{shape} float32: not through the float32 kernel")
        if not all(bool(torch.isfinite(t).all()) for t in got):
            raise AssertionError(f"{shape} float32: non-finite outputs")
        err = cell_err(got, kernels.conv_lstm_cell_plain(*raw),
                       CELL_TOL[torch.float32])
        run = lambda: kernels.conv_lstm_cell(*args)
        ms = [cuda_ms(run, n=5)]
        plain = cuda_ms(lambda: kernels.conv_lstm_cell_plain(*args), n=5)
        lib = gate_conv_ms(*raw[:2], raw[3], raw[4])
        ms += [cuda_ms(run, n=5) for _ in range(2)]
        ops, (bound, by) = cell_bound(*raw, PEAK_F32)
        s = kernels.f32_schedule(*shape, dev)
        mean_ms = float(np.mean(ms))
        row = dict(B=B, k=k, C=C, layout="padded" if det else "contiguous",
                   ms=mean_ms, ms_runs=ms, plain_ms=plain, library_ms=lib,
                   bound_ms=bound, bound_by=by, gflop=ops / 1e9,
                   gflop_multiplied=2.0 * s["macs"] / 1e9,
                   tflops_multiplied=2.0 * s["macs"] / mean_ms / 1e9,
                   schedule=s, waves=s["tiles"] / (s["blocks_per_sm"] * s["sms"]),
                   max_abs_err=err)
        rows.append(row)
        print(f"cell B={B} k={k} C={C}{' (det, padded)' if det else ''} "
              f"float32: kernel {mean_ms:.4f} ms ("
              + ", ".join(f"{v:.4f}" for v in ms)
              + f"), plain {plain:.4f} ms, cuDNN float32 gate conv (TF32 off) "
              f"{lib:.4f} ms (kernel {mean_ms / lib:.3f}x it), bound "
              f"{bound:.4f} ms ({by}, {row['gflop']:.1f} GFLOP at "
              f"{PEAK_F32 / 1e12:.0f} TFLOP/s) = {mean_ms / bound:.2f}x the "
              f"bound; {row['gflop_multiplied']:.1f} GFLOP multiplied = "
              f"{row['tflops_multiplied']:.1f} TFLOP/s; tile "
              f"{s['bm']}x{s['nh']} ({s['threads']} threads), {s['tiles']} "
              f"tiles, {s['blocks_per_sm']} blocks an SM, "
              f"{row['waves']:.2f} waves; max |kernel - plain| {err:.3g}")
    ptxas = ptxas_info("conv_lstm_cell_f32")
    print("ptxas, conv_lstm_cell_f32.cu: " + ptxas)
    plan = [r for r in rows if r["B"] == PLANNER_CELLS[0][0] and r["C"] == 256]
    mean = lambda key: sum(r[key] for r in plan) / len(plan)
    return dict(name="conv_lstm_cell_f32", route="cuda", source=F32_SRC,
                replaces=CELL_REPLACES, launches=launches,
                launches_parity=launches_parity,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=mean("ms"), plain_ms=mean("plain_ms"),
                bound_ms=mean("bound_ms"), bound_by=plan[0]["bound_by"],
                library_ms=mean("library_ms"),
                schedule={f"B={r['B']} k={r['k']} C={r['C']}": r["schedule"]
                          for r in rows},
                ptxas=ptxas, per_shape=rows)


def f32_plan_summary(latency, launches, prof) -> dict:
    """The float32 canonical plans' numbers: latency, launches, and from
    the profiled plan the device's busy time, the kernel time summed over
    streams and the cell kernel's part of that sum."""
    out = dict(latency_s=latency, launches=launches)
    if prof:
        busy, wall, rows = prof
        cell = [(ms, n) for ms, n, key in rows if "cell_kernel" in key]
        out.update(busy_ms=busy, wall_ms=wall, busy_share=busy / wall,
                   kernel_ms=sum(r[0] for r in rows),
                   cell_ms=sum(ms for ms, _ in cell),
                   cell_launches=sum(n for _, n in cell))
        out["cell_share"] = out["cell_ms"] / out["kernel_ms"]
        print(f"float32 plan: latency {latency:.4f} s, device busy {busy:.1f} "
              f"ms ({busy / wall:.1%}), kernel time summed "
              f"{out['kernel_ms']:.1f} ms, the cell kernel "
              f"{out['cell_ms']:.1f} ms in {out['cell_launches']} launches = "
              f"{out['cell_share']:.1%} of it")
    return out


def variant_train_step(name, dev, fields=None):
    """One train step at the training config of bench.py:136-156 (batch
    128, window 6, bf16, remat conv) with the variant's fields (`fields`,
    else TRAIN_VARIANTS[name]): one warm-up and 3 timed steps (host clock,
    each ending in a sync), no hand kernel."""
    cfg = Config(**dict(TRAIN, **(TRAIN_VARIANTS[name] if fields is None
                                  else fields)))
    model = get_model(cfg).init(cfg, seed=0, device=dev, train=True)
    step, _ = make_train_step(cfg, model)
    t0 = time.perf_counter()
    batch = bench_batch(cfg, cfg.batch_size, 0, dev)
    make_s = time.perf_counter() - t0
    gen = torch.Generator(dev).manual_seed(0)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    seconds, losses = [], []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch, 1.0, gen)["loss"]))
        torch.cuda.synchronize()
        if i:
            seconds.append(time.perf_counter() - t0)
    if any(kernels.launches.values()) or not all(np.isfinite(losses)):
        raise AssertionError(f"{name} train steps launched {kernels.launches}, "
                             f"losses {losses}")
    med = statistics.median(seconds)
    window = cfg.n_past + cfg.n_future
    out = dict(step_s=med, step_s_runs=seconds,
               frames_per_s=cfg.batch_size * window / med,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               loss=losses[-1], batch_seconds=make_s)
    print(f"train {name} (remat conv, batch {cfg.batch_size}): step {med:.4f} "
          "s (median of 3: " + ", ".join(f"{v:.4f}" for v in seconds)
          + f"), {out['frames_per_s']:.1f} frames/s, peak {out['peak_gb']:.2f}"
          f" GB, loss {losses[0]:.4f} -> {losses[-1]:.4f}, 0 kernel launches"
          + (f"; heatmaps made by create_heatmaps with the batch in "
             f"{make_s:.2f} s" if cfg.model_use_heatmap else ""))
    del model, step, batch
    torch.cuda.empty_cache()
    return out


def check_copy_and_resume():
    """The trainer's --model copy baseline on the synthetic experiment
    (finite metrics over full train and test epochs, PSNR finite or +inf,
    no kernel launched);
    then a det trainer at full width trains an epoch, runs its eval epoch
    through the sm90 cell (launches counted) and saves, and a
    second one, given that checkpoint by --dynamics_model_ckpt, starts
    from its weights and step and trains on."""
    here = os.path.dirname(os.path.abspath(__file__))
    base = dict(TRAIN, experiment="synthetic", batch_size=32,
                test_batch_size=16, niter=1, epoch_size=2, video_length=12,
                n_eval=6, eval_interval=10, checkpoint_interval=1)
    with tempfile.TemporaryDirectory(dir=here) as d:
        tr = PredictionTrainer(Config(**dict(base, model="copy", log_dir=d,
                                             jobname="copy")))
        kernels.reset_launches()
        t0 = time.perf_counter()
        copy = tr.train()
        copy_s = time.perf_counter() - t0
        tr.logger.close()
        # finite metrics, but PSNR: +inf where a copied frame equals its
        # target (a step in which nothing but the robot moved), as in JAX
        if any(kernels.launches.values()) or not all(
                np.isfinite(v) or (k.endswith("psnr") and v == np.inf)
                for m in copy.values() for k, v in m.items()):
            raise AssertionError(f"copy baseline {copy}, {kernels.launches}")
        print(f"copy baseline ({copy_s:.1f} s): " + "; ".join(
            f"{split} autoregressive PSNR {m['autoreg_psnr']:.2f}, SSIM "
            f"{m['autoreg_ssim']:.4f}, world {m['autoreg_world_loss']:.5f}"
            for split, m in copy.items()))
        det = dict(base, model="det", log_dir=d)
        # the first det trainer runs an eval epoch: its cells (B = 16,
        # 260 channels) through sm90, 2 a model step
        first = PredictionTrainer(Config(**dict(det, jobname="det0",
                                                eval_interval=1)))
        kernels.reset_launches()
        first.train()
        det_eval = dict(kernels.launches)
        # 1-step and autoregressive over 2 test batches, then the eval gif
        cells = eval_cells(first.cfg, 2, cells_a_step=2)
        if det_eval != {"conv_lstm_cell": cells, "conv_lstm_cell_sm90": cells,
                        "conv_lstm_cell_f32": 0, "capsule_mask_render": 0}:
            raise AssertionError(f"det trainer's eval epoch launched "
                                 f"{det_eval}, expected {cells} sm90 cells")
        path = ckpt.latest_checkpoint(first.log_dir)
        first.logger.close()
        cfg = Config(**dict(det, jobname="det1", dynamics_model_ckpt=path))
        probe = PredictionTrainer(cfg)
        probe.load_checkpoint(path)
        for k, v in first.model.state_dict().items():
            if not torch.equal(probe.model.state_dict()[k], v):
                raise AssertionError(f"{k} differs after loading {path}")
        probe.logger.close()
        second = PredictionTrainer(cfg)
        second.train()
        second.logger.close()
        per_epoch = cfg.epoch_size * (cfg.video_length // 6)
        if probe._step != first._step or second._step != first._step + per_epoch:
            raise AssertionError(f"steps: first {first._step}, loaded "
                                 f"{probe._step}, trained on {second._step}")
    print(f"det trainer's eval epoch: {cells} cell launches, all through "
          f"sm90; --dynamics_model_ckpt: a det trainer loaded "
          f"{os.path.basename(path)} (every tensor equal, step {probe._step}) "
          f"and trained on to step {second._step}")
    return dict(copy=copy, copy_seconds=copy_s, det_loaded_step=probe._step,
                det_trained_to=second._step, det_eval_sm90=cells)


def check_variants(dev):
    """Phase 11 (see the module docstring). Returns its JSON line's dict
    and the kernels line's entry for det's cells."""
    out = {"plans": {}}
    det_errs = check_det_cells(dev)
    for name in VARIANTS:
        err, flips, cell_err = small_cost_parity(name)
        print(f"small f32 {name} rollout costs, GPU vs CPU: max |diff| / |cost|"
              f" = {err:.3g} (tolerance {COST_RTOL}"
              + (f", plus one 1/255 step for each of {flips} pixels on "
                 "another blur step)" if name == "blur" else ")")
              + f"; cell states: max |diff| / max |CPU| = {cell_err:.3g} "
              f"(tolerance {CELL_RTOL})")
        out.setdefault("cost_parity", {})[name] = dict(
            rel_err=err, flips=flips, cell_rel_err=cell_err)
        if name != "blur":
            err, launched = small_plan_parity(name)
            print(f"small f32 {name} plan, GPU vs CPU: max |diff| = {err:.3g} "
                  f"(tolerance {PLAN_TOL}); launches {launched}")
            out.setdefault("plan_parity", {})[name] = err
    for name in TRAIN_VARIANTS:
        errs, _ = train_step_parity("cuda", **TRAIN_VARIANTS[name])
        print(f"small f32 {name} train step, GPU vs CPU: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items())
            + f" (tolerance {TRAIN_TOL}; gradients {GRAD_TOL_DEVICES} of each "
            "leaf's norm)")
        out.setdefault("train_parity", {})[name] = errs
    det_launches = None
    for name in VARIANTS:
        cfg, policy, plans = variant_plans(name)
        if name == "blur":
            plans["blur"] = time_blur(cfg, dev, plans.get("busy_ms"))
        if name == "det":
            det_launches = plans["launches"]["conv_lstm_cell_sm90"]
        # the server's guarantee for every model it loads
        checks = plan_checks(policy, repeats=2, batch_sizes=(2, 4))
        print(f"{name} plans: one request twice, one plan; batched == single "
              "bit for bit at R = 2 and 4")
        plans["batched_diff"] = checks["batched"]
        out["plans"][name] = plans
    det_entries = time_det_cells(dev, det_launches, det_errs)
    out["train"] = {name: variant_train_step(name, dev) for name in TRAIN_VARIANTS}
    out["trainer"] = check_copy_and_resume()
    det_entries[0]["launches_trainer_eval"] = out["trainer"]["det_eval_sm90"]
    return out, det_entries


# ------------------------------------------------------------------ data
def check_resize():
    """The port's C++ resize, built here with c++, against the float64
    bilinear reference at RoboNet's stored 64x85 to the model's 48x64, and
    its host time a frame (median of 5 calls of 310 frames)."""
    t0 = time.perf_counter()
    if not native.available():
        native.bilinear_resize(np.zeros((2, 2), np.float32), 1, 1)  # raises
    build_s = time.perf_counter() - t0
    imgs = np.random.RandomState(0).rand(310, 64, 85, 3).astype(np.float32)
    out = native.bilinear_resize_batch(imgs, 64, 48)
    err = max(float(np.abs(o - bilinear_reference(i, 64, 48)).max())
              for o, i in zip(out, imgs))
    if not err < RESIZE_TOL:
        raise AssertionError(f"native resize off the float64 reference by {err}")
    times = []
    for _ in range(5):
        t = time.perf_counter()
        native.bilinear_resize_batch(imgs, 64, 48)
        times.append(time.perf_counter() - t)
    ms = statistics.median(times) / len(imgs) * 1e3
    print(f"native resize (c++ build {build_s:.2f} s): 64x85x3 -> 48x64, max "
          f"|diff| from float64 {err:.3g} (tolerance {RESIZE_TOL}), "
          f"{ms:.4f} ms a frame on the host")
    return dict(build_s=build_s, max_abs_err=err, host_ms_per_frame=ms)


def check_data(dev):
    """Phase 12 (see the module docstring). Returns its JSON line's dict
    and the records-fed trainer's sm90 cell launches."""
    out = {"resize": check_resize()}
    out["imports"] = {m: importlib.util.find_spec(m) is not None
                      for m in ("h5py", "cv2", "imageio")}
    out["resize_route"] = robonet_hdf5.resize_route()
    print(f"importable here: {out['imports']}; the HDF5 reader's resize "
          f"route: {out['resize_route']}")
    cfg = Config(**dict(TRAIN, batch_size=128, test_batch_size=16,
                        video_length=31, n_eval=10, niter=1, epoch_size=2,
                        eval_interval=1, checkpoint_interval=1,
                        data_threads=5, jobname="records"))
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as d:
        t = time.perf_counter()
        # 8 shards of 64 episodes: a shuffled epoch reads every shard in
        # every batch
        shards = write_record_split(os.path.join(d, "train"),
                                    4 * cfg.batch_size, cfg, 0)
        write_record_split(os.path.join(d, "test"), 32, cfg, 1)
        out["write_s"] = time.perf_counter() - t
        train = RecordDataset(os.path.join(d, "train"))
        loader = DataLoader(train, cfg.batch_size, num_workers=cfg.data_threads,
                            seed=cfg.seed)
        t = time.perf_counter()
        n = sum(b["images"].shape[1] for b in loader)
        out["loader_episodes_per_s"] = n / (time.perf_counter() - t)
        out["shards"] = len(shards)
        out["shard_decodes"] = train.decodes
        if train.decodes != len(shards):
            raise AssertionError(f"{train.decodes} decodes of {len(shards)} "
                                 "shards in one epoch")
        # 8 batches of 64 through 2 staged ones: later copies land in
        # memory that the allocator freed from earlier batches
        pf = prefetch_check(DataLoader(train, 64, num_workers=cfg.data_threads,
                                       seed=cfg.seed), dev)
        if pf["mismatched"] or pf["batches"] != 8:
            raise AssertionError(f"prefetched batches differ from the host's: {pf}")
        out["prefetch"] = pf
        print(f"record shards: {len(train)} train episodes in {len(shards)} "
              f"shards and 32 test episodes of {cfg.video_length} frames "
              f"written in {out['write_s']:.1f} s; the loader "
              f"({cfg.data_threads} threads) {out['loader_episodes_per_s']:.1f} "
              f"episodes/s on the host, {train.decodes} shard decodes in a "
              f"shuffled epoch; device_prefetch: {pf['batches']} batches of 64 "
              f"equal to the host's bit for bit ({', '.join(pf['keys'])})")
        tr = RecordTrainer(cfg.replace(log_dir=d), d)
        kernels.reset_launches()
        tr.train()
        launched = dict(kernels.launches)
        cells = eval_cells(cfg, 32 // cfg.test_batch_size)
        if launched != {"conv_lstm_cell": cells, "conv_lstm_cell_sm90": cells,
                        "conv_lstm_cell_f32": 0, "capsule_mask_render": 0}:
            raise AssertionError(f"records trainer launched {launched}, "
                                 f"expected {cells} cells, all through sm90")
        with open(os.path.join(tr.log_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        train_rec = next(r for r in recs if "train/loss" in r)
        ev = next(r for r in recs if "eval/autoreg_psnr" in r)
        if not all(np.isfinite(v) for r in (train_rec, ev) for v in r.values()):
            raise AssertionError(f"non-finite trainer metrics {train_rec} {ev}")
        path = ckpt.latest_checkpoint(tr.log_dir)
        windows = cfg.epoch_size * (cfg.video_length // 6)
        if tr._step != windows or not path.endswith(f"ckpt_{windows}.npz"):
            raise AssertionError(f"records trainer at step {tr._step}, saved {path}")
        tr.logger.close()
        tr2 = RecordTrainer(cfg.replace(log_dir=d), d)
        tr2._resume()
        tr2.logger.close()
        if tr2._step != tr._step:
            raise AssertionError(f"resumed at {tr2._step}, saved {tr._step}")
        syn = PredictionTrainer(cfg.replace(experiment="synthetic", log_dir=d,
                                            jobname="synthetic",
                                            eval_interval=10,
                                            checkpoint_interval=10))
        syn.train()
        with open(os.path.join(syn.log_dir, "metrics.jsonl")) as f:
            syn_fps = next(json.loads(line) for line in f
                           if "train/loss" in line)["train/frames_per_sec"]
        syn.logger.close()
    epoch = tr.last_epoch
    out["trainer"] = dict(
        frames_per_s=train_rec["train/frames_per_sec"],
        epoch_s=epoch["seconds"], data_wait_s=epoch["data_wait_s"],
        data_wait_share=epoch["data_wait_s"] / epoch["seconds"],
        steps=tr._step, resumed_step=tr2._step,
        cell_launches=launched["conv_lstm_cell"],
        sm90_launches=launched["conv_lstm_cell_sm90"],
        loss=train_rec["train/loss"], autoreg_psnr=ev["eval/autoreg_psnr"],
        synthetic_frames_per_s=syn_fps,
        synthetic_wait_share=syn.last_epoch["data_wait_s"] / syn.last_epoch["seconds"])
    print(f"records trainer (batch {cfg.batch_size}, {cfg.data_threads} loader "
          f"threads): {out['trainer']['frames_per_s']:.1f} frames/s over the "
          f"epoch, waiting {out['trainer']['data_wait_share']:.1%} of it in "
          f"next(train_iter); synthetic trainer at the same batch "
          f"{syn_fps:.1f} frames/s (waiting "
          f"{out['trainer']['synthetic_wait_share']:.1%}); "
          f"{out['trainer']['sm90_launches']} cell launches "
          f"in its eval epoch and gif, all through sm90; resumed at step "
          f"{tr2._step}; loss {out['trainer']['loss']:.4f}")
    return out, launched["conv_lstm_cell_sm90"]


# ---------------------------------------------------------------- robots
def count_syncs(fn) -> dict:
    """Host syncs that PyTorch ops make in fn() (its sync debug mode warns
    at each), by the Python line that called the op."""
    import collections
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)))


def device_ms(fn) -> float:
    """The device's busy milliseconds in one fn() under torch.profiler
    (`device_busy_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_busy_ms(prof)


def chain_plans(experiment, n_timed=3):
    """Phase 13 (b) for one chain robot (see the module docstring)."""
    cfg = Config(**dict(CANONICAL, experiment=experiment))
    policy = CEMPolicy(cfg, svg.init(cfg, seed=0, device="cuda"))
    engine = policy.engine
    start, goal = chain_start_goal(np.random.RandomState(0), experiment)
    want = dict(plan_launches(cfg), capsule_mask_render=0)
    plan_at = lambda i: policy.get_action(start, goal, ep_num=1, step=i)
    seconds = []
    kernels.reset_launches()
    for i in range(n_timed + 1):
        before = dict(kernels.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = plan_at(i)
        torch.cuda.synchronize()
        if i:
            seconds.append(time.perf_counter() - t0)
        got = {k: kernels.launches[k] - before[k] for k in want}
        if got != want:
            raise AssertionError(f"{experiment} plan {i} launched {got}, "
                                 f"expected {want}")
        if (plan.shape != (cfg.horizon - 1, 2) or not np.all(np.isfinite(plan))
                or np.abs(plan).max() > 0.05):
            raise AssertionError(f"{experiment}: bad plan {plan!r}")
    launches = dict(kernels.launches)
    latency = statistics.median(seconds)
    sync_sites = count_syncs(lambda: plan_at(10))
    syncs = sum(sync_sites.values())
    torch.cuda.reset_peak_memory_stats()
    plan_at(11)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_plan(lambda: plan_at(12), f"{experiment} plan")
    # the IK and the render of one rollout at the plan's shapes
    N, T, A = cfg.action_candidates, cfg.horizon - 1, cfg.action_dim
    g = torch.Generator("cuda").manual_seed(0)
    acts = (torch.randn(T, N, A, generator=g, device="cuda") * 0.015).clamp(
        -0.05, 0.05)
    start_raw = torch.tensor(np.array([0.3, 0.0, 0.15, 0, 0], np.float32),
                             device="cuda").expand(N, 5)
    q0 = torch.zeros(N, engine.qpos_dim, device="cuda")
    _, qs = engine.chain_joints(start_raw, q0, acts)
    # the IK launches thousands of kernels, more than the launch queue
    # holds behind cuda_ms's sleeping kernel: its device time is the busy
    # time of a profile
    ik_ms = device_ms(lambda: engine.chain_joints(start_raw, q0, acts))
    render_ms = cuda_ms(lambda: engine.chain_env.render(qs), n=5)
    joints = chain_joints_parity(engine, start_raw, q0, acts)
    batched_diff = chain_batched_diff(policy, experiment, 2)
    if batched_diff != 0.0:
        raise AssertionError(f"{experiment}: batched plans differ from single "
                             f"plans by {batched_diff}")
    out = dict(latency_s=latency, latency_runs=seconds, launches=launches,
               launches_per_plan=want, host_syncs_per_plan=syncs,
               host_sync_sites=sync_sites,
               peak_gb=peak_gb, ik_ms_per_rollout=ik_ms,
               render_ms_per_rollout=render_ms,
               ik_ms_per_plan=ik_ms * cfg.opt_iter,
               render_ms_per_plan=render_ms * cfg.opt_iter,
               joints_vs_cpu=joints, batched_diff=batched_diff)
    if prof:
        out["busy_ms"], out["wall_ms"] = prof[:2]
        out["busy_share"] = prof[0] / prof[1]
        out["device_kernels_per_plan"] = sum(r[1] for r in prof[2])
    print(f"{experiment}: plan latency {latency:.4f} s (median of {n_timed}: "
          + ", ".join(f"{v:.4f}" for v in seconds) + f"), launches per plan "
          f"{want}, {out.get('device_kernels_per_plan')} device kernels and "
          f"{syncs} host syncs a plan ({sync_sites}), peak {peak_gb:.2f} GB; IK "
          f"{ik_ms:.3f} ms and chain render {render_ms:.3f} ms of device time "
          f"a rollout ({ik_ms * cfg.opt_iter:.2f} and "
          f"{render_ms * cfg.opt_iter:.2f} ms a plan); warm-started IK vs CPU "
          f"at {joints['tips']} tips: {joints['ik_tip_err']:.2g} m (CPU "
          f"{joints['ik_tip_err_cpu']:.2g}), {joints['mask_differ']} mask pixels "
          f"differ ({joints['mask_band']} near an edge); batched == single")
    return out


def check_robot_trainer(dev, d):
    """Phase 13 (c). Returns its dict and the checkpoint's path."""
    out = {"step_parity": robot_step_parity(dev, os.path.join(d, "parity"))}
    cfg = Config(**dict(ROBOT, log_dir=d))
    tr = RobotPredictionTrainer(cfg)
    test = JointPosDataset(cfg, num=64, seed=cfg.seed + 1)
    before = tr.evaluate(test)
    kernels.reset_launches()
    t0 = time.perf_counter()
    tr.train(None, test)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    launched = dict(kernels.launches)
    after = tr.evaluate(test)
    eval_batches = 64 // min(cfg.test_batch_size, 64)
    want = {"capsule_mask_render": 2 * eval_batches * cfg.niter,
            "conv_lstm_cell": 0, "conv_lstm_cell_sm90": 0, "conv_lstm_cell_f32": 0}
    if launched != want:
        raise AssertionError(f"robot trainer launched {launched}, expected {want}")
    if not (after["state_rollout_mse"] < before["state_rollout_mse"]
            and 0.0 <= after["mask_iou"] <= 1.0):
        raise AssertionError(f"robot trainer: before {before}, after {after}")
    # the mask kernel on an eval's own segments against its plain version
    batch = {k: torch.tensor(v, device=dev) for k, v in next(test.batches(16)).items()}
    with torch.no_grad():
        _, qq = rollout(tr.joint, tr.grip, batch["states"][0], batch["qpos"][0],
                        batch["actions"])
    segs = tr.renderer.segment_params(qq).reshape(-1, 8, 6).contiguous()
    got = kernels.capsule_mask_render(segs, cfg.image_height, cfg.image_width)
    differ = int((got != kernels.capsule_mask_render_plain(
        segs, cfg.image_height, cfg.image_width)).sum())
    if differ:
        raise AssertionError(f"mask kernel differs from plain on the robot "
                             f"trainer's segments in {differ} pixels")
    path = ckpt.latest_checkpoint(tr.log_dir)
    tr.logger.close()
    out.update(before=before, after=after, launches=launched,
               kernel_vs_plain_differ=differ, masks_checked=segs.shape[0],
               checkpoint=os.path.basename(path))
    print(f"robot trainer ({cfg.niter} epochs of 256 sequences, batch "
          f"{cfg.batch_size}) {out['seconds']:.2f} s: state rollout MSE "
          f"{before['state_rollout_mse']:.5f} -> {after['state_rollout_mse']:.5f}, "
          f"mask IoU {after['mask_iou']:.4f}, {launched['capsule_mask_render']} "
          f"mask kernel launches in its evals (kernel == plain on "
          f"{segs.shape[0]} of its masks); one train step vs CPU "
          f"{out['step_parity']}; wrote {out['checkpoint']}")
    return out, path


def check_finetune(dev, d, robot_ckpt, records_fps):
    """Phase 13 (d)."""
    cfg = Config(**dict(TRAIN, experiment="finetune_locobot", test_batch_size=16,
                        video_length=31, n_eval=10, niter=1, epoch_size=2,
                        eval_interval=1, checkpoint_interval=1, data_threads=5,
                        jobname="finetune"))
    write_record_split(os.path.join(d, "train"), 2 * cfg.batch_size, cfg, 0)
    write_record_split(os.path.join(d, "test"), 32, cfg, 1)
    src = PredictionTrainer(cfg.replace(experiment="synthetic",
                                        log_dir=os.path.join(d, "src")))
    src._step = 5
    src._save(0)
    ckpt.wait_for_checkpoints()
    src_path = ckpt.latest_checkpoint(src.log_dir)
    src.logger.close()
    out = {}
    for mode in ("analytical", "learned"):
        fcfg = cfg.replace(log_dir=os.path.join(d, mode),
                           dynamics_model_ckpt=src_path,
                           learned_robot_model=mode == "learned",
                           robot_model_ckpt=robot_ckpt if mode == "learned" else None)
        tr = FinetuneRecordTrainer(fcfg, d)
        if (tr.learned_robot is None) != (mode == "analytical"):
            raise AssertionError(f"{mode}: robot model not set up")
        seen = {}
        epochs = tr._train_epochs

        def first(train_iter, test_loader, tr=tr, seen=seen, epochs=epochs):
            seen.update(step=tr._step, opt_state=len(tr.optimizer.state))
            return epochs(train_iter, test_loader)

        tr._train_epochs = first
        rendered = record_renders(tr)
        kernels.reset_launches()
        tr.train()
        launched = dict(kernels.launches)
        vs_plain = recorded_kernel_vs_plain(rendered)
        want = finetune_launches(cfg, cfg.epoch_size, 32 // cfg.test_batch_size)
        if launched != want or seen != {"step": 0, "opt_state": 0}:
            raise AssertionError(f"finetune {mode}: launched {launched}, expected "
                                 f"{want}; started at {seen}")
        with open(os.path.join(tr.log_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        train = next(r for r in recs if "train/loss" in r)
        ev = next(r for r in recs if "eval/autoreg_psnr" in r)
        if not all(np.isfinite(v) for r in (train, ev) for v in r.values()):
            raise AssertionError(f"finetune {mode}: non-finite metrics {train} {ev}")
        epoch = tr.last_epoch
        tr.logger.close()
        out[mode] = dict(frames_per_s=train["train/frames_per_sec"],
                         data_wait_share=epoch["data_wait_s"] / epoch["seconds"],
                         epoch_s=epoch["seconds"], steps=tr._step, launches=launched,
                         kernel_vs_plain=vs_plain,
                         started=seen, loss=train["train/loss"],
                         autoreg_psnr=ev["eval/autoreg_psnr"])
        print(f"finetune_locobot ({mode} robot model, batch {cfg.batch_size}, "
              f"records): {out[mode]['frames_per_s']:.1f} frames/s over the "
              f"epoch, waiting {out[mode]['data_wait_share']:.1%} of it for data "
              f"(phase 12's records trainer {records_fps:.1f} frames/s); started "
              f"at step 0 with a fresh optimizer from {os.path.basename(src_path)}; "
              f"launches {launched} (mask kernel == plain on "
              f"{vs_plain['masks_checked']} of its masks, shapes "
              f"{vs_plain['shapes']}); loss {out[mode]['loss']:.4f}, best-of-3 "
              f"autoregressive PSNR {out[mode]['autoreg_psnr']:.2f}")
    return out


def check_robots(dev, records_fps):
    """Phase 13 (see the module docstring). Returns its JSON line's dict."""
    out = {"geometry": chain_geometry(dev)}
    print("chain geometry, card vs CPU, all 8 keys: " + "; ".join(
        f"{k} FK {r['fk_err']:.2g} m, IK tips {r['ik_tip_err']:.2g} m (CPU "
        f"{r['ik_tip_err_cpu']:.2g}), "
        f"{r['mask_differ']} mask pixels differ ({r['mask_band']} near an edge)"
        for k, r in out["geometry"].items()))
    out["plans"] = {exp: chain_plans(exp) for exp in CHAIN_EXPERIMENTS}
    out["small_plan_parity"] = {exp: small_chain_plan_parity(exp, dev)
                                for exp in CHAIN_EXPERIMENTS}
    print(f"small float32 chain plans, card vs CPU at the CPU's robot "
          f"trajectory: {out['small_plan_parity']}")
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as d:
        out["robot_trainer"], robot_ckpt = check_robot_trainer(
            dev, os.path.join(d, "robot"))
        out["finetune"] = check_finetune(dev, d, robot_ckpt, records_fps)
    return out


# -------------------------------------------------------------- families
def check_cdna_cells(policy, start, goal, dev):
    """Phase 14 (b): one canonical CDNA plan with the cell wrapper keeping
    the inputs of its first model steps' cells; the second step's (cell0 k
    = 5 and cell1 k = 3, states no longer zero) each run once more through
    the kernel (one sm90 launch each, not counted on the plan's path) and
    held to its plain version, and timed beside it."""
    calls = []
    wrapper = kernels.conv_lstm_cell

    def record(x, h, c, w, b):
        if len(calls) < 4:
            calls.append([t.clone() for t in (x, h, c, w, b)])
        return wrapper(x, h, c, w, b)

    kernels.conv_lstm_cell = record
    try:
        policy.get_action(start, goal, ep_num=3, step=0)
    finally:
        kernels.conv_lstm_cell = wrapper
    rows = []
    for args in calls[2:]:
        x, h, c, w, b = args
        if not all(kernels.tma_ready(t) for t in (x, h, c)):
            raise AssertionError(f"CDNA cell {tuple(x.shape)} k={w.shape[0]} "
                                 "is not read in place")
        before = kernels.launches["conv_lstm_cell_sm90"]
        got = wrapper(*args)
        if kernels.launches["conv_lstm_cell_sm90"] - before != 1:
            raise AssertionError("the CDNA cell did not launch sm90 once")
        err = cell_err(got, kernels.conv_lstm_cell_plain(*args),
                       CELL_TOL[torch.bfloat16])
        ms = cuda_ms(lambda: wrapper(*args))
        plain = cuda_ms(lambda: kernels.conv_lstm_cell_plain(*args))
        rows.append(dict(shape=list(x.shape), k=int(w.shape[0]),
                         max_abs_err=err, ms=ms, plain_ms=plain,
                         h_absmax=float(h.float().abs().max())))
    print("CDNA cells at a plan's own state (second model step), sm90 vs "
          "plain: " + "; ".join(
              f"k={r['k']} {r['shape']}: max |diff| {r['max_abs_err']:.3g} "
              f"(tolerance {CELL_TOL[torch.bfloat16]}), {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, |h| <= {r['h_absmax']:.3g}" for r in rows))
    return rows


def check_debug_cem(cfg, model, d):
    """Phase 14 (c): one canonical plan with debug_cem on: the frames its
    rollout hands save_gif are horizon-1 finite (H, 2W, 3) images."""
    policy = CEMPolicy(cfg.replace(debug_cem=True, log_dir=d), model)
    start, goal = start_goal(np.random.RandomState(0))
    t0 = time.perf_counter()
    plan, frames, path = debug_cem_frames(policy, start, goal, ep_num=1)
    seconds = time.perf_counter() - t0
    shape = (cfg.image_height, 2 * cfg.image_width, 3)
    if (plan.shape != (cfg.horizon - 1, 2) or len(frames) != cfg.horizon - 1
            or any(f.shape != shape or not np.all(np.isfinite(f))
                   for f in frames)):
        raise AssertionError(f"debug_cem: plan {plan.shape}, frames "
                             f"{[f.shape for f in frames]}")
    print(f"debug_cem ({cfg.model}): plan and rollout plot {seconds:.3f} s, "
          f"{len(frames)} finite frames of {shape}; "
          + (f"wrote {os.path.basename(path)}" if path else
             "gif skipped: imageio does not import here"))
    return dict(seconds=seconds, frames=len(frames), gif_written=bool(path))


def check_families(dev):
    """Phase 14 (see the module docstring). Returns its JSON line's dict."""
    out = {"plans": {}, "small_plan_parity": {}, "train_parity": {},
           "train": {}}
    for name in FAMILIES:
        err, launched = family_plan_parity(name, dev)
        out["small_plan_parity"][name] = dict(err=err, launches=launched)
        print(f"small f32 {name} plan, GPU vs CPU: max |diff| = {err:.3g} "
              f"(tolerance {PLAN_TOL}); launches {launched}")
    policies = {}
    for name in FAMILIES:
        cfg, policy, plans = variant_plans(
            name, fields=family_fields(name, small=False))
        if name in ("cdna_det", "svg_vec"):
            checks = plan_checks(policy, repeats=2, batch_sizes=(2, 4))
            plans["batched_diff"] = checks["batched"]
            print(f"{name} plans: one request twice, one plan; batched == "
                  "single bit for bit at R = 2 and 4")
        out["plans"][name] = plans
        policies[name] = policy
    start, goal = start_goal(np.random.RandomState(0))
    out["cdna_cells"] = check_cdna_cells(policies["cdna_det"], start, goal, dev)
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as d:
        out["debug_cem"] = check_debug_cem(policies["cdna_det"].cfg,
                                           policies["cdna_det"].model, d)
    del policies
    torch.cuda.empty_cache()
    for name in FAMILIES:
        errs, _ = family_train_parity(name, dev)
        out["train_parity"][name] = errs
        print(f"small f32 {name} train step, GPU vs CPU: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items())
            + f" (tolerance {TRAIN_TOL}; gradients {GRAD_TOL_DEVICES} of each "
            "leaf's norm)")
    for name in ("svg_vec", "cdna_det"):
        out["train"][name] = variant_train_step(
            name, dev, fields=family_fields(name, small=False))
    result = eval_kernel_vs_plain(dev, model="cdna_det")
    out["cdna_eval_kernel_vs_plain"] = result
    for mode, r in result.items():
        print(f"full-width bf16 cdna_det eval step ({mode}), kernel vs plain "
              f"cell: predictions {r['preds']:.3g}, metrics {r['metrics']:.3g} "
              f"of their max (tolerance {EVAL_TOL}); "
              f"{r['launched']['conv_lstm_cell_sm90']} sm90 launches")
    out["inverse"] = dict(
        step_parity={str(disc): inverse_step_parity(dev, discretized=disc)
                     for disc in (False, True)},
        losses_batch_128=inverse_learns(dev))
    losses = out["inverse"]["losses_batch_128"]
    print(f"inverse model: one Adam step GPU vs CPU {out['inverse']['step_parity']}"
          f"; 20 steps at batch 128, loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    return out


# ------------------------------------------------------------------- sim
def time_sim_mask(dev):
    """The mask kernel at the sim path's launches: one GT CEM iteration's
    (M = N x (horizon - 1) thin capsules of LocobotPush scenes) and one
    observation's (M = 1), by CUDA events behind a sleeping kernel, beside
    its plain version and its bound."""
    renderer, qpos = gt_scenes(dev)
    h, w = renderer.h, renderer.w
    out = {}
    for name, q in (("gt", qpos), ("observation", qpos[:1])):
        segs = renderer.segment_params(q).float().contiguous()
        M, S = segs.shape[:2]
        ms = cuda_ms(lambda: kernels.capsule_mask_render(segs, h, w), n=200)
        plain = cuda_ms(lambda: kernels.capsule_mask_render_plain(segs, h, w))
        needed, ops, _, bound, by = mask_bound(segs, h, w)
        kept = kernels.capsule_mask_tests_kept(segs, h, w).float().mean().item()
        out[name] = dict(M=M, S=S, ms=ms, plain_ms=plain, bound_ms=bound,
                         bound_by=by, gops=ops / 1e9, tests_kept=kept,
                         inside_boxes=needed / (M * S * h * w))
        print(f"mask kernel, sim {name} launch M={M} S={S} {h}x{w} thin: "
              f"{ms:.5f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms "
              f"({by}, {ops / 1e9:.5f} G operations); share of the tests "
              f"the skip rule keeps {kept:.4f}")
    return out


def sim_episode(fields, dev, log_dir, model=None):
    """One 4-step PushEpisodeRunner episode (tests/torch_sim_cases.py):
    plan latency a step, env step time, launches (expected: 1 mask launch
    an observation, the reset's and the demo start's included, and the
    plans' own), a finite summary."""
    cfg = Config(**dict(fields, log_dir=log_dir))
    r = run_push_episode(cfg, dev, model)
    steps = cfg.max_episode_length - 1
    plans = len(r["plan_s"])
    want = {"capsule_mask_render": 2 + steps + plans * cfg.opt_iter,
            "conv_lstm_cell_sm90": 0 if model is None
            else plans * plan_launches(cfg)["conv_lstm_cell_sm90"]}
    got = {k: r["launches"][k] for k in want}
    if len(r["actions"]) != steps or got != want:
        raise AssertionError(f"episode ran {len(r['actions'])} steps with "
                             f"launches {got}, expected {steps} and {want}")
    if not all(np.isfinite(v) for v in r["stats"].values()):
        raise AssertionError(f"episode stats not finite: {r['stats']}")
    out = dict(stats=r["stats"], launches=got, plan_s=r["plan_s"],
               step_s=r["step_s"], plan_s_median=float(np.median(r["plan_s"])),
               step_s_median=float(np.median(r["step_s"])))
    print(f"{'GT' if model is None else 'learned'} episode: {steps} steps, "
          f"plan {out['plan_s_median']:.4f} s a step (median; "
          + ", ".join(f"{v:.4f}" for v in r["plan_s"])
          + f"), env step {out['step_s_median'] * 1e3:.2f} ms, launches "
          f"{got}; stats {r['stats']}")
    return out


def check_sim(dev):
    """Phase 15 (see the module docstring). Returns its JSON line's dict."""
    out = {"physics": {}}
    for name in SIM_ENVS:
        r = physics_card_vs_cpu(name, dev)
        out["physics"][name] = r
        print(f"{name}, {STEPS} steps card vs CPU: positions and joints "
              f"{r['pos_err']:.3g} (tolerance {POS_TOL}), images "
              f"{r['img_err']:.3g}, {r['mask_differ']} mask pixels differ; "
              f"{r['coverage']}")
        cov = r["coverage"]
        covered = ((cov["grabs"] and cov["drops"]) if name == "LocobotPick"
                   else cov["moved"] == (3 if name == "ClutterPush" else 1))
        if not (r["pos_err"] <= POS_TOL and r["img_err"] <= IMG_TOL
                and r["mask_differ"] == 0 and covered):
            raise AssertionError(f"{name}: the card's physics or render "
                                 "differs from the CPU's")
    out["mask_kernel_vs_plain"] = gt_mask_kernel_vs_plain(dev)
    print(f"mask kernel vs plain at the sim launches: "
          f"{out['mask_kernel_vs_plain']}")
    if any(r["differ"] for r in out["mask_kernel_vs_plain"].values()):
        raise AssertionError("mask kernel differs from plain on sim scenes")
    out["mask_times"] = time_sim_mask(dev)
    gt = gt_plans(dev)
    policy, goal = gt.pop("policy"), gt.pop("goal")
    plan = lambda: policy.get_action(None, goal, ep_num=2)
    prof = profile_plan(plan, "GT plan")
    if prof:
        busy, wall, rows = prof
        gt.update(busy_ms=busy, profiled_wall_ms=wall, busy_share=busy / wall,
                  device_kernels=sum(n for _, n, _ in rows),
                  top_kernels=[(ms, n, key[:80]) for ms, n, key in rows[:8]])
    gt["device_ms"] = device_ms(plan)
    gt["syncs"] = count_syncs(plan)
    print(f"GT plan (LocobotPush, N=100, horizon 5, opt_iter 10, topk 5): "
          f"{gt['latency']:.4f} s (median of 3: "
          + ", ".join(f"{v:.4f}" for v in gt["seconds"])
          + f"), device {gt['device_ms']:.2f} ms, launches {gt['launches']}, "
          f"{sum(gt['syncs'].values())} host syncs {gt['syncs']}")
    out["gt_plan"] = gt
    err = small_gt_plan_parity(dev)
    out["small_gt_plan_parity"] = err
    print(f"small GT plan, card vs CPU with injected noise: {err:.3g} "
          f"(tolerance {GT_PLAN_TOL})")
    if not err <= GT_PLAN_TOL:
        raise AssertionError("GT plan on the card differs from the CPU's")
    env = make("LocobotPush", Config(), seed=0, device=dev)
    env.reset()
    env.step(np.array([0.9, 0.1], np.float32))
    before = kernels.launches["capsule_mask_render"]
    out["env_step"] = dict(
        syncs=count_syncs(lambda: env.step(np.array([0.9, 0.1], np.float32))),
        mask_launches=kernels.launches["capsule_mask_render"] - before)
    print(f"one LocobotPush env step on the card: {out['env_step']}")
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as d:
        out["gt_episode"] = sim_episode(GT_EPISODE, dev, d)
        model = svg.init(Config(**LEARNED_EPISODE), seed=0, device=dev)
        out["learned_episode"] = sim_episode(LEARNED_EPISODE, dev, d, model)
    # the canonical learned plan's host syncs (the IK's constants are made
    # once a device, so none of them comes from its loop)
    start, goal = start_goal(np.random.RandomState(0))
    policy = CEMPolicy(Config(**LEARNED_EPISODE), model, device=dev)
    policy.get_action(start, goal)
    out["learned_plan_syncs"] = count_syncs(
        lambda: policy.get_action(start, goal, step=1))
    print(f"canonical learned plan: {sum(out['learned_plan_syncs'].values())}"
          f" host syncs {out['learned_plan_syncs']}")
    del model, policy
    out["bridge"] = bridge_plan_check(dev)
    print(f"bridge: a reference state dict of {out['bridge']['keys']} tensors "
          f"through torch_import plans as convert.py's: {out['bridge']}")
    if not out["bridge"]["equal"]:
        raise AssertionError("the bridged model's plan differs")
    return out


# ----------------------------------------------------------- experiments
def _stamped(owner, name, log):
    """Wraps owner.name (a function or method) to append each call's
    (start, end) host seconds to `log`; returns the original."""
    orig = getattr(owner, name)

    def wrapped(*a, **k):
        t0 = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            log.append((t0, time.perf_counter()))

    setattr(owner, name, wrapped)
    return orig


class KernelInputs:
    """While active, keeps a copy of the first inputs of each distinct
    shape that the mask kernel's and the cell's wrappers are called with
    (the main path's own tensors), to hold the kernels against their plain
    versions on them afterwards."""

    def __init__(self):
        self.cells, self.masks = {}, {}

    def __enter__(self):
        self._cell, self._mask = kernels.conv_lstm_cell, kernels.capsule_mask_render

        def cell(x, h, c, w, b):
            key = (*x.shape, h.shape[-1], w.shape[0], str(x.dtype))
            if key not in self.cells:
                self.cells[key] = [t.detach().clone() for t in (x, h, c, w, b)]
            return self._cell(x, h, c, w, b)

        def mask(segs, h, w):
            key = (*segs.shape[:2], h, w)
            if key not in self.masks and len(segs):
                self.masks[key] = segs.detach().clone()
            return self._mask(segs, h, w)

        kernels.conv_lstm_cell, kernels.capsule_mask_render = cell, mask
        return self

    def __exit__(self, *exc):
        kernels.conv_lstm_cell, kernels.capsule_mask_render = self._cell, self._mask

    def check(self, label: str) -> dict:
        """Each recorded shape: the kernel against its plain version on the
        recorded inputs (masks bit for bit, bf16 cells CELL_TOL), timed by
        CUDA events beside the plain version."""
        out = {"cells": [], "masks": []}
        for key, args in sorted(self.cells.items()):
            B, H, W, Cx, C, k, dt = key
            tol = CELL_TOL[torch.bfloat16]
            got, _ = one_launch(lambda: kernels.conv_lstm_cell(*args), "sm90")
            err = cell_err(got, kernels.conv_lstm_cell_plain(*args), tol)
            x, h, c, w, b = args
            ms = cuda_ms(lambda: kernels.conv_lstm_cell(*args))
            plain = cuda_ms(lambda: kernels.conv_lstm_cell_plain(*args), n=5)
            xh = torch.cat([x, h], -1).permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib = cuda_ms(lambda: F.conv2d(xh, w_oihw, b.to(x.dtype),
                                           padding=k // 2))
            ops = 2.0 * B * valid_taps(H, W, k) * (Cx + C) * 4 * C
            nbytes = 2 * (x.numel() + h.numel() + c.numel() + w.numel()
                          + 2 * h.numel()) + 4 * b.numel()
            bound, by = bound_ms(ops, PEAK_BF16, nbytes)
            out["cells"].append(dict(B=B, H=H, W=W, Cx=Cx, C=C, k=k,
                                     max_abs_err=err, ms=ms, plain_ms=plain,
                                     library_ms=lib, bound_ms=bound,
                                     bound_by=by))
            print(f"{label}: sm90 cell at the run's own inputs B={B} {H}x{W} "
                  f"Cx={Cx} C={C} k={k}: max |kernel - plain| {err:.3g} "
                  f"(tolerance {tol}), {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"cuDNN gate conv {lib:.4f} ms, bound {bound:.4f} ms ({by})")
        for key, segs in sorted(self.masks.items()):
            M, S, h, w = key
            got = kernels.capsule_mask_render(segs, h, w)
            differ = int((got != kernels.capsule_mask_render_plain(segs, h, w)).sum())
            if differ:
                raise AssertionError(f"{label}: mask kernel differs at {key}")
            ms = cuda_ms(lambda: kernels.capsule_mask_render(segs, h, w), n=200)
            plain = cuda_ms(lambda: kernels.capsule_mask_render_plain(segs, h, w))
            _, ops, _, bound, by = mask_bound(segs, h, w)
            out["masks"].append(dict(M=M, S=S, h=h, w=w, differ=differ, ms=ms,
                                     plain_ms=plain, bound_ms=bound,
                                     bound_by=by, library_ms=None))
            print(f"{label}: mask kernel at the run's own inputs M={M} S={S} "
                  f"{h}x{w}: bit for bit, {ms:.5f} ms, plain {plain:.4f} ms, "
                  f"bound {bound:.5f} ms ({by})")
        return out


def _train_fps(log_dir: str) -> float:
    """The last train epoch's frames/s in a trainer's metrics.jsonl."""
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if "train/frames_per_sec" in r][-1][
        "train/frames_per_sec"]


def pick_experiment(d: str, dev) -> dict:
    """Phase 16 (b): experiments.pick.main end to end on the card (record
    route), timed by phase: collection, shards, training, the learned pick
    episodes (plan latency and env step time a step); the host syncs of a
    plan; the kernels' launches over the whole run."""
    from robot_aware_control_tpu_torch.envs.locobot_pick import LocobotPickEnv
    from robot_aware_control_tpu_torch.experiments import pick
    from robot_aware_control_tpu_torch.planning.gt_rollout import DemoCEMPolicy

    log_dir = os.path.join(d, "pick")
    stamps = {k: [] for k in ("write", "train", "plan", "step")}
    syncs = {}
    plan = DemoCEMPolicy.get_action

    def plan_counting(self, *a, **k):
        if len(stamps["plan"]) == 1:  # the second plan: count its syncs
            out = []
            syncs.update(count_syncs(lambda: out.append(plan(self, *a, **k))))
            return out[0]
        return plan(self, *a, **k)

    patched = [(pick, "write_training_records"), (PredictionTrainer, "train"),
               (DemoCEMPolicy, "get_action"), (LocobotPickEnv, "step")]
    DemoCEMPolicy.get_action = plan_counting
    origs = [_stamped(owner, name, stamps[key]) for (owner, name), key in
             zip(patched, ("write", "train", "plan", "step"))]
    origs[2] = plan
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with KernelInputs() as inputs:
            result = pick.main(flags(EXPERIMENT_CUTS)
                               + ["--log_dir", log_dir, "--device", str(dev)])
    finally:
        for (owner, name), orig in zip(patched, origs):
            setattr(owner, name, orig)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    (w0, w1), (tr0, tr1) = stamps["write"][0], stamps["train"][0]
    plan_s = [b - a for a, b in stamps["plan"]]
    ep_steps = [b - a for a, b in stamps["step"] if a > stamps["plan"][0][0]]
    out = dict(seconds=seconds, collect_s=w0 - t0, shards_s=w1 - w0,
               train_s=tr1 - tr0,
               train_frames_per_s=_train_fps(os.path.join(log_dir, "pick_model")),
               episodes_s=seconds - tr1 + t0, plans=len(plan_s),
               plan_s_median=float(np.median(plan_s)),
               env_step_s_median=float(np.median(ep_steps)),
               plan_syncs=syncs, launches=launches,
               summary=result["summary"], cuts=EXPERIMENT_CUTS)
    if not (all(np.isfinite(v) for v in result["summary"].values())
            and launches["capsule_mask_render"] > 0
            and launches["conv_lstm_cell_sm90"] > 0):
        raise AssertionError(f"pick experiment: summary {result['summary']}, "
                             f"launches {launches}")
    print(f"pick experiment ({EXPERIMENT_CUTS}, the record route): "
          f"{seconds:.1f} s; collection {out['collect_s']:.2f} s, shards "
          f"{out['shards_s']:.2f} s, training {out['train_s']:.1f} s at "
          f"{out['train_frames_per_s']:.1f} frames/s, {out['plans']} learned "
          f"pick plans at {out['plan_s_median']:.4f} s a step (median), env "
          f"step {out['env_step_s_median'] * 1e3:.2f} ms; a plan's host syncs "
          f"{sum(syncs.values())} {syncs}; launches {launches}; summary "
          f"{result['summary']}")
    out["kernels_vs_plain"] = inputs.check("pick")
    return out


def transfer_experiment(d: str, dev) -> dict:
    """Phase 16 (c): experiments.transfer.main end to end on the card
    (record route); the sm90 cell's launches in its eval_transfer (the
    trainers run no eval epoch: every cell launch of the run is the
    eval's)."""
    from robot_aware_control_tpu_torch.experiments import transfer

    log_dir = os.path.join(d, "transfer")
    evals = []
    orig = _stamped(transfer, "eval_transfer", evals)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with KernelInputs() as inputs:
            result = transfer.main(flags(TRANSFER_CUTS)
                                   + ["--log_dir", log_dir, "--device", str(dev)])
    finally:
        transfer.eval_transfer = orig
    seconds = time.perf_counter() - t0
    launches = dict(kernels.launches)
    out = dict(seconds=seconds, eval_s=[b - a for a, b in evals],
               launches=launches, result=result, cuts=TRANSFER_CUTS,
               log_dir=log_dir)
    finite = all(np.isfinite(v) for k in ("robot_aware", "vanilla")
                 for v in result[k].values())
    if not (finite and launches["conv_lstm_cell_sm90"] > 0):
        raise AssertionError(f"transfer experiment: {result}, {launches}")
    print(f"transfer experiment ({TRANSFER_CUTS}, the record route): "
          f"{seconds:.1f} s, eval_transfer "
          + ", ".join(f"{v:.2f}" for v in out["eval_s"])
          + f" s; launches {launches}; world MSE ratio vanilla / robot-aware "
          f"{result['world_mse_ratio_vanilla_over_ra']} (one epoch: not a "
          f"result); {json.dumps(result)}")
    out["kernels_vs_plain"] = inputs.check("transfer")
    return out


def fvd_checks(dev, transfer_out: dict) -> dict:
    """Phase 16 (d): the random-init I3D and the random embedder on the
    card against the CPU (TF32 off), the I3D's embed time for 16 videos of
    10 frames at 48x64, and evaluate_fvd of the transfer run's robot-aware
    checkpoint over its training episodes' shards."""
    from robot_aware_control_tpu_torch.data.records import create_record_loaders
    from robot_aware_control_tpu_torch.evaluation import i3d
    from robot_aware_control_tpu_torch.evaluation.evaluate_checkpoint import (
        evaluate_fvd,
    )
    from robot_aware_control_tpu_torch.evaluation.fvd import make_i3d_embed_fn
    from robot_aware_control_tpu_torch.experiments import transfer
    from robot_aware_control_tpu_torch.config import argparser

    out = {"i3d": i3d_card_vs_cpu(dev),
           "random_embedder": random_embed_card_vs_cpu(dev)}
    print(f"I3D (seed 42) card vs CPU, 2 videos of 8 frames at 48x64: "
          f"{out['i3d']['rel_err']:.3g} of the largest |logit| (tolerance "
          f"{I3D_TOL}); random embedder {out['random_embedder']['rel_err']:.3g}"
          f" (tolerance {EMBED_TOL})")
    if not (out["i3d"]["rel_err"] <= I3D_TOL and out["i3d"]["finite"]
            and out["random_embedder"]["rel_err"] <= EMBED_TOL):
        raise AssertionError(f"FVD embedders on the card differ: {out}")
    model = i3d.init(42, dev)
    x = torch.from_numpy(videos(16, 10, 48, 64)).to(dev)
    # some 400 launches a call fill the launch queue behind a sleeping
    # kernel, so CUDA events time 5 calls back to back after a warm-up,
    # the host's launch gaps included
    embed = lambda: i3d.embed(model, x)
    embed()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(5):
        embed()
    ev[1].record()
    torch.cuda.synchronize()
    out["i3d_embed_ms"] = ev[0].elapsed_time(ev[1]) / 5
    print(f"I3D embed of 16 videos of 10 frames at 48x64: "
          f"{out['i3d_embed_ms']:.3f} ms a call (CUDA events over 5 calls)")
    del model
    ra, _ = transfer.pair_cfgs(argparser(flags(dict(
        TRANSFER_CUTS, log_dir=transfer_out["log_dir"])))[0])
    ckpt_path = ckpt.latest_checkpoint(os.path.join(ra.log_dir, ra.jobname))
    train, _ = create_record_loaders(ra, os.path.join(ra.data_root, "records"))
    kernels.reset_launches()
    r = evaluate_fvd(ra.replace(jobname="fvd_eval"), ckpt_path, loader=train,
                     embed_fn=make_i3d_embed_fn(device=dev), device=dev)
    out["evaluate_fvd"] = dict(r, sm90_launches=kernels.launches[
        "conv_lstm_cell_sm90"])
    print(f"evaluate_fvd (robot-aware checkpoint, random-init I3D): {r}")
    if not (np.isfinite(r["fvd"]) and r.get("fvd_caveat")):
        raise AssertionError(f"evaluate_fvd: {r}")
    return out


def cyclegan_checks(dev, d: str) -> dict:
    """Phase 16 (e): the runner's default CycleGAN on the card against the
    CPU (TF32 off), one train_step, and a 2-step push episode with
    --cyclegan."""
    out = {"card_vs_cpu": cyclegan_card_vs_cpu(dev)}
    r = out["card_vs_cpu"]
    print(f"CycleGAN translator card vs CPU: {r['max_diff']:.3g} (tolerance "
          f"{CYCLEGAN_TOL}); one train_step on the card: {r['losses']}")
    if not (r["finite"] and r["max_diff"] <= CYCLEGAN_TOL):
        raise AssertionError(f"CycleGAN on the card: {r}")
    kernels.reset_launches()
    ep = cyclegan_episode(dev, d)
    ep["launches"] = dict(kernels.launches)
    out["episode"] = ep
    print(f"push episode with --cyclegan (GT dynamics): {ep}")
    if not (ep["finite"] and len(ep["actions"]) == 2 and ep["translated"] == 2):
        raise AssertionError(f"cyclegan episode: {ep}")
    return out


def check_experiments(dev) -> dict:
    """Phase 16 (see the module docstring). Returns its JSON line's dict."""
    from robot_aware_control_tpu_torch.data import demo_io

    out = {"h5py_installed": demo_io.has_h5py()}
    print(f"h5py installed: {out['h5py_installed']}; the experiments take "
          "the record route")
    here = os.path.dirname(os.path.abspath(__file__))
    hidden = sys.modules.get("h5py", False)
    sys.modules["h5py"] = None  # the route of a machine without it
    try:
        with tempfile.TemporaryDirectory(dir=here) as d:
            kernels.reset_launches()
            r = record_route(os.path.join(d, "route", "data_pick"), dev, n=8)
            r["launches"] = dict(kernels.launches)
            out["record_route"] = r
            print(f"record route: 8 LocobotPick episodes collected on the "
                  f"card in {r['collect_s']:.2f} s and written as "
                  f"{r['shards']} shard(s), {r['episodes_per_s']:.2f} "
                  f"episodes/s; split train {r['train']}, test {r['test']}; "
                  f"launches {r['launches']}")
            out["pick"] = pick_experiment(d, dev)
            out["transfer"] = transfer_experiment(d, dev)
            out["fvd"] = fvd_checks(dev, out["transfer"])
            out["cyclegan"] = cyclegan_checks(dev, d)
    finally:
        if hidden is False:
            del sys.modules["h5py"]
        else:
            sys.modules["h5py"] = hidden
    return out


def check_raw(dev, card: str):
    """Phase 17 (see the module docstring). Returns its JSON line's dict
    and the mask kernel's entry of the kernels line at the raw route's
    64x85 launches."""
    from robot_aware_control_tpu_torch.data import demo_io
    from robot_aware_control_tpu_torch.data import raw_robonet as rr
    from robot_aware_control_tpu_torch.data.collect import write_training_records
    from robot_aware_control_tpu_torch.data.records import (
        create_record_loaders,
        create_record_transfer_loader,
    )
    from robot_aware_control_tpu_torch.robot.kinematic_chain import (
        ChainMaskEnv,
        _LocobotMaskEnv,
        get_mask_env,
    )
    from robot_aware_control_tpu_torch.utils import profiling

    probe = mp4_probe()
    out = {"h5py_installed": demo_io.has_h5py(), "cv2": rr._HAS_CV2,
           "mp4_probe": probe, "card": card}
    print(f"raw route: h5py installed {out['h5py_installed']} (hidden for "
          f"this phase), cv2 {out['cv2']}; cv2 mp4 write and read back: "
          f"{probe}")
    here = os.path.dirname(os.path.abspath(__file__))
    hidden = sys.modules.get("h5py", False)
    sys.modules["h5py"] = None  # the route of a machine without it
    try:
        with tempfile.TemporaryDirectory(dir=here) as d:
            root = os.path.join(d, "data")
            t = time.perf_counter()
            trees = raw_trees(root, T=31, hw=STORED_HW, seed=0)
            if probe["mp4"]:  # one more train-view trajectory, as mp4
                trees += raw_trees(root, T=31, hw=STORED_HW, seed=1,
                                   encoding="mp4", prefix="mp4_traj",
                                   layout=(RAW_LAYOUT[0][:2] + (1,),))
            out["build_s"] = time.perf_counter() - t
            # decode: each stream's frames decoded and shrunk to 64x85
            # (INTER_AREA), as the reader does, by encoding
            decode = {}
            for _, _, tree in trees:
                md = rr.load_metadata_dict(tree)
                t = time.perf_counter()
                rr.load_camera_imgs(0, tree, md, NATIVE_HW)
                e = decode.setdefault(md["img_encoding"], [0.0, 0])
                e[0] += time.perf_counter() - t
                e[1] += md["img_T"]
            out["decode_ms_a_frame"] = {k: v[0] * 1e3 / v[1]
                                        for k, v in decode.items()}
            out["frames_decoded"] = {k: v[1] for k, v in decode.items()}
            # two epochs: the first takes the first steps' set-up and the
            # traced step, the second's frames/s is read; one eval epoch
            cfg = Config(**dict(RAW_TRAIN, niter=2, epoch_size=2,
                                eval_interval=2, checkpoint_interval=2,
                                data_threads=2, seed=0,
                                log_dir=os.path.join(d, "log"),
                                jobname="raw_sawyer_multiview"))
            rec_dir = os.path.join(d, "records")
            stamps = {"sawyer": [], "locobot": [], "load": [], "shard": []}
            patched = ((ChainMaskEnv, "generate_masks", "sawyer"),
                       (_LocobotMaskEnv, "generate_masks", "locobot"),
                       (robonet_hdf5.RoboNetHDF5Dataset, "_load_file", "load"),
                       (np, "savez_compressed", "shard"))
            origs = [_stamped(owner, name, stamps[key])
                     for owner, name, key in patched]
            trace_paths = []
            kernels.reset_launches()
            try:
                with MaskLaunches() as rec:
                    # the main path: raw trees -> reader (masks on the card)
                    # -> record shards; the converter at locobot_c0; the
                    # trainer on the shards
                    t = time.perf_counter()
                    shards = write_training_records(
                        [(p, tree) for p, _, tree in trees], rec_dir, cfg,
                        viewpoint=[v for _, v, _ in trees], device=dev)
                    route_s = time.perf_counter() - t
                    env = get_mask_env("locobot", image_size=NATIVE_HW,
                                       camera_key="locobot_c0", device=dev)
                    converted = [rr.converted_tree(
                        tree, rr.load_metadata_dict(tree), env,
                        rr.LoaderParams(img_size=NATIVE_HW), 0, "locobot",
                        os.path.basename(p))
                        for p, v, tree in trees if v == "locobot_c0"]
                    route_launches = dict(kernels.launches)
                    tr = PredictionTrainer(cfg, device=dev, record_dir=rec_dir)
                    step, calls = tr.train_step, []

                    def traced(*a, **k):
                        calls.append(1)
                        if len(calls) != 2:
                            return step(*a, **k)
                        with profiling.trace(d) as path:
                            trace_paths.append(path)
                            return step(*a, **k)

                    tr.train_step = traced
                    t = time.perf_counter()
                    tr.train()
                    train_s = time.perf_counter() - t
                    launches = dict(kernels.launches)
            finally:
                for (owner, name, _), orig in zip(patched, origs):
                    setattr(owner, name, orig)
            # the route's seconds: decode and masks (the reader's _load_file),
            # the shard's npz write, and the rest (resize, normalization)
            spent = {k: sum(b - a for a, b in stamps.pop(k))
                     for k in ("load", "shard")}
            checked = rec.check()
            with open(trace_paths[0]) as f:
                events = json.load(f)["traceEvents"]
            out["trace"] = dict(exists=True, events=len(events), kernel_events=sum(
                e.get("cat") == "kernel" for e in events))
            train, test = create_record_loaders(cfg, rec_dir)
            transfer = create_record_transfer_loader(cfg, rec_dir)
            name = lambda ld: [os.path.relpath(p, root)
                               for p in ld.dataset.file_paths]
            out.update(
                trajectories=len(trees), shards=len(shards),
                route_s=route_s, episodes_per_s=len(trees) / route_s,
                route_load_s=spent["load"], route_shard_write_s=spent["shard"],
                route_launches=route_launches, launches=launches,
                train_s=train_s, train_frames_per_s=_train_fps(tr.log_dir),
                split=dict(train=name(train), test=name(test),
                           transfer=name(transfer)),
                mask_ms_a_trajectory={k: float(np.median(
                    [(b - a) * 1e3 for a, b in v])) for k, v in stamps.items()},
                mask_launches_checked=[dict(zip("MShwd", c)) for c in checked],
                converted=len(converted))
            if not (launches["capsule_mask_render"] == len(checked) > 0
                    and launches["conv_lstm_cell_sm90"] > 0
                    and all(c["mask"][()].any() for c in converted)):
                raise AssertionError(f"raw route launches {launches}, "
                                     f"{len(checked)} mask launches checked")
            with open(os.path.join(tr.log_dir, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            if not all(np.isfinite(v) for r in recs for v in r.values()
                       if isinstance(v, float)):
                raise AssertionError(f"non-finite raw trainer metrics {recs}")
            out["transfer_metrics"] = sorted(
                k for r in recs for k in r if k.startswith("transfer/"))
            if not out["transfer_metrics"]:
                raise AssertionError("raw trainer ran no transfer eval")
            # the chain masks (and everything else) against the CPU
            out["card_vs_cpu"] = raw_card_vs_cpu(dev, trees, cfg)
            # the mask kernel at the route's own 64x85 launch (M = 31)
            segs, h, w = next(r for r in rec.segs)
            ms = cuda_ms(lambda: kernels.capsule_mask_render(segs, h, w), n=200)
            plain = cuda_ms(lambda: kernels.capsule_mask_render_plain(segs, h, w))
            _, ops, _, bound, by = mask_bound(segs, h, w)
            entry = dict(
                name="capsule_mask_render_raw", route="cuda", source=MASK_SRC,
                replaces="robot_aware_control_tpu/ops/pallas_kernels.py:57",
                launches=launches["capsule_mask_render"], max_abs_err=0.0,
                ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, path="raw route, locobot masks at 64x85",
                M=int(segs.shape[0]), S=int(segs.shape[1]), h=h, w=w,
                gops=ops / 1e9)
            out["mask_kernel"] = entry
    finally:
        if hidden is False:
            del sys.modules["h5py"]
        else:
            sys.modules["h5py"] = hidden
    dec = ", ".join(f"{k} {v:.3f} ms a frame ({out['frames_decoded'][k]} "
                    f"frames)" for k, v in out["decode_ms_a_frame"].items())
    masks = ", ".join(f"{k} {v:.3f} ms" for k, v in
                      out["mask_ms_a_trajectory"].items())
    print(f"[{card}] raw decode of {STORED_HW[0]}x{STORED_HW[1]} frames to "
          f"64x85: {dec}")
    print(f"[{card}] raw masks a 31-frame trajectory (host ms, median): "
          f"{masks}; mask kernel launches {out['launches']['capsule_mask_render']} "
          f"(each bit for bit to plain), sm90 cell launches "
          f"{out['launches']['conv_lstm_cell_sm90']}")
    print(f"[{card}] raw route: {out['trajectories']} trajectories to "
          f"{out['shards']} shard(s) in {out['route_s']:.3f} s, "
          f"{out['episodes_per_s']:.2f} episodes/s (decode and masks "
          f"{out['route_load_s']:.3f} s, the shard's write "
          f"{out['route_shard_write_s']:.3f} s, the rest preprocessing); "
          f"split {out['split']}")
    print(f"[{card}] raw-fed train_sawyer_multiview: "
          f"{out['train_frames_per_s']:.1f} frames/s (its second epoch), "
          f"{out['train_s']:.1f} s for 2 epochs and an eval epoch; trace of "
          f"a step of the first: "
          f"{out['trace']['kernel_events']} kernel events")
    print(f"[{card}] mask kernel at the raw route's M={entry['M']} "
          f"S={entry['S']} {h}x{w}: {ms:.5f} ms, plain {plain:.4f} ms, bound "
          f"{bound:.5f} ms ({by}); chain masks card vs CPU "
          f"{out['card_vs_cpu']}")
    return out, entry


# ------------------------------------------------------------------ int8
# NVIDIA H100 SXM data sheet, dense int8 tensor-core operations
PEAK_INT8 = 1979e12
# the gate convolutions of the canonical planner's two cells: B = 100,
# 6x8, cat(x, h) of 256 + 256 channels into 4 x 256 gates, k = 5 and 3
GATE_CONVS = [(100, 6, 8, 512, 1024, 5), (100, 6, 8, 512, 1024, 3)]


def int8_gate_conv(dev, B, H, W, Cin, O, k):
    """The int8 product at one gate conv's shapes: the card's im2col +
    torch._int_mm against the CPU's plain float64 version on the same int8
    inputs (bit for bit, asserted; 20 rows of the launch: the CPU's float64
    convolution of all 100 takes tens of seconds), the whole Int8Conv2d
    (scale, quantize, product, dequantize, bias) against the CPU's on the
    same float input of 20 rows (its largest difference), their times per launch by CUDA events beside
    cuDNN's bf16 gate conv of the same shapes, and the int8 product's
    bound."""
    g = torch.Generator().manual_seed(k)
    x_q = torch.randint(-127, 128, (B, H, W, Cin), generator=g,
                        dtype=torch.int8)
    # the CPU's float64 convolutions check 20 of the B rows (each row's
    # sums are exact integers whatever the batch: the rows stand for all)
    rows = 20
    w_q = torch.randint(-127, 128, (O, Cin, k, k), generator=g,
                        dtype=torch.int8)
    pads = quant._pads(x_q.shape, (k, k), 1, "same")
    w_mat = quant.gemm_weight(w_q.to(dev))
    xd = x_q.to(dev)
    got = quant.conv_int8_mm(xd, w_mat, O, (k, k), 1, pads)[:rows].cpu()
    want = quant.conv_int8_plain(x_q[:rows], w_q, 1, pads)
    if not torch.equal(got, want):
        raise AssertionError(f"int8 conv k={k}: the card's int32 sums differ "
                             f"from the CPU's at {(got != want).sum()} places")
    conv = quant.Int8Conv2d(torch.randn(O, Cin, k, k, generator=g) * 0.02,
                            torch.randn(O, generator=g))
    xf = torch.randn(rows, H, W, Cin, generator=g)
    y_cpu = conv(xf)
    conv_dev = conv.to(dev)
    conv_diff = float((conv_dev(xf.to(dev)).cpu() - y_cpu).abs().max())
    xf = torch.randn(B, H, W, Cin, generator=g)
    xb = xf.to(dev, torch.bfloat16)
    mm_ms = cuda_ms(lambda: quant.conv_int8_mm(xd, w_mat, O, (k, k), 1, pads))
    # the GEMM alone, on an im2col made once
    a = F.pad(xd, (0, 0, *pads[1], *pads[0]))
    sB, sH, sW, sC = a.stride()
    a = a.as_strided((B, H, W, k, k, Cin), (sB, sH, sW, sH, sW, sC)).reshape(
        B * H * W, -1)
    a = F.pad(a, (0, w_mat.shape[1] - a.shape[1]))
    gemm_ms = cuda_ms(lambda: torch._int_mm(a, w_mat.t()))
    conv_ms = cuda_ms(lambda: conv_dev(xb))
    w_hwio = (torch.randn(k, k, Cin, O, generator=g) * 0.02).to(dev,
                                                                 torch.bfloat16)
    cudnn_ms = gate_conv_ms(xb[..., :Cin // 2].contiguous(),
                            xb[..., Cin // 2:].contiguous(), w_hwio,
                            torch.zeros(O, device=dev))
    ops = 2.0 * B * valid_taps(H, W, k) * Cin * O
    nbytes = x_q.numel() + w_q.numel() + 4 * B * H * W * O
    bound, by = bound_ms(ops, PEAK_INT8, nbytes)
    return {"k": k, "M": B * H * W, "K": k * k * Cin, "N": O,
            "int32_equal_cpu": True, "rows_checked_on_cpu": rows,
            "int8_conv_max_diff_cpu": conv_diff,
            "im2col_int_mm_ms": mm_ms, "int_mm_ms": gemm_ms,
            "int8_conv_ms": conv_ms, "cudnn_bf16_gate_conv_ms": cudnn_ms,
            "bound_ms": bound, "bound_by": by}


def check_int8(dev, bf16_latency, bf16_prof):
    """Phase 18 (see the module docstring); `bf16_prof` is phase 7's
    profile of the bf16 plan (the same config and weights)."""
    cfg = Config(**CANONICAL)
    model = svg.init(cfg, seed=0, device="cuda")
    bf16 = CEMPolicy(cfg, model)
    q8cfg = cfg.replace(plan_quantize="int8")
    int8 = CEMPolicy(q8cfg, model)
    start, goal = start_goal(np.random.RandomState(0))
    want = dict(plan_launches(cfg), conv_lstm_cell=0, conv_lstm_cell_sm90=0,
                conv_lstm_cell_f32=0)
    plan_at = lambda p, i: p.get_action(start, goal, ep_num=1, step=i)
    seconds, mm = [], []
    kernels.reset_launches()
    quant.launches["int8_mm"] = 0
    for i in range(4):
        before = dict(kernels.launches)
        mm0 = quant.launches["int8_mm"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = plan_at(int8, i)
        torch.cuda.synchronize()
        if i:
            seconds.append(time.perf_counter() - t0)
        got = {k: kernels.launches[k] - before[k] for k in want}
        mm.append(quant.launches["int8_mm"] - mm0)
        if got != want or not mm[-1]:
            raise AssertionError(f"int8 plan {i} launched {got} and "
                                 f"{mm[-1]} int8 GEMMs, expected {want}")
        if plan.shape != (cfg.horizon - 1, 2) or not np.all(np.isfinite(plan)):
            raise AssertionError(f"bad int8 plan {plan!r}")
    launches = dict(kernels.launches)
    latency = statistics.median(seconds)
    # the first switch of the sync debug mode in a process warns once at
    # the switch itself: switched once before, unread
    count_syncs(lambda: None)
    plans = {}
    syncs = {name: count_syncs(lambda: plans.setdefault(name, plan_at(p, 10)))
             for name, p in (("bf16", bf16), ("int8", int8))}
    n_syncs = {k: sum(v.values()) for k, v in syncs.items()}
    if n_syncs["int8"] > n_syncs["bf16"]:
        raise AssertionError(f"the int8 plan syncs more: {syncs}")
    drift = float(np.abs(plans["int8"] - plans["bf16"]).max())
    prof = {"int8": profile_plan(lambda: plan_at(int8, 11), "int8 plan"),
            "bf16": bf16_prof}
    convs = [int8_gate_conv(dev, *shape) for shape in GATE_CONVS]
    out = dict(latency_s=latency, latency_runs=seconds,
               bf16_latency_s=bf16_latency, launches=launches,
               launches_per_plan=want, int8_gemms_per_plan=mm[1],
               host_syncs_per_plan=n_syncs, host_sync_sites=syncs,
               drift_from_bf16_plan=drift, gate_convs=convs)
    for name, pr in prof.items():
        if pr:
            out[f"{name}_busy_ms"], out[f"{name}_wall_ms"] = pr[:2]
            out[f"{name}_busy_share"] = pr[0] / pr[1]
    print(f"int8 plan latency {latency:.4f} s (median of 3: "
          + ", ".join(f"{v:.4f}" for v in seconds) + f"), bf16 "
          f"{bf16_latency:.4f} s (phase 6); launches per plan {want} and "
          f"{mm[1]} int8 GEMMs; host syncs a plan int8 {n_syncs['int8']}, "
          f"bf16 {n_syncs['bf16']}; int8 plan - bf16 plan: max |diff| "
          f"{drift:.4g}")
    for c in convs:
        print(f"int8 gate conv k={c['k']} (M {c['M']}, K {c['K']}, N "
              f"{c['N']}): int32 sums equal the CPU's (Int8Conv2d outputs "
              f"differ by {c['int8_conv_max_diff_cpu']:.3g}); im2col + "
              f"_int_mm {c['im2col_int_mm_ms']:.4f} ms (the GEMM alone "
              f"{c['int_mm_ms']:.4f}), whole Int8Conv2d "
              f"{c['int8_conv_ms']:.4f} ms, cuDNN bf16 gate conv "
              f"{c['cudnn_bf16_gate_conv_ms']:.4f} ms, int8 bound "
              f"{c['bound_ms']:.4f} ms ({c['bound_by']})")
    return out


# ------------------------------------------------------------------ mesh
def check_mesh(dev):
    """Phase 19 (see the module docstring)."""
    import torch.distributed as dist

    from robot_aware_control_tpu_torch import convert
    from robot_aware_control_tpu_torch.parallel import mesh as pmesh

    d = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    store = dist.FileStore(os.path.join(d, "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        cfg = Config(**mesh_cases.TINY)
        params, bn = convert.jax_flat_trees(
            svg.init(cfg, seed=0, device="cpu", train=True))
        plain = mesh_cases.train_steps(cfg, params, bn, device="cuda")
        layouts, fsdp = {}, None
        for kind in ("replicated", "data", "model"):
            c = mesh_cases.layout_config(kind)
            layout = pmesh.Layout(c)
            metrics, model, opt = mesh_cases.trained(c, params, bn, layout,
                                                     device="cuda")
            got = (metrics, convert.jax_flat_trees(model)[0])
            errs = mesh_cases.step_errors(got, plain, c.lr)
            if errs["step1"] > 1 or errs["step2"] > 1 or errs["params_lr"] > 5:
                raise AssertionError(f"{kind} layout step differs from the "
                                     f"plain step: {errs}")
            layouts[kind] = errs
            if kind == "data":
                fsdp = (model, opt, got[1])
        # a DCP checkpoint of the FSDP2 model and Adam restored into a plain
        # model and optimizer on the card
        path = ckpt.save_checkpoint_sharded(d, 2, fsdp[0], fsdp[1])
        model = mesh_cases.train_model(params, bn, cfg, "cuda")
        _, opt = make_train_step(cfg, model)
        step = ckpt.load_checkpoint_sharded(path, model, opt)
        restored = convert.jax_flat_trees(model)[0]
        if step != 2 or any(not np.array_equal(restored[k], v)
                            for k, v in fsdp[2].items()):
            raise AssertionError("the DCP checkpoint did not restore the "
                                 "FSDP2 model's parameters")
        n_opt = sum(len(v) for v in opt.state.values())
        # a mesh plan against the unsharded plan, bf16 and int8
        mesh = pmesh.get_mesh(axis="data")
        plans = {}
        start, goal = start_goal(np.random.RandomState(0))
        pcfg = Config(**CANONICAL)
        pmodel = svg.init(pcfg, seed=0, device="cuda")
        for q in ("none", "int8"):
            qcfg = pcfg.replace(plan_quantize=q)
            plain_p = CEMPolicy(qcfg, pmodel).get_action(start, goal, ep_num=3)
            meshed = CEMPolicy(qcfg, pmodel, mesh=mesh)
            kernels.reset_launches()
            got = meshed.get_action(start, goal, ep_num=3)
            launched = dict(kernels.launches)
            if not np.array_equal(got, plain_p):
                raise AssertionError(f"mesh plan ({q}) differs from the "
                                     "unsharded plan by "
                                     f"{np.abs(got - plain_p).max()}")
            plans[q] = {"equal": True, "launches": launched}
        want = plan_launches(pcfg)
        if plans["none"]["launches"] != want:
            raise AssertionError(f"mesh plan launched {plans['none']}, "
                                 f"expected {want}")
    finally:
        dist.destroy_process_group()
    out = dict(backend="nccl", world=1, layouts=layouts,
               dcp={"path": os.path.basename(path), "step": step,
                    "optimizer_state_entries": n_opt, "params_equal": True},
               plans=plans)
    print("NCCL world of 1: DDP, FSDP2 and the model-axis layout, two steps "
          "each against the plain step (errors at their limits' scale: "
          + ", ".join(f"{k} {v['step1']:.3g}/{v['step2']:.3g}/"
                      f"{v['params_lr']:.3g}" for k, v in layouts.items())
          + f"); DCP save of the FSDP2 model restored bit for bit into a "
          f"plain one (step {step}); mesh plans == unsharded plans, bf16 "
          f"(launches {plans['none']['launches']}) and int8 (launches "
          f"{plans['int8']['launches']})")
    return out


# ---------------------------------------------------------------- widths
def check_widths(dev, policy, start, goal):
    """Phase 20: models whose g_dim is not a multiple of 8 (their bf16 cells
    took the retired WMMA kernel before). (a) A small float32 plan at g_dim 12
    on the card equals the CPU's (PLAN_TOL; its cells on the float32
    kernel at 12-channel strides). (b) The same plan in bf16 on the card:
    every cell through sm90, each first cell of a stack with its x staged
    (a contiguous 12-channel *_in output), every recorded cell held to its
    plain version; its difference from the CPU's bf16 plan printed, not
    held (cuDNN's and the CPU's bf16 convolutions round apart, and the
    top-k may then pick other candidates). (c) The canonical planner at
    g_dim 252: launches, staging copies and latency of its plans, then one
    profiled plan beside one of phase 6's g_dim 256 planner (`policy`),
    device time and the cell kernel's part of each."""
    out = {}
    err, launched = small_plan_parity("g_dim 12", dev, fields=dict(g_dim=12))
    print(f"small f32 plan at g_dim 12, GPU vs CPU: max |diff| = {err:.3g} "
          f"(tolerance {PLAN_TOL}); launches {launched}")
    out["f32_g12"] = dict(max_abs_diff=err, launches=launched)

    cfg = Config(**dict(SMALL, g_dim=12, compute_dtype="bfloat16"))
    noise = np.random.RandomState(2).randn(
        cfg.opt_iter, cfg.action_candidates, cfg.horizon - 1, 2)
    small_start, small_goal = start_goal(np.random.RandomState(1))
    plans, calls, wrapper = {}, [], kernels.conv_lstm_cell
    for d in ("cpu", "cuda"):
        model = svg.init(cfg, seed=3, device=d)
        if d == "cuda":
            kernels.conv_lstm_cell = lambda *a: calls.append(
                [t.clone() for t in a]) or wrapper(*a)
            kernels.reset_launches()
            staged = kernels.staged["inputs"]
        try:
            plans[d] = CEMPolicy(cfg, model, device=d).get_action(
                small_start, small_goal, noise=noise)
        finally:
            kernels.conv_lstm_cell = wrapper
    launched, staged = dict(kernels.launches), kernels.staged["inputs"] - staged
    if launched != plan_launches(cfg) or staged != len(calls) // 2:
        raise AssertionError(f"bf16 g_dim 12 plan launched {launched}, staged "
                             f"{staged} inputs for {len(calls)} cells")
    errs = [cell_err(one_launch(lambda: wrapper(*a), "sm90")[0],
                     kernels.conv_lstm_cell_plain(*a), CELL_TOL[torch.bfloat16])
            for a in calls]
    diff = float(np.abs(plans["cuda"] - plans["cpu"]).max())
    print(f"small bf16 plan at g_dim 12 on the card: launches {launched}, "
          f"{staged} inputs staged (x of each stack's first cell), every "
          f"recorded cell vs plain max |diff| {max(errs):.3g} (tolerance "
          f"{CELL_TOL[torch.bfloat16]}); GPU vs CPU bf16 plan max |diff| "
          f"{diff:.3g} (not held)")
    out["bf16_g12"] = dict(launches=launched, staged=staged,
                           cell_max_abs_err=max(errs), cpu_plan_diff=diff)

    launches, policy252, _, _, latency = canonical_plans(g_dim=252)
    before = kernels.staged["inputs"]
    policy252.get_action(start, goal, ep_num=3, step=0)
    staged = kernels.staged["inputs"] - before
    profiles = {}
    for g_dim, pol in ((256, policy), (252, policy252)):
        prof = profile_plan(lambda: pol.get_action(start, goal, ep_num=2, step=0),
                            f"g_dim {g_dim} plan")
        if prof:
            busy, wall, rows = prof
            cell = [r for r in rows if "cell_kernel" in r[2]]
            profiles[g_dim] = dict(
                busy_ms=busy, wall_ms=wall,
                cell_ms=sum(r[0] for r in cell), cell_count=sum(r[1] for r in cell))
    ratio = (profiles[252]["busy_ms"] / profiles[256]["busy_ms"]
             if len(profiles) == 2 else None)
    print(f"canonical plan at g_dim 252: launches {launches} over 4 plans "
          f"(a warm-up, 3 timed), {staged} inputs staged a plan, "
          f"latency {latency:.4f} s; device busy "
          + (f"{profiles[252]['busy_ms']:.1f} ms against g_dim 256's "
             f"{profiles[256]['busy_ms']:.1f} ms ({ratio:.3f}x; cells "
             f"{profiles[252]['cell_ms']:.1f} ms / {profiles[252]['cell_count']} "
             f"launches against {profiles[256]['cell_ms']:.1f} ms / "
             f"{profiles[256]['cell_count']})" if ratio else "not measured"))
    out["plan_g252"] = dict(launches=launches, staged_per_plan=staged,
                            latency_s=latency, profiles=profiles,
                            busy_ratio_252_to_256=ratio)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = phase("card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(f"{card}; python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    t = phase("build")
    kernels.build()
    print(f"built {sorted(kernels.SOURCES)} in {time.perf_counter() - t:.1f} s "
          "(one nvcc each, in parallel; seconds until each was done: "
          + ", ".join(f"{n} {v['seconds']:.1f}"
                      for n, v in kernels.build_log.items()) + ")")

    # plain versions in full float32: cuDNN would otherwise use TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("masks")
    mask_err = check_masks(dev)
    phase("cell")
    cell_errs = check_cells(dev)
    phase("parity")
    kernels.reset_launches()
    check_small_plan_parity()
    # every cell of the small float32 plans goes to the float32 kernel
    f32_parity = kernels.launches["conv_lstm_cell_f32"]
    if not f32_parity or f32_parity != kernels.launches["conv_lstm_cell"]:
        raise AssertionError(f"small float32 plans launched {kernels.launches}")

    phase("plan")
    launches, policy, start, goal, latency = canonical_plans()
    f32_launches, f32_policy, _, _, f32_latency = canonical_plans(
        compute_dtype="float32")
    phase("profile")
    bf16_prof = profile_plan(
        lambda: policy.get_action(start, goal, ep_num=2, step=0))
    f32_plan = f32_plan_summary(f32_latency, f32_launches, profile_plan(
        lambda: f32_policy.get_action(start, goal, ep_num=2, step=0),
        "float32 plan"))
    del f32_policy
    phase("kernels")
    line = {"kernels": [
        time_mask(dev, launches["capsule_mask_render"], mask_err),
        time_cell(dev, launches["conv_lstm_cell_sm90"], cell_errs),
    ]}
    f32_entry = time_f32_cell(dev, f32_launches["conv_lstm_cell_f32"], f32_parity)
    f32_entry["plan"] = f32_plan
    phase("serve")
    serve = check_serve(latency)
    for entry, name in zip(line["kernels"],
                           ("capsule_mask_render", "conv_lstm_cell_sm90")):
        entry["launches_serve"] = serve["launches"][name]
    print(json.dumps({"serve": dict(serve, card=card)}))

    # training: the train step runs no hand kernel; the trainer's eval
    # epoch runs the cell kernel
    phase("train")
    parity = check_train_parity()
    eval_kernel = check_eval_kernel()
    modes, flops = train_step_timing(dev)
    trainer = check_trainer()
    line["kernels"][1]["launches_trainer_eval"] = trainer["cell_launches"]

    # the model variants: heatmaps, the blur cost, GroupNorm cells, det
    phase("variants")
    variants, det_entries = check_variants(dev)
    line["kernels"] += [*det_entries, f32_entry]
    for entry, name in zip(line["kernels"][:2],
                           ("capsule_mask_render", "conv_lstm_cell_sm90")):
        entry["launches_variants"] = {
            v: r["launches"][name] for v, r in variants["plans"].items()}
    print(json.dumps({"variants": dict(variants, card=card)}))

    # the data path: host resize, record shards, prefetch, the trainer on them
    phase("data")
    data, data_cells = check_data(dev)
    line["kernels"][1]["launches_data_trainer"] = data_cells
    print(json.dumps({"data": dict(data, card=card)}))

    # the chain robots, the robot trainer and the finetune trainers
    phase("robots")
    robots = check_robots(dev, data["trainer"]["frames_per_s"])
    mask_entry, cell_entry = line["kernels"][:2]
    mask_entry["launches_robot_trainer"] = robots["robot_trainer"]["launches"][
        "capsule_mask_render"]
    for mode, r in robots["finetune"].items():
        mask_entry[f"launches_finetune_{mode}"] = r["launches"]["capsule_mask_render"]
        cell_entry[f"launches_finetune_{mode}"] = r["launches"]["conv_lstm_cell_sm90"]
    for exp, r in robots["plans"].items():
        cell_entry[f"launches_{exp}"] = r["launches"]["conv_lstm_cell_sm90"]
        mask_entry[f"launches_{exp}"] = r["launches"]["capsule_mask_render"]
    print(json.dumps({"robots": dict(robots, card=card)}))

    # the other model families, the inverse model and the debug_cem plots
    phase("families")
    families = check_families(dev)
    for name, r in families["plans"].items():
        cell_entry[f"launches_{name}"] = r["launches"]["conv_lstm_cell_sm90"]
        mask_entry[f"launches_{name}"] = r["launches"]["capsule_mask_render"]
    cell_entry["cdna_state"] = families["cdna_cells"]
    print(json.dumps({"families": dict(families, card=card)}))

    # the simulated envs, ground-truth CEM, the episode runner, the bridge
    t = phase("sim")
    sim = check_sim(dev)
    sim["seconds"] = time.perf_counter() - t
    sim["script_seconds"] = time.perf_counter() - t_start
    mask_entry["launches_sim_gt_plan"] = sim["gt_plan"]["launches"][
        "capsule_mask_render"]
    mask_entry["launches_sim_env_step"] = sim["env_step"]["mask_launches"]
    for kind in ("gt_episode", "learned_episode"):
        mask_entry[f"launches_sim_{kind}"] = sim[kind]["launches"][
            "capsule_mask_render"]
    mask_entry["sim_launches"] = sim["mask_times"]
    cell_entry["launches_sim_learned_episode"] = sim["learned_episode"][
        "launches"]["conv_lstm_cell_sm90"]
    print(f"phase sim took {sim['seconds']:.1f} s; the script "
          f"{sim['script_seconds']:.1f} s so far")
    print(json.dumps({"sim": dict(sim, card=card)}))

    # the paper's experiments on the record route, FVD, the CycleGAN
    t = phase("experiments")
    exp = check_experiments(dev)
    exp["seconds"] = time.perf_counter() - t
    exp["script_seconds"] = time.perf_counter() - t_start
    for name, key in (("capsule_mask_render", "pick"),
                      ("conv_lstm_cell_sm90", "pick"),
                      ("capsule_mask_render", "transfer"),
                      ("conv_lstm_cell_sm90", "transfer")):
        entry = mask_entry if name == "capsule_mask_render" else cell_entry
        entry[f"launches_{key}_experiment"] = exp[key]["launches"][name]
    mask_entry["launches_record_route"] = exp["record_route"]["launches"][
        "capsule_mask_render"]
    mask_entry["launches_cyclegan_episode"] = exp["cyclegan"]["episode"][
        "launches"]["capsule_mask_render"]
    cell_entry["launches_evaluate_fvd"] = exp["fvd"]["evaluate_fvd"][
        "sm90_launches"]
    for key in ("pick", "transfer"):
        checks = exp[key]["kernels_vs_plain"]
        cell_entry[f"{key}_experiment_inputs"] = checks["cells"]
        mask_entry[f"{key}_experiment_inputs"] = checks["masks"]
    print(f"phase experiments took {exp['seconds']:.1f} s; the script "
          f"{exp['script_seconds']:.1f} s so far")
    print(json.dumps({"experiments": dict(exp, card=card)}))

    # the public RoboNet raw layout: decode, masks on the card, shards, the
    # sawyer multiview trainer
    t = phase("raw")
    raw, raw_entry = check_raw(dev, card)
    raw["seconds"] = time.perf_counter() - t
    raw["script_seconds"] = time.perf_counter() - t_start
    line["kernels"].append(raw_entry)
    cell_entry["launches_raw_trainer"] = raw["launches"]["conv_lstm_cell_sm90"]
    print(f"phase raw took {raw['seconds']:.1f} s; the script "
          f"{raw['script_seconds']:.1f} s so far")
    print(json.dumps({"raw": raw}))

    # int8 planning: the canonical planner with --plan_quantize int8
    t = phase("int8")
    int8 = check_int8(dev, latency, bf16_prof)
    int8["seconds"] = time.perf_counter() - t
    mask_entry["launches_int8_plan"] = int8["launches_per_plan"][
        "capsule_mask_render"]
    cell_entry["launches_int8_plan"] = int8["launches_per_plan"][
        "conv_lstm_cell_sm90"]
    print(json.dumps({"int8": dict(int8, card=card)}))

    # the parallel layouts on an NCCL world of one card
    t = phase("mesh")
    mesh = check_mesh(dev)
    mesh["seconds"] = time.perf_counter() - t
    mesh["script_seconds"] = time.perf_counter() - t_start
    mask_entry["launches_mesh_plan"] = mesh["plans"]["none"]["launches"][
        "capsule_mask_render"]
    cell_entry["launches_mesh_plan"] = mesh["plans"]["none"]["launches"][
        "conv_lstm_cell_sm90"]
    print(f"phases int8 and mesh took {int8['seconds']:.1f} s and "
          f"{mesh['seconds']:.1f} s; the script {mesh['script_seconds']:.1f} s")
    print(json.dumps({"mesh": dict(mesh, card=card)}))

    # g_dims that are not multiples of 8: staged onto the wgmma/TMA kernel
    t = phase("widths")
    widths = check_widths(dev, policy, start, goal)
    widths["seconds"] = time.perf_counter() - t
    widths["script_seconds"] = time.perf_counter() - t_start
    cell_entry["launches_g_dim_252_plan"] = widths["plan_g252"]["launches"][
        "conv_lstm_cell_sm90"]
    cell_entry["launches_g_dim_12_small_plan"] = widths["bf16_g12"]["launches"][
        "conv_lstm_cell_sm90"]
    print(f"phase widths took {widths['seconds']:.1f} s; the script "
          f"{widths['script_seconds']:.1f} s")
    print(json.dumps({"widths": dict(widths, card=card)}))
    print(card)
    print(json.dumps({"train": {"card": card, "parity": parity,
                                "eval_kernel_vs_plain": eval_kernel,
                                "remat": modes, "flops": flops,
                                "trainer": trainer}}))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
