#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (``cusrl_tpu_torch``) runs its main paths
on one NVIDIA GPU (built for an H100, ``sm_90a``).

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases, each printing its own lines; any failure raises and exits non-zero
without printing a result:

1. the card, its power limit and PyTorch's name for it;
2. build the hand-written kernels (``cusrl_tpu_torch/csrc/*.cu``, one ``nvcc``
   per source, all at once) and print the build seconds and ptxas usage;
3. ``[kernels]``: hold each kernel (K1f, K1b, K2f, K2b; K8f with and without
   saved activations, K8b with and without the latent's cotangent, K9s and
   K9m (its forward's activations, then its loss and backward on them, and
   against K2f + K9s, whose bits it must give) with and without the
   value-loss clip; K3f primal and
   saving probabilities, K3b and K6 at the transformer's shapes and a ragged
   one with ALiBi and rows that see no key; K7f at path TL's shapes, a ragged
   T = 200 with ALiBi, rows that see no key and a part-valid cache, and a
   window wider than its query block; the fused block's pre and post ops, forward and
   backward, single (K4) and paired (K5), at the minibatch's 6,144 rows,
   the primal pre and post at 24,576 and a ragged 1,000 (pre with dX, post
   with ELU), K4 also at path TL's 65,536 and 262,144 rows; K1f/K1b with
   gelu at the FFN's widths, and on the ELU head at TL's 65,536 rows (K1f
   primal also at 262,144 and at the rollout step's 1,024); K1f/K1b on the
   recurrent entry's ELU head (256 -> 128 on the GRU's fp32 output) at path
   R's 1,024-row rollout step, 6,144-row minibatch (saving; the backward with
   dX), 24,576-row KL pass and a ragged 1,000); K1f/K1b with relu on the amp
   entry's 48-512-256 backbones at path AMP's 1,024-row rollout step,
   4,096-row minibatch (saving; the backward with ``skip_input_grad``),
   16,384-row value and KL passes and a ragged 1,000); K1f at path F's
   48-128-128-128 (the zoo's Velocity-Flat ``ppo``) at its 4,096-row rollout
   step, 98,304-row value and KL passes and the Player's 64 rows, and K2f/K2b
   on F's pair at 2 x 24,576 (saving; the backward with ``skip_input_grad``)
   and a ragged 2 x 1,000; ``[kernels] H``: K1f/K1b with tanh on path H's
   4-64-64 backbones (fp32 observations 4 wide, which the launch pads to 16
   columns) at the update's 256 rows (saving, the backward with
   ``skip_input_grad`` and with dX; and primal), the Player's 8 rows, a
   ragged 1,000 and the input widths 2, 3, 6 and 24, with the pad's device
   time apart from the kernels'); ``[kernels]`` of the auxiliary paths
   (``check_aux_kernels``): K1f/K1b on path D's student (relu 48-256-128)
   primal at 4,096 rows and saving at the minibatch's 12,288, K2f/K2b on
   path S's augmented pair at 2 x 49,152, K1f/K1b on path SL's mirrored
   actor pass at 24,576, and K1f/K1b on path X's RND networks (ELU
   48-256-128-64) primal at 98,304 and 24,576 and saving at 24,576, each
   backward with ``skip_input_grad``); ``[kernels]`` of the control paths
   (``check_control_kernels``): K1f/K1b on path SC's state estimator (ELU
   48-256-128-16) saving at 32,768 and 24,576 rows, K2f/K2b on SC's pair at
   2 x 32,768 and PO's at 2 x 49,152, each backward with
   ``skip_input_grad``; ``check_lane_routes``: K3f and K3b at path TJC's
   N = 512, both networks in one call, and on path TQ's RMS-normed q and k,
   K3f primal also at 1,024; ``[kernels] IL``: K1f/K1b on the Anymal-C
   entry's ELU 235-512-256-128 backbones (fp32 observations 235 wide, padded
   per launch to 240 columns) at the rollout step's 4,096 rows, the value
   and KL passes' 98,304, the minibatch's 24,576 (saving; the backward with
   ``skip_input_grad``) and a ragged 1,000, with the pad's device time
   apart) against its plain PyTorch
   version on the card, and time the kernel, the plain version and a PyTorch
   yardstick the port never calls (bf16 ``F.linear`` chains, fp32 heads
   and, for K9s, the loss, for K9m the forward too; a masked
   ``scaled_dot_product_attention`` for the attention kernels; bf16
   ``F.linear`` + ``F.layer_norm`` chains for the fused block; autograd for
   the backwards) with CUDA events; for every backward (K1b, K2b, K8b, K9s,
   K9m, K4/K5 pre and post) also phase 1's and phase 2's device times (the
   profiler's, by kernel name: phase 1 every kernel of the call but phase
   2's, the pack of the transposed weights included), both phases' bounds,
   phase 2's row split, for the wgmma phase 1 (K1b, K2b, K8b, K9s, K4/K5
   pre and post b, K9m) its plan, registers and spills, and two calls on the
   same inputs compared bit for bit; for K3f, K3b, K6 and K7f their device
   time (the profiler's) beside their events' time, their wrapper's host
   time per call, their launch plan and every instance's registers and
   spills, K3b's bf16 outputs against its fp32 ones cast and K3b and K7f on
   two calls bit for bit, K3b and K7f on the main path's views (one device
   event a call), and the device time of TL's recomputing K7 backward;
   then the redesign queue (K3f saving and primal, K3b, K6, K7f at 256 and
   1,024 environments, K9m, K4/K5 pre b) and the rows still to be ordered (K1f with the
   gelu FFN at 6,144 and 1,024 rows and on TL's ELU head at 65,536 and 1,024,
   K4 post f at 65,536, K4 pre f primal at 24,576, K5 pre f) beside their
   library calls in one block, ten calls each; for the fused
   block's forwards (K4/K5 pre and post f) and the MLP chain forward (K1f,
   K2f, K8f) at each timed shape the launch plan (grid, tiles per block,
   ring slots, resident or streamed images, shared memory per block), the
   kernel's registers and spills from the build log, and the device time of
   the pack kernel (where there is one) and of the forward kernel (the
   profiler's, by name);
4. ``[wrappers]``: hold the wrappers the port calls (``fused_mlp``,
   ``fused_mlp_pair``, ``fused_mlp_pair_heads``, ``fused_ppo_step`` in split
   and in mono mode (against split too), ``lane_window_attention``,
   ``banded_window_attention``, ``lane_next_token_attention``,
   ``fused_block_pre``/``post`` and their pair variants, and their autograd
   Functions) against the plain versions at the shapes their paths give
   them (for path T ``fused_mlp`` with the gelu FFN and the ELU head; for TJ
   ``fused_mlp_pair`` with input gradients; ``lane_next_token_attention`` on
   the transformer's views, one device event a call; the lane wrapper's
   backward one K3b launch and no cast): outputs, losses and every
   ``.grad`` after ``backward``, one launch per call, the residual's
   cotangent reaching the pre op in fp32, an activation the fused block
   does not take raising on the card; and the fused step route against
   the modular step at 1,024 environments; ``[second-order]``: AMP's
   gradient penalty differentiated once more on the card (the
   discriminator's gradient at penalty weight 5 less at 0) against the CPU,
   no kernel launched; ``[optimizer]``: adam, adamw, sgd (Nesterov momentum)
   and rmsprop three steps on the card against the CPU on AMP's parameter
   set with device learning rates, packed Adam against the default, and the
   device time of one step on path A's and AMP's parameter sets for the
   default Adam, packed Adam and ``torch.optim.Adam(fused=True)``;
5. ``[update-check]``: one whole update on the card against the same update
   through the port's plain CPU path, at full width on a small rollout, for
   the slice-1 configuration, the zoo's paths A, B, C and CM, path T
   (modular route) and paths TF, TJ and TL (the fused-block route; on the
   CPU under ``CUSRL_TPU_FUSED_TRANSFORMER=force``; TL keeps T = 256), and
   the recurrent entry's paths R (the zoo's ``recurrent_ppo``: GRU 256, the
   per-step critic), RJ (R with the joint evaluation: the two GRUs stacked,
   the heads on K2) and RL (R with LSTM cells), and path AMP (the zoo's
   ``Velocity-Flat``/``amp``: reward shaping and AMP's ``post_step`` over the
   rollout with the same expert rows on both sides, then the update with the
   same subsamples; the AMP losses and accuracy among the metrics, the
   discriminator among the gradient leaves), and path F (the zoo's
   ``Velocity-Flat``/``ppo``, the README's quick-start entry); and
   ``[update-check] H``: the zoo's ``CartPole-v1``/``ppo`` update (20 epochs
   of one 256-row minibatch) on the CPU agent's 32-step rollout on the native
   CartPole, the same Gumbel draws and minibatch plan on both sides; and the
   auxiliary paths: D (the distillation preset's student with a path-A
   expert from a ``package`` export, its actions from the hook's
   ``post_step``), S (A with ``SymmetricDataAugmentation`` before the joint
   evaluation and the mirrors' override: the batch doubled), SL (A with
   ``MirrorSymmetryLoss``), X (A with RND and ``ReturnPrediction``: RND's
   predictor and the return head among the gradient leaves) and RS (R with
   ``ActionSmoothnessLoss`` on its temporal batches); and the control
   paths: SC (A with the control hooks and schedules; the optimization
   stage's first gradient and its Adam moments after the update among the
   leaves) and PO (A with the adaptive Normal head, the minibatch-wise
   advantages, the sparse bootstrap and 4-4-4-2-2 minibatches, at lr 1e-4);
   ``[update-check] TQ TJC SB``: TQ (path T's entry with ``qk_norm=True`` on
   every encoder layer, through the default route, which keeps a QK-normed
   layer modular: T's launches), TJC (TJ with ``CUSRL_TPU_PAIR_CONCAT=1``,
   set around its phases only: each minibatch's pair attention one
   K3f/K3b over 512 environments), also against TJ on the card on the same
   weights and batch (bit for bit or within the limits, printed), and SB
   (path A's entry with ``SimbaFactory()`` backbones and without the joint
   evaluation, which takes Mlp backbones only: no kernel launch);
   ``[update-check] IL``: the zoo's ``Isaac-Velocity-Rough-Anymal-C-v0``/
   ``ppo`` update on the IsaacLab adapter's spec (235-D observations, no
   state, autoreset with final states missing);
6. ``[train]``: the slice-1 loop (Velocity-Rough widths without observation
   normalization and the adaptive learning rate) for a few iterations;
7. ``[train-zoo]``: paths T, TF, TJ and TL (the zoo's uncut Velocity-Flat
   ``transformer_ppo``: embed 128, 4 heads, window 16, gelu FFN 512, ELU head
   128, 1,024 environments; T on the modular route with
   ``CUSRL_TPU_FUSED_TRANSFORMER=0``: K3f/K3b/K6 and K1 with gelu; TF on its
   default fused-block route: K4, K3, K6, K1; TJ as TF with
   ``fuse_actor_critic_evaluation=True``: K5 and K2 in the minibatches; TL as
   TF with ``num_steps_per_update=256``: K4 around K7f, the next-token pass
   in its plain version) and paths A (the
   zoo's uncut Velocity-Rough ``ppo``: 4,096 environments, joint evaluation
   on K2), B (A with the heads in the kernel: K8), C (A with the fused
   PPO update: K2f + K9s) and CM (C in mono mode, ``fused_ppo_step._PPO_MODE
   = "mono"``: K9m), and paths R and RJ (the zoo's uncut Velocity-Flat
   ``recurrent_ppo``: GRU 256 and an ELU head of 128, 1,024 environments,
   the per-step critic; RJ with ``fuse_actor_critic_evaluation=True``), and
   path AMP (the zoo's uncut Velocity-Flat ``amp``: relu 512-256 actor and
   critic, 1,024 environments, 16 steps, 4 x 4 minibatches of 4,096 rows,
   reward shaping and the AMP discriminator with its gradient penalty in
   plain layers; the entry's ``iterations_per_dispatch`` of 1 set to 10),
   and path F (the zoo's uncut Velocity-Flat ``ppo``: ELU 128-128-128,
   4,096 environments, joint evaluation on K2), and paths S and X (path A
   uncut with the symmetric augmentation, or with RND and the return probe)
   and D (the distillation preset at its defaults on Velocity-Rough's 4,096
   environments, its expert the agent ``[train-zoo] A`` trained, exported
   and loaded by ``expert_path``), and paths SC (A uncut with
   ``ConditionalObjectiveActivation``, ``MiniBatchWiseLRSchedule``, an
   ``OptimizationStage`` with its own Adam around a ``StateEstimation``,
   the entropy weight's parameter schedule, the entropy loss switched off
   from iteration 3, ``OnPolicyBufferCapacitySchedule`` from 24 to 32 steps
   at iteration 2, so its timed chunk runs 32, and ``DeviceMemoryStats``,
   whose ``Memory/device_peak_bytes`` it prints) and PO (A uncut with
   ``AdaptiveNormalDistFactory(bijector="softplus")``, the minibatch-wise
   advantage normalization, ``sparse_value_bootstrap`` and 4, 4, 4, 2 and
   2 minibatches in its five epochs: one host read of the bootstrap's
   overflow flag an update beside the chunk's transfer), and path TQ (T with
   QK-norm on its default route), each built through ``get_experiment(...).to_training_factory()`` with
   ``iterations_per_dispatch=10``, observation normalization and (but AMP)
   the KL-adaptive learning rate, and driven through the Trainer for a warm-up
   chunk and a timed chunk of 10 iterations, with the launch counters set to
   0 just before the timed chunk and read just after (``EXPECTED_ZOO_LAUNCHES``
   per iteration), one host transfer per chunk and no other synchronizing
   call; ``[train-zoo] H``: the zoo's ``CartPole-v1``/``ppo`` entry as
   registered on ``NativeCartPoleEnv(8)`` (the card's machine has no
   gymnasium) through the Trainer's host loop, two warm-up iterations and 10
   timed ones (43 K1f and 40 K1b an iteration; the 8-row policy steps run
   plain layers below the training floor), the synchronizing calls by site
   (one a rollout step, the action's transfer; one an update, the
   metrics'), the Timer's environment and agent seconds and env-steps/s;
   ``[play] H``: the Player on the trained checkpoint, deterministic and
   unpaced, for 500 steps on ``NativeCartPoleEnv(8)``, one K1f launch a
   step; ``[train-zoo] IL``: the zoo's uncut
   ``Isaac-Velocity-Rough-Anymal-C-v0``/``ppo`` entry (ELU 512-256-128 on
   235-D observations, 4,096 environments, no joint evaluation) through
   ``make_isaaclab_env``, ``IsaacLabEnvLauncher`` and the adapter, with fake
   IsaacLab and gymnasium modules installed around the phase whose
   ``gym.make`` gives ``_StandInAnymalEnv``, a stand-in simulator whose
   tensors live on the card, into the Trainer's host loop on those tensors:
   a warm-up iteration and 10 through ``run_training_loop`` (67 K1f and 40
   K1b an iteration; the synchronizing calls by site: the update's metrics
   transfer, which carries the episode aggregates, and the ``extras["log"]``
   read, one each an iteration, none in a rollout step; the adapter's
   metrics logged as ``Environment/<key>``), the stand-in's and the policy
   step's device ms a step, a profile; ``[play] IL``: the playing factory's
   ``-Play`` task (50 environments) for 100 deterministic, unpaced steps
   from the trained checkpoint, one K1f a step; and a profile of one
   iteration of each path (device time by kernel
   name, phase 2 of the backwards listed whatever its rank, the fused
   block's and the MLP chain's forward kernels and phase-1 backward kernels
   (``fbp::``, ``fbb::``, ``mlpb::``, K9m's ``mlpm::``) by name with their
   sums, and the share of the device's busy time of K3f, K3b, K6 and K7f);
   path TJC runs two warm-up iterations and one profiled iteration, its
   launches counted over that iteration (``launches_by_path`` holds them
   per iteration, the other paths' per 10-iteration chunk), and its K3f and
   K3b launches and device ms print beside TJ's; ``[modules]``: ``Cnn`` at
   ``CnnFactory()``'s defaults on 4,096 images, ``SeparableConv2d`` on its
   first feature map, ``TransformerEncoderLayer`` and
   ``TransformerDecoderLayer`` (128 wide, 4 heads, gelu FFN 512 with bf16
   layers, each launching one K1f and one K1b) on 24 x 1,024 tokens and
   ``GeGlu``/``SwiGlu``, forward and backward on the card against the CPU
   (2e-2 of each value's largest element) with device ms a call;
   ``[library]``: the README's snippet through ``cusrl_tpu_torch``'s
   top-level names for 2 iterations on the card;
8. ``[cli]``: the user surface on path F, in a temporary directory:
   ``python -m cusrl_tpu_torch train -env Velocity-Flat -alg ppo
   --num-iterations 20 --logger jsonl --seed 0 --log-dir <tmp> --
   --checkpoint_interval 10`` as a subprocess (exit 0, ``ckpt_10.npz``,
   ``ckpt_20.npz``, ``info/metadata.json``, the ``latest`` link, 20 finite
   jsonl lines); then in this process, through
   ``cusrl_tpu_torch.__main__.main``: ``train --checkpoint`` resuming at 20
   and stopping at 25, fresh card agents loading ``ckpt_20.npz`` and
   ``ckpt_25.npz`` giving back each file's ``agent_state`` bit for bit (and
   for 25 the saving agent's deterministic actions on a fixed batch), ``play
   --num-steps 100`` deterministic and ``--stochastic`` (finite summaries,
   one K1f launch a step at the Player's 64 rows), ``benchmark --num-steps
   1000`` (its env-steps/s), ``find-trial``, ``list-experiments``, ``export``
   as ``torch_export`` (the ``graph.pt2`` run on the card and on the CPU,
   each against the card agent's kernel route within 2e-2) and as
   ``package``; and a jsonl-logged Trainer whose chunk ending at no
   checkpoint makes one host transfer and no other synchronizing call; each
   subcommand's seconds;
9. ``[ddp]``: data parallelism over ``torch.distributed``.  A1, a NCCL group
   of one in this process: path A's update (4,096 environments x 24 steps)
   through ``distribute_agent`` / ``cross_process_update`` against the same
   update without a group, from the same state, rollout and permutations,
   bit for bit (metrics, every leaf of the agent's state, the first
   minibatch's gradient); then path A through the Trainer undistributed and
   distributed (a warm-up and a timed 10-iteration chunk each: launches,
   one host transfer a chunk in sync debug mode, env-steps/s, the
   collectives' calls and bytes an iteration, a profile of the distributed
   iteration).  A2, two rank processes on this one card (``--ddp-rank``;
   first a NCCL probe, ``--ddp-probe``: NCCL if it takes two ranks on one
   device, else gloo, which moves CUDA tensors through the host), each with
   path A's 4,096 environments: one update of A, then one of CM, on their
   own rollouts with the permutations fed, against this process's update
   of the 8,192 environments side by side at ``[update-check]``'s limits,
   the ranks bit for bit equal, 20 K2f/K2b or K9m launches a rank on
   24,576-row slices; then, in the same rank processes, every other route
   at its zoo entry's environments a rank (``DDP_ROUTES``: R, TF, TJ, AMP,
   X, SC at 24 steps, PO, S, D, and H through ``agent.update()`` on a
   ``Buffer`` of 8 environments a rank; TF, TJ and PO at lr 1e-4): this
   process collects one rollout of both ranks' environments with the
   path's own agent and environment (every hook's fields, memories warm),
   the ranks load the state after it (their own environments' rows of the
   memories) and update on their halves with the plan and AMP's subsample
   draws fed, each rank launching every kernel of the one-process update
   on half its rows; each path prints each rank's launches, minibatch
   rows, collectives (calls and bytes) and the seconds of both updates; a
   rank that fails or outlives its time fails the run;
10. ``[tp]``: tensor parallelism and the hierarchical mesh (``--tp-rank``
   processes on this one card, the NCCL probe first: gloo where NCCL refuses
   two ranks on one device).  Two ranks (1 x 2: ``model=2``) take path A's
   update (4,096 environments), TF's (at lr 1e-4) and AMP's, then path A
   through ``Trainer.rollout_and_update`` (a warm-up iteration and a chunk
   of 3; env-steps/s beside ``[train-zoo] A``'s, no claim); side by side
   four ranks take path A's update on 2 x 2 (4,096 environments a data
   rank) and on ``dcn=2 x data=2`` (2,048 a data rank: the same 8,192
   environments).  Each case against this process's one-process update of
   its joined rollout at ``[update-check]``'s limits (the shards gathered),
   every rank's state bit for bit equal, 0 MLP chain kernel launches on the
   sharded chains and the one-process counts of the kernels with whole
   weights (TF's fused block and attention kernels), A2's counts on the
   hierarchical mesh, the tensor-parallel warning once a rank, the
   collectives' calls and bytes a minibatch by axis; the model peers of the
   Trainer seeded alike and ending with the same observations and state;
11. each phase's seconds on a line of its own as it ends, and all of them
   in one ``[seconds]`` line; the total seconds, the ``nvidia-smi`` line,
   the ``kernels`` JSON line
   (each kernel's launches from the path that runs it, ``launches_by_path``
   every path's; ``not_ported`` is empty), and the final
   ``{"ok": true, ...}`` line.

``python3 chip_smoke.py --ddp`` runs only ``[ddp]``; ``--ddp-cards`` runs A2's
check with one rank on each card of the machine, over NCCL.  ``--tp`` runs
only ``[tp]``; ``--tp-cards`` its four-rank cases (2 x 2 and ``dcn=2 x
data=2``) with one NCCL rank on each of four cards.
``python3 chip_smoke.py --paths TL C`` runs only the named paths'
``[train-zoo]`` chunks and profiles (``SC PO``: the control paths) (``H``: its host-loop iterations and
profile; ``IL``: its iterations, profile and ``[play] IL``; ``TJC``: its
profiled iteration), with the kernels of the package beside
the script: copied into another checkout, it times that checkout's port the
same way (two versions compare inside one call, in turns).

Depth is not cut: the MLP paths have 3 hidden layers (AMP 2, as registered),
the transformer paths their one encoder layer and one head layer, the
recurrent paths their one GRU layer and one head layer.  Weights are random, from seed 0.  There is no CPU
fallback: without CUDA the script exits 2.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
WIDTHS = (48, 512, 256, 128)  # Velocity-Rough: 48-D observations, 512-256-128 backbones
NUM_ENVS, STEPS, EPOCHS, MINIBATCHES = 4096, 24, 5, 4
MINIBATCH_ROWS = NUM_ENVS * STEPS // MINIBATCHES  # 24,576
# Iterations of a path's warm-up chunk before its timed chunk of 10, so that
# the timed chunk runs one configuration: past the first iteration's lazy
# set-up and the only settings of any path that change with the iteration,
# SC's schedules (32 steps from iteration 2, the entropy loss off from 3; the
# entropy weight's ramp to iteration 10 changes a value, not what runs).  The
# zoo's KL-adaptive learning rates adapt from iteration 0 (no warm-up
# iterations), and no path logs or writes a checkpoint (every 50 iterations
# with a logger).
WARMUP_ITERATIONS = 5
RAGGED_ROWS = 1000
TIMED_ITERATIONS = 3
EXPECTED_LAUNCHES_PER_ITERATION = {"K1f": STEPS + 3, "K1b": 0, "K2f": EPOCHS * MINIBATCHES, "K2b": EPOCHS * MINIBATCHES}

# Published dense peaks of one H100 SXM (NVIDIA data sheet), at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel-vs-plain tolerances.  Forward outputs are bf16: the two sides
# accumulate in another order, so a value can round to the neighbouring bf16
# number (2^-8 relative) and that step can propagate through later layers.
# Gradients are fp32 sums over many rows of products of bf16 values; a flipped
# bf16 rounding of d moves a sum by ~2^-8 of one term.
FWD_RTOL, FWD_ATOL = 2e-2, 2e-2
GRAD_REL = 1e-2  # max |kernel - plain| <= GRAD_REL * max |plain|

REPLACES = {
    "K1f": "cusrl_tpu/nn/kernels/fused_mlp.py:256",
    "K1b": "cusrl_tpu/nn/kernels/fused_mlp.py:293",
    "K2f": "cusrl_tpu/nn/kernels/fused_mlp.py:567",
    "K2b": "cusrl_tpu/nn/kernels/fused_mlp.py:604",
    "K8f": "cusrl_tpu/nn/kernels/fused_mlp.py:960",
    "K8b": "cusrl_tpu/nn/kernels/fused_mlp.py:1009",
    "K9s": "cusrl_tpu/nn/kernels/fused_ppo_step.py:417",
    "K3f": "cusrl_tpu/nn/kernels/lane_attention.py:204",
    "K3b": "cusrl_tpu/nn/kernels/lane_attention.py:247",
    "K6": "cusrl_tpu/nn/kernels/lane_attention.py:385",
    "K9m": "cusrl_tpu/nn/kernels/fused_ppo_step.py:289",
    "K7f": "cusrl_tpu/nn/kernels/banded_attention.py:202",
}
SOURCES = {
    "K1f": "cusrl_tpu_torch/csrc/mlp_chain_fwd.cu",
    "K1b": "cusrl_tpu_torch/csrc/mlp_chain_bwd.cu",
    "K2f": "cusrl_tpu_torch/csrc/mlp_chain_fwd.cu",
    "K2b": "cusrl_tpu_torch/csrc/mlp_chain_bwd.cu",
    "K8f": "cusrl_tpu_torch/csrc/mlp_chain_fwd.cu",
    "K8b": "cusrl_tpu_torch/csrc/mlp_chain_bwd.cu",
    "K9s": "cusrl_tpu_torch/csrc/mlp_chain_bwd.cu",
    "K3f": "cusrl_tpu_torch/csrc/lane_attention.cu",
    "K3b": "cusrl_tpu_torch/csrc/lane_attention.cu",
    "K6": "cusrl_tpu_torch/csrc/lane_attention.cu",
    "K9m": "cusrl_tpu_torch/csrc/mlp_chain_bwd.cu",
    "K7f": "cusrl_tpu_torch/csrc/banded_attention.cu",
}
ROUTE = "CUSRL_TPU_FUSED_TRANSFORMER"


@contextlib.contextmanager
def _fused_route(mode):
    """Sets the encoder layer's route (``CUSRL_TPU_FUSED_TRANSFORMER``; None:
    unset, the default) for the block and restores it after."""
    old = os.environ.pop(ROUTE, None)
    if mode is not None:
        os.environ[ROUTE] = mode
    try:
        yield
    finally:
        os.environ.pop(ROUTE, None)
        if old is not None:
            os.environ[ROUTE] = old


def _time_ms(fn, repeats: int = 10, warmup: int = 3) -> float:
    """Median of ``repeats`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _tensors(obj) -> list:
    """The tensors in a nest of tuples, lists and dicts, in order."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return [t for item in obj for t in _tensors(item)]
    return []


PROFILE_ATTEMPTS = 5  # a profiler session can drop kernel events; a short count profiles again
# The redesign queue's kernels beside their library calls, {(kernel, field
# prefix): (kernel call, library call)}, filled by the kernel checks and
# timed together by time_redesign_queue.
QUEUE: dict = {}
# Queued ahead of a start event, this sleep (in clock cycles, some 10 ms) keeps
# the card busy while the host does a call's work before its launches.
QUEUED_SLEEP_CYCLES = 20_000_000


def _in_namespaces(key: str, namespaces) -> bool:
    """Whether the profiler's kernel name ``key`` (demangled or not) is a
    function of one of ``namespaces`` (``"fbf"``, ...): by its own name, not
    by the types its signature names."""
    return any(f"{ns}::" in key.split("(")[0] or key.startswith(f"_ZN{len(ns)}{ns}") for ns in namespaces)


def _profiled_kernels(fn, namespaces, repeats: int, warmup: int) -> tuple[list, int, float]:
    """``(name, launches, device us)`` of the CUDA kernels of ``namespaces``
    over ``repeats`` calls of ``fn`` under torch.profiler after ``warmup``
    calls, then the count and the device us of every device event the
    session recorded (kernels of any name, copies, fills)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    found, device_events, device_us = [], 0, 0.0
    for event in prof.key_averages():
        if _is_device_work(event):
            us = getattr(event, "self_device_time_total", 0) or getattr(event, "self_cuda_time_total", 0)
            device_events += event.count
            device_us += us
            if _in_namespaces(event.key, namespaces):
                found.append((event.key, event.count, us))
    return found, device_events, device_us


def _is_device_work(event) -> bool:
    """Whether a profiler event is work on the card (a kernel, a copy, a
    fill).  A ``record_function`` range that PyTorch also records on the
    device (``Optimizer.step#Adam.step``: the span from its first kernel to
    its last, gaps included) repeats its kernels' time, and is not."""
    import torch

    return event.device_type == torch.autograd.DeviceType.CUDA and not getattr(event, "is_user_annotation", False)


def _queued_events_ms(fn, repeats: int = 10, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` by CUDA events, its kernels together:
    the median over ``repeats`` calls, each behind a queued sleep so that the
    host's work before the launches does not show.  Taken where the profiler
    records no device event at all."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUED_SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_ms(fn, repeats: int = 20, warmup: int = 3) -> float:
    """The host's time per call of ``fn`` (a wrapper's checks, allocations
    and launch) by the host clock over ``repeats`` calls queued behind a
    sleep on the card, so that no call waits for the device."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUED_SLEEP_CYCLES)
    start = time.perf_counter()
    for _ in range(repeats):
        fn()
    host_ms = (time.perf_counter() - start) * 1e3 / repeats
    torch.cuda.synchronize()
    return host_ms


def time_redesign_queue(results: dict) -> None:
    """The kernels of the redesign queue (K3f saving and primal, K3b, K6,
    K7f at TL's minibatch and primal, K9m, K4/K5 pre b) and the rows that wait to be ordered (K1f with the gelu
    FFN at 6,144 and 1,024 rows, K1f on TL's ELU head at 65,536 and 1,024, K4
    post f at 65,536 saving, K4 pre f primal at 24,576, K5 pre f) each beside
    its library call, timed together in this one block: CUDA events, median
    of ten calls each, kernel then library.  Adds ``queue_ms`` and
    ``queue_library_ms`` (with the shape's prefix) to each kernel's
    results."""
    print("[kernels] the redesign queue beside its library calls, one block (CUDA events, median of 10 calls each)")
    for (key, prefix), (kernel, library) in QUEUE.items():
        k_ms, l_ms = _time_ms(kernel), _time_ms(library)
        results[key].update({prefix + "queue_ms": k_ms, prefix + "queue_library_ms": l_ms})
        print(f"    {key + ' ' + prefix.rstrip('_'):16s} kernel_ms={k_ms:.4f} library_ms={l_ms:.4f} "
              f"factor={k_ms / l_ms:.2f}")


def _no_grad(fn):
    """``fn`` called under ``torch.no_grad()``: a library yardstick that must
    build no autograd graph, queued to run later."""
    import torch

    def call():
        with torch.no_grad():
            return fn()

    return call


def _ms(value) -> str:
    return "not measured" if value is None else f"{value:.4f}"


# Phase 2's device ms with the design the wgmma one replaced (WMMA tiles in
# one launch, the splits added in a second), by (kernel, rows per chain,
# chains, dW shapes): the brackets of PERF.md §6's phase table.
MLP_SHAPES = ((512, 48), (256, 512), (128, 256))
PRE_SHAPES = ((128, 48), (128, 128), (128, 128), (128, 128))
POST_SHAPES = ((128, 128), (512, 128), (128, 512))
PHASE2_BEFORE = {
    ("K1b", 6144, 1, ((512, 128), (128, 512))): 0.0311, ("K1b", 24576, 1, MLP_SHAPES): 0.0855,
    ("K1b", 65536, 1, ((128, 128),)): 0.0320, ("K1b", 6144, 1, ((128, 256),)): 0.0106,
    ("K1b", 4096, 1, ((512, 48), (256, 512))): 0.0184, ("K2b", 6144, 2, ((128, 256),)): 0.0163,
    ("K2b", 24576, 2, ((128, 48), (128, 128), (128, 128))): 0.0464, ("K2b", 24576, 2, MLP_SHAPES): 0.1844,
    ("K8b", 24576, 2, MLP_SHAPES): 0.1866, ("K9s", 24576, 2, MLP_SHAPES): 0.1878, ("K9m", 24576, 2, MLP_SHAPES): 0.1897,
    ("K4pre_b", 6144, 1, PRE_SHAPES): 0.0156, ("K4pre_b", 65536, 1, PRE_SHAPES): 0.0795,
    ("K4post_b", 6144, 1, POST_SHAPES): 0.0375, ("K4post_b", 65536, 1, POST_SHAPES): 0.3142,
    ("K5pre_b", 6144, 2, PRE_SHAPES): 0.0208, ("K5post_b", 6144, 2, POST_SHAPES): 0.0708,
    ("K1b", 24576, 1, ((512, 235), (256, 512), (128, 256))): 0.1418,
}


def _phase2_plan(fn, chains: int) -> dict:
    """Phase 2's plan as one call of ``fn`` makes it (``dw_phase2.make_scratch``
    watched): splits, cluster, clusters a tile, dW tiles, blocks, the column
    chunk, the ring's stages by tile width and H's type (as the library
    sizes them: ``dw_phase2_stages``), and the blocks the card holds at once
    in such clusters (``dw_phase2_max_blocks``: the wave the plan assumes is
    ``dw_phase2.WAVE``)."""
    import torch

    from cusrl_tpu_torch.nn.kernels import build, dw_phase2

    seen = []
    make = dw_phase2.make_scratch
    dw_phase2.make_scratch = lambda *args, **kwargs: seen.append(make(*args, **kwargs)) or seen[-1]
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        dw_phase2.make_scratch = make
    s = seen[-1][0]
    lib = build.load_library("mlp_chain_bwd")
    stages = {f"{name} {64 * hb}": lib.dw_phase2_stages(s.col_chunk, kind, hb)
              for name, kind, widths in (("bf16", dw_phase2.H_BF16, (4, 2, 1)), ("fp32", dw_phase2.H_F32, (2, 1)))
              for hb in widths}
    return dict(phase2_splits=s.splits, phase2_cluster=s.cluster, phase2_clusters_per_tile=s.splits // s.cluster,
                phase2_tiles=s.tiles, phase2_blocks=s.splits * s.tiles * chains, phase2_col_chunk=s.col_chunk,
                phase2_stages=stages, phase2_active_blocks=lib.dw_phase2_max_blocks(s.cluster, s.col_chunk))


def _backward_phases(name: str, fn, rows: int, chains: int, dw_shapes, bytes_per_row: int, cols: int,
                     phase1: tuple, plan: dict | None = None, repeats: int = 10, warmup: int = 3) -> dict:
    """Phase 1's and phase 2's device time per call of the backward launch in
    ``fn`` (torch.profiler over ``repeats`` calls, kernels by name: phase 2
    ``dw::phase2_kernel``, phase 1 every other kernel of the port's
    backwards, the pack of the transposed weights included: ``mlpb::``,
    ``fbb::``, ``fbp::`` and ``mlpm::`` (K9m, whose forward runs in its
    phase 1)), both phases' bounds, phase 2's plan (``_phase2_plan``), and
    two calls of ``fn`` compared bit for bit (raises if they differ).  Phase
    2's time before the redesign (``PHASE2_BEFORE``, a constant from earlier
    runs) is printed beside this run's and kept out of the fields.  Phase 1's work, all
    chains: ``phase1 = (bytes, FLOP)`` per row (each input read once, each
    output written once, the data products); phase 2's per chain: ``2 * rows
    * sum(n_out * n_in)`` FLOP over ``dw_shapes``, its bytes each input read
    once (``bytes_per_row`` per chain: the bf16 output cotangents and the
    layer inputs), the per-row-tile column partials (``cols`` floats per
    tile, all chains) and the outputs once.  ``plan``: phase 1's plan
    fields, printed beside its time."""
    import torch

    from cusrl_tpu_torch.nn.kernels import dw_phase2

    first, second = _tensors(fn()), _tensors(fn())
    torch.cuda.synchronize()
    if len(first) != len(second) or not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    # Each call launches phase 1's kernels (the pack, where the images stream,
    # and the row kernel) and phase 2's one kernel; a phase's time per call
    # is the sum of its kernels' mean times (the profiler can miss a profiled
    # run's first kernel, so counts may fall short of ``repeats``).
    device_events = 0
    for _ in range(PROFILE_ATTEMPTS):
        found, seen, _ = _profiled_kernels(fn, ("dw", "mlpb", "fbb", "fbp", "mlpm"), repeats, warmup)
        device_events += seen
        kernels = [[k for k in found if not _in_namespaces(k[0], ("dw",))],
                   [k for k in found if _in_namespaces(k[0], ("dw",))]]
        counts = [[count for _, count, _ in phase] for phase in kernels]
        if (1 <= len(counts[0]) <= 2 and len(counts[1]) == 1
                and all(repeats // 2 <= c <= repeats for c in sum(counts, []))):
            p1, p2 = (sum(us / count for _, count, us in phase) / 1e3 for phase in kernels)
            by_kernel = "; ".join(f"{k.split('(')[0]} {us / count / 1e3:.4f} ms" for k, count, us in kernels[0])
            call_ms = None
            break
    else:
        if device_events:
            raise AssertionError(f"{name}: the profiler saw {kernels} over {repeats} calls in each of "
                                 f"{PROFILE_ATTEMPTS} sessions; expected phase 1's one or two kernels and phase 2's "
                                 f"kernel, each launched once per call")
        # The profiler recorded nothing on the card: both phases together by events.
        p1 = p2 = None
        call_ms = _queued_events_ms(fn, repeats, warmup)
        by_kernel = (f"the profiler saw no device event in {PROFILE_ATTEMPTS} sessions; both phases together "
                     f"{call_ms:.4f} ms by CUDA events")
    dw_floats = sum(o * i for o, i in dw_shapes)
    row_tiles = -(-rows // dw_phase2.ROW_TILE)
    work = (chains * 2 * rows * dw_floats,
            chains * (rows * bytes_per_row + dw_floats * 4) + (row_tiles + 1) * cols * 4)
    bound, by = _bound_ms(*work)
    bound1, by1 = _bound_ms(rows * phase1[1], rows * phase1[0])
    p2_plan = _phase2_plan(fn, chains)
    before = PHASE2_BEFORE.get((name.split()[0], rows, chains, tuple(map(tuple, dw_shapes))))
    fields = dict(phase1_ms=p1, phase1_bound_ms=bound1, phase1_bound_by=by1, phase1_kernels=by_kernel,
                  phase2_ms=p2, phase2_bound_ms=bound, phase2_bound_by=by,
                  bitwise_repeat=True, **p2_plan, **(plan or {}))
    if call_ms is not None:
        fields["phases_events_ms"] = call_ms
    before = "no earlier run" if before is None else f"{before:.4f} (earlier runs, not measured here)"
    print(f"    {name} rows={rows}: phase1_ms={_ms(p1)} ({by_kernel}) phase1_bound_ms={bound1:.4f} "
          f"({by1}, {phase1[0]} B and {phase1[1]} FLOP a row) phase2_ms={_ms(p2)} (dw::phase2_kernel; before the "
          f"redesign {before}) phase2_bound_ms={bound:.4f} ({by}) "
          f"plan: {p2_plan['phase2_splits']} splits in clusters of {p2_plan['phase2_cluster']} "
          f"({p2_plan['phase2_clusters_per_tile']} a tile), {p2_plan['phase2_tiles']} dW tiles, "
          f"{p2_plan['phase2_blocks']} blocks ({p2_plan['phase2_active_blocks']} at once), stages "
          f"{p2_plan['phase2_stages']}; two calls: same bits ({len(first)} tensors)")
    return fields


def _chain_phase1_work(dims, skip: bool, head_dim: int = 0, loss_bytes: int = 0, trailing: bool = True):
    """Phase 1's (bytes, FLOP) per row of one MLP chain's backward: the
    cotangent read (bf16, or the head's fp32 and the loss rows), the saved
    values whose derivative or latent it reads, each D_l written (bf16) and
    dX (fp32) unless skipped; the data products and the head's two."""
    top = 4 * head_dim + loss_bytes if head_dim else 2 * dims[-1]
    saved = 2 * sum(dims[1:-1]) + (2 * dims[-1] if trailing or head_dim else 0)
    nbytes = top + saved + 2 * sum(dims[1:]) + (0 if skip else 4 * dims[0])
    flops = 2 * sum(dims[l] * dims[l + 1] for l in range(len(dims) - 1) if l > 0 or not skip)
    return nbytes, flops + 4 * head_dim * dims[-1]


def _sum_work(*works):
    return tuple(sum(w[i] for w in works) for i in range(2))


def _phase1_plan(key: str, plan: dict, stem: str, symbol: str, images_of: str = "W^T") -> dict:
    """Prints and returns phase 1's plan (grid, images resident or streamed,
    shared memory per block) and its kernel's registers and spills from the
    build log (``symbol``: a part of the mangled name)."""
    usage = _ptxas_usage(stem)
    name = next(n for n in usage if symbol in n)
    regs, spill_st, spill_ld = usage[name]
    per_sm = plan.get("per_sm", 2)
    loaded = "converted once per block" if stem == "mlp_chain_bwd" else "packed per call, loaded once per block"
    images = f"resident, {loaded}" if plan["resident"] else f"streamed through {plan['slots']} slots, packed per call"
    print(f"    {key} phase 1 plan: grid {plan['blocks']} blocks per chain ({per_sm} per SM), {plan['tiles']} tiles of "
          f"64 rows, up to {-(-plan['tiles'] // plan['blocks'])} per block; {plan['images']} images of {images_of} "
          f"({images}); "
          f"{plan['smem_bytes']} B shared memory per block; {regs} registers, spills {spill_st}/{spill_ld} B (ptxas)")
    return {"phase1_grid": f"{plan['blocks']} blocks per chain ({per_sm} per SM), {plan['tiles']} tiles",
            "phase1_ring": f"{plan['slots']} of {plan['images']} images "
                           f"({'resident' if plan['resident'] else 'streamed'})",
            "phase1_smem_bytes": plan["smem_bytes"], "phase1_regs": regs, "phase1_spills": f"{spill_st}/{spill_ld}"}


def _chain_phase1_plan(key: str, dims, rows: int, chains: int, skip: bool, head_mode: int = 0,
                       head_dim: int = 0) -> dict:
    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    plan = fm.bwd_plan(dims, rows, chains, skip, head_mode, head_dim)
    return _phase1_plan(key, plan, "mlp_chain_bwd", f"chain_bwd_kernelILi{plan['per_sm']}ELi{head_mode}E")


def _chain_work(rows: int, chains: int, backward: bool, save_hiddens: bool, input_grad: bool, dims=WIDTHS,
                x_bytes: int = 4):
    """(FLOP, bytes) the function must do and move: each input read once
    (``x_bytes`` per element of x), each output written once."""
    pairs = [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    macs = sum(a * b for a, b in pairs)
    params = macs + sum(b for _, b in pairs)
    hidden = sum(b for _, b in pairs[:-1])
    if not backward:
        flops = 2 * rows * macs
        nbytes = rows * dims[0] * x_bytes + params * 4 + rows * dims[-1] * 2 + (rows * hidden * 2 if save_hiddens else 0)
    else:
        dx_macs = sum(a * b for a, b in (pairs if input_grad else pairs[1:]))
        flops = 2 * rows * (macs + dx_macs)
        nbytes = (rows * dims[0] * x_bytes + rows * dims[-1] * 2 + rows * (hidden + dims[-1]) * 2  # x, g, saved h
                  + macs * 4 + params * 4 + (rows * dims[0] * 4 if input_grad else 0))  # W, dW + db, dx
    return chains * flops, chains * nbytes


def _bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# Phase 2 of the MLP backwards: the dW shapes and the bytes per row it reads
# (D_l bf16 for the three layers; x fp32, h_1 and h_2 bf16).
MLP_DW_SHAPES = [(WIDTHS[i + 1], WIDTHS[i]) for i in range(len(WIDTHS) - 1)]
MLP_DW_BYTES_PER_ROW = 2 * sum(WIDTHS[1:]) + 4 * WIDTHS[0] + 2 * sum(WIDTHS[1:-1])


def _params(generator, device):
    import torch

    ws, bs = [], []
    for a, b in zip(WIDTHS[:-1], WIDTHS[1:]):
        ws.append((torch.randn(b, a, generator=generator) / math.sqrt(a)).to(device))
        bs.append((torch.randn(b, generator=generator) * 0.1).to(device))
    return ws, bs


def _check(name: str, got, want, rel: bool, grad_rel: float = GRAD_REL) -> float:
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    if rel:
        limit = grad_rel * want.abs().max().item()
        ok = err <= limit
    else:
        ok = bool(torch.allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL))
        limit = FWD_ATOL + FWD_RTOL * want.abs().max().item()
    print(f"    {name:28s} max_abs_err={err:.3e} (limit {limit:.3e}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max_abs_err {err:.3e})")
    return err


def _library_fwd(xs, wss, bss, save):
    """The yardstick: a bf16 F.linear + ELU chain per net (autograd graph kept when ``save``)."""
    import torch
    import torch.nn.functional as F

    outs = []
    for x, ws, bs in zip(xs, wss, bss):
        h = x.to(torch.bfloat16)
        for w, b in zip(ws, bs):
            h = F.elu(F.linear(h, w, b))
        outs.append(h)
    return outs


def check_kernels(device) -> dict:
    import torch

    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED)
    wa, ba = _params(gen, device)
    wc, bc = _params(gen, device)
    wa16 = [w.to(torch.bfloat16).requires_grad_() for w in wa]
    ba16 = [b.to(torch.bfloat16).requires_grad_() for b in ba]
    wc16 = [w.to(torch.bfloat16).requires_grad_() for w in wc]
    bc16 = [b.to(torch.bfloat16).requires_grad_() for b in bc]
    results = {}

    def obs(rows):
        return torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(device)

    def cotangent(rows):
        return (torch.randn(rows, WIDTHS[-1], generator=gen) * 0.01).to(device, torch.bfloat16)

    # -- K1f: single-chain forward (rollout actor, whole-rollout critic/actor passes)
    print("[kernels] K1f mlp_chain_fwd x1")
    errs = []
    for rows, save in ((4096, False), (NUM_ENVS * STEPS, False), (RAGGED_ROWS, True)):
        x = obs(rows)
        (out,), (hid,), _ = fm._launch_fwd([x], [wa], [ba], "elu", True, save, "K1f")
        ref, ref_hid = fm.mlp_chain_fwd_plain(x, wa, ba, "elu", True, save)
        torch.cuda.synchronize()
        errs.append(_check(f"out rows={rows}", out, ref, rel=False))
        for i, (h, r) in enumerate(zip(hid, ref_hid)):
            errs.append(_check(f"h{i + 1} rows={rows}", h, r, rel=False))
    x = obs(NUM_ENVS * STEPS)
    k_ms = _time_ms(lambda: fm._launch_fwd([x], [wa], [ba], "elu", True, False, "K1f"))
    p_ms = _time_ms(lambda: fm.mlp_chain_fwd_plain(x, wa, ba, "elu", True, False))
    with torch.no_grad():
        l_ms = _time_ms(lambda: _library_fwd([x], [wa16], [ba16], False))
    bound, by = _bound_ms(*_chain_work(NUM_ENVS * STEPS, 1, False, False, False))
    x4 = obs(4096)
    k4_ms = _time_ms(lambda: fm._launch_fwd([x4], [wa], [ba], "elu", True, False, "K1f"))
    p4_ms = _time_ms(lambda: fm.mlp_chain_fwd_plain(x4, wa, ba, "elu", True, False))
    with torch.no_grad():
        l4_ms = _time_ms(lambda: _library_fwd([x4], [wa16], [ba16], False))
    bound4, _ = _bound_ms(*_chain_work(4096, 1, False, False, False))
    print(f"    rows=98304: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={bound:.4f} ({by})")
    print(f"    rows=4096:  kernel_ms={k4_ms:.4f} plain_ms={p4_ms:.4f} library_ms={l4_ms:.4f} bound_ms={bound4:.4f}")
    fields = _chain_forward_fields("K1f", lambda: fm._launch_fwd([x], [wa], [ba], "elu", True, False, "K1f"),
                                   WIDTHS, NUM_ENVS * STEPS, 1, k_ms)
    step = _chain_forward_fields("K1f step", lambda: fm._launch_fwd([x4], [wa], [ba], "elu", True, False, "K1f"),
                                 WIDTHS, 4096, 1, k4_ms)
    results["K1f"] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=l_ms,
                          shape="98304 x 48-512-256-128", rollout_step_ms=k4_ms, rollout_step_plain_ms=p4_ms,
                          rollout_step_library_ms=l4_ms, rollout_step_bound_ms=bound4, **fields,
                          **{f"rollout_step_{k}": v for k, v in step.items()})

    # -- K2f: pair forward with saved activations (every minibatch)
    print("[kernels] K2f mlp_chain_fwd x2 (saves hiddens)")
    errs = []
    for rows in (MINIBATCH_ROWS, RAGGED_ROWS):
        xa, xc = obs(rows), obs(rows)
        outs, hids, _ = fm._launch_fwd([xa, xc], [wa, wc], [ba, bc], "elu", True, True, "K2f")
        for tag, x, ws, bs, out, hid in (("a", xa, wa, ba, outs[0], hids[0]), ("c", xc, wc, bc, outs[1], hids[1])):
            ref, ref_hid = fm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, True)
            torch.cuda.synchronize()
            errs.append(_check(f"out_{tag} rows={rows}", out, ref, rel=False))
            for i, (h, r) in enumerate(zip(hid, ref_hid)):
                errs.append(_check(f"h{i + 1}_{tag} rows={rows}", h, r, rel=False))
    xa, xc = obs(MINIBATCH_ROWS), obs(MINIBATCH_ROWS)
    k_ms = _time_ms(lambda: fm._launch_fwd([xa, xc], [wa, wc], [ba, bc], "elu", True, True, "K2f"))
    p_ms = _time_ms(lambda: [fm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, True)
                             for x, ws, bs in ((xa, wa, ba), (xc, wc, bc))])
    with torch.enable_grad():
        l_ms = _time_ms(lambda: _library_fwd([xa, xc], [wa16, wc16], [ba16, bc16], True))
    bound, by = _bound_ms(*_chain_work(MINIBATCH_ROWS, 2, False, True, False))
    print(f"    rows=24576: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={bound:.4f} ({by})")
    fields = _chain_forward_fields("K2f", lambda: fm._launch_fwd([xa, xc], [wa, wc], [ba, bc], "elu", True, True,
                                                                 "K2f"), WIDTHS, MINIBATCH_ROWS, 2, k_ms)
    results["K2f"] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=l_ms,
                          shape="2 x 24576 x 48-512-256-128", **fields)

    # -- K2b: pair backward, skip_input_grad (every minibatch); K1b: single chain with dX
    for key, chains, skip in (("K2b", 2, True), ("K1b", 1, False)):
        print(f"[kernels] {key} mlp_chain_bwd x{chains}{' (skip_input_grad)' if skip else ''}")
        wss, bss = [wa, wc][:chains], [ba, bc][:chains]
        fwd_key = "K2f" if chains == 2 else "K1f"
        errs = []
        for rows in (MINIBATCH_ROWS, RAGGED_ROWS):
            xs = [obs(rows) for _ in range(chains)]
            gs = [cotangent(rows) for _ in range(chains)]
            outs, hids, _ = fm._launch_fwd(xs, wss, bss, "elu", True, True, fwd_key)
            hss = [[*h, o] for h, o in zip(hids, outs)]
            got = fm._launch_bwd(xs, gs, wss, hss, "elu", True, skip, key)
            for c, (dx, dws, dbs, _) in enumerate(got):
                rdx, rdws, rdbs = fm.mlp_chain_bwd_plain(xs[c], gs[c], wss[c], hss[c], "elu", True, skip)
                torch.cuda.synchronize()
                for l, (a, b) in enumerate(zip(dws, rdws)):
                    errs.append(_check(f"dW{l}[{c}] rows={rows}", a, b, rel=True))
                for l, (a, b) in enumerate(zip(dbs, rdbs)):
                    errs.append(_check(f"db{l}[{c}] rows={rows}", a, b, rel=True))
                if skip:
                    assert dx is None
                else:
                    errs.append(_check(f"dx[{c}] rows={rows}", dx, rdx, rel=True))
        xs = [obs(MINIBATCH_ROWS) for _ in range(chains)]
        gs = [cotangent(MINIBATCH_ROWS) for _ in range(chains)]
        outs, hids, _ = fm._launch_fwd(xs, wss, bss, "elu", True, True, fwd_key)
        hss = [[*h, o] for h, o in zip(hids, outs)]
        k_ms = _time_ms(lambda: fm._launch_bwd(xs, gs, wss, hss, "elu", True, skip, key))
        p_ms = _time_ms(lambda: [fm.mlp_chain_bwd_plain(xs[c], gs[c], wss[c], hss[c], "elu", True, skip)
                                 for c in range(chains)])
        with torch.enable_grad():
            lib_w = [wa16, wc16][:chains]
            lib_b = [ba16, bc16][:chains]
            lib_x = [x.clone().requires_grad_(not skip) for x in xs]
            lib_out = _library_fwd(lib_x, lib_w, lib_b, True)
            inputs = [p for ws_, bs_ in zip(lib_w, lib_b) for p in (*ws_, *bs_)] + ([] if skip else lib_x)
            l_ms = _time_ms(lambda: torch.autograd.grad(lib_out, inputs, gs, retain_graph=True))
        bound, by = _bound_ms(*_chain_work(MINIBATCH_ROWS, chains, True, True, not skip))
        print(f"    rows=24576: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"bound_ms={bound:.4f} ({by})")
        phases = _backward_phases(key, lambda: fm._launch_bwd(xs, gs, wss, hss, "elu", True, skip, key),
                                  MINIBATCH_ROWS, chains, MLP_DW_SHAPES, MLP_DW_BYTES_PER_ROW,
                                  chains * sum(WIDTHS[1:]),
                                  _sum_work(*[_chain_phase1_work(WIDTHS, skip)] * chains),
                                  _chain_phase1_plan(key, WIDTHS, MINIBATCH_ROWS, chains, skip))
        results[key] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
                            library_ms=l_ms, shape=f"{chains} x 24576 x 48-512-256-128", **phases)
    return results


A_DIM, V_DIM = 12, 1  # Velocity-Rough: 12-D actions, one value


def _head_params(generator, device):
    """(mean head, value head): fp32 ``[out, 128]`` weights and ``[out]`` biases."""
    import torch

    return [((torch.randn(d, WIDTHS[-1], generator=generator) * 0.2).to(device),
             (torch.randn(d, generator=generator) * 0.1).to(device)) for d in (A_DIM, V_DIM)]


def _heads_work(rows: int, backward: bool, save: bool, expose: bool, loss: bool, loss_clip: bool):
    """(FLOP, bytes) of K8f / K8b / K9s: both chains plus the fp32 heads; each
    input read once, each output written once."""
    pairs = [(WIDTHS[i], WIDTHS[i + 1]) for i in range(len(WIDTHS) - 1)]
    macs = sum(a * b for a, b in pairs)
    params = macs + sum(b for _, b in pairs)
    hidden = sum(b for _, b in pairs)  # h_1 .. h_L (the latent included)
    head_macs = (A_DIM + V_DIM) * WIDTHS[-1]
    head_params = head_macs + A_DIM + V_DIM
    if not backward:
        flops = 2 * rows * (2 * macs + head_macs)
        nbytes = (2 * rows * WIDTHS[0] * 4 + (2 * params + head_params) * 4 + rows * (A_DIM + V_DIM) * 4
                  + (2 * rows * hidden * 2 if save else 0))
        return flops, nbytes
    dx_macs = macs - WIDTHS[0] * WIDTHS[1]  # skip_input_grad
    flops = 2 * rows * (2 * (macs + dx_macs) + 2 * head_macs)
    nbytes = (2 * rows * WIDTHS[0] * 4 + 2 * rows * hidden * 2 + 2 * macs * 4 + head_macs * 4  # x, saved h, W
              + (2 * params + head_params) * 4)  # dW, db, head gradients
    if loss:  # action, old logp, advantage, returns (+ old value), std; dstd and four sums
        nbytes += rows * (A_DIM + 2 + V_DIM * (2 if loss_clip else 1)) * 4 + head_params * 4 + A_DIM * 8 + 16
    else:  # head cotangents (+ the latent's)
        nbytes += rows * (A_DIM + V_DIM + (WIDTHS[-1] if expose else 0)) * 4
    return flops, nbytes


def _library_heads(xs, wss16, bss16, heads):
    """Yardstick: the bf16 F.linear + ELU chains, then the fp32 heads."""
    outs = _library_fwd(xs, wss16, bss16, True)
    return [o.float() @ w.T + b for o, (w, b) in zip(outs, heads)]


def _library_loss(xs, wss16, bss16, heads, std, rows_data, loss_clip):
    """Yardstick for K9s: the chains, heads and PPO + value loss as PyTorch ops."""
    import torch

    action, old_logp, adv, old_value, ret = rows_data
    mean, vhat = _library_heads(xs, wss16, bss16, heads)
    z = (action - mean) / std
    logp = torch.sum(-0.5 * z.square() - torch.log(std) - 0.9189385332046727, -1)
    ratio = torch.exp(logp - old_logp)
    surrogate = -torch.minimum(adv * ratio, adv * torch.clamp(ratio, 0.8, 1.2)).mean()
    if loss_clip is None:
        value_loss = (vhat - ret).square().mean()
    else:
        clipped = old_value + torch.clamp(vhat - old_value, -loss_clip, loss_clip)
        value_loss = torch.maximum((vhat - ret).square(), (clipped - ret).square()).mean()
    return surrogate + 0.5 * value_loss


def _loss_rows(generator, device, rows, mean):
    """Rollout rows for K9s near the policy ``mean``, so the clip is exercised."""
    import torch

    std = torch.exp(torch.randn(A_DIM, generator=generator) * 0.2).to(device)
    action = mean + std * torch.randn(rows, A_DIM, generator=generator).to(device)
    old_logp = (-0.5 * ((action - mean) / std).square() - torch.log(std) - 0.9189385332046727).sum(-1)
    old_logp = old_logp + (torch.randn(rows, generator=generator) * 0.2).to(device)
    adv = torch.randn(rows, generator=generator).to(device)
    old_value = torch.randn(rows, V_DIM, generator=generator).to(device)
    ret = torch.randn(rows, V_DIM, generator=generator).to(device)
    return std, (action, old_logp, adv, old_value, ret)


def _check_sums(name, got, want, tol: float = 1e-4) -> float:
    """Scalars against their plain values within ``tol * max(1, |want|)``:
    the four K9s loss sums are fp32 sums over all rows in another order
    (1e-4); the loss and its metrics from a forward of their own on each side
    differ by bf16 roundings of the activations (2e-3, the JAX test's)."""
    err = (got - want).abs().max().item()
    limit = tol * max(1.0, want.abs().max().item())
    print(f"    {name:28s} max_abs_err={err:.3e} (limit {limit:.3e}) {'ok' if err <= limit else 'MISMATCH'}")
    if not (err <= limit):
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max_abs_err {err:.3e})")
    return err


def check_head_kernels(device) -> dict:
    """K8f, K8b and K9s against their plain versions at the main-path shape
    (24,576 rows) and a ragged one (1,000), with times and bounds."""
    import torch

    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm
    from cusrl_tpu_torch.nn.kernels import fused_ppo_step as fp

    gen = torch.Generator().manual_seed(SEED + 5)
    wa, ba = _params(gen, device)
    wc, bc = _params(gen, device)
    heads = _head_params(gen, device)
    w16 = [[w.to(torch.bfloat16).requires_grad_() for w in ws] for ws in (wa, wc)]
    b16 = [[b.to(torch.bfloat16).requires_grad_() for b in bs] for bs in (ba, bc)]
    lib_heads = [(w.clone().requires_grad_(), b.clone().requires_grad_()) for w, b in heads]
    results = {}

    def obs(rows):
        return [torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(device) for _ in range(2)]

    # -- K8f: both chains + fp32 heads, without and with saved activations
    print("[kernels] K8f mlp_chain_fwd x2 + heads")
    errs = []
    for rows in (MINIBATCH_ROWS, RAGGED_ROWS):
        xs = obs(rows)
        for save in (False, True):
            outs, hids, head_outs = fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, save, "K8f", heads=heads)
            for c, (tag, x, ws, bs, (w, b)) in enumerate(zip("ac", xs, (wa, wc), (ba, bc), heads)):
                ref, ref_lat, ref_hid = fm.pair_heads_fwd_plain(x, ws, bs, w, b, "elu", True, save)
                torch.cuda.synchronize()
                errs.append(_check(f"head_{tag} save={int(save)} rows={rows}", head_outs[c], ref, rel=False))
                if save:
                    errs.append(_check(f"latent_{tag} rows={rows}", outs[c], ref_lat, rel=False))
                    for i, (h, r) in enumerate(zip(hids[c], ref_hid)):
                        errs.append(_check(f"h{i + 1}_{tag} rows={rows}", h, r, rel=False))
                elif outs[c] is not None:
                    raise AssertionError("K8f without save wrote the latent")
    xs = obs(MINIBATCH_ROWS)
    timing = {}
    for save in (False, True):
        timing[save] = (
            _time_ms(lambda: fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, save, "K8f", heads=heads)),
            _time_ms(lambda: [fm.pair_heads_fwd_plain(x, ws, bs, w, b, "elu", True, save)
                              for x, ws, bs, (w, b) in zip(xs, (wa, wc), (ba, bc), heads)]),
            _bound_ms(*_heads_work(MINIBATCH_ROWS, False, save, False, False, False)),
        )
    with torch.no_grad():
        l_ms = _time_ms(lambda: _library_heads(xs, w16, b16, lib_heads))
    device_fields = {}
    for save, (k_ms, p_ms, (bound, by)) in timing.items():
        print(f"    rows=24576 save={int(save)}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"bound_ms={bound:.4f} ({by})")
        device_fields[save] = _chain_forward_fields(
            f"K8f save={int(save)}", lambda: fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, save, "K8f",
                                                            heads=heads), WIDTHS, MINIBATCH_ROWS, 2, k_ms, heads=True)
    k_ms, p_ms, (bound, by) = timing[True]  # the grad path saves (path B)
    results["K8f"] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=l_ms,
                          shape="2 x 24576 x 48-512-256-128 + heads 12/1, saves h", primal_ms=timing[False][0],
                          primal_bound_ms=timing[False][2][0], **device_fields[True],
                          **{f"primal_{k}": v for k, v in device_fields[False].items()})

    # -- K8b: heads' backward + both chains, skip_input_grad, with and without the latent's cotangent
    print("[kernels] K8b mlp_chain_bwd x2 + heads (skip_input_grad)")
    errs = []
    for rows in (MINIBATCH_ROWS, RAGGED_ROWS):
        xs = obs(rows)
        outs, hids, _ = fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, True, "K8f", heads=heads)
        hss = [[*h, o] for h, o in zip(hids, outs)]
        gm = (torch.randn(rows, A_DIM, generator=gen) * 0.01).to(device)
        gv = (torch.randn(rows, V_DIM, generator=gen) * 0.01).to(device)
        gl = (torch.randn(rows, WIDTHS[-1], generator=gen) * 0.01).to(device)
        for expose in (False, True):
            spec = [(heads[0][0], None, gm, gl if expose else None), (heads[1][0], None, gv, None)]
            got = fm._launch_bwd(xs, None, [wa, wc], hss, "elu", True, True, "K8b", heads=spec)
            for c, (_, dws, dbs, (dwh, dbh)) in enumerate(got):
                d, rdwh, rdbh = fm.head_bwd_plain(hss[c][-1], spec[c][2], spec[c][0], spec[c][3])
                _, rdws, rdbs = fm.mlp_chain_bwd_plain(xs[c], d, (wa, wc)[c], hss[c], "elu", True, True)
                torch.cuda.synchronize()
                tag = f"[{c}] expose={int(expose)} rows={rows}"
                for l, (a, b) in enumerate(zip([*dws, *dbs], [*rdws, *rdbs])):
                    errs.append(_check(f"{'dW' if l < len(dws) else 'db'}{l % len(dws)}{tag}", a, b, rel=True))
                errs.append(_check(f"dW_head{tag}", dwh, rdwh, rel=True))
                errs.append(_check(f"db_head{tag}", dbh, rdbh, rel=True))
    # Timed at the main-path shape (the loop above ended on the ragged one).
    xs = obs(MINIBATCH_ROWS)
    outs, hids, _ = fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, True, "K8f", heads=heads)
    hss = [[*h, o] for h, o in zip(hids, outs)]
    gm = (torch.randn(MINIBATCH_ROWS, A_DIM, generator=gen) * 0.01).to(device)
    gv = (torch.randn(MINIBATCH_ROWS, V_DIM, generator=gen) * 0.01).to(device)
    spec = [(heads[0][0], None, gm, None), (heads[1][0], None, gv, None)]
    k_ms = _time_ms(lambda: fm._launch_bwd(xs, None, [wa, wc], hss, "elu", True, True, "K8b", heads=spec))
    p_ms = _time_ms(lambda: [fm.mlp_chain_bwd_plain(xs[c], fm.head_bwd_plain(hss[c][-1], spec[c][2], spec[c][0])[0],
                                                    (wa, wc)[c], hss[c], "elu", True, True) for c in range(2)])
    with torch.enable_grad():
        mean, vhat = _library_heads(xs, w16, b16, lib_heads)
        inputs = [p for ws, bs in zip(w16, b16) for p in (*ws, *bs)] + [t for h in lib_heads for t in h]
        l_ms = _time_ms(lambda: torch.autograd.grad([mean, vhat], inputs, [gm, gv], retain_graph=True))
    bound, by = _bound_ms(*_heads_work(MINIBATCH_ROWS, True, True, False, False, False))
    print(f"    rows=24576: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={bound:.4f} ({by})")
    head_cols = 2 * sum(WIDTHS[1:]) + (A_DIM + V_DIM) * (WIDTHS[-1] + 1)
    phases = _backward_phases("K8b", lambda: fm._launch_bwd(xs, None, [wa, wc], hss, "elu", True, True, "K8b",
                                                            heads=spec),
                              MINIBATCH_ROWS, 2, MLP_DW_SHAPES, MLP_DW_BYTES_PER_ROW, head_cols,
                              _sum_work(_chain_phase1_work(WIDTHS, True, A_DIM), _chain_phase1_work(WIDTHS, True, V_DIM)),
                              _chain_phase1_plan("K8b", WIDTHS, MINIBATCH_ROWS, 2, True, 1, A_DIM))
    results["K8b"] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=l_ms,
                          shape="2 x 24576 x 48-512-256-128 + heads 12/1, skip_input_grad", **phases)

    # -- K9s: heads + PPO/value loss + analytic backward on K2f's saved activations
    print("[kernels] K9s mlp_chain_bwd x2 + heads + PPO loss")
    errs = []
    (wm, bm), (wv, bv) = heads
    for rows in (MINIBATCH_ROWS, RAGGED_ROWS):
        xs = obs(rows)
        outs, hids, _ = fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, True, "K2f")
        hss = [[*h, o] for h, o in zip(hids, outs)]
        std, rows_data = _loss_rows(gen, device, rows, outs[0].float() @ wm.T + bm)
        for loss_clip in (None, 0.2):
            args = (xs, hss, [wa, wc], wm, bm, wv, bv, std, *rows_data, 0.2, 1.0, 0.5, loss_clip, "elu", True)
            got, sums = fp._loss_bwd(*args)
            want, ref_sums = fp.ppo_loss_bwd_plain(*args)
            torch.cuda.synchronize()
            names = ["dW_a", "db_a", "dW_c", "db_c"]
            tag = f" clip={loss_clip} rows={rows}"
            # A row whose ratio lies within an fp32 rounding of a clip bound
            # takes the other branch of the clipped surrogate on one side: one
            # row's gradient, up to ~1% of the largest element at 24,576 rows
            # (seen once on an H100; otherwise the two agree to ~3e-4).  The
            # limit is the JAX package's own kernel-against-reference rtol,
            # 3e-2 (tests/test_fused_ppo_step.py:92).
            for name, a_list, b_list in zip(names, got[:4], want[:4]):
                for l, (a, b) in enumerate(zip(a_list, b_list)):
                    errs.append(_check(f"{name}{l}{tag}", a, b, rel=True, grad_rel=3e-2))
            for name, a, b in zip(("dW_mean", "db_mean", "dW_value", "db_value", "dstd"), got[4:], want[4:]):
                errs.append(_check(name + tag, a, b, rel=True, grad_rel=3e-2))
            # max_abs_err counts the sums' error per row (the loss's scale).
            errs.append(_check_sums("sums" + tag, sums, ref_sums) / rows)
    xs = obs(MINIBATCH_ROWS)  # timed at the main-path shape
    outs, hids, _ = fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, True, "K2f")
    hss = [[*h, o] for h, o in zip(hids, outs)]
    std, rows_data = _loss_rows(gen, device, MINIBATCH_ROWS, outs[0].float() @ wm.T + bm)
    timing = {}
    for loss_clip in (None, 0.2):
        args = (xs, hss, [wa, wc], wm, bm, wv, bv, std, *rows_data, 0.2, 1.0, 0.5, loss_clip, "elu", True)
        with torch.enable_grad():
            lib_std = std.clone().requires_grad_()
            loss = _library_loss(xs, w16, b16, lib_heads, lib_std, rows_data, loss_clip)
            inputs = [p for ws, bs in zip(w16, b16) for p in (*ws, *bs)] + [t for h in lib_heads for t in h] + [lib_std]
            l_ms = _time_ms(lambda: torch.autograd.grad(loss, inputs, retain_graph=True))
        timing[loss_clip] = (_time_ms(lambda: fp._loss_bwd(*args)), _time_ms(lambda: fp.ppo_loss_bwd_plain(*args)),
                             l_ms, _bound_ms(*_heads_work(MINIBATCH_ROWS, True, True, False, True, loss_clip)))
    for loss_clip, (k_ms, p_ms, l_ms, (bound, by)) in timing.items():
        print(f"    rows=24576 loss_clip={loss_clip}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"bound_ms={bound:.4f} ({by})")
    k_ms, p_ms, l_ms, (bound, by) = timing[None]  # the zoo's value loss is unclipped
    loss_cols = head_cols + 4 + A_DIM  # the four loss sums and dstd
    args = (xs, hss, [wa, wc], wm, bm, wv, bv, std, *rows_data, 0.2, 1.0, 0.5, None, "elu", True)
    # The loss rows read: action, old log-prob and advantage (actor); returns (critic).
    k9s_work = _sum_work(_chain_phase1_work(WIDTHS, True, A_DIM, 4 * A_DIM + 8), _chain_phase1_work(WIDTHS, True, V_DIM, 4))
    phases = _backward_phases("K9s", lambda: fp._loss_bwd(*args), MINIBATCH_ROWS, 2, MLP_DW_SHAPES,
                              MLP_DW_BYTES_PER_ROW, loss_cols, k9s_work,
                              _chain_phase1_plan("K9s", WIDTHS, MINIBATCH_ROWS, 2, True, 2, A_DIM))
    results["K9s"] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=l_ms,
                          shape="2 x 24576 x 48-512-256-128 + heads 12/1 + PPO loss, loss_clip None", **phases)

    # -- K9m: both chains' forward, heads, loss and backward in one launch
    print("[kernels] K9m mlp_ppo_step (mono): forward + heads + PPO loss + backward")
    errs = []
    for rows in (MINIBATCH_ROWS, RAGGED_ROWS):
        xs = obs(rows)
        with torch.no_grad():
            mean = fm.mlp_chain_fwd_plain(xs[0], wa, ba, "elu", True, False)[0].float() @ wm.T + bm
        std, rows_data = _loss_rows(gen, device, rows, mean)
        for loss_clip in (None, 0.2):
            tail = (wm, bm, wv, bv, std, *rows_data, 0.2, 1.0, 0.5, loss_clip, "elu", True)
            got, sums, saved = fp._ppo_step(xs, [ba, bc], [wa, wc], *tail)
            tag = f" clip={loss_clip} rows={rows}"
            # The forward: the activations K9m wrote against the plain forward.
            for c, (x, ws, bs, hs) in enumerate(zip(xs, (wa, wc), (ba, bc), saved)):
                out, hidden = fm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, True)
                torch.cuda.synchronize()
                for i, (h, r) in enumerate(zip(hs, [*hidden, out])):
                    errs.append(_check(f"h{i + 1}[{c}]{tag}", h, r, rel=False))
            # The loss and backward: against the plain loss backward on those
            # activations, at K9s's limits; and against K2f + K9s.
            want, ref_sums = fp.ppo_loss_bwd_plain(xs, saved, [wa, wc], *tail)
            outs, hids, _ = fm._launch_fwd(xs, [wa, wc], [ba, bc], "elu", True, True, "K2f")
            split, split_sums = fp._loss_bwd(xs, [[*h, o] for h, o in zip(hids, outs)], [wa, wc], *tail)
            torch.cuda.synchronize()
            names = ["dW_a", "db_a", "dW_c", "db_c"]
            for ref_tag, ref_grads in (("", want), (" vs split", split)):
                for name, a_list, b_list in zip(names, got[:4], ref_grads[:4]):
                    for l, (a, b) in enumerate(zip(a_list, b_list)):
                        errs.append(_check(f"{name}{l}{tag}{ref_tag}", a, b, rel=True, grad_rel=3e-2))
                for name, a, b in zip(("dW_mean", "db_mean", "dW_value", "db_value", "dstd"), got[4:],
                                      ref_grads[4:]):
                    errs.append(_check(name + tag + ref_tag, a, b, rel=True, grad_rel=3e-2))
            errs.append(_check_sums("sums" + tag, sums, ref_sums) / rows)
            _check_sums("sums vs split" + tag, sums, split_sums)
            # K9m runs K2f's forward tile and K9s's backward tile: the same bits.
            split_saved = [[*h, o] for h, o in zip(hids, outs)]
            same = (all(torch.equal(h, r) for hs, rs in zip(saved, split_saved) for h, r in zip(hs, rs))
                    and all(torch.equal(a, b) for a, b in zip(_tensors(got), _tensors(split)))
                    and torch.equal(sums, split_sums))
            verdict = "the same bits as" if same else "DIFFER from"
            print(f"    activations, gradients and sums{tag}: {verdict} K2f + K9s")
            if not same:
                raise AssertionError(f"K9m{tag}: its activations, gradients or sums differ from K2f + K9s's bits")
    xs = obs(MINIBATCH_ROWS)  # timed at the main-path shape
    with torch.no_grad():
        mean = fm.mlp_chain_fwd_plain(xs[0], wa, ba, "elu", True, False)[0].float() @ wm.T + bm
    std, rows_data = _loss_rows(gen, device, MINIBATCH_ROWS, mean)
    timing = {}
    for loss_clip in (None, 0.2):
        tail = (wm, bm, wv, bv, std, *rows_data, 0.2, 1.0, 0.5, loss_clip, "elu", True)
        lib_std = std.clone().requires_grad_()
        inputs = [p for ws, bs in zip(w16, b16) for p in (*ws, *bs)] + [t for h in lib_heads for t in h] + [lib_std]

        def library(loss_clip=loss_clip, lib_std=lib_std, inputs=inputs):  # the forward, loss, autograd's backward
            with torch.enable_grad():
                loss = _library_loss(xs, w16, b16, lib_heads, lib_std, rows_data, loss_clip)
                return torch.autograd.grad(loss, inputs)

        if loss_clip is None:
            QUEUE["K9m", ""] = (functools.partial(fp._ppo_step, xs, [ba, bc], [wa, wc], *tail), library)

        timing[loss_clip] = (_time_ms(lambda: fp._ppo_step(xs, [ba, bc], [wa, wc], *tail)),
                             _time_ms(lambda: fp.ppo_step_mono_plain(xs, [ba, bc], [wa, wc], *tail)),
                             _time_ms(library), _bound_ms(*_mono_work(MINIBATCH_ROWS, loss_clip)))
    for loss_clip, (k_ms, p_ms, l_ms, (bound, by)) in timing.items():
        print(f"    rows=24576 loss_clip={loss_clip}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"bound_ms={bound:.4f} ({by})")
    k_ms, p_ms, l_ms, (bound, by) = timing[None]
    tail = (wm, bm, wv, bv, std, *rows_data, 0.2, 1.0, 0.5, None, "elu", True)
    # K9m's phase 1 also reads x (fp32) and writes every activation, and runs the forward's products.
    fwd_macs = sum(a * b for a, b in zip(WIDTHS[:-1], WIDTHS[1:]))
    k9m_work = _sum_work(k9s_work, (2 * (4 * WIDTHS[0] + 2 * sum(WIDTHS[1:])), 2 * 2 * fwd_macs))
    plan = fm.ppo_step_plan(WIDTHS, MINIBATCH_ROWS, A_DIM)
    phase1_plan = _phase1_plan("K9m", plan, "mlp_chain_bwd", f"ppo_step_kernelILi{plan['per_sm']}E",
                               f"W ({plan['fwd_images']}) and W^T")
    phases = _backward_phases("K9m", lambda: fp._ppo_step(xs, [ba, bc], [wa, wc], *tail), MINIBATCH_ROWS, 2,
                              MLP_DW_SHAPES, MLP_DW_BYTES_PER_ROW, loss_cols, k9m_work, phase1_plan)
    results["K9m"] = dict(max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=l_ms,
                          shape="2 x 24576 x 48-512-256-128 forward + heads 12/1 + PPO loss + backward, "
                                "loss_clip None", bitwise_equals_split=True, **phases)
    return results


def _mono_work(rows: int, loss_clip):
    """(FLOP, bytes) of K9m: both chains' forward and K9s's work; it reads x
    (not saved activations) and the loss rows, writes the gradients and sums."""
    pairs = [(WIDTHS[i], WIDTHS[i + 1]) for i in range(len(WIDTHS) - 1)]
    macs = sum(a * b for a, b in pairs)
    flops, nbytes = _heads_work(rows, True, True, False, True, loss_clip)
    hidden = sum(b for _, b in pairs)
    return flops + 2 * 2 * rows * macs, nbytes - 2 * rows * hidden * 2 + 2 * sum(b for _, b in pairs) * 4


def check_head_wrappers(device) -> dict:
    """``fused_mlp_pair_heads`` and ``fused_ppo_step`` under autograd at
    24,576 rows against the same calls on the CPU (their plain versions):
    outputs, the loss and its four metrics, and every ``.grad`` (``std``'s
    too).  The two sides run their own forwards, so a bf16 rounding may fall
    differently; the limits are the launcher checks'."""
    import torch

    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm
    from cusrl_tpu_torch.nn.kernels import fused_ppo_step as fp

    gen = torch.Generator().manual_seed(SEED + 6)
    rows = MINIBATCH_ROWS
    chains = [_params(gen, "cpu") for _ in range(2)]
    heads = _head_params(gen, "cpu")
    cpu_params = [t.clone() for ws, bs in chains for t in (*ws, *bs)] + [t.clone() for h in heads for t in h]
    nl = len(WIDTHS) - 1
    xs = [torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)) for _ in range(2)]
    errs = {"K8f": [], "K8b": [], "K2f": [], "K9s": []}

    def run(device_, fn):
        params = [p.detach().to(device_, copy=True).requires_grad_() for p in cpu_params]
        wa, ba, wc, bc = params[:nl], params[nl:2 * nl], params[2 * nl:3 * nl], params[3 * nl:4 * nl]
        before = dict(fm.LAUNCHES)
        outs = fn(device_, [x.to(device_) for x in xs], wa, ba, wc, bc, *params[4 * nl:])
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in fm.LAUNCHES.items() if v != before[k]}
        return outs, params, launched

    for expose in (False, True):
        print(f"[wrappers] fused_mlp_pair_heads, expose_latent={expose}, rows={rows}")
        gm = torch.randn(rows, A_DIM, generator=gen) * 0.01
        gv = torch.randn(rows, V_DIM, generator=gen) * 0.01
        gl = (torch.randn(rows, WIDTHS[-1], generator=gen) * 0.01).to(torch.bfloat16)

        def heads_fn(device_, xs_, wa, ba, wc, bc, wm, bm, wv, bv):
            outs = fm.fused_mlp_pair_heads(*xs_, wa, ba, wc, bc, wm, bm, wv, bv, expose_latent=expose)
            grads = [gm, gv, gl][:len(outs)]
            torch.autograd.backward(list(outs), [g.to(device_) for g in grads])
            return outs

        (got, params, launched), (want, cpu_ref, _) = run(device, heads_fn), run("cpu", heads_fn)
        if launched != {"K8f": 1, "K8b": 1}:
            raise AssertionError(f"fused_mlp_pair_heads launched {launched}, not K8f and K8b once each")
        for name, a, b in zip(("mean", "value", "latent"), got, want):
            errs["K8f"].append(_check(f"{name} expose={int(expose)}", a.cpu(), b, rel=False))
        for i, (p, q) in enumerate(zip(params, cpu_ref)):
            errs["K8b"].append(_check(f"param{i}.grad expose={int(expose)}", p.grad.cpu(), q.grad, rel=True))

    print(f"[wrappers] fused_ppo_step, rows={rows}")
    mean = fm.pair_heads_fwd_plain(xs[0], chains[0][0], chains[0][1], *heads[0], "elu", True, False)[0]
    std, rows_data = _loss_rows(gen, "cpu", rows, mean)

    def step_fn(device_, xs_, wa, ba, wc, bc, wm, bm, wv, bv):
        s = std.detach().to(device_, copy=True).requires_grad_()
        loss, metrics = fp.fused_ppo_step(*xs_, wa, ba, wc, bc, wm, bm, wv, bv, s,
                                          *(t.to(device_) for t in rows_data), 0.2, 1.0, 0.5)
        if any(m.requires_grad for m in metrics):
            raise AssertionError("a metric of fused_ppo_step carries a gradient")
        loss.backward()
        return loss, metrics, s

    ((loss, metrics, s), params, launched), ((c_loss, c_metrics, c_s), cpu_ref, _) = (
        run(device, step_fn), run("cpu", step_fn))
    if launched != {"K2f": 1, "K9s": 1}:
        raise AssertionError(f"fused_ppo_step launched {launched}, not K2f and K9s once each")
    errs["K9s"].append(_check_sums("loss, 4 metrics", torch.stack([loss, *metrics]).detach().cpu(),
                                   torch.stack([c_loss, *c_metrics]).detach(), tol=2e-3))
    # The two forwards round differently, and a row whose ratio sits at a
    # clip bound can take the other branch of the clipped surrogate: 3e-2 of
    # the largest gradient (the JAX package's own kernel-against-reference
    # rtol, tests/test_fused_ppo_step.py:92).
    for i, (p, q) in enumerate(zip([*params, s], [*cpu_ref, c_s])):
        errs["K9s"].append(_check(f"param{i}.grad" if i < len(params) else "std.grad", p.grad.cpu(), q.grad,
                                  rel=True, grad_rel=3e-2))

    print(f"[wrappers] fused_ppo_step in mono mode, rows={rows}: against the CPU (its plain version) and split")
    split = (loss, metrics, s, params)
    with _ppo_mode("mono"):
        ((loss, metrics, s), params, launched), ((c_loss, c_metrics, c_s), cpu_ref, _) = (
            run(device, step_fn), run("cpu", step_fn))
    if launched != {"K9m": 1}:
        raise AssertionError(f"fused_ppo_step in mono mode launched {launched}, not K9m once")
    errs["K9m"] = []
    values = torch.stack([loss, *metrics]).detach().cpu()
    for tag, (r_loss, r_metrics, r_s, r_params) in (("cpu", (c_loss, c_metrics, c_s, cpu_ref)), ("split", split)):
        errs["K9m"].append(_check_sums(f"loss, 4 metrics vs {tag}", values,
                                       torch.stack([r_loss, *r_metrics]).detach().cpu(), tol=2e-3))
        for i, (p, q) in enumerate(zip([*params, s], [*r_params, r_s])):
            errs["K9m"].append(_check(f"{'std' if i == len(params) else f'param{i}'}.grad vs {tag}", p.grad.cpu(),
                                      q.grad.cpu(), rel=True, grad_rel=3e-2))
    return {k: max(v) for k, v in errs.items() if v}


@contextlib.contextmanager
def _ppo_mode(mode: str):
    """Sets the port's fused PPO step mode (``fused_ppo_step._PPO_MODE``, the
    module attribute ``CUSRL_TPU_PPO_MODE`` sets at import) for the block."""
    from cusrl_tpu_torch.nn.kernels import fused_ppo_step as fp

    old = fp._PPO_MODE
    fp._PPO_MODE = mode
    try:
        yield
    finally:
        fp._PPO_MODE = old


def check_wrappers(device) -> dict:
    """The wrappers the port calls (``fused_mlp``, ``fused_mlp_pair`` and
    their autograd Functions) against the plain versions at main-path shapes:
    outputs, and every parameter's ``.grad`` after ``backward`` with a fixed
    cotangent.  This holds the layer above the launchers: the gradient order,
    the zero cotangent of an unused output, the ``skip_input_grad`` decision
    and the dtype casts.  Returns the largest error per kernel."""
    import torch

    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED + 3)
    errs = {"K1f": [], "K1b": [], "K2f": [], "K2b": []}

    def leaf_params():
        ws, bs = _params(gen, device)
        return [w.requires_grad_() for w in ws], [b.requires_grad_() for b in bs]

    def obs(rows):
        return torch.tanh(torch.randn(rows, WIDTHS[0], generator=gen)).to(device)

    def cotangent(rows):
        return (torch.randn(rows, WIDTHS[-1], generator=gen) * 0.01).to(device, torch.bfloat16)

    def plain(x, ws, bs, g, skip):
        with torch.no_grad():
            out, hid = fm.mlp_chain_fwd_plain(x, ws, bs, "elu", True, True)
            return out, fm.mlp_chain_bwd_plain(x, g, ws, [*hid, out], "elu", True, skip)

    def grads(key, tag, ws, bs, want_dws, want_dbs):
        for l, (w, want) in enumerate(zip(ws, want_dws)):
            errs[key].append(_check(f"{tag} W{l}.grad", w.grad, want, rel=True))
        for l, (b, want) in enumerate(zip(bs, want_dbs)):
            errs[key].append(_check(f"{tag} b{l}.grad", b.grad, want, rel=True))

    # fused_mlp without grad: the rollout actor (4,096 rows) and the
    # whole-rollout passes (98,304 rows); the primal launch saves nothing.
    print("[wrappers] fused_mlp, no grad")
    wa, ba = leaf_params()
    for rows in (NUM_ENVS, NUM_ENVS * STEPS):
        x = obs(rows)
        before = fm.LAUNCHES["K1f"]
        with torch.no_grad():
            out = fm.fused_mlp(x, wa, ba)
        ref, _ = fm.mlp_chain_fwd_plain(x, wa, ba, "elu", True, False)
        if fm.LAUNCHES["K1f"] != before + 1:
            raise AssertionError("fused_mlp did not launch K1f")
        errs["K1f"].append(_check(f"out rows={rows}", out, ref, rel=False))

    # fused_mlp with grad, the input too: K1f saving hiddens, then K1b with dX.
    print("[wrappers] fused_mlp, grad of input and parameters")
    x = obs(RAGGED_ROWS).requires_grad_()
    g = cotangent(RAGGED_ROWS)
    before = dict(fm.LAUNCHES)
    out = fm.fused_mlp(x, wa, ba)
    out.backward(g)
    if fm.LAUNCHES["K1f"] != before["K1f"] + 1 or fm.LAUNCHES["K1b"] != before["K1b"] + 1:
        raise AssertionError("fused_mlp with grad did not launch K1f and K1b once each")
    ref, (rdx, rdws, rdbs) = plain(x.detach(), wa, ba, g, False)
    errs["K1f"].append(_check(f"out rows={RAGGED_ROWS}", out, ref, rel=False))
    if x.grad is None or x.grad.dtype != x.dtype:
        raise AssertionError("fused_mlp returned no input gradient of the input's dtype")
    errs["K1b"].append(_check(f"x.grad rows={RAGGED_ROWS}", x.grad, rdx, rel=True))
    grads("K1b", f"rows={RAGGED_ROWS}", wa, ba, rdws, rdbs)

    # fused_mlp_pair as joint evaluation calls it: data inputs, parameters
    # that need grad, skip_input_grad=True; then only the actor's output used,
    # so the critic's cotangent is the zero fill.
    for rows in (MINIBATCH_ROWS, RAGGED_ROWS):
        print(f"[wrappers] fused_mlp_pair, skip_input_grad, rows={rows}")
        wa, ba = leaf_params()
        wc, bc = leaf_params()
        xa, xc = obs(rows), obs(rows)
        ga, gc = cotangent(rows), cotangent(rows)
        before = dict(fm.LAUNCHES)
        out_a, out_c = fm.fused_mlp_pair(xa, xc, wa, ba, wc, bc, skip_input_grad=True)
        torch.autograd.backward([out_a, out_c], [ga, gc])
        if fm.LAUNCHES["K2f"] != before["K2f"] + 1 or fm.LAUNCHES["K2b"] != before["K2b"] + 1:
            raise AssertionError("fused_mlp_pair did not launch K2f and K2b once each")
        for tag, x, ws, bs, g, out in (("a", xa, wa, ba, ga, out_a), ("c", xc, wc, bc, gc, out_c)):
            ref, (rdx, rdws, rdbs) = plain(x, ws, bs, g, True)
            if rdx is not None:
                raise AssertionError("plain backward returned an input gradient under skip_input_grad")
            errs["K2f"].append(_check(f"out_{tag} rows={rows}", out, ref, rel=False))
            grads("K2b", f"{tag} rows={rows}", ws, bs, rdws, rdbs)
        if rows != MINIBATCH_ROWS:
            continue
        for p in (*wa, *ba, *wc, *bc):
            p.grad = None
        out_a, _ = fm.fused_mlp_pair(xa, xc, wa, ba, wc, bc, skip_input_grad=True)
        out_a.backward(ga)
        _, (_, rdws, rdbs) = plain(xa, wa, ba, ga, True)
        grads("K2b", f"a, c unused rows={rows}", wa, ba, rdws, rdbs)
        for p in (*wc, *bc):
            if p.grad is not None and p.grad.abs().max().item() != 0.0:
                raise AssertionError("an unused output's zero cotangent gave a non-zero gradient")
        print("    c unused: critic gradients are zero")

    # Path T's chains as its modules call fused_mlp: the FFN (128-512-128
    # gelu, no trailing activation) and the MLP head (128->128 ELU), both on
    # bf16 inputs; with grad at the minibatch's 6,144 rows (K1f saving the
    # pre-activations or hiddens, K1b with dX), without at the rollout step's
    # 1,024 and the value and KL passes' 24,576.
    rows_mb = T_MB_ENVS * STEPS
    for tag, widths, activation, trailing in (("ffn gelu", FFN_WIDTHS, "gelu", False),
                                              ("head elu", (T_EMBED, T_EMBED), "elu", True)):
        ws = [(torch.randn(b, a, generator=gen) / math.sqrt(a)).to(device).requires_grad_()
              for a, b in zip(widths, widths[1:])]
        bs = [(torch.randn(b, generator=gen) * 0.1).to(device).requires_grad_() for b in widths[1:]]
        print(f"[wrappers] fused_mlp {tag} {'-'.join(map(str, widths))}, no grad")
        for rows in (T_ENVS, T_ENVS * STEPS):
            x = torch.randn(rows, widths[0], generator=gen).to(device, torch.bfloat16)
            before = fm.LAUNCHES["K1f"]
            with torch.no_grad():
                out = fm.fused_mlp(x, ws, bs, activation, trailing)
            if fm.LAUNCHES["K1f"] != before + 1:
                raise AssertionError(f"fused_mlp {tag} did not launch K1f once")
            ref, _ = fm.mlp_chain_fwd_plain(x, ws, bs, activation, trailing, False)
            errs["K1f"].append(_check(f"{tag} out rows={rows}", out, ref, rel=False))
        print(f"[wrappers] fused_mlp {tag}, grad of input and parameters, rows={rows_mb}")
        x = torch.randn(rows_mb, widths[0], generator=gen).to(device, torch.bfloat16).requires_grad_()
        g = (torch.randn(rows_mb, widths[-1], generator=gen) * 0.01).to(device, torch.bfloat16)
        before = dict(fm.LAUNCHES)
        out = fm.fused_mlp(x, ws, bs, activation, trailing)
        out.backward(g)
        if fm.LAUNCHES["K1f"] != before["K1f"] + 1 or fm.LAUNCHES["K1b"] != before["K1b"] + 1:
            raise AssertionError(f"fused_mlp {tag} with grad did not launch K1f and K1b once each")
        with torch.no_grad():
            ref, hid = fm.mlp_chain_fwd_plain(x.detach(), ws, bs, activation, trailing, True)
            rdx, rdws, rdbs = fm.mlp_chain_bwd_plain(x.detach(), g, ws, [*hid, ref], activation, trailing, False)
        errs["K1f"].append(_check(f"{tag} out rows={rows_mb}", out, ref, rel=False))
        if x.grad is None or x.grad.dtype != x.dtype:
            raise AssertionError(f"fused_mlp {tag} returned no input gradient of the input's dtype")
        # The wrapper casts dX to bf16: one rounding of the fp32 value.
        errs["K1b"].append(_check(f"{tag} x.grad rows={rows_mb}", x.grad, rdx, rel=True))
        grads("K1b", f"{tag} rows={rows_mb}", ws, bs, rdws, rdbs)
    return {k: max(v) for k, v in errs.items()}


# -- Path T: the zoo's Velocity-Flat transformer_ppo entry ---------------------

T_ENVS, T_HEADS, T_HEAD_DIM, T_WINDOW, T_EMBED, T_FF = 1024, 4, 32, 16, 128, 512
T_MB_ENVS = T_ENVS // MINIBATCHES  # 256 environments x 24 steps per minibatch
FFN_WIDTHS = (T_EMBED, T_FF, T_EMBED)
PEAK_FP32_FLOPS = 67e12  # CUDA-core fp32 (the attention kernels do no tensor-core work)
# Attention outputs and gradients are fp32 sums over at most W+1 terms of the
# same bf16 inputs on both sides: only the summation order and the exp differ.
ATT_RTOL, ATT_ATOL = 1e-4, 1e-5


def _lane_inputs(gen, device, n, t_len=STEPS, window=T_WINDOW, invalid=False):
    """q/k/v bf16 in the JAX layout, segments with dones, a half-valid cache;
    with ``invalid`` a third of the environments see no valid key at all."""
    import torch

    s_len = window + t_len
    shape_q, shape_k = (n, T_HEADS, t_len, T_HEAD_DIM), (n, T_HEADS, s_len, T_HEAD_DIM)
    q = torch.randn(shape_q, generator=gen).to(device, torch.bfloat16)
    k, v = (torch.randn(shape_k, generator=gen).to(device, torch.bfloat16) for _ in range(2))
    done = torch.rand(n, t_len, generator=gen) < 0.05
    q_seg = torch.cumsum(torch.cat([torch.zeros(n, 1, dtype=torch.int32), done[:, :-1].int()], 1), 1,
                         dtype=torch.int32)
    k_seg = torch.cat([torch.zeros(n, window, dtype=torch.int32), q_seg], 1)
    k_valid = torch.cat([(torch.rand(n, window, generator=gen) < 0.5).int(), torch.ones(n, t_len, dtype=torch.int32)],
                        1)
    if invalid:
        k_valid[: n // 3] = 0
    return [t.to(device) for t in (q, k, v, q_seg, k_seg, k_valid)]


def _band_valid(q_seg, k_seg, k_valid, window: int, first: int):
    """``[N, T, W+1-first]`` bool: key ``t+j`` (j >= first) valid for query t."""
    b = window + 1
    mask = (k_seg.unfold(1, b, 1) == q_seg[:, :, None]) & (k_valid.unfold(1, b, 1) > 0)
    return mask[..., first:]


def _dense_mask(q_seg, k_seg, k_valid, window: int, first: int):
    """The same visibility as a dense ``[N, 1, T, S]`` mask (the yardstick's)."""
    import torch

    n, t_len = q_seg.shape
    s_len = k_seg.shape[1]
    t = torch.arange(t_len, device=q_seg.device)[:, None]
    s = torch.arange(s_len, device=q_seg.device)[None, :]
    band = (s >= t + first) & (s <= t + window)
    return (band[None] & (k_seg[:, None, :] == q_seg[:, :, None]) & (k_valid[:, None, :] > 0))[:, None]


def _lane_work(kind: str, q, k, masks, window: int, save: bool = False, out_bytes: int = 4):
    """(FLOP, bytes) of K3f / K3b / K6 on these inputs: each input read once,
    each output written once (K3b's dq, dk and dv at ``out_bytes`` each: 2
    for the bf16 variant the autograd wrapper takes); FLOP from the (query,
    key) pairs this data makes valid (two per multiply-add: QK and PV
    forward, four products backward)."""
    q_seg, k_seg, k_valid = masks
    heads, dim = q.shape[1], q.shape[-1]
    mask_bytes = 4 * (q_seg.numel() + k_seg.numel() + k_valid.numel())
    if kind == "K6":
        pairs = int(_band_valid(q_seg, k_seg, k_valid, window, 1).sum()) * heads + q_seg.numel() * heads
        nbytes = 2 * (3 * q.numel() + 2 * k.numel()) + mask_bytes + 4 * q.numel()
        return 4 * dim * pairs, nbytes
    pairs = int(_band_valid(q_seg, k_seg, k_valid, window, 0).sum()) * heads
    probs = q.shape[0] * heads * q.shape[2] * (window + 1)
    if kind == "K3f":
        nbytes = 2 * (q.numel() + 2 * k.numel()) + mask_bytes + 4 * q.numel() + (4 * probs if save else 0)
        return 4 * dim * pairs, nbytes
    nbytes = 2 * (q.numel() + 2 * k.numel()) + 4 * probs + 4 * q.numel() + out_bytes * (q.numel() + 2 * k.numel())
    return 8 * dim * pairs, nbytes


def _check_attention(name, got, want) -> float:
    """An attention kernel's fp32 output against its plain version within
    ``ATT_RTOL``/``ATT_ATOL``; returns the largest error."""
    import torch

    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, rtol=ATT_RTOL, atol=ATT_ATOL))
    limit = ATT_ATOL + ATT_RTOL * want.abs().max().item()
    print(f"    {name:28s} max_abs_err={err:.3e} (limit {limit:.3e}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max_abs_err {err:.3e})")
    return err


def _band_kernel_usage(stem: str, kernel: str) -> dict:
    """``{"bf16 D=32 small": (registers, spill store bytes, spill load
    bytes), ...}``: ptxas's usage of every instance of ``kernel`` (a band
    attention kernel of ``csrc/<stem>.cu``) from the build log."""
    import re

    usage = {}
    for symbol, regs in _ptxas_usage(stem).items():
        found = re.search(rf"{kernel}I(13__nv_bfloat16|f)Li(\d+)E(?:Lb(\d)E)?", symbol)
        if found:
            dtype, dim, small = found.groups()
            tag = f"{'bf16' if dtype != 'f' else 'fp32'} D={dim}" + {None: "", "1": " small", "0": " large"}[small]
            usage[tag] = regs
    return dict(sorted(usage.items()))


def _print_usage(name: str, usage: dict) -> dict:
    """Prints every instance's registers and spills; returns the main
    path's (bf16, D = 32, the instance for small blocks where there are
    two) as ``{"regs": .., "spills": "store/load B"}``."""
    print(f"    {name} ptxas: " + "; ".join(f"{tag} {r} registers, spills {st}/{ld} B"
                                          for tag, (r, st, ld) in usage.items()))
    main = usage.get("bf16 D=32 small", usage.get("bf16 D=32"))
    return {} if main is None else {"regs": main[0], "spills": f"{main[1]}/{main[2]}"}


def _only_kernel(name: str, fn, symbol: str) -> None:
    """Every device event of a profiled run of ten calls of ``fn`` (kernels,
    copies, casts, fills) must be the kernel ``symbol``'s; a session that
    records none is profiled again."""
    for _ in range(PROFILE_ATTEMPTS):
        found, seen, _ = _profiled_kernels(fn, ("",), 10, 3)
        if seen:
            break
    own = sum(count for key, count, _ in found if symbol in key)
    print(f"    {name}: device events over ten calls: {seen}, {symbol}'s {own} "
          f"({'; '.join(f'{key.split(chr(40))[0]} x{count}' for key, count, _ in found) or 'not measured'})")
    if seen != own:
        raise AssertionError(f"{name} ran {found}, not {symbol} alone")


def check_lane_kernels(device) -> dict:
    """K3f (primal and saving the probabilities), K3b and K6 against their
    plain versions at the path's shapes (the update's 256 environments, the
    value and KL passes' 1,024) and a ragged one (130 environments, T = 5,
    W = 4, ALiBi, a third of the rows with no valid key), K3b's bf16 outputs
    against its fp32 ones cast and two calls bit for bit; K3b and K6 on the
    main path's views and the autograd wrapper's backward, each one device
    event a call; then each timed with the plain version and a masked
    ``scaled_dot_product_attention`` (for K3b its autograd) as the yardstick
    the port never calls, with its device time, host time, plan, registers
    and spills."""
    import torch
    import torch.nn.functional as F

    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    gen = torch.Generator().manual_seed(SEED + 7)
    errs = {"K3f": [], "K3b": [], "K6": []}
    check = _check_attention

    print("[kernels] K3f/K3b/K6 lane attention")
    cases = ((T_MB_ENVS, STEPS, T_WINDOW, None), (T_ENVS, STEPS, T_WINDOW, None), (130, 5, 4, (0.5, 0.25, 0.125, 0.0625)))
    for n, t_len, window, slopes in cases:
        q, k, v, *masks = _lane_inputs(gen, device, n, t_len, window, invalid=slopes is not None)
        tag = f"N={n} T={t_len} W={window}{' alibi' if slopes else ''}"
        ref, ref_probs = la.lane_fwd_plain(q, k, v, *masks, window, slopes, True)
        for save in (False, True):
            out, probs = la._launch_fwd(q, k, v, *masks, window, slopes, save)
            errs["K3f"].append(check(f"K3f out save={int(save)} {tag}", out, ref))
            if save:
                errs["K3f"].append(check(f"K3f probs {tag}", probs, ref_probs))
            if slopes is not None and out[: n // 3].any():
                raise AssertionError("K3f: a row without a valid key is not exactly 0")
        g = torch.randn(q.shape, generator=gen).to(device)
        got = la._launch_bwd(q, k, v, ref_probs, g, *masks, window)
        for name, a, b in zip(("dq", "dk", "dv"), got, la.lane_bwd_plain(q, k, v, ref_probs, g, window)):
            errs["K3b"].append(check(f"K3b {name} {tag}", a, b))
        rounded = la._launch_bwd(q, k, v, ref_probs, g, *masks, window, torch.bfloat16)
        again = la._launch_bwd(q, k, v, ref_probs, g, *masks, window)
        if not all(r.dtype == torch.bfloat16 and torch.equal(r, a.to(torch.bfloat16)) for r, a in zip(rounded, got)):
            raise AssertionError(f"K3b {tag}: the bf16 outputs are not the fp32 outputs cast")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K3b {tag}: two calls gave different bits")
        if slopes is not None and any(a[: n // 3].any() for a in got):
            raise AssertionError("K3b: an environment without a valid key has a gradient that is not exactly 0")
        print(f"    K3b {tag}: bf16 outputs are the fp32 outputs cast, bit for bit; two calls, the same bits")
        k_self, v_self = (torch.randn(q.shape, generator=gen).to(device, torch.bfloat16) for _ in range(2))
        errs["K6"].append(check(f"K6 out {tag}", la._launch_next(q, k_self, v_self, k, v, *masks, window, slopes),
                                la.next_token_plain(q, k_self, v_self, k, v, *masks, window, slopes)))

    print("[wrappers] lane_window_attention (autograd) against autograd of the plain version, N=256")
    q, k, v, *masks = _lane_inputs(gen, device, T_MB_ENVS)
    g = torch.randn(q.shape, generator=gen).to(device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(la.LAUNCHES)
    out = la.lane_window_attention(*leaves, *masks, window=T_WINDOW)
    out.backward(g)
    launched = {key: la.LAUNCHES[key] - before[key] for key in before}
    if launched != {"K3f": 1, "K3b": 1, "K6": 0}:
        raise AssertionError(f"lane_window_attention with grad launched {launched}")
    plain = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref, _ = la.lane_fwd_plain(*plain, *masks, T_WINDOW, None)
    ref.backward(g)
    errs["K3f"].append(check("wrapper out", out, ref))
    for name, a, b in zip(("q", "k", "v"), leaves, plain):
        if a.grad.dtype != torch.bfloat16:
            raise AssertionError("the lane wrapper's input gradient is not in the input's dtype")
        # The wrapper's gradients are cast to bf16: one rounding of the fp32 value.
        err = (a.grad.float() - b.grad.float()).abs().max().item()
        limit = 2 ** -8 * b.grad.float().abs().max().item()
        print(f"    {name + '.grad (bf16)':28s} max_abs_err={err:.3e} (limit {limit:.3e}) "
              f"{'ok' if err <= limit else 'MISMATCH'}")
        if err > limit:
            raise AssertionError(f"lane wrapper {name}.grad disagrees with autograd of the plain version")
    # The wrapper's backward writes the inputs' dtype itself: no cast kernel.
    again = la.lane_window_attention(*leaves, *masks, window=T_WINDOW)
    _only_kernel("lane_window_attention backward (autograd.grad)",
                 lambda: torch.autograd.grad(again, leaves, g, retain_graph=True), "lane_bwd_kernel")

    print("[kernels] K3b on the main path's views, N=256: q a head-split view, the cotangent a transposed view")
    _, k, v, *masks = _lane_inputs(gen, device, T_MB_ENVS)
    proj = torch.randn(T_MB_ENVS, STEPS, 3 * T_EMBED, generator=gen).to(device, torch.bfloat16)
    q = proj[..., :T_EMBED].reshape(T_MB_ENVS, STEPS, T_HEADS, T_HEAD_DIM).transpose(1, 2)
    g = torch.randn(STEPS * T_MB_ENVS, T_EMBED, generator=gen).to(device)
    g = g.view(STEPS, T_MB_ENVS, T_HEADS, T_HEAD_DIM).permute(1, 2, 0, 3)
    _, probs = la.lane_fwd_plain(q, k, v, *masks, T_WINDOW, None, True)
    views = la._launch_bwd(q, k, v, probs, g, *masks, T_WINDOW, torch.bfloat16)
    copies = la._launch_bwd(q.contiguous(), k, v, probs, g.contiguous(), *masks, T_WINDOW, torch.bfloat16)
    if not all(torch.equal(a, b) for a, b in zip(views, copies)):
        raise AssertionError("K3b on the main path's views gave other bits than on contiguous copies")
    _only_kernel("K3b on these views", lambda: la._launch_bwd(q, k, v, probs, g, *masks, T_WINDOW, torch.bfloat16),
                 "lane_bwd_kernel")

    print("[wrappers] lane_next_token_attention against its plain version, N=1024, on the main path's views")
    q, k, v, q_seg, k_seg, k_valid = _lane_inputs(gen, device, T_ENVS)
    k_self = torch.randn(q.shape, generator=gen).to(device, torch.bfloat16)
    # As the transformer hands them over: v_self a head-split view of the
    # projection, q_seg a transposed view.
    proj = torch.randn(T_ENVS, STEPS, 3 * T_EMBED, generator=gen).to(device, torch.bfloat16)
    v_self = proj[..., 2 * T_EMBED:].reshape(T_ENVS, STEPS, T_HEADS, T_HEAD_DIM).transpose(1, 2)
    q_seg = q_seg.T.contiguous().T
    masks = (q_seg, k_seg, k_valid)
    before = dict(la.LAUNCHES)
    out = la.lane_next_token_attention(q, k_self, v_self, k, v, *masks, window=T_WINDOW)
    launched = {key: la.LAUNCHES[key] - before[key] for key in before}
    if launched != {"K3f": 0, "K3b": 0, "K6": 1}:
        raise AssertionError(f"lane_next_token_attention launched {launched}")
    errs["K6"].append(check("wrapper out", out, la.next_token_plain(q, k_self, v_self, k, v, *masks, T_WINDOW)))
    _only_kernel("lane_next_token_attention on these views",
                 lambda: la.lane_next_token_attention(q, k_self, v_self, k, v, *masks, window=T_WINDOW),
                 "lane_next_kernel")

    usage = {"K3f": _print_usage("K3f", _band_kernel_usage("lane_attention", "lane_fwd_kernel")),
             "K3b": _print_usage("K3b", _band_kernel_usage("lane_attention", "lane_bwd_kernel")),
             "K6": _print_usage("K6", _band_kernel_usage("lane_attention", "lane_next_kernel"))}
    results = {}
    for key, n in (("K3f", T_MB_ENVS), ("K3f primal", T_ENVS), ("K3b", T_MB_ENVS), ("K6", T_ENVS)):
        q, k, v, *masks = _lane_inputs(gen, device, n)
        dense = _dense_mask(*masks, T_WINDOW, 1 if key == "K6" else 0)
        if key.startswith("K3f"):
            save = key == "K3f"
            kernel = functools.partial(la._launch_fwd, q, k, v, *masks, T_WINDOW, None, save)
            k_ms = _time_ms(kernel)
            p_ms = _time_ms(lambda: la.lane_fwd_plain(q, k, v, *masks, T_WINDOW, None, save))
            with torch.no_grad():
                library = functools.partial(F.scaled_dot_product_attention, q, k, v, attn_mask=dense)
                l_ms = _time_ms(library)
            QUEUE["K3f", "primal_" if key == "K3f primal" else ""] = (kernel, library)
            flops, nbytes = _lane_work("K3f", q, k, masks, T_WINDOW, save)
            extra = _forward_device_ms(key, kernel, "lane", 1)
            extra["host_ms"] = _host_ms(kernel)
            extra["plan"] = la.fwd_card_plan(q, T_WINDOW)
            print(f"    {key} N={n}: device_ms={_ms(extra['device_ms'])} (torch.profiler) of the events' "
                  f"{k_ms:.4f} ms; the wrapper's host time {extra['host_ms']:.4f} ms a call; plan {extra['plan']}")
        elif key == "K3b":
            _, probs = la.lane_fwd_plain(q, k, v, *masks, T_WINDOW, None, True)
            g = torch.randn(q.shape, generator=gen).to(device)
            # The variant the autograd wrapper launches: bf16 gradients.
            kernel = functools.partial(la._launch_bwd, q, k, v, probs, g, *masks, T_WINDOW, torch.bfloat16)
            k_ms = _time_ms(kernel)
            p_ms = _time_ms(lambda: la.lane_bwd_plain(q, k, v, probs, g, T_WINDOW))
            lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=dense)
            gb = g.to(torch.bfloat16)
            library = functools.partial(torch.autograd.grad, lib_out, (lq, lk, lv), gb, retain_graph=True)
            l_ms = _time_ms(library)
            QUEUE[key, ""] = (kernel, library)
            flops, nbytes = _lane_work("K3b", q, k, masks, T_WINDOW, out_bytes=2)
            extra = _forward_device_ms("K3b", kernel, "lane", 1)
            extra["host_ms"] = _host_ms(kernel)
            extra["plan"] = la.bwd_card_plan(q, T_WINDOW)
            print(f"    K3b N={n}: device_ms={_ms(extra['device_ms'])} (torch.profiler) of the events' {k_ms:.4f} "
                  f"ms; the wrapper's host time {extra['host_ms']:.4f} ms a call; plan {extra['plan']}")
        else:
            k_self, v_self = (torch.randn(q.shape, generator=gen).to(device, torch.bfloat16) for _ in range(2))
            kernel = functools.partial(la._launch_next, q, k_self, v_self, k, v, *masks, T_WINDOW, None)
            k_ms = _time_ms(kernel)
            p_ms = _time_ms(lambda: la.next_token_plain(q, k_self, v_self, k, v, *masks, T_WINDOW, None))
            # One SDPA over [cache ++ sequence ++ self] keys: the band [t+1, W+t] and key S+t.
            eye = torch.eye(STEPS, dtype=torch.bool, device=device)[None, None].expand(n, 1, STEPS, STEPS)
            kk, vv, mm = torch.cat([k, k_self], 2), torch.cat([v, v_self], 2), torch.cat([dense, eye], 3)
            with torch.no_grad():
                library = functools.partial(F.scaled_dot_product_attention, q, kk, vv, attn_mask=mm)
                l_ms = _time_ms(library)
            QUEUE["K6", ""] = (kernel, library)
            flops, nbytes = _lane_work("K6", q, k, masks, T_WINDOW)
            extra = _forward_device_ms("K6", kernel, "lane", 1)
            extra["host_ms"] = _host_ms(kernel)
            extra["plan"] = la.next_card_plan(q, T_WINDOW)
            print(f"    K6 N={n}: device_ms={_ms(extra['device_ms'])} (torch.profiler) of the events' {k_ms:.4f} ms; "
                  f"the wrapper's host time {extra['host_ms']:.4f} ms a call; plan {extra['plan']}")
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
        bound, by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
        print(f"    {key} N={n}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"bound_ms={bound:.4f} ({by}; {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP fp32)")
        out_type = "bf16 gradients out (the autograd wrapper's)" if key == "K3b" else "fp32 out"
        results[key] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by, library_ms=l_ms,
                            shape=f"N={n} H={T_HEADS} T={STEPS} W={T_WINDOW} D={T_HEAD_DIM}, bf16 in, {out_type}",
                            device_ms=extra["device_ms"], host_ms=extra["host_ms"], plan=extra["plan"],
                            **usage[key.split()[0]])
    primal = results.pop("K3f primal")
    results["K3f"].update({f"primal_{field}": primal[field]
                           for field in ("ms", "bound_ms", "plain_ms", "library_ms", "device_ms", "host_ms", "plan")})
    results["K3f"]["shape"] += ", saves probabilities (the update); primal at N=1024 (value and KL passes)"
    for key in results:
        results[key]["max_abs_err"] = max(errs[key])
    return results


TJC_MB_ENVS = 2 * T_MB_ENVS  # path TJC: the pair pass's one lane call over both networks' 256 environments


def _rms_normed(gen, device, t, head_dim: int = T_HEAD_DIM):
    """``t`` through the port's QK-norm (an RMS norm of each head's features,
    a random fp32 scale about 1), in its dtype: path TQ's q and k."""
    import torch

    from cusrl_tpu_torch.nn.layer.mha import _RmsNorm

    norm = _RmsNorm(head_dim).to(device)
    with torch.no_grad():
        norm.scale.copy_(0.5 + torch.rand(head_dim, generator=gen))
        return norm(t)


def check_lane_routes(device) -> dict:
    """K3f (saving) and K3b on the two routes this slice adds, each against
    its plain version and timed beside it, the masked SDPA (its autograd for
    K3b) and the bound: path TJC's one lane call over both networks'
    environments (N = 512 in the update) and path TQ's RMS-normed q and k
    (N = 256 in the update, the value and KL passes' primal K3f at 1,024).
    Returns the fields under ``tjc_`` and ``tq_`` (``tq_primal_`` for the
    primal K3f)."""
    import torch
    import torch.nn.functional as F

    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    gen = torch.Generator().manual_seed(SEED + 21)
    results, errs = {"K3f": {}, "K3b": {}}, {"K3f": [], "K3b": []}
    print("[kernels] K3f/K3b on paths TJC (N=512, both networks in one call) and TQ (RMS-normed q and k)")
    for prefix, n, save, normed in (("tjc_", TJC_MB_ENVS, True, False), ("tq_", T_MB_ENVS, True, True),
                                    ("tq_primal_", T_ENVS, False, True)):
        q, k, v, *masks = _lane_inputs(gen, device, n)
        if normed:
            q, k = _rms_normed(gen, device, q), _rms_normed(gen, device, k)
        tag = f"{prefix[:-1]} N={n}"
        ref, ref_probs = la.lane_fwd_plain(q, k, v, *masks, T_WINDOW, None, True)
        out, probs = la._launch_fwd(q, k, v, *masks, T_WINDOW, None, save)
        errs["K3f"].append(_check_attention(f"K3f out {tag}", out, ref))
        if save:
            errs["K3f"].append(_check_attention(f"K3f probs {tag}", probs, ref_probs))
        dense = _dense_mask(*masks, T_WINDOW, 0)
        kernel = functools.partial(la._launch_fwd, q, k, v, *masks, T_WINDOW, None, save)
        plain = functools.partial(la.lane_fwd_plain, q, k, v, *masks, T_WINDOW, None, save)
        with torch.no_grad():
            library = functools.partial(F.scaled_dot_product_attention, q, k, v, attn_mask=dense)
            rows = [("K3f", kernel, plain, library, _lane_work("K3f", q, k, masks, T_WINDOW, save))]
        if save:
            g = torch.randn(q.shape, generator=gen).to(device)
            got = la._launch_bwd(q, k, v, ref_probs, g, *masks, T_WINDOW)
            for name, a, b in zip(("dq", "dk", "dv"), got, la.lane_bwd_plain(q, k, v, ref_probs, g, T_WINDOW)):
                errs["K3b"].append(_check_attention(f"K3b {name} {tag}", a, b))
            lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=dense)
            rows.append(("K3b", functools.partial(la._launch_bwd, q, k, v, ref_probs, g, *masks, T_WINDOW,
                                                  torch.bfloat16),
                         functools.partial(la.lane_bwd_plain, q, k, v, ref_probs, g, T_WINDOW),
                         functools.partial(torch.autograd.grad, lib_out, (lq, lk, lv), g.to(torch.bfloat16),
                                           retain_graph=True),
                         _lane_work("K3b", q, k, masks, T_WINDOW, out_bytes=2)))
        for key, kernel, plain, library, (flops, nbytes) in rows:
            k_ms, p_ms, l_ms = _time_ms(kernel), _time_ms(plain), _time_ms(library)
            device_ms = _forward_device_ms(f"{key} {tag}", kernel, "lane", 1)["device_ms"]
            bound, by = _bound_ms(flops, nbytes, PEAK_FP32_FLOPS)
            print(f"    {key} {tag}: kernel_ms={k_ms:.4f} device_ms={_ms(device_ms)} plain_ms={p_ms:.4f} "
                  f"library_ms={l_ms:.4f} bound_ms={bound:.4f} ({by}; {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
            results[key].update({f"{prefix}ms": k_ms, f"{prefix}device_ms": device_ms, f"{prefix}plain_ms": p_ms,
                                 f"{prefix}library_ms": l_ms, f"{prefix}bound_ms": bound, f"{prefix}bound_by": by,
                                 f"{prefix}shape": f"N={n} H={T_HEADS} T={STEPS} W={T_WINDOW} D={T_HEAD_DIM}"
                                                   + (", RMS-normed q and k" if normed else "")})
    for key in results:
        results[key]["lane_routes_max_abs_err"] = max(errs[key])
    return results


TL_STEPS = 256  # path TL: the transformer entry with 256-step rollouts (T > 64: K7)


def check_banded_kernels(device) -> dict:
    """K7f against its plain version at path TL's shapes (the minibatch's 256
    environments and the value and KL passes' 1,024, T = 256, W = 16), a
    ragged one (T = 200: the second query block half full; ALiBi, a third of
    the rows with no valid key, a half-valid cache) and a window wider than
    the kernel's 128-query block (W = 160) and one too wide for its
    tensor-core staging (W = 1,582: the lanes path, ALiBi, rows with no
    valid key), each repeated bit for bit; then
    ``banded_window_attention`` under autograd at TL's minibatch shape:
    output and q/k/v ``.grad`` against autograd of the plain version, one K7f
    launch per call; K7f on TL's views, one device event a call; the device
    time of the recomputing backward (all its events); then K7f timed with
    the plain version and a masked ``scaled_dot_product_attention`` as the
    yardstick the port never calls, with its device time, host time, plan,
    registers and spills."""
    import torch
    import torch.nn.functional as F

    from cusrl_tpu_torch.nn.kernels import banded_attention as ba

    gen = torch.Generator().manual_seed(SEED + 12)
    errs = []

    def check(name, got, want):
        errs.append(_check_attention(name, got, want))

    print("[kernels] K7f banded window attention")
    slopes4 = (0.5, 0.25, 0.125, 0.0625)
    cases = ((T_MB_ENVS, TL_STEPS, T_WINDOW, None), (T_ENVS, TL_STEPS, T_WINDOW, None),
             (130, 200, T_WINDOW, slopes4), (64, 70, 160, None), (8, 70, 1582, slopes4))
    for n, t_len, window, slopes in cases:
        q, k, v, *masks = _lane_inputs(gen, device, n, t_len, window, invalid=slopes is not None)
        tag = f"N={n} T={t_len} W={window}{' alibi' if slopes else ''}"
        out = ba._launch_fwd(q, k, v, *masks, window, slopes)
        check(f"K7f out {tag}", out, ba.banded_plain(q, k, v, *masks, window, slopes))
        if slopes is not None and out[: n // 3].any():
            raise AssertionError("K7f: a row without a valid key is not exactly 0")
        if not torch.equal(out, ba._launch_fwd(q, k, v, *masks, window, slopes)):
            raise AssertionError(f"K7f {tag}: two calls gave different bits")

    print(f"[wrappers] banded_window_attention (autograd) against autograd of the plain version, N={T_MB_ENVS}")
    q, k, v, *masks = _lane_inputs(gen, device, T_MB_ENVS, TL_STEPS)
    g = torch.randn(q.shape, generator=gen).to(device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = ba.LAUNCHES["K7f"]
    out = ba.banded_window_attention(*leaves, *masks, window=T_WINDOW)
    out.backward(g)
    if ba.LAUNCHES["K7f"] != before + 1:
        raise AssertionError(f"banded_window_attention with grad launched K7f {ba.LAUNCHES['K7f'] - before} times")
    plain = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref = ba.banded_plain(*plain, *masks, T_WINDOW)
    ref.backward(g)
    check("wrapper out", out, ref)
    for name, a, b in zip(("q", "k", "v"), leaves, plain):
        if a.grad.dtype != torch.bfloat16:
            raise AssertionError("the banded wrapper's input gradient is not in the input's dtype")
        # Both sides' gradients come from the same recomputing backward, cast to bf16.
        err = (a.grad.float() - b.grad.float()).abs().max().item()
        limit = 2 ** -8 * b.grad.float().abs().max().item()
        print(f"    {name + '.grad (bf16)':28s} max_abs_err={err:.3e} (limit {limit:.3e}) "
              f"{'ok' if err <= limit else 'MISMATCH'}")
        if err > limit:
            raise AssertionError(f"banded wrapper {name}.grad disagrees with autograd of the plain version")

    # TL's recomputing backward (banded_plain under autograd): all its device time.
    grad_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    again = ba.banded_window_attention(*grad_leaves, *masks, window=T_WINDOW)
    backward = functools.partial(torch.autograd.grad, again, grad_leaves, g, retain_graph=True)
    for _ in range(PROFILE_ATTEMPTS):
        _, events, us = _profiled_kernels(backward, (), 10, 3)
        if events:
            break
    bwd_ms = us / 10 / 1e3 if events else None
    print(f"    TL's recomputing K7 backward, N={T_MB_ENVS} T={TL_STEPS}: device_ms={_ms(bwd_ms)} a call over its "
          f"{events / 10:g} device events (torch.profiler, 10 calls)")

    print("[kernels] K7f on TL's views, N=256: q a head-split view of the projection, q_seg a transposed view")
    _, k, v, q_seg, k_seg, k_valid = _lane_inputs(gen, device, T_MB_ENVS, TL_STEPS)
    proj = torch.randn(TL_STEPS * T_MB_ENVS, 3 * T_EMBED, generator=gen).to(device, torch.bfloat16)
    q = proj[:, :T_EMBED].reshape(TL_STEPS, T_MB_ENVS, T_HEADS, T_HEAD_DIM).permute(1, 2, 0, 3)
    q_seg_t = q_seg.T.contiguous().T
    if not torch.equal(ba._launch_fwd(q, k, v, q_seg_t, k_seg, k_valid, T_WINDOW, None),
                       ba._launch_fwd(q.contiguous(), k, v, q_seg, k_seg, k_valid, T_WINDOW, None)):
        raise AssertionError("K7f on TL's views gave other bits than on contiguous copies")
    _only_kernel("K7f on these views", lambda: ba._launch_fwd(q, k, v, q_seg_t, k_seg, k_valid, T_WINDOW, None),
                 "banded_fwd_kernel")

    usage = _print_usage("K7f (tensor cores)", _band_kernel_usage("banded_attention", "banded_fwd_kernel"))
    _print_usage("K7f (lanes)", _band_kernel_usage("banded_attention", "banded_lanes_kernel"))
    timing = {}
    for n in (T_MB_ENVS, T_ENVS):
        q, k, v, *masks = _lane_inputs(gen, device, n, TL_STEPS)
        dense = _dense_mask(*masks, T_WINDOW, 0)
        kernel = functools.partial(ba._launch_fwd, q, k, v, *masks, T_WINDOW, None)
        k_ms = _time_ms(kernel)
        p_ms = _time_ms(lambda: ba.banded_plain(q, k, v, *masks, T_WINDOW))
        with torch.no_grad():
            library = functools.partial(F.scaled_dot_product_attention, q, k, v, attn_mask=dense)
            l_ms = _time_ms(library)
        QUEUE["K7f", "primal_" if n == T_ENVS else ""] = (kernel, library)
        flops, nbytes = _lane_work("K3f", q, k, masks, T_WINDOW)
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
        bound, by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
        extra = _forward_device_ms(f"K7f N={n}", kernel, "banded", 1)
        extra["host_ms"] = _host_ms(kernel)
        extra["plan"] = ba.fwd_card_plan(q, T_WINDOW)
        print(f"    K7f N={n}: device_ms={_ms(extra['device_ms'])} (torch.profiler) of the events' {k_ms:.4f} ms; "
              f"the wrapper's host time {extra['host_ms']:.4f} ms a call; plan {extra['plan']}")
        print(f"    K7f N={n}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={bound:.4f} "
              f"({by}; {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP fp32)")
        timing[n] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound, bound_by=by,
                         device_ms=extra["device_ms"], host_ms=extra["host_ms"], plan=extra["plan"])
    result = dict(timing[T_MB_ENVS], max_abs_err=max(errs), **usage, tl_recompute_bwd_device_ms=bwd_ms,
                  shape=f"N={T_MB_ENVS} H={T_HEADS} T={TL_STEPS} W={T_WINDOW} D={T_HEAD_DIM}, bf16 in, fp32 out "
                        f"(the update's minibatch); primal at N={T_ENVS} (value and KL passes)")
    result.update({f"primal_{key}": value for key, value in timing[T_ENVS].items() if key != "bound_by"})
    return {"K7f": result}


def check_gelu_kernels(device) -> dict:
    """K1f/K1b with gelu at the FFN's widths (128-512-128): forward saving the
    bf16 pre-activations and backward with dX, against the plain versions at
    the rollout step's 1,024 rows, the minibatch's 6,144 and a ragged 1,000;
    timed at 6,144 with a bf16 ``F.linear`` + ``F.gelu`` chain (autograd for
    the backward) as the yardstick.  Returns extra fields for K1f and K1b."""
    import torch
    import torch.nn.functional as F

    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED + 8)
    ws = [(torch.randn(b, a, generator=gen) / math.sqrt(a)).to(device) for a, b in zip(FFN_WIDTHS, FFN_WIDTHS[1:])]
    bs = [(torch.randn(b, generator=gen) * 0.1).to(device) for b in FFN_WIDTHS[1:]]
    errs = {"K1f": [], "K1b": []}
    print("[kernels] K1f/K1b with gelu, FFN 128-512-128")
    rows_mb = T_MB_ENVS * STEPS
    for rows in (T_ENVS, rows_mb, RAGGED_ROWS):
        x = torch.randn(rows, T_EMBED, generator=gen).to(device, torch.bfloat16)
        g = (torch.randn(rows, T_EMBED, generator=gen) * 0.01).to(device, torch.bfloat16)
        (out,), (hid,), _ = fm._launch_fwd([x], [ws], [bs], "gelu", False, True, "K1f")
        ref, ref_hid = fm.mlp_chain_fwd_plain(x, ws, bs, "gelu", False, True)
        torch.cuda.synchronize()
        errs["K1f"].append(_check(f"gelu out rows={rows}", out, ref, rel=False))
        errs["K1f"].append(_check(f"gelu z rows={rows}", hid[0], ref_hid[0], rel=False))
        ((dx, dws, dbs, _),) = fm._launch_bwd([x], [g], [ws], [[*ref_hid, ref]], "gelu", False, False, "K1b")
        rdx, rdws, rdbs = fm.mlp_chain_bwd_plain(x, g, ws, [*ref_hid, ref], "gelu", False, False)
        torch.cuda.synchronize()
        for name, a, b in zip(("dx", "dW0", "dW1", "db0", "db1"), (dx, *dws, *dbs), (rdx, *rdws, *rdbs)):
            errs["K1b"].append(_check(f"gelu {name} rows={rows}", a, b, rel=True))

    w16 = [w.to(torch.bfloat16).requires_grad_() for w in ws]
    b16 = [b.to(torch.bfloat16).requires_grad_() for b in bs]

    def library(x_):
        return F.linear(F.gelu(F.linear(x_, w16[0], b16[0]), approximate="tanh"), w16[1], b16[1])

    def work(rows, backward, save):
        macs = sum(a * b for a, b in zip(FFN_WIDTHS, FFN_WIDTHS[1:]))
        params = macs + sum(FFN_WIDTHS[1:])
        if not backward:
            return 2 * rows * macs, rows * T_EMBED * 2 * 2 + params * 4 + (rows * T_FF * 2 if save else 0)
        return 4 * rows * macs, rows * (T_EMBED * 2 * 3 + T_FF * 2 + T_EMBED * 2) + macs * 4 + params * 4

    fields = {}
    for rows in (rows_mb, T_ENVS):
        x = torch.randn(rows, T_EMBED, generator=gen).to(device, torch.bfloat16)
        g = (torch.randn(rows, T_EMBED, generator=gen) * 0.01).to(device, torch.bfloat16)
        save = rows == rows_mb
        f_ms = _time_ms(lambda: fm._launch_fwd([x], [ws], [bs], "gelu", False, save, "K1f"))
        fp_ms = _time_ms(lambda: fm.mlp_chain_fwd_plain(x, ws, bs, "gelu", False, save))
        with torch.no_grad():
            fl_ms = _time_ms(lambda: library(x))
        f_bound, f_by = _bound_ms(*work(rows, False, save))
        print(f"    K1f gelu rows={rows}: kernel_ms={f_ms:.4f} plain_ms={fp_ms:.4f} library_ms={fl_ms:.4f} "
              f"bound_ms={f_bound:.4f} ({f_by})")
        tag = "gelu" if save else "gelu_step"
        QUEUE["K1f", tag + "_"] = (functools.partial(fm._launch_fwd, [x], [ws], [bs], "gelu", False, save, "K1f"),
                                   _no_grad(functools.partial(library, x)))
        chain_fields = _chain_forward_fields(
            f"K1f {tag}", lambda: fm._launch_fwd([x], [ws], [bs], "gelu", False, save, "K1f"), FFN_WIDTHS, rows, 1, f_ms)
        fields.setdefault("K1f", {}).update({f"{tag}_ms": f_ms, f"{tag}_plain_ms": fp_ms, f"{tag}_library_ms": fl_ms,
                                             f"{tag}_bound_ms": f_bound})
        fields["K1f"].update({f"{tag}_{k}": v for k, v in chain_fields.items()})
        if not save:
            continue
        out, hid = fm.mlp_chain_fwd_plain(x, ws, bs, "gelu", False, True)
        b_ms = _time_ms(lambda: fm._launch_bwd([x], [g], [ws], [[*hid, out]], "gelu", False, False, "K1b"))
        bp_ms = _time_ms(lambda: fm.mlp_chain_bwd_plain(x, g, ws, [*hid, out], "gelu", False, False))
        with torch.enable_grad():
            lx = x.clone().requires_grad_()
            lib_out = library(lx)
            bl_ms = _time_ms(lambda: torch.autograd.grad(lib_out, [lx, *w16, *b16], g, retain_graph=True))
        b_bound, b_by = _bound_ms(*work(rows, True, True))
        print(f"    K1b gelu rows={rows}: kernel_ms={b_ms:.4f} plain_ms={bp_ms:.4f} library_ms={bl_ms:.4f} "
              f"bound_ms={b_bound:.4f} ({b_by})")
        ffn_shapes = list(zip(FFN_WIDTHS[1:], FFN_WIDTHS))
        # D_1, D_2 bf16; x and z bf16 (gelu(z) recomputed).
        phases = _backward_phases("K1b gelu", lambda: fm._launch_bwd([x], [g], [ws], [[*hid, out]], "gelu", False,
                                                                      False, "K1b"),
                                  rows, 1, ffn_shapes, 2 * (T_FF + T_EMBED) + 2 * (T_EMBED + T_FF), T_FF + T_EMBED,
                                  _chain_phase1_work(FFN_WIDTHS, False, trailing=False),
                                  _chain_phase1_plan("K1b gelu", FFN_WIDTHS, rows, 1, False))
        # K1b runs on path T alone: these are its main fields.
        fields["K1b"] = dict(ms=b_ms, plain_ms=bp_ms, library_ms=bl_ms, bound_ms=b_bound, bound_by=b_by,
                             shape=f"{rows_mb} x 128-512-128 gelu with dX (the FFN's minibatch)",
                             **{f"gelu_{k}": v for k, v in phases.items()})
    fields["K1f"]["gelu_shape"] = f"{rows_mb} x 128-512-128 gelu (the FFN's minibatch; step at {T_ENVS} rows)"
    for key in fields:
        fields[key]["gelu_max_abs_err"] = max(errs[key])
    return fields


def _check_chain_kernels(device, label: str, prefix: str, dims, x_dtype, cases, seed: int, activation: str = "elu",
                         skip_input_grad: bool = False, queued: tuple = (), chains: int = 1) -> dict:
    """K1f and K1b on one MLP chain of widths ``dims`` (trailing activation),
    or with ``chains=2`` K2f and K2b on a pair of such chains, at ``cases``,
    ``(rows, save, tag, timed)`` each: the forward primal or saving, the
    backward (with dX unless ``skip_input_grad``) after a saving forward,
    against the plain versions at ``check_kernels``'s limits; where
    ``timed``, also two forward calls compared bit for bit, the times of the
    kernel, the plain version and a bf16 ``F.linear`` + activation chain on
    the input (autograd for the backward) with CUDA events, the forward's
    device time and plan, the backward's phases, plan, registers, spills and
    two calls bit for bit.  ``queued`` tags go to the redesign queue's block.
    Returns ``{forward key, backward key: {prefix + tag + field: value}}``
    with ``prefix + "max_abs_err"``, for the keys the cases checked (only the
    forward's where no case saves)."""
    import torch
    import torch.nn.functional as F

    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    fkey, bkey = ("K1f", "K1b") if chains == 1 else ("K2f", "K2b")
    act = {"elu": F.elu, "relu": F.relu, "tanh": torch.tanh}[activation]
    gen = torch.Generator().manual_seed(SEED + seed)
    pairs = list(zip(dims[:-1], dims[1:]))
    wss = [[(torch.randn(b, a, generator=gen) / math.sqrt(a)).to(device) for a, b in pairs] for _ in range(chains)]
    bss = [[(torch.randn(b, generator=gen) * 0.1).to(device) for _, b in pairs] for _ in range(chains)]
    w16 = [[w.to(torch.bfloat16).requires_grad_() for w in ws] for ws in wss]
    b16 = [[b.to(torch.bfloat16).requires_grad_() for b in bs] for bs in bss]
    x_bytes = torch.finfo(x_dtype).bits // 8
    fields, errs = {fkey: {}, bkey: {}}, {fkey: [], bkey: []}

    def record(key, tag, rows, timed, work):
        (k_ms, p_ms, l_ms), (bound, by) = timed, _bound_ms(*work)
        print(f"    {key} {label} rows={rows}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
              f"bound_ms={bound:.4f} ({by})")
        fields[key].update({f"{tag}ms": k_ms, f"{tag}plain_ms": p_ms, f"{tag}library_ms": l_ms,
                            f"{tag}bound_ms": bound, f"{tag}bound_by": by})

    def library(xs_):
        outs = []
        for x_, ws, bs in zip(xs_, w16, b16):
            h = x_.to(torch.bfloat16)
            for w, b in zip(ws, bs):
                h = act(F.linear(h, w, b))
            outs.append(h)
        return outs

    def forward(xs_, save):
        return fm._launch_fwd(xs_, wss, bss, activation, True, save, fkey)

    def plain_forward(xs_, save):
        return [fm.mlp_chain_fwd_plain(x_, ws, bs, activation, True, save) for x_, ws, bs in zip(xs_, wss, bss)]

    def chain(name, c):
        return name if chains == 1 else f"{name}[{c}]"

    for rows, save, tag, timed_case in cases:
        tag = prefix + tag
        xs = [torch.randn(rows, dims[0], generator=gen).to(device, x_dtype) for _ in range(chains)]
        outs, hids, _ = forward(xs, save)
        refs = plain_forward(xs, True)
        for c, (out, hid, (ref, ref_hid)) in enumerate(zip(outs, hids, refs)):
            errs[fkey].append(_check(f"{label} {chain('out', c)} save={int(save)} rows={rows}", out, ref, rel=False))
            for i, (h, r) in enumerate(zip(hid, ref_hid)):
                errs[fkey].append(_check(f"{label} {chain(f'h{i + 1}', c)} rows={rows}", h, r, rel=False))
        if timed_case:
            again = forward(xs, save)[0]
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs, again)):
                raise AssertionError(f"{fkey} {label} rows={rows}: two calls on the same inputs differ")
            with torch.no_grad():
                timed = (_time_ms(lambda: forward(xs, save)), _time_ms(lambda: plain_forward(xs, save)),
                         _time_ms(lambda: library(xs)))
            record(fkey, tag, rows, timed, _chain_work(rows, chains, False, save, False, dims, x_bytes))
            if tag in queued:
                QUEUE[fkey, tag] = (functools.partial(forward, xs, save), _no_grad(functools.partial(library, xs)))
            device_fields = _chain_forward_fields(f"{fkey} {tag[:-1]}", lambda: forward(xs, save), dims, rows, chains,
                                                  timed[0])
            fields[fkey].update({tag + k: v for k, v in device_fields.items()})
        if not save:
            continue
        gs = [(torch.randn(rows, dims[-1], generator=gen) * 0.01).to(device, torch.bfloat16) for _ in range(chains)]
        hss = [[*ref_hid, ref] for ref, ref_hid in refs]

        def backward():
            return fm._launch_bwd(xs, gs, wss, hss, activation, True, skip_input_grad, bkey)

        for c, ((dx, dws, dbs, _), x, g, ws, hs) in enumerate(zip(backward(), xs, gs, wss, hss)):
            rdx, rdws, rdbs = fm.mlp_chain_bwd_plain(x, g, ws, hs, activation, True, skip_input_grad)
            if skip_input_grad:
                if dx is not None:
                    raise AssertionError(f"{bkey} {label}: skip_input_grad still wrote dX")
            else:
                errs[bkey].append(_check(f"{label} {chain('dx', c)} rows={rows}", dx, rdx, rel=True))
            for l, (a, b) in enumerate(zip(dws, rdws)):
                errs[bkey].append(_check(f"{label} {chain(f'dW{l}', c)} rows={rows}", a, b, rel=True))
            for l, (a, b) in enumerate(zip(dbs, rdbs)):
                errs[bkey].append(_check(f"{label} {chain(f'db{l}', c)} rows={rows}", a, b, rel=True))
        if not timed_case:
            continue
        lxs = [x.to(torch.bfloat16, copy=True).requires_grad_(not skip_input_grad) for x in xs]
        with torch.enable_grad():
            lib_outs = library(lxs)
        lib_inputs = [p for ws, bs in zip(w16, b16) for p in (*ws, *bs)] + ([] if skip_input_grad else lxs)
        timed = (_time_ms(backward),
                 _time_ms(lambda: [fm.mlp_chain_bwd_plain(x, g, ws, hs, activation, True, skip_input_grad)
                                   for x, g, ws, hs in zip(xs, gs, wss, hss)]),
                 _time_ms(lambda: torch.autograd.grad(lib_outs, lib_inputs, gs, retain_graph=True)))
        record(bkey, tag, rows, timed, _chain_work(rows, chains, True, True, not skip_input_grad, dims, x_bytes))
        phases = _backward_phases(f"{bkey} {label}", backward, rows, chains, [(b, a) for a, b in pairs],
                                  2 * sum(dims[1:]) + x_bytes * dims[0] + 2 * sum(dims[1:-1]), chains * sum(dims[1:]),
                                  _sum_work(*[_chain_phase1_work(dims, skip_input_grad)] * chains),
                                  _chain_phase1_plan(f"{bkey} {label}", dims, rows, chains, skip_input_grad))
        fields[bkey].update({tag + k: v for k, v in phases.items()})
    for key in [key for key in fields if errs[key]]:
        fields[key][prefix + "max_abs_err"] = max(errs[key])
    return {key: value for key, value in fields.items() if errs[key]}


def check_tl_head_kernels(device) -> dict:
    """K1f and K1b on the transformer entry's ELU head (128 -> 128, trailing
    activation) at the sizes path TL gives them: the forward saving at the
    minibatch's 65,536 rows and primal at the value and KL passes' 262,144
    and at the rollout step's 1,024, the backward with dX at 65,536.
    Returns the ``tl_head_`` fields of K1f and K1b."""
    import torch

    print("[kernels] K1f/K1b on the ELU head 128 -> 128 at path TL's sizes (K1f also at its rollout step)")
    fields = _check_chain_kernels(device, "head", "tl_head_", (T_EMBED, T_EMBED), torch.bfloat16,
                                 ((TL_MB_ROWS, True, "", True), (TL_PRIMAL_ROWS, False, "primal_", True),
                                  (T_ENVS, False, "step_", True)), seed=14, queued=("tl_head_", "tl_head_step_"))
    for key in fields:
        fields[key]["tl_head_shape"] = (f"{TL_MB_ROWS} x 128-128 ELU (TL's minibatch, saving; backward with dX)"
                                        + (f"; primal at {TL_PRIMAL_ROWS} rows (value and KL passes) and at "
                                           f"{T_ENVS} (the rollout step)" if key == "K1f" else ""))
    return fields


# -- Paths R and RJ: the zoo's recurrent entry (GRU 256, ELU head 128) ---------

R_HIDDEN = 256  # Velocity-Flat recurrent_ppo: GRU 256, one ELU head layer of 128
R_MB_ROWS = T_ENVS // MINIBATCHES * STEPS  # 6,144 rows per minibatch (256 environments x 24 steps)
R_PRIMAL_ROWS = T_ENVS * STEPS  # 24,576 rows in the KL pass


def check_r_head_kernels(device) -> dict:
    """K1f and K1b on the recurrent entry's head (256 -> 128 ELU, trailing
    activation) at the sizes path R gives them, on the GRU's fp32 output (the
    kernel rounds it to bf16 as the plain version's cast does): the forward
    primal at the rollout step's 1,024 rows and the KL pass's 24,576, saving
    at the minibatch's 6,144, and at a ragged 1,000 (checked, not timed); the
    backward with dX at 6,144 and 1,000.  Returns the ``r_head_`` fields of
    K1f and K1b."""
    import torch

    print("[kernels] K1f/K1b on the recurrent entry's ELU head 256 -> 128 at path R's sizes (fp32 input: the GRU's)")
    fields = _check_chain_kernels(device, "R head", "r_head_", (R_HIDDEN, T_EMBED), torch.float32,
                                 ((T_ENVS, False, "step_", True), (R_MB_ROWS, True, "", True),
                                  (R_PRIMAL_ROWS, False, "primal_", True), (RAGGED_ROWS, True, "ragged_", False)),
                                 seed=15)
    for key in fields:
        fields[key]["r_head_shape"] = (f"{R_MB_ROWS} x 256-128 ELU on fp32 input (R's minibatch, saving; backward "
                                       f"with dX; also {RAGGED_ROWS} rows)"
                                       + (f"; primal at {T_ENVS} rows (the rollout step) and {R_PRIMAL_ROWS} (the KL "
                                          f"pass)" if key == "K1f" else ""))
    return fields


def check_rj_pair_kernels(device) -> dict:
    """K2f and K2b on path RJ's pair of heads (two 256 -> 128 ELU, trailing
    activation, on the stacked GRUs' fp32 output): the forward saving and
    the backward with dX at the minibatch's 2 x 6,144 rows (timed, planned,
    repeated bit for bit) and at a ragged 2 x 1,000 (checked), then
    ``fused_mlp_pair(..., skip_input_grad=False)`` under autograd at 2 x
    6,144 against the CPU.  Returns the ``rj_pair_`` fields of K2f and K2b."""
    import torch

    print("[kernels] K2f/K2b on path RJ's pair of ELU heads 256 -> 128 with dX (fp32 input: the stacked GRUs')")
    fields = _check_chain_kernels(device, "RJ pair", "rj_pair_", (R_HIDDEN, T_EMBED), torch.float32,
                                 ((R_MB_ROWS, True, "", True), (RAGGED_ROWS, True, "ragged_", False)),
                                 seed=16, chains=2)
    print(f"[wrappers] fused_mlp_pair with input gradients, rows={R_MB_ROWS}, 256 -> 128 ELU on fp32 input "
          f"(path RJ's heads)")
    errs = _pair_wrapper_errors(device, torch.Generator().manual_seed(SEED + 17), R_HIDDEN, torch.float32,
                                R_MB_ROWS)
    for key in fields:
        fields[key]["rj_pair_max_abs_err"] = max(fields[key]["rj_pair_max_abs_err"], *errs[key])
        fields[key]["rj_pair_shape"] = (f"2 x {R_MB_ROWS} x 256-128 ELU on fp32 input (RJ's minibatch, saving; "
                                        f"backward with dX; also 2 x {RAGGED_ROWS} rows)")
    return fields


# -- Path AMP: the zoo's Velocity-Flat amp entry (relu 48-512-256, discriminator) --

AMP_WIDTHS = (48, 512, 256)  # Velocity-Flat amp: relu actor and critic backbones 512-256
AMP_STEPS, AMP_EPOCHS, AMP_MINIBATCHES = 16, 4, 4
AMP_MB = AMP_EPOCHS * AMP_MINIBATCHES  # 16 minibatches an update
AMP_MB_ROWS = T_ENVS * AMP_STEPS // AMP_MINIBATCHES  # 4,096 rows per minibatch
AMP_ROLLOUT_ROWS = T_ENVS * AMP_STEPS  # 16,384 rows in the value and KL passes
AMP_HOOK = "adversarial_motion_prior"


def check_amp_kernels(device) -> dict:
    """K1f and K1b on the AMP entry's relu backbones (48 -> 512 -> 256, trailing
    relu; its derivative from the saved post-activation) at the sizes path
    AMP gives them: the forward primal at the rollout step's 1,024 rows and
    the value and KL passes' 16,384, saving at the minibatch's 4,096 and a
    ragged 1,000 (checked, not timed); the backward with ``skip_input_grad``
    (the observations take no gradient) at 4,096 and 1,000.  Returns the
    ``amp_`` fields of K1f and K1b."""
    import torch

    print("[kernels] K1f/K1b on the AMP entry's relu backbones 48-512-256 at path AMP's sizes")
    fields = _check_chain_kernels(device, "AMP", "amp_", AMP_WIDTHS, torch.float32,
                                  ((T_ENVS, False, "step_", True), (AMP_MB_ROWS, True, "", True),
                                   (AMP_ROLLOUT_ROWS, False, "rollout_", True), (RAGGED_ROWS, True, "ragged_", False)),
                                  seed=18, activation="relu", skip_input_grad=True)
    for key in fields:
        fields[key]["amp_shape"] = (f"{AMP_MB_ROWS} x 48-512-256 relu (AMP's minibatch, saving; backward with "
                                    f"skip_input_grad; also {RAGGED_ROWS} rows)"
                                    + (f"; primal at {T_ENVS} rows (the rollout step) and {AMP_ROLLOUT_ROWS} (the "
                                       f"value and KL passes)" if key == "K1f" else ""))
    return fields


# -- Path F: the zoo's Velocity-Flat ppo entry (ELU 128-128-128), the quick start --

F_WIDTHS = (48, 128, 128, 128)  # Velocity-Flat ppo: 48-D observations, ELU 128-128-128 backbones
F_PRIMAL_ROWS = NUM_ENVS * STEPS  # 98,304 rows in the value and KL passes
PLAYER_ROWS = 64  # the entry's benchmarking environments: the Player's policy step


def check_f_kernels(device) -> dict:
    """K1f on path F's backbones (48 -> 128 -> 128 -> 128 ELU, trailing
    activation) primal at the rollout step's 4,096 rows, the value and KL
    passes' 98,304 and the Player's 64; K2f/K2b on F's pair (the joint
    evaluation) saving at the minibatch's 2 x 24,576 rows and a ragged
    2 x 1,000 (checked, not timed), the backward with ``skip_input_grad``.
    Returns the ``f_`` fields of K1f and the ``f_pair_`` fields of K2f and
    K2b."""
    import torch

    print("[kernels] K1f on path F's ELU backbones 48-128-128-128 (rollout step, value and KL passes, Player step)")
    fields = _check_chain_kernels(device, "F", "f_", F_WIDTHS, torch.float32,
                                  ((NUM_ENVS, False, "step_", True), (F_PRIMAL_ROWS, False, "primal_", True),
                                   (PLAYER_ROWS, False, "play_", True)), seed=19)
    fields["K1f"]["f_shape"] = (f"48-128-128-128 ELU primal at {NUM_ENVS} rows (the rollout step), {F_PRIMAL_ROWS} "
                                f"(the value and KL passes) and {PLAYER_ROWS} (the Player's step)")
    print("[kernels] K2f/K2b on path F's pair of ELU backbones 48-128-128-128 (skip_input_grad)")
    pair = _check_chain_kernels(device, "F pair", "f_pair_", F_WIDTHS, torch.float32,
                                ((MINIBATCH_ROWS, True, "", True), (RAGGED_ROWS, True, "ragged_", False)), seed=20,
                                skip_input_grad=True, chains=2)
    for key in pair:
        pair[key]["f_pair_shape"] = (f"2 x {MINIBATCH_ROWS} x 48-128-128-128 ELU (F's minibatch, saving; backward "
                                     f"with skip_input_grad; also 2 x {RAGGED_ROWS} rows)")
    return {**fields, **pair}


# -- Path H: the zoo's CartPole-v1 ppo entry on the host loop ---------------

H_WIDTHS = (4, 64, 64)  # CartPole-v1 ppo: 4 observations, tanh 64-64 backbones
H_ENVS, H_STEPS, H_EPOCHS = 8, 32, 20  # 8 environments, 32 steps, 20 epochs x 1 minibatch of 256 rows
H_ROWS = H_ENVS * H_STEPS  # 256: the value, minibatch and KL passes
H_PLAY_STEPS = 500
H_NARROW = (2, 3, 6, 24)  # the other gym entries' input widths (MountainCar, Pendulum, Acrobot, BipedalWalker)


def check_h_kernels(device) -> dict:
    """K1f and K1b with tanh on path H's backbones (4 -> 64 -> 64, fp32
    observations 4 wide: the launch pads x and W_0 to 16 columns) at the
    update's 256 rows (saving, the backward with ``skip_input_grad`` as the
    path runs it; and primal), the Player's 8 rows and a ragged 1,000; K1b
    with dX at width 4; the input widths 2, 3, 6 and 24 at 256 rows (forward
    and backward with dX, checked, not timed); and the pad's device time
    apart from the kernel's.  Returns the ``h_`` fields of K1f and K1b."""
    import torch

    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    print("[kernels] H: K1f/K1b with tanh on path H's backbones 4-64-64 (the update's 256 rows, the Player's 8, "
          "a ragged 1,000)")
    fields = _check_chain_kernels(device, "H", "h_", H_WIDTHS, torch.float32,
                                  ((H_ROWS, True, "", True), (H_ROWS, False, "primal_", True),
                                   (H_ENVS, False, "play_", True), (RAGGED_ROWS, True, "ragged_", False)), seed=21,
                                  activation="tanh", skip_input_grad=True)
    print("[kernels] H: K1b with dX at input width 4")
    with_dx = _check_chain_kernels(device, "H dX", "h_dx_", H_WIDTHS, torch.float32, ((H_ROWS, True, "", True),),
                                   seed=22, activation="tanh")
    fields["K1b"].update({k: v for k, v in with_dx["K1b"].items()})
    errs = {key: [fields[key]["h_max_abs_err"], with_dx[key]["h_dx_max_abs_err"]] for key in ("K1f", "K1b")}
    for width in H_NARROW:
        print(f"[kernels] H: K1f/K1b with tanh at input width {width} ({width}-64-64, 256 rows, backward with dX)")
        narrow = _check_chain_kernels(device, f"H w{width}", f"h_w{width}_", (width, *H_WIDTHS[1:]), torch.float32,
                                      ((H_ROWS, True, "", False),), seed=23 + width, activation="tanh")
        for key in errs:
            errs[key].append(narrow[key][f"h_w{width}_max_abs_err"])
    for key in errs:
        fields[key]["h_max_abs_err"] = max(errs[key])
    gen = torch.Generator().manual_seed(SEED + 29)
    x = torch.randn(H_ROWS, H_WIDTHS[0], generator=gen).to(device)
    ws = [(torch.randn(b, a, generator=gen) / math.sqrt(a)).to(device) for a, b in zip(H_WIDTHS[:-1], H_WIDTHS[1:])]
    pad_ms = _queued_events_ms(lambda: fm.pad_input([x], [ws]))
    print(f"    the pad of x [{H_ROWS}, 4] and W_0 [64, 4] to 16 columns: {pad_ms:.4f} device ms a launch (CUDA "
          f"events behind a queued sleep; not in the kernels' device times)")
    for key in ("K1f", "K1b"):
        fields[key]["h_pad_device_ms"] = pad_ms
        fields[key]["h_shape"] = (f"{H_ROWS} x 4-64-64 tanh, fp32 input padded to 16 columns per launch (H's value, "
                                  f"minibatch and KL passes; backward with skip_input_grad, also with dX)"
                                  + (f"; primal also at {H_ENVS} rows (the Player's step)" if key == "K1f" else "")
                                  + f"; input widths {', '.join(map(str, H_NARROW))} checked at {H_ROWS} rows")
    return fields


def _amp_agent(device, live_logits: bool = True):
    """The zoo's uncut AMP agent on ``device`` (weights from seed 0), its
    discriminator's last bias lifted to 0.5 where ``live_logits``: at its
    random start the trailing relu can leave every logit at 0, where the
    gradient penalty and its second derivative hold nothing to compare."""
    import torch

    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.zoo.registry import get_experiment

    env = VelocityLocomotionEnv(num_instances=T_ENVS, device=device)
    agent = get_experiment("Velocity-Flat", "amp").make_agent_factory()(env.spec, device=device, seed=SEED)
    if live_logits:
        with torch.no_grad():
            agent.get_hook(AMP_HOOK).discriminator.layers[-1].bias.fill_(0.5)
    return agent


def check_second_order(device) -> None:
    """The gradient penalty's second derivative on the card: the
    discriminator's gradient at ``grad_penalty_weight`` 5 less its gradient
    at 0 (the penalty's own gradient, a second derivative of the
    discriminator) against the same on the CPU (same weights, batch and
    subsample), each leaf within 2e-2 of its largest element, and not 0; the
    discriminator took no kernel (``fused_kernel=False``, K1f and K1b
    launches 0)."""
    import torch

    print("[second-order] AMP's gradient penalty: the discriminator's gradient at weight 5 less at weight 0, card "
          "against CPU")
    gen = torch.Generator().manual_seed(SEED + 19)
    batch = {"agent_transition": torch.randn(AMP_MB_ROWS, 32, generator=gen),
             "expert_transition": torch.randn(AMP_MB_ROWS, 32, generator=gen) * 0.5 + 0.2}
    subsample = torch.randint(0, AMP_MB_ROWS, (512,), generator=gen)
    diffs = {}
    state = None
    for dev in ("cpu", device):
        agent = _amp_agent(dev)
        hook = agent.get_hook(AMP_HOOK)
        if state is None:
            state = {k: v.detach().clone() for k, v in hook.discriminator.state_dict().items()}
        hook.discriminator.load_state_dict(state)
        grads = {}
        _reset_launch_counts()
        for weight in (5.0, 0.0):
            hook.grad_penalty_weight = weight
            hook.queue_draws(subsample=[subsample])
            objectives, _ = hook.objective(agent, {}, {k: v.to(dev) for k, v in batch.items()})
            params = list(hook.discriminator.parameters())
            grads[weight] = torch.autograd.grad(sum(objectives.values()), params)
            if any(g.device.type != torch.device(dev).type for g in grads[weight]):
                raise AssertionError(f"the discriminator's gradient is not on {dev}")
        launched = {k: v for k, v in _launch_counts().items() if v}
        if launched:
            raise AssertionError(f"the discriminator launched kernels on {dev}: {launched}")
        diffs[str(dev)] = [(a - b).cpu() for a, b in zip(grads[5.0], grads[0.0])]
    # A relu network's input gradient is W3 D2 W2 D1 W1 with 0/1 masks D: its
    # penalty moves the weights, and the biases only where a unit flips (a
    # gradient of 0 on both sides).
    worst = 0.0
    for (name, _), card, cpu in zip(hook.discriminator.named_parameters(), diffs[str(device)], diffs["cpu"]):
        scale = cpu.abs().max().item()
        ratio = (card - cpu).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, ratio)
        print(f"    {name:18s} max|penalty grad| cpu={scale:.4e} card={card.abs().max().item():.4e} "
              f"max|card - cpu| / max|cpu| = {ratio:.3e} (limit 2e-2)")
        if not (ratio <= 2e-2 and (scale > 0 or name.endswith("bias"))):
            raise AssertionError(f"the penalty's gradient of {name} on the card disagrees with the CPU's")
    print(f"[second-order] held: worst leaf {worst:.3e}; the discriminator launched no kernel")


OPTIMIZER_FAMILIES = (("adam", {}), ("adamw", {}), ("sgd", {"momentum": 0.9, "nesterov": True}), ("rmsprop", {}))


def _optimizer_run(named, factory, grads, device_lr: bool, steps: int = 3) -> dict:
    """``steps`` steps of ``build_optimizer(factory)`` on copies of ``named``
    with the given gradients; returns the parameters by path."""
    import torch

    from cusrl_tpu_torch.template.optimizer import build_optimizer

    params = [(path, torch.nn.Parameter(p.detach().clone())) for path, p in named]
    opt = build_optimizer(factory, params)
    if device_lr:
        opt.use_device_learning_rates()
    for step in range(steps):
        for (path, p), g in zip(params, grads[step]):
            p.grad = g.to(p.device)
        opt.step()
    return {path: p.detach() for path, p in params}


def _device_ms_per_call(fn, repeats: int = 10, warmup: int = 3) -> tuple[float, str]:
    """Device time of one call of ``fn``: every device event of ``repeats``
    calls under torch.profiler, or by queued CUDA events where the profiler
    records none."""
    for _ in range(PROFILE_ATTEMPTS):
        _, events, us = _profiled_kernels(fn, (), repeats, warmup)
        if events:
            return us / repeats / 1e3, "torch.profiler, every device event"
    return _queued_events_ms(fn, repeats, warmup), "CUDA events behind a queued sleep"


def check_optimizer(device) -> dict:
    """``[optimizer]``: each family (adam, adamw, sgd with momentum 0.9 and
    Nesterov, rmsprop) three steps on the card against the CPU on AMP's
    parameter set (actor, critic, discriminator; the critic a group at
    another lr) with device learning rates, and packed Adam
    (``CUSRL_TPU_PACKED_ADAM=1``) against the default Adam on the card (bit
    for bit printed), each element within 1e-4 of the steps' largest
    movement (3 x the largest lr): fp32 rounding of the update, whose bias
    corrections ``1 - b^t`` carry up to 6e-5 relative error at t = 1 in fp32
    (JAX's arithmetic, and Adam's ``capturable`` on the card) and none in
    fp64 (``torch.optim.Adam`` on the CPU); then
    the device time of one step on path A's and AMP's parameter sets for the
    default (``torch.optim.Adam`` as each path builds it: A with its
    schedule's device learning rates, ``capturable``; AMP with float ones),
    packed Adam and ``torch.optim.Adam(fused=True)`` (float learning rates; a
    yardstick the port never builds).  Returns the phase's fields."""
    import torch

    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.template.optimizer import AdamFactory, OptimizerFactory, build_optimizer
    from cusrl_tpu_torch.zoo.registry import get_experiment

    print("[optimizer] the families on the card against the CPU, on AMP's parameter set (3 steps, device lrs)")
    amp = _amp_agent(device, live_logits=False)
    named = [(path, p) for path, p in amp.model.named_parameters()]
    gen = torch.Generator().manual_seed(SEED + 20)
    grads = [[torch.randn(p.shape, generator=gen) * 0.01 for _, p in named] for _ in range(3)]
    cpu_named = [(path, p.detach().cpu()) for path, p in named]
    movement = 3 * 3e-3  # three steps at the largest group lr

    def gap(got, want):
        """The largest element gap over every leaf, as a share of ``movement``: (share, leaf)."""
        gaps = {path: (got[path].cpu() - want[path].cpu()).abs().max().item() / movement for path in want}
        name = max(gaps, key=gaps.get)
        return gaps[name], name

    fields, worst = {}, {}
    for cls, kwargs in OPTIMIZER_FAMILIES:
        factory = OptimizerFactory(cls=cls, lr=1e-3, kwargs=dict(kwargs), param_groups={"critic": {"lr": 3e-3}})
        ratio, name = gap(_optimizer_run(named, factory, grads, True), _optimizer_run(cpu_named, factory, grads, True))
        worst[cls] = ratio
        print(f"    {cls:8s} {kwargs}: worst leaf {name} max|card - cpu| / (3 x 3e-3) = {ratio:.3e} (limit 1e-4)")
        if not ratio <= 1e-4:
            raise AssertionError(f"optimizer {cls} on the card disagrees with the CPU")
    fields["family_worst_gap"] = worst
    adam = OptimizerFactory(cls="adam", lr=1e-3, param_groups={"critic": {"lr": 3e-3}})
    default = _optimizer_run(named, adam, grads, True)
    os.environ["CUSRL_TPU_PACKED_ADAM"] = "1"
    try:
        packed = _optimizer_run(named, adam, grads, True)
    finally:
        os.environ.pop("CUSRL_TPU_PACKED_ADAM")
    ratio, name = gap(packed, default)
    bitwise = all(torch.equal(packed[p], default[p]) for p in default)
    print(f"    packed Adam against the default on the card: worst leaf {name} {ratio:.3e} (limit 1e-4), "
          f"{'the same bits' if bitwise else 'not the same bits'}")
    if not ratio <= 1e-4:
        raise AssertionError("packed Adam disagrees with the default Adam on the card")
    fields.update(packed_gap=ratio, packed_bitwise=bitwise)

    print("[optimizer] device ms of one optimizer step (torch.profiler), three variants")
    path_a = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
    a_agent = path_a(VelocityLocomotionEnv(num_instances=NUM_ENVS, device=device).spec, device=device, seed=SEED)
    for label, agent in (("A", a_agent), ("AMP", amp)):
        params = [p for p in agent.model.parameters()]
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen).to(device) * 0.01
        count = sum(p.numel() for p in params)
        groups = [{"params": g["params"], "lr": float(g["lr"])} for g in agent.optimizer.optimizer.param_groups]
        os.environ["CUSRL_TPU_PACKED_ADAM"] = "1"
        try:
            packed_opt = build_optimizer(AdamFactory(lr=agent.optimizer.base_learning_rates["default"]),
                                         agent.model.named_parameters())
        finally:
            os.environ.pop("CUSRL_TPU_PACKED_ADAM")
        if isinstance(agent.optimizer.optimizer.param_groups[0]["lr"], torch.Tensor):  # A: its schedule's
            packed_opt.use_device_learning_rates()
        fused = torch.optim.Adam(groups, fused=True)
        variants = {"default": agent.optimizer.step, "packed": packed_opt.step, "fused": fused.step}
        times = {}
        for variant, step in variants.items():
            ms, by = _device_ms_per_call(step)
            times[variant] = ms
            print(f"    {label} ({count} parameters in {len(params)} leaves): {variant:8s} {ms:.4f} device ms per "
                  f"step ({by})")
        fields[f"{label}_step_device_ms"] = times
    return fields


# -- Paths TF and TJ: the transformer entry on its fused-block route ----------

T_IN = 48  # Velocity-Flat observations
BLOCK_ROWS = T_MB_ENVS * STEPS  # 6,144 rows per minibatch pass
PRIMAL_ROWS = T_ENVS * STEPS  # 24,576 rows in the value, next-token and KL passes
TL_MB_ROWS = T_MB_ENVS * TL_STEPS  # 65,536 rows per minibatch pass on path TL
TL_PRIMAL_ROWS = T_ENVS * TL_STEPS  # 262,144 rows in TL's value, next-token and KL passes
BLOCK_REPLACES = {
    "K4pre_f": "cusrl_tpu/nn/kernels/fused_block.py:193",
    "K4pre_b": "cusrl_tpu/nn/kernels/fused_block.py:218",
    "K4post_f": "cusrl_tpu/nn/kernels/fused_block.py:359",
    "K4post_b": "cusrl_tpu/nn/kernels/fused_block.py:390",
    "K5pre_f": "cusrl_tpu/nn/kernels/fused_block.py:696",
    "K5pre_b": "cusrl_tpu/nn/kernels/fused_block.py:720",
    "K5post_f": "cusrl_tpu/nn/kernels/fused_block.py:883",
    "K5post_b": "cusrl_tpu/nn/kernels/fused_block.py:910",
}


# Phase 1 of the block backwards: (bytes, FLOP) per row per chain, each input
# read once and each output written once.  Pre (skip_input_grad): gqkv (bf16),
# h and gh (fp32) in, y and bf16(dh) out; dy = gqkv W_qkv.  Post: g, r1 and the
# saved z1 (bf16) in; bf16(dz1), y2, bf16(dr1) (bf16), dh and dattn (fp32)
# out; dz1 = g W_down, dy2 = dz1 W_up, dattn = dr1 W_o.
BLOCK_PHASE1 = {
    "pre_b": (2 * 3 * T_EMBED + 4 * 2 * T_EMBED + 2 * 2 * T_EMBED, 2 * 3 * T_EMBED * T_EMBED),
    "post_b": (2 * (2 * T_EMBED + T_FF) + 2 * (T_FF + 2 * T_EMBED) + 4 * 2 * T_EMBED,
               2 * (2 * T_EMBED * T_FF + T_EMBED * T_EMBED)),
}

# Phase 2 of the block backwards: (dW shapes, bytes per row it reads, column
# sums).  Pre: D = bf16(dh) and gqkv, H = x (fp32) and y; post: D = bf16(dr1),
# bf16(dz1) and g, H = attn (fp32), y2 and the saved z1.
BLOCK_PHASE2 = {
    "pre_b": ([(T_EMBED, T_IN)] + [(T_EMBED, T_EMBED)] * 3, 2 * 4 * T_EMBED + 4 * T_IN + 2 * T_EMBED, 6 * T_EMBED),
    "post_b": ([(T_EMBED, T_EMBED), (T_FF, T_EMBED), (T_EMBED, T_FF)],
               2 * (2 * T_EMBED + T_FF) + 4 * T_EMBED + 2 * (T_EMBED + T_FF), 4 * T_EMBED + T_FF),
}


def _block_params(gen, device):
    """Random (pre, post) parameters of one encoder layer at the zoo's widths,
    in the order ``fused_block_pre`` / ``fused_block_post`` take them."""
    import torch

    def w(out, inp):
        return (torch.randn(out, inp, generator=gen) / math.sqrt(inp)).to(device)

    def v(n, base=0.0):
        return (base + torch.randn(n, generator=gen) * 0.1).to(device)

    e, f = T_EMBED, T_FF
    return ((w(e, T_IN), v(e), v(e, 1.0), v(e), w(e, e), w(e, e), w(e, e), v(e), v(e), v(e)),
            (w(e, e), v(e), v(e, 1.0), v(e), w(f, e), v(f), w(e, f), v(e)))


def _block_work(op: str, rows: int, chains: int, save: bool = True):
    """(FLOP, bytes) of one pre or post op, forward or backward (the pre
    backward with skip_input_grad, as the path runs it), on these shapes:
    each input read once, each output written once (h travels as fp32, the
    rest of the activations as bf16)."""
    e, f, i = T_EMBED, T_FF, T_IN
    if op.startswith("pre"):
        params = i * e + 3 * e * e + 6 * e
        if op == "pre_f":
            flops = 2 * rows * (i * e + 3 * e * e)
            nbytes = rows * i * 4 + params * 4 + rows * e * 4 + rows * 3 * e * 2
        else:
            flops = 2 * rows * (6 * e * e + e * i)
            nbytes = (rows * (i * 4 + e * 4 + e * 4 + 3 * e * 2) + (i * e + 3 * e * e + 2 * e) * 4  # x, h, gh, gqkv, W
                      + params * 4)  # gradients
    else:
        params = e * e + 2 * e * f + 5 * e + f
        if op == "post_f":
            flops = 2 * rows * (e * e + 2 * e * f)
            nbytes = rows * e * 8 + params * 4 + rows * e * 2 + ((rows * e * 2 + rows * f * 2) if save else 0)
        else:
            flops = 2 * rows * (2 * e * e + 4 * e * f)
            nbytes = (rows * (e * 4 + e * 2 + e * 2 + f * 2) + (e * e + 2 * e * f + 2 * e) * 4  # attn, g, r1, s, W
                      + rows * e * 8 + params * 4)  # dattn, dh, gradients
    return chains * flops, chains * nbytes


def _library_blocks(op, xs, hs, params):
    """``_library_block`` on each chain: the pre op on ``xs`` with the pre
    parameters ``params``, or the post op on ``xs`` (attention outputs) and
    ``hs`` with the post parameters."""
    if op == "pre":
        return [_library_block("pre", x, None, p, None) for x, p in zip(xs, params)]
    return [_library_block("post", a, h, None, p) for a, h, p in zip(xs, hs, params)]


def _library_block(op, x, h, pre16, post16):
    """The yardstick the port never calls: bf16 ``F.linear`` +
    ``F.layer_norm`` + ``F.linear`` for pre, and the post chain in the same
    ops (gelu FFN)."""
    import torch
    import torch.nn.functional as F

    if op == "pre":
        w_in, b_in, g1, bb1, w_qkv, b_qkv = pre16
        hh = F.linear(x, w_in, b_in)
        return hh, F.linear(F.layer_norm(hh, (T_EMBED,), g1, bb1, eps=1e-6), w_qkv, b_qkv)
    w_o, b_o, g2, bb2, w_up, b_up, w_down, b_down = post16
    r1 = h + F.linear(x, w_o, b_o)
    y2 = F.layer_norm(r1, (T_EMBED,), g2, bb2, eps=1e-6)
    return (r1 + F.linear(F.gelu(F.linear(y2, w_up, b_up), approximate="tanh"), w_down, b_down),)


def _ptxas_usage(stem: str) -> dict:
    """``{kernel symbol: (registers, spill store bytes, spill load bytes)}``
    from the ``-Xptxas -v`` log of ``csrc/<stem>.cu`` (``_build/<stem>.log``)."""
    from cusrl_tpu_torch.nn.kernels import build

    usage, name, spills = {}, None, (0, 0)
    for line in (build.BUILD_DIR / f"{stem}.log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            words = line.split()
            spills = (int(words[words.index("spill") - 2]), int(words[-4]))
        elif "Used" in line and "registers" in line and name:
            words = line.split()
            usage[name] = (int(words[words.index("registers,") - 1]), *spills)
    return usage


def _forward_device_ms(key: str, fn, namespace: str = "fbf", kernels: int = 2, repeats: int = 10,
                       warmup: int = 3) -> dict:
    """Device time per call of a wgmma forward's launches (torch.profiler by
    kernel name in ``namespace``: the pack kernel, where there is one, and
    the forward kernel, each its mean per launch; ``kernels`` of them); the
    events' ``ms`` adds the wrapper's host time before the launches.  Where
    the profiler records no device event, ``device_ms`` is the call's
    kernels together by CUDA events, the pack's time not measured."""
    device_events = 0
    for _ in range(PROFILE_ATTEMPTS):
        found, seen, _ = _profiled_kernels(fn, (namespace,), repeats, warmup)
        device_events += seen
        if len(found) == kernels and all(repeats // 2 <= count <= repeats for _, count, _ in found):
            break
    else:
        if device_events:
            raise AssertionError(f"{key}: the profiler saw {found} over {repeats} calls in each of {PROFILE_ATTEMPTS} "
                                 f"sessions; expected {kernels} kernel(s) of {namespace}::, each once per call")
        device_ms = _queued_events_ms(fn, repeats, warmup)
        print(f"    {key}: the profiler saw no device event in {PROFILE_ATTEMPTS} sessions; the call's kernels "
              f"together {device_ms:.4f} ms by CUDA events")
        return {"pack_ms": None, "device_ms": device_ms, "device_ms_by": "CUDA events, the pack included"}
    fields = {("pack_ms" if "pack_kernel" in name else "device_ms"): us / count / 1e3 for name, count, us in found}
    return {"pack_ms": 0.0, **fields}


def _chain_forward_fields(key: str, fn, dims, rows: int, chains: int, events_ms: float, heads: bool = False) -> dict:
    """Prints and returns the MLP chain forward's plan at these rows
    (``mlpf::plan``: grid, images resident or streamed through the ring,
    shared memory per block, the kernel instance's registers from the build
    log) and its device time per call by kernel name (``mlpf::pack_kernel``
    where the images stream, ``mlpf::chain_fwd_kernel``) beside the events'."""
    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    plan = fm.fwd_plan(dims, rows, chains)
    usage = _ptxas_usage("mlp_chain_fwd")
    symbol = next(name for name in usage if f"chain_fwd_kernelILi{plan['per_sm']}ELb{int(heads)}E" in name)
    regs, spill_st, spill_ld = usage[symbol]
    fields = _forward_device_ms(key, fn, "mlpf", 1 if plan["resident"] else 2)
    images = ("resident, converted once per block" if plan["resident"]
              else f"streamed through {plan['slots']} slots, packed per call")
    print(f"    {key} rows={rows}: device_ms={_ms(fields['device_ms'])} (+ pack {_ms(fields['pack_ms'])}) of the "
          f"events' {events_ms:.4f} ms; grid {plan['blocks']} x {chains} ({plan['per_sm']} per SM), "
          f"{plan['tiles']} tiles of 64 rows, up to {-(-plan['tiles'] // plan['blocks'])} per block; "
          f"{plan['images']} images ({images}); {plan['smem_bytes']} B shared memory per block; {regs} registers, "
          f"spills {spill_st}/{spill_ld} B (ptxas)")
    return {**fields, "grid": f"{plan['blocks']} x {chains} blocks ({plan['per_sm']} per SM), {plan['tiles']} tiles",
            "ring": f"{plan['slots']} of {plan['images']} images ({'resident' if plan['resident'] else 'streamed'})",
            "smem_bytes": plan["smem_bytes"], "regs": regs}


def _forward_plan_fields(key: str, rows: int, chains: int, save: bool) -> dict:
    """Prints and returns the launch plan of a fused block forward (K4/K5 pre
    or post f) at these rows: grid, tiles per block, ring, shared memory per
    block, and the kernel's registers and spills from the build log."""
    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    op = "pre" if "pre" in key else "post"
    plan = fb.fwd_plan(op, rows, chains, T_IN, T_EMBED, T_FF, "gelu", save)
    symbol = next(name for name in _ptxas_usage("fused_block") if f"{op}_fwd_kernel" in name and "fbf" in name)
    regs, spill_st, spill_ld = _ptxas_usage("fused_block")[symbol]
    per_block = -(-plan["tiles"] // plan["blocks"])
    tile_rows, per_sm = fb.FWD_GRID[op]
    print(f"    {key} rows={rows}: grid {plan['blocks']} blocks x {chains} chain(s) ({per_sm} per SM), "
          f"{plan['tiles']} tiles of {tile_rows} rows, up to {per_block} per block; ring {plan['slots']} slots of "
          f"{plan['images']} images ({'resident' if plan['resident'] else 'streamed'}); {plan['smem_bytes']} B shared "
          f"memory per block; {regs} registers, spills {spill_st}/{spill_ld} B (ptxas)")
    return {"grid": f"{plan['blocks']} x {chains} blocks, {plan['tiles']} tiles of {tile_rows} rows, up to "
                    f"{per_block} per block", "ring": f"{plan['slots']} of {plan['images']} images",
            "smem_bytes": plan["smem_bytes"], "regs": regs}


def check_block_kernels(device) -> dict:
    """K4 (one layer) and K5 (the actor+critic pair) pre and post, forward
    and backward, against their plain versions (forward and hand-written
    backward) at the paths' shapes (TF's 6,144 rows per minibatch pass and
    the primal pre and post at 24,576; K4 also at TL's 65,536 and 262,144;
    K5 at 2 x 6,144) and a ragged one (1,000 rows: pre with dX, post with
    ELU); timed with the plain version and the library yardstick (autograd
    over a retained graph for the backwards).  TL's numbers are the ``tl_``
    and ``tl_primal_`` fields."""
    import torch

    from cusrl_tpu_torch.nn.kernels import fused_block as fb

    gen = torch.Generator().manual_seed(SEED + 9)
    layers = [_block_params(gen, device) for _ in range(2)]
    errs = {key: [] for key in BLOCK_REPLACES}
    results = {}

    def obs(rows):
        return torch.tanh(torch.randn(rows, T_IN, generator=gen)).to(device)

    def attn_in(rows):
        return torch.randn(rows, T_EMBED, generator=gen).to(device)

    def residual(rows):
        return torch.randn(rows, T_EMBED, generator=gen).to(device, torch.bfloat16).float()

    def cot(rows, width, dtype=torch.bfloat16):
        return (torch.randn(rows, width, generator=gen) * 0.01).to(device, dtype)

    def bwd_plain_pre(x, h, gh, gqkv, ps, skip):
        return fb.pre_bwd_plain(x, h, gh, gqkv, ps[0], *ps[4:7], ps[2], ps[3], skip)

    def post_w(ps):
        return (ps[0], ps[4], ps[6], ps[2], ps[3])

    for k, chains in (("K4", 1), ("K5", 2)):
        pres, posts = [l[0] for l in layers[:chains]], [l[1] for l in layers[:chains]]
        print(f"[kernels] {k} fused block, {chains} chain{'s' if chains > 1 else ''}")
        cases = ((BLOCK_ROWS, True, "gelu"), (RAGGED_ROWS, False, "elu"))
        if k == "K4":
            cases += ((TL_MB_ROWS, True, "gelu"),)
        for rows, skip, act in cases:
            xs = [obs(rows) for _ in range(chains)]
            hs, qkvs = fb._launch_pre_fwd(xs, pres, f"{k}pre_f")
            refs = [fb.pre_fwd_plain(x, *ps) for x, ps in zip(xs, pres)]
            torch.cuda.synchronize()
            for c, (h, qkv, (rh, rqkv)) in enumerate(zip(hs, qkvs, refs)):
                errs[f"{k}pre_f"].append(_check(f"pre h[{c}] rows={rows}", h, rh, rel=False))
                errs[f"{k}pre_f"].append(_check(f"pre qkv[{c}] rows={rows}", qkv, rqkv, rel=False))
            ghs = [cot(rows, T_EMBED, torch.float32) for _ in range(chains)]
            gqkvs = [cot(rows, 3 * T_EMBED) for _ in range(chains)]
            got = fb._launch_pre_bwd(xs, [r[0] for r in refs], ghs, gqkvs, pres, skip, f"{k}pre_b")
            names = ("dx", "dW_in", "db_in", "dg1", "dbb1", "dW_q", "dW_k", "dW_v", "db_q", "db_k", "db_v")
            for c, result in enumerate(got):
                want = bwd_plain_pre(xs[c], refs[c][0], ghs[c], gqkvs[c], pres[c], skip)
                torch.cuda.synchronize()
                if (result[0] is None) != skip:
                    raise AssertionError("pre backward: dx present against skip_input_grad")
                for name, a, b in zip(names, result, want):
                    if b is not None:
                        errs[f"{k}pre_b"].append(_check(f"pre {name}[{c}] rows={rows}", a, b, rel=True))
            attns, hs_in = [attn_in(rows) for _ in range(chains)], [residual(rows) for _ in range(chains)]
            prefs = [fb.post_fwd_plain(a, h, *ps, act, True) for a, h, ps in zip(attns, hs_in, posts)]
            for save in (True, False):
                outs, r1s, saveds = fb._launch_post_fwd(attns, hs_in, posts, act, save, f"{k}post_f")
                torch.cuda.synchronize()
                for c, (out, r1, saved) in enumerate(zip(outs, r1s, saveds)):
                    tag = f"[{c}] save={int(save)} {act} rows={rows}"
                    errs[f"{k}post_f"].append(_check(f"post out{tag}", out, prefs[c][0], rel=False))
                    if save:
                        errs[f"{k}post_f"].append(_check(f"post r1{tag}", r1, prefs[c][1], rel=False))
                        errs[f"{k}post_f"].append(_check(f"post saved{tag}", saved, prefs[c][2], rel=False))
                    elif r1 is not None or saved is not None:
                        raise AssertionError("the primal post op wrote saved tensors")
            gs = [cot(rows, T_EMBED) for _ in range(chains)]
            got = fb._launch_post_bwd(attns, gs, [r[1] for r in prefs], [r[2] for r in prefs],
                                      [post_w(ps) for ps in posts], act, f"{k}post_b")
            names = ("dattn", "dh", "dW_o", "db_o", "dg2", "dbb2", "dW_up", "db_up", "dW_down", "db_down")
            for c, result in enumerate(got):
                want = fb.post_bwd_plain(attns[c], gs[c], prefs[c][1], prefs[c][2], *post_w(posts[c]), act)
                torch.cuda.synchronize()
                for name, a, b in zip(names, result, want):
                    errs[f"{k}post_b"].append(_check(f"post {name}[{c}] {act} rows={rows}", a, b, rel=True))

        # Timing at the paths' shapes (gelu, skip_input_grad): kernel, plain, library.
        for rows, tag in ((BLOCK_ROWS, ""), (TL_MB_ROWS, "tl_"))[: 2 if k == "K4" else 1]:
            xs = [obs(rows) for _ in range(chains)]
            attns, hs_in = [attn_in(rows) for _ in range(chains)], [residual(rows) for _ in range(chains)]
            refs = [fb.pre_fwd_plain(x, *ps) for x, ps in zip(xs, pres)]
            prefs = [fb.post_fwd_plain(a, h, *ps, "gelu", True) for a, h, ps in zip(attns, hs_in, posts)]
            ghs = [cot(rows, T_EMBED, torch.float32) for _ in range(chains)]
            gqkvs = [cot(rows, 3 * T_EMBED) for _ in range(chains)]
            gs = [cot(rows, T_EMBED) for _ in range(chains)]
            pre16 = [(ps[0], ps[1], ps[2], ps[3], torch.cat(ps[4:7]), torch.cat(ps[7:10])) for ps in pres]
            pre16 = [[t.to(torch.bfloat16).requires_grad_() for t in ps] for ps in pre16]
            post16 = [[t.to(torch.bfloat16).requires_grad_() for t in ps] for ps in posts]
            x16 = [x.to(torch.bfloat16) for x in xs]
            a16 = [a.to(torch.bfloat16).requires_grad_() for a in attns]
            h16 = [h.to(torch.bfloat16).requires_grad_() for h in hs_in]
            timed = {
                "pre_f": (lambda: fb._launch_pre_fwd(xs, pres, f"{k}pre_f"),
                          lambda: [fb.pre_fwd_plain(x, *ps) for x, ps in zip(xs, pres)]),
                "pre_b": (lambda: fb._launch_pre_bwd(xs, [r[0] for r in refs], ghs, gqkvs, pres, True, f"{k}pre_b"),
                          lambda: [bwd_plain_pre(x, r[0], gh, gq, ps, True)
                                   for x, r, gh, gq, ps in zip(xs, refs, ghs, gqkvs, pres)]),
                "post_f": (lambda: fb._launch_post_fwd(attns, hs_in, posts, "gelu", True, f"{k}post_f"),
                           lambda: [fb.post_fwd_plain(a, h, *ps, "gelu", True) for a, h, ps in zip(attns, hs_in, posts)]),
                "post_b": (lambda: fb._launch_post_bwd(attns, gs, [r[1] for r in prefs], [r[2] for r in prefs],
                                                       [post_w(ps) for ps in posts], "gelu", f"{k}post_b"),
                           lambda: [fb.post_bwd_plain(a, g, r[1], r[2], *post_w(ps), "gelu")
                                    for a, g, r, ps in zip(attns, gs, prefs, posts)]),
            }
            with torch.no_grad():
                lib_f = {"pre_f": functools.partial(_library_blocks, "pre", x16, None, pre16),
                         "post_f": functools.partial(_library_blocks, "post", a16, h16, post16)}
                lib_ms = {op: _time_ms(fn) for op, fn in lib_f.items()}
            if (k, tag) == ("K4", "tl_"):  # TL's post forward, saving
                QUEUE["K4post_f", tag] = (
                    functools.partial(fb._launch_post_fwd, attns, hs_in, posts, "gelu", True, "K4post_f"),
                    _no_grad(lib_f["post_f"]))
            if (k, tag) == ("K5", ""):  # TJ's paired pre forward
                QUEUE["K5pre_f", tag] = (functools.partial(fb._launch_pre_fwd, xs, pres, "K5pre_f"),
                                         _no_grad(lib_f["pre_f"]))
            with torch.enable_grad():
                pre_out = [_library_block("pre", x, None, p, None) for x, p in zip(x16, pre16)]
                pre_in = [t for p in pre16 for t in p]
                pre_g = [g for gh, gq in zip(ghs, gqkvs) for g in (gh.to(torch.bfloat16), gq)]
                lib_pre_b = functools.partial(torch.autograd.grad, [t for o in pre_out for t in o], pre_in, pre_g,
                                              retain_graph=True)
                lib_ms["pre_b"] = _time_ms(lib_pre_b)
                QUEUE[f"{k}pre_b", tag] = (functools.partial(fb._launch_pre_bwd, xs, [r[0] for r in refs], ghs, gqkvs,
                                                             pres, True, f"{k}pre_b"), lib_pre_b)
                post_out = [_library_block("post", a, h, None, p)[0] for a, h, p in zip(a16, h16, post16)]
                post_in = [*a16, *h16, *(t for p in post16 for t in p)]
                lib_ms["post_b"] = _time_ms(lambda: torch.autograd.grad(post_out, post_in, gs, retain_graph=True))
            for op, (kernel_fn, plain_fn) in timed.items():
                key = f"{k}{op}"
                k_ms, p_ms = _time_ms(kernel_fn), _time_ms(plain_fn)
                bound, by = _bound_ms(*_block_work(op, rows, chains))
                print(f"    {key} rows={rows}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={lib_ms[op]:.4f} "
                      f"bound_ms={bound:.4f} ({by})")
                fields = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms[op], bound_ms=bound, bound_by=by,
                              shape=f"{chains} x {rows} rows, 48 -> 128 (3 x 128), FFN 512 gelu"
                              + (", skip_input_grad" if op == "pre_b" else "")
                              + (", saves r1 and z1" if op == "post_f" else ""))
                if op in BLOCK_PHASE2:
                    if op == "post_b":
                        plan = _phase1_plan(key, fb.bwd_plan(rows, chains, T_EMBED, T_FF), "fused_block",
                                            "3fbb15post_bwd_kernel")
                    else:
                        plan = _phase1_plan(key, {**fb.pre_bwd_card_plan(rows, chains, T_IN, T_EMBED, True),
                                                  "per_sm": fb.PRE_BWD_BLOCKS_PER_SM}, "fused_block",
                                            "3fbp14pre_bwd_kernel")
                    fields.update(_backward_phases(key, kernel_fn, rows, chains, *BLOCK_PHASE2[op][:2],
                                                   chains * BLOCK_PHASE2[op][2],
                                                   tuple(chains * v for v in BLOCK_PHASE1[op]), plan))
                else:
                    fields.update(_forward_plan_fields(key, rows, chains, save=True))
                    fields.update(_forward_device_ms(key, kernel_fn))
                    print(f"    {key} rows={rows}: device_ms={_ms(fields['device_ms'])} (+ pack "
                          f"{_ms(fields['pack_ms'])}) of the events' {k_ms:.4f} ms")
                results.setdefault(key, {}).update({tag + f: v for f, v in fields.items()})
        if k == "K4":  # the value, next-token and KL passes: pre, and post saving nothing
            for rows, tag in ((PRIMAL_ROWS, "primal_"), (TL_PRIMAL_ROWS, "tl_primal_")):
                x, a, h = obs(rows), attn_in(rows), residual(rows)
                (hh,), (qkv,) = fb._launch_pre_fwd([x], pres[:1], "K4pre_f")
                rh, rqkv = fb.pre_fwd_plain(x, *pres[0])
                errs["K4pre_f"].append(_check(f"pre h primal rows={rows}", hh, rh, rel=False))
                errs["K4pre_f"].append(_check(f"pre qkv primal rows={rows}", qkv, rqkv, rel=False))
                ref = fb.post_fwd_plain(a, h, *posts[0], "gelu", False)[0]
                out = fb._launch_post_fwd([a], [h], posts[:1], "gelu", False, "K4post_f")[0][0]
                errs["K4post_f"].append(_check(f"post out primal rows={rows}", out, ref, rel=False))
                x16, a16, h16 = x.to(torch.bfloat16), a.to(torch.bfloat16), h.to(torch.bfloat16)
                primal = {
                    "K4pre_f": (lambda: fb._launch_pre_fwd([x], pres[:1], "K4pre_f"),
                                lambda: fb.pre_fwd_plain(x, *pres[0]),
                                lambda: _library_block("pre", x16, None, pre16[0], None),
                                _block_work("pre_f", rows, 1)),
                    "K4post_f": (lambda: fb._launch_post_fwd([a], [h], posts[:1], "gelu", False, "K4post_f"),
                                 lambda: fb.post_fwd_plain(a, h, *posts[0], "gelu", False),
                                 lambda: _library_block("post", a16, h16, None, post16[0]),
                                 _block_work("post_f", rows, 1, save=False)),
                }
                if rows == PRIMAL_ROWS:  # the value, next-token and KL passes' pre forward
                    QUEUE["K4pre_f", tag] = (
                        functools.partial(fb._launch_pre_fwd, [x], pres[:1], "K4pre_f"),
                        _no_grad(functools.partial(_library_blocks, "pre", [x16], None, pre16[:1])))
                for key, (kernel_fn, plain_fn, library_fn, work) in primal.items():
                    k_ms, p_ms = _time_ms(kernel_fn), _time_ms(plain_fn)
                    with torch.no_grad():
                        l_ms = _time_ms(library_fn)
                    bound, by = _bound_ms(*work)
                    print(f"    {key} primal rows={rows}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                          f"library_ms={l_ms:.4f} bound_ms={bound:.4f} ({by})")
                    results[key].update({tag + "ms": k_ms, tag + "plain_ms": p_ms, tag + "library_ms": l_ms,
                                         tag + "bound_ms": bound})
                    plan = _forward_plan_fields(key, rows, 1, save=False)
                    plan.update(_forward_device_ms(key, kernel_fn))
                    print(f"    {key} primal rows={rows}: device_ms={_ms(plan['device_ms'])} (+ pack "
                          f"{_ms(plan['pack_ms'])}) of the events' {k_ms:.4f} ms")
                    results[key].update({tag + f: v for f, v in plan.items()})
    for key in results:
        results[key]["max_abs_err"] = max(errs[key])
    return results


def _pair_wrapper_errors(device, gen, in_dim: int, x_dtype, rows: int) -> dict:
    """``fused_mlp_pair`` with input gradients on two ``in_dim`` -> 128 ELU
    tails (trailing activation) under autograd, on the card against the same
    call on the CPU (its plain version): each call launches K2f and K2b once,
    the input gradients come back in the inputs' dtype, and the outputs, dX,
    dW and db agree at ``check_kernels``'s limits.  Returns
    ``{"K2f": [errors], "K2b": [errors]}``."""
    import torch

    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    tails = [[(torch.randn(T_EMBED, in_dim, generator=gen) / math.sqrt(in_dim)),
              torch.randn(T_EMBED, generator=gen) * 0.1] for _ in range(2)]
    lat = [torch.randn(rows, in_dim, generator=gen).to(x_dtype) for _ in range(2)]
    gl = [(torch.randn(rows, T_EMBED, generator=gen) * 0.01).to(torch.bfloat16) for _ in range(2)]

    def run(device_):
        leaves = [[t.to(device_).requires_grad_() for t in tail] for tail in tails]
        x = [t.to(device_).requires_grad_() for t in lat]
        before = dict(fm.LAUNCHES)
        outs = fm.fused_mlp_pair(*x, leaves[0][:1], leaves[0][1:], leaves[1][:1], leaves[1][1:], "elu", True,
                                 skip_input_grad=False)
        torch.autograd.backward(list(outs), [g.to(device_) for g in gl])
        launched = {n: v - before[n] for n, v in fm.LAUNCHES.items() if v != before[n]}
        return outs, x, leaves, launched

    (outs, x, leaves, launched), (ref_outs, ref_x, ref_leaves, _) = run(device), run("cpu")
    if launched != {"K2f": 1, "K2b": 1}:
        raise AssertionError(f"fused_mlp_pair with input gradients launched {launched}")
    errs = {"K2f": [], "K2b": []}
    for c in range(2):
        errs["K2f"].append(_check(f"tail out[{c}]", outs[c].cpu(), ref_outs[c], rel=False))
        if x[c].grad is None or x[c].grad.dtype != x_dtype:
            raise AssertionError(f"fused_mlp_pair returned no {x_dtype} input gradient")
        errs["K2b"].append(_check(f"tail x.grad[{c}]", x[c].grad.cpu(), ref_x[c].grad, rel=True))
        for i, (a, b) in enumerate(zip(leaves[c], ref_leaves[c])):
            errs["K2b"].append(_check(f"tail param{i}.grad[{c}]", a.grad.cpu(), b.grad, rel=True))
    return errs


def check_block_wrappers(device) -> dict:
    """The wrappers the fused route calls, under autograd at the path's
    shapes, against the same calls on the CPU (their plain versions): K4's
    and K5's pre -> post with every ``.grad`` and the residual's cotangent
    reaching the pre op in fp32, and the post wrappers raising for an
    unsupported activation; ``fused_mlp_pair`` with input gradients (the
    joint evaluation's tails, 6,144 x 128 -> 128 ELU); and the fused step
    route against the modular step for a few rollout steps at 1,024
    environments.  Returns the largest error per kernel."""
    import torch

    from cusrl_tpu_torch.nn.kernels import fused_block as fb
    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED + 10)
    rows = BLOCK_ROWS
    errs = {key: [] for key in BLOCK_REPLACES}
    errs.update(K2f=[], K2b=[])
    for k, chains in (("K4", 1), ("K5", 2)):
        print(f"[wrappers] {k}: fused_block{'_pair' if chains > 1 else ''}_pre -> post, autograd, rows={rows}")
        params = [t for _ in range(chains) for ps in _block_params(gen, "cpu") for t in ps]
        xs = [torch.tanh(torch.randn(rows, T_IN, generator=gen)) for _ in range(chains)]
        noise = [torch.randn(rows, T_EMBED, generator=gen) for _ in range(chains)]
        gouts = [(torch.randn(rows, T_EMBED, generator=gen) * 0.01).to(torch.bfloat16) for _ in range(chains)]

        def run(device_):
            ps = [p.detach().to(device_, copy=True).requires_grad_() for p in params]
            pre = [ps[18 * c:18 * c + 10] for c in range(chains)]
            post = [ps[18 * c + 10:18 * c + 18] for c in range(chains)]
            x = [t.to(device_) for t in xs]
            before = dict(fb.LAUNCHES)
            if chains == 2:
                ha, hc, qa, qc = fb.fused_block_pair_pre(*x, pre[0], pre[1])
                hs, qkvs = [ha, hc], [qa, qc]
            else:
                h, qkv = fb.fused_block_pre(x[0], *pre[0])
                hs, qkvs = [h], [qkv]
            seen = []
            for h in hs:
                h.register_hook(seen.append)
            attns = [q[:, :T_EMBED].float() * n.to(device_) for q, n in zip(qkvs, noise)]
            outs = (list(fb.fused_block_pair_post(*attns, *hs, post[0], post[1])) if chains == 2
                    else [fb.fused_block_post(attns[0], hs[0], *post[0])])
            torch.autograd.backward(outs, [g.to(device_) for g in gouts])
            torch.cuda.synchronize()
            launched = {n: v - before[n] for n, v in fb.LAUNCHES.items() if v != before[n]}
            return outs, ps, seen, launched

        (outs, ps, seen, launched), (ref_outs, ref_ps, ref_seen, _) = run(device), run("cpu")
        if launched != {f"{k}pre_f": 1, f"{k}pre_b": 1, f"{k}post_f": 1, f"{k}post_b": 1}:
            raise AssertionError(f"{k} wrappers launched {launched}")
        if not all(g.dtype == torch.float32 for g in (*seen, *ref_seen)) or len(seen) != chains:
            raise AssertionError("the residual's cotangent did not reach the pre op in fp32")
        if all(torch.equal(g, g.to(torch.bfloat16).float()) for g in seen):
            raise AssertionError("the residual's cotangent holds only bf16 values: it was rounded")
        print(f"    residual cotangent reaches the pre op as {seen[0].dtype} (not bf16-representable)")
        for c, (a, b) in enumerate(zip(outs, ref_outs)):
            errs[f"{k}post_f"].append(_check(f"out[{c}]", a.cpu(), b, rel=False))
        for i, (a, b) in enumerate(zip(ps, ref_ps)):
            key = f"{k}pre_b" if i % 18 < 10 else f"{k}post_b"
            errs[key].append(_check(f"param{i}.grad", a.grad.cpu(), b.grad, rel=True))

    # An activation the kernels do not take raises on the card (the CPU takes the reference).
    post = [p.to(device) for p in _block_params(gen, "cpu")[1]]
    attn = torch.randn(64, T_EMBED, generator=gen).to(device)
    for call in (lambda: fb.fused_block_post(attn, attn, *post, "silu"),
                 lambda: fb.fused_block_pair_post(attn, attn, attn, attn, post, post, "silu")):
        try:
            call()
        except NotImplementedError:
            continue
        raise AssertionError("the fused block's post wrapper took an unsupported activation on the card")
    print("[wrappers] an unsupported activation (silu) raises on the card, single and pair")

    print(f"[wrappers] fused_mlp_pair with input gradients, rows={rows}, 128 -> 128 ELU (the joint evaluation's tails)")
    for key, found in _pair_wrapper_errors(device, gen, T_EMBED, torch.bfloat16, rows).items():
        errs[key].extend(found)

    print(f"[wrappers] the fused step route against the modular step, {T_ENVS} environments, 4 steps")
    from cusrl_tpu_torch.nn.module.causal_attn import CausalTransformerEncoderLayerFactory

    torch.manual_seed(SEED + 11)
    layer = CausalTransformerEncoderLayerFactory(embed_dim=T_EMBED, num_heads=T_HEADS, window=T_WINDOW,
                                                 ff_dim=T_FF)(T_IN, None).to(device)
    steps = [torch.tanh(torch.randn(T_ENVS, T_IN, generator=gen)).to(device) for _ in range(4)]
    outputs = {}
    for mode in ("0", "force"):
        fb.reset_launch_counts()
        memory, outs = layer.init_memory(T_ENVS), []
        with _fused_route(mode), torch.no_grad():
            for x in steps:
                out, memory, _ = layer(x, memory)
                outs.append(out)
        torch.cuda.synchronize()
        outputs[mode] = (outs, memory, dict(fb.LAUNCHES))
    (ref_outs, ref_mem, _), (outs, mem, launched) = outputs["0"], outputs["force"]
    if {n: v for n, v in launched.items() if v} != {"K4pre_f": 4, "K4post_f": 4}:
        raise AssertionError(f"the fused step route launched {launched}")
    # The JAX package's fused-against-modular step tolerance (tests/test_fused_block.py:225-255).
    for i, (a, b) in enumerate(zip(outs, ref_outs)):
        if not torch.allclose(a.float(), b.float(), rtol=5e-2, atol=5e-2):
            raise AssertionError(f"fused step {i} disagrees with the modular step")
        errs["K4post_f"].append((a.float() - b.float()).abs().max().item())
    for key in ("k_cache", "v_cache", "cache_mask", "cursor"):
        if not torch.allclose(mem[key].float(), ref_mem[key].float(), rtol=3e-2, atol=3e-2):
            raise AssertionError(f"fused step ring {key} disagrees with the modular step")
    print(f"    outputs max_abs_err={max(errs['K4post_f'][-4:]):.3e} (limit 5e-2 + 5e-2 rel), ring ok, "
          f"launches {launched['K4pre_f']}/{launched['K4post_f']} pre/post")
    return {k: max(v) for k, v in errs.items() if v}


# -- Paths D, S, SL and X: the auxiliary hook library on path A's configuration --

D_WIDTHS = (48, 256, 128)  # the distillation preset's student: relu 48-256-128, a Normal head of 12
D_EPOCHS, D_MINIBATCHES = 1, 8
D_MB = D_EPOCHS * D_MINIBATCHES  # 8 minibatches an update
D_MB_ROWS = NUM_ENVS * STEPS // D_MINIBATCHES  # 12,288 rows per minibatch
D_HOOK = "policy_distillation"
S_MB_ROWS = 2 * MINIBATCH_ROWS  # 49,152: path S's augmented minibatch, per chain of the joint evaluation
X_WIDTHS = (48, 256, 128, 64)  # RND's target and predictor: ELU 48-256-128 -> 64
X_ROLLOUT_ROWS = NUM_ENVS * STEPS  # 98,304 rows in RND's pre_update passes
X_HOOK = "random_network_distillation"
AUX_PATHS = ("D", "S", "X")  # [train-zoo] and [profile]
AUX_CHECKS = ("D", "S", "SL", "X")  # [update-check]
SC_EST_WIDTHS = (48, 256, 128, 16)  # SC's state estimator (in its optimization stage): ELU, 16 observation channels
SC_STEPS = 32  # SC's rollout length from iteration 2 on (OnPolicyBufferCapacitySchedule: 24, then 32)
SC_MB_ROWS = NUM_ENVS * SC_STEPS // MINIBATCHES  # 32,768 rows per minibatch at 32 steps
PO_MINI_BATCHES = (4, 4, 4, 2, 2)  # PO's minibatches in each of its five epochs
PO_MB = sum(PO_MINI_BATCHES)  # 16 minibatches an update
PO_MB_ROWS = NUM_ENVS * STEPS // 2  # 49,152 rows per minibatch in PO's 2-minibatch epochs
CONTROL_PATHS = ("SC", "PO")  # [update-check], [train-zoo] and [profile]
TRAINED: dict = {}  # [train-zoo]'s trained agents by path: A's is path D's expert
ZOO_RATES: dict = {}  # [train-zoo]'s env-steps/s by path


def _s_mirrors():
    """Path S's mirrors, each its own inverse: the halves of the 48-wide
    observation and of the 12-wide action swapped, one channel pair that is
    closed under the swap flipped."""
    from cusrl_tpu_torch.hook.auxiliary.symmetry import MirrorDef

    return {"mirror_observation": MirrorDef((*range(24, 48), *range(24)), (0, 1, 24, 25)),
            "mirror_action": MirrorDef((*range(6, 12), *range(6)), (0, 6))}


def _aux_factory(path: str, ppo_factory=None, expert_path: str | None = None):
    """The agent factory of path D (the distillation preset at its defaults,
    the expert from a ``package`` export at ``expert_path``) or of S, SL or X
    (path A's zoo factory, or ``ppo_factory``, with the hooks added: S the
    override at index 0 and ``SymmetricDataAugmentation`` before the joint
    evaluation, whose batch it doubles; SL the override and
    ``MirrorSymmetryLoss`` after ``on_policy_preparation``; X RND before
    ``value_computation`` and ``ReturnPrediction`` after
    ``on_policy_preparation``)."""
    from cusrl_tpu_torch.hook import (
        EnvironmentSpecOverride,
        MirrorSymmetryLoss,
        RandomNetworkDistillation,
        ReturnPrediction,
        SymmetricDataAugmentation,
    )
    from cusrl_tpu_torch.nn.module.mlp import MlpFactory
    from cusrl_tpu_torch.preset.distillation import DistillationAgentFactory
    from cusrl_tpu_torch.zoo.registry import get_experiment

    if path == "D":
        return DistillationAgentFactory(expert_path=expert_path)
    underlying = (ppo_factory or get_experiment("Velocity-Rough", "ppo").make_agent_factory()).to_underlying()
    if path in ("S", "SL"):
        underlying.register_hook(EnvironmentSpecOverride.create(_s_mirrors()), index=0)
    if path == "S":
        underlying.register_hook(SymmetricDataAugmentation(), before="joint_policy_value_evaluation")
    elif path == "SL":
        underlying.register_hook(MirrorSymmetryLoss(weight=1.0), after="on_policy_preparation")
    elif path == "X":
        underlying.register_hook(RandomNetworkDistillation(module_factory=MlpFactory(hidden_dims=X_WIDTHS[1:-1]),
                                                           output_dim=X_WIDTHS[-1]), before="value_computation")
        underlying.register_hook(ReturnPrediction(), after="on_policy_preparation")
    return underlying


def _export_expert(agent, directory: str) -> str:
    """``agent``'s actor as a ``package`` export in ``directory``."""
    from cusrl_tpu_torch.export import export_agent

    export_agent(agent, directory, target_format="package", verbose=False)
    return directory


def _path_a_agent():
    """A fresh agent of path A (the zoo's Velocity-Rough ``ppo``) on the
    CPU, from the script's seed: the expert of path D's update check."""
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.zoo.registry import get_experiment

    spec = VelocityLocomotionEnv(num_instances=256, device="cpu").spec
    return get_experiment("Velocity-Rough", "ppo").make_agent_factory()(spec, device="cpu", seed=SEED)


def check_aux_kernels(device) -> dict:
    """The chain kernels at the shapes paths D, S, SL and X give them: D's
    student (relu 48-256-128) K1f primal at the rollout step's 4,096 rows,
    saving at the minibatch's 12,288 and a ragged 1,000, K1b with
    ``skip_input_grad`` at both (D's expert, ELU 48-512-256-128 at 4,096,
    is path A's step, checked in ``check_kernels``); S's pair K2f/K2b at 2 x
    49,152 (the augmented minibatch), K2b with ``skip_input_grad``; SL's
    mirrored actor pass, K1f saving and K1b with ``skip_input_grad`` at
    24,576 x 48-512-256-128; X's RND networks (ELU 48-256-128-64) K1f primal
    at ``pre_update``'s 98,304 rows and at the minibatch's 24,576 (the
    target), saving at 24,576 and a ragged 1,000 with K1b
    ``skip_input_grad`` (the predictor).  Returns the ``d_``, ``s_pair_``,
    ``sl_`` and ``x_`` fields of K1f, K1b, K2f and K2b."""
    import torch

    results: dict = {}

    def merge(fields, prefix, shape):
        for key, value in fields.items():
            value[prefix + "shape"] = shape
            results.setdefault(key, {}).update(value)

    print("[kernels] K1f/K1b on path D's student, relu 48-256-128 (the distillation preset)")
    merge(_check_chain_kernels(device, "D", "d_", D_WIDTHS, torch.float32,
                               ((NUM_ENVS, False, "step_", True), (D_MB_ROWS, True, "", True),
                                (RAGGED_ROWS, True, "ragged_", False)), seed=30, activation="relu",
                               skip_input_grad=True), "d_",
          f"{D_MB_ROWS} x 48-256-128 relu (D's minibatch, saving; backward with skip_input_grad; also "
          f"{RAGGED_ROWS} rows); primal at {NUM_ENVS} rows (the rollout step)")
    print("[kernels] K2f/K2b on path S's augmented pair, 2 x 49,152 x 48-512-256-128 (skip_input_grad)")
    merge(_check_chain_kernels(device, "S pair", "s_pair_", WIDTHS, torch.float32,
                               ((S_MB_ROWS, True, "", True),), seed=31, skip_input_grad=True, chains=2), "s_pair_",
          f"2 x {S_MB_ROWS} x 48-512-256-128 ELU (S's augmented minibatch, saving; backward with skip_input_grad)")
    print("[kernels] K1f/K1b on path SL's mirrored actor pass, 24,576 x 48-512-256-128 (skip_input_grad)")
    merge(_check_chain_kernels(device, "SL", "sl_", WIDTHS, torch.float32, ((MINIBATCH_ROWS, True, "", True),),
                               seed=32, skip_input_grad=True), "sl_",
          f"{MINIBATCH_ROWS} x 48-512-256-128 ELU (SL's mirrored actor pass, saving; backward with skip_input_grad)")
    print("[kernels] K1f/K1b on path X's RND networks, ELU 48-256-128-64")
    merge(_check_chain_kernels(device, "X", "x_", X_WIDTHS, torch.float32,
                               ((X_ROLLOUT_ROWS, False, "primal_", True), (MINIBATCH_ROWS, False, "target_", True),
                                (MINIBATCH_ROWS, True, "", True), (RAGGED_ROWS, True, "ragged_", False)), seed=33,
                               skip_input_grad=True), "x_",
          f"{MINIBATCH_ROWS} x 48-256-128-64 ELU (X's predictor, saving; backward with skip_input_grad; also "
          f"{RAGGED_ROWS} rows); primal at {X_ROLLOUT_ROWS} rows (pre_update) and {MINIBATCH_ROWS} (the target)")
    for key, value in results.items():
        value["aux_max_abs_err"] = max(v for k, v in value.items() if k.endswith("max_abs_err"))
    return results


def _control_factory(path: str, ppo_factory=None):
    """The agent factory of path SC or PO: path A's zoo factory (or
    ``ppo_factory``) with, for SC, ``ConditionalObjectiveActivation`` (the
    value loss in epochs 0-2 only) before the value loss,
    ``MiniBatchWiseLRSchedule`` after ``on_policy_preparation``, then an
    ``OptimizationStage`` with its own Adam around a ``StateEstimation`` (ELU
    48-256-128 -> 16 observation channels, from the observation), the
    entropy weight's ``HookParameterSchedule`` (piecewise linear to 0 at
    iteration 10), ``HookActivationSchedule`` (entropy loss off from
    iteration 3), ``OnPolicyBufferCapacitySchedule`` (24 steps, then 32 from
    iteration 2) and ``DeviceMemoryStats``; for PO the adaptive Normal head
    with the softplus bijector, the minibatch-wise advantage normalization,
    ``sparse_value_bootstrap`` and 4, 4, 4, 2 and 2 minibatches in its five
    epochs."""
    from cusrl_tpu_torch.hook import (
        AdvantageNormalization,
        ConditionalObjectiveActivation,
        DeviceMemoryStats,
        EpochIndexCondition,
        HookActivationSchedule,
        HookParameterSchedule,
        MiniBatchWiseLRSchedule,
        OnPolicyBufferCapacitySchedule,
        OptimizationStage,
        StateEstimation,
    )
    from cusrl_tpu_torch.nn.module.distribution import AdaptiveNormalDistFactory
    from cusrl_tpu_torch.nn.module.mlp import MlpFactory
    from cusrl_tpu_torch.preset.optimizer import AdamFactory
    from cusrl_tpu_torch.sampler import AutoMiniBatchSampler
    from cusrl_tpu_torch.utils.scheduler import LessThan, PiecewiseLinearScheduler, StepScheduler
    from cusrl_tpu_torch.zoo.registry import get_experiment

    zoo = ppo_factory or get_experiment("Velocity-Rough", "ppo").make_agent_factory()
    if path == "PO":
        zoo.sparse_value_bootstrap = True
        underlying = zoo.to_underlying()
        underlying.actor_factory.distribution_factory = AdaptiveNormalDistFactory(bijector="softplus")
        underlying.sampler = AutoMiniBatchSampler(num_epochs=EPOCHS, num_mini_batches=PO_MINI_BATCHES)
        underlying.hooks = [AdvantageNormalization(mini_batch_wise=True) if isinstance(h, AdvantageNormalization)
                            else h for h in underlying.hooks]
        return underlying
    underlying = zoo.to_underlying()
    estimation = StateEstimation(estimator_factory=MlpFactory(hidden_dims=SC_EST_WIDTHS[1:-1]),
                                 target_name="observation", target_indices=tuple(range(SC_EST_WIDTHS[-1])))
    underlying.register_hook(ConditionalObjectiveActivation.create(value_loss=EpochIndexCondition((0, 1, 2))),
                             before="value_loss")
    underlying.register_hook(MiniBatchWiseLRSchedule(desired_kl_divergence=zoo.desired_kl_divergence),
                             after="on_policy_preparation")
    for hook in (OptimizationStage(stage_name="estimation", stage_hooks=(estimation,),
                                   optimizer_factory=AdamFactory(lr=1e-3)),
                 HookParameterSchedule(target_hook="entropy_loss", parameter="weight",
                                       scheduler=PiecewiseLinearScheduler((0, zoo.entropy_loss_weight), (10, 0.0))),
                 HookActivationSchedule(target_hook="entropy_loss", scheduler=LessThan(3)),
                 OnPolicyBufferCapacitySchedule(schedule=StepScheduler(STEPS, (2, SC_STEPS))),
                 DeviceMemoryStats()):
        underlying.register_hook(hook)
    return underlying


def check_control_kernels(device) -> dict:
    """The chain kernels at the new shapes paths SC and PO give them: SC's
    state estimator (ELU 48-256-128 -> 16, in its optimization stage) K1f
    saving and K1b with ``skip_input_grad`` at the minibatch's 32,768 rows
    (32 steps, timed) and 24,576 (24 steps); SC's joint evaluation K2f/K2b
    at 2 x 32,768 and PO's at 2 x 49,152 (its 2-minibatch epochs), each
    backward with ``skip_input_grad``.  Returns the ``sc_est_``,
    ``sc_pair_`` and ``po_pair_`` fields of K1f, K1b, K2f and K2b."""
    import torch

    results: dict = {}

    def merge(fields, prefix, shape):
        for key, value in fields.items():
            value[prefix + "shape"] = shape
            results.setdefault(key, {}).update(value)

    print("[kernels] K1f/K1b on path SC's state estimator, ELU 48-256-128-16 (skip_input_grad)")
    merge(_check_chain_kernels(device, "SC estimator", "sc_est_", SC_EST_WIDTHS, torch.float32,
                               ((SC_MB_ROWS, True, "", True), (MINIBATCH_ROWS, True, "mb24_", False)), seed=34,
                               skip_input_grad=True), "sc_est_",
          f"{SC_MB_ROWS} x 48-256-128-16 ELU (SC's estimator per minibatch at 32 steps, saving; backward with "
          f"skip_input_grad; also {MINIBATCH_ROWS} rows at 24 steps)")
    print("[kernels] K2f/K2b on path SC's pair at 32 steps, 2 x 32,768 x 48-512-256-128 (skip_input_grad)")
    merge(_check_chain_kernels(device, "SC pair", "sc_pair_", WIDTHS, torch.float32, ((SC_MB_ROWS, True, "", True),),
                               seed=35, skip_input_grad=True, chains=2), "sc_pair_",
          f"2 x {SC_MB_ROWS} x 48-512-256-128 ELU (SC's minibatch at 32 steps, saving; backward with "
          f"skip_input_grad)")
    print("[kernels] K2f/K2b on path PO's pair in its 2-minibatch epochs, 2 x 49,152 x 48-512-256-128")
    merge(_check_chain_kernels(device, "PO pair", "po_pair_", WIDTHS, torch.float32, ((PO_MB_ROWS, True, "", True),),
                               seed=36, skip_input_grad=True, chains=2), "po_pair_",
          f"2 x {PO_MB_ROWS} x 48-512-256-128 ELU (PO's minibatch in its 2-minibatch epochs, saving; backward "
          f"with skip_input_grad)")
    for key, value in results.items():
        value["control_max_abs_err"] = max(v for k, v in value.items() if k.endswith("max_abs_err"))
    return results


def _slice_factory(**overrides):
    from cusrl_tpu_torch.preset.ppo import PpoAgentFactory

    kwargs = dict(
        num_steps_per_update=STEPS,
        actor_hidden_dims=WIDTHS[1:],
        critic_hidden_dims=WIDTHS[1:],
        activation_fn="elu",
        lr=1e-3,
        sampler_epochs=EPOCHS,
        sampler_mini_batches=MINIBATCHES,
        entropy_loss_weight=0.005,
        fuse_actor_critic_evaluation=True,
    )
    kwargs.update(overrides)
    return PpoAgentFactory(**kwargs)


PATHS = ("A", "B", "C", "CM")
PATH_NAMES = {"A": "zoo Velocity-Rough ppo", "B": "A + fuse_heads (K8)", "C": "A + fused_ppo_update (K9)",
              "CM": "C in mono mode (K9m)",
              "T": "zoo Velocity-Flat transformer_ppo, modular route", "TF": "zoo Velocity-Flat transformer_ppo",
              "TJ": "TF + fuse_actor_critic_evaluation (K5)", "TL": "TF with 256-step rollouts (K7)",
              "R": "zoo Velocity-Flat recurrent_ppo (GRU 256)", "RJ": "R + fuse_actor_critic_evaluation (K2)",
              "RL": "R with rnn_type='lstm'", "RS": "R + ActionSmoothnessLoss", "AMP": "zoo Velocity-Flat amp (relu 512-256, the AMP discriminator)",
              "F": "zoo Velocity-Flat ppo (ELU 128-128-128), the quick start",
              "H": "zoo CartPole-v1 ppo (tanh 4-64-64) on NativeCartPoleEnv(8), the host loop",
              "D": "the distillation preset (relu 256-128, Stub critic) on Velocity-Rough, expert: path A's agent",
              "S": "A + SymmetricDataAugmentation (the batch doubled, mirrored statistics)",
              "SL": "A + MirrorSymmetryLoss", "X": "A + RandomNetworkDistillation (ELU 256-128-64) + ReturnPrediction",
              "SC": "A + the control hooks and schedules (an optimization stage with a state estimator, 24 -> 32 "
                    "steps)",
              "PO": "A + the adaptive Normal head (softplus), minibatch-wise advantages, the sparse bootstrap, "
                    "4-4-4-2-2 minibatches",
              "TQ": "T with qk_norm=True on every encoder layer (the default route, which keeps it modular)",
              "TJC": "TJ with CUSRL_TPU_PAIR_CONCAT=1 (one lane call over both networks' environments)",
              "SB": "A with SimbaFactory() backbones (hidden 256, 2 blocks; plain layers), without the joint "
                    "evaluation (it takes Mlp backbones only)",
              "IL": "zoo Isaac-Velocity-Rough-Anymal-C-v0 ppo (ELU 512-256-128 on 235-D observations) through the "
                    "IsaacLab adapter on a card-resident stand-in simulator, the host loop"}
# The route each transformer path runs: T the modular one, TF, TJ, TL, TQ and TJC the default.
PATH_ROUTES = {"T": "0", "TF": None, "TJ": None, "TL": None, "TQ": None, "TJC": None}
# TJC's [train-zoo] is one profiled iteration after two warm-up ones (its
# counts per iteration, its device ms beside TJ's).
PROFILE_ONLY_PATHS = ("TJC",)
QK_PAIR_PATHS = ("TQ", "TJC")  # QK-norm and the one-lane-call pair pass: [update-check] in a phase of their own
PATH_STEPS = {"TL": TL_STEPS, "AMP": AMP_STEPS, "SC": SC_STEPS}  # rollout steps per iteration; STEPS elsewhere
# The recurrent entry's paths: R as registered, RJ with the joint evaluation
# (the GRUs stacked, the heads on K2), RL with LSTM cells (update check only).
RECURRENT_PATHS = ("R", "RJ")
RECURRENT_CHECKS = ("R", "RJ", "RL", "RS")  # RS: R with ActionSmoothnessLoss (temporal batches)
AMP_PATHS = ("AMP",)  # the zoo's amp entry: 16 steps, 4 x 4 minibatches (not STEPS and MB)
F_PATHS = ("F",)  # the zoo's Velocity-Flat ppo entry, the user surface's path
H_PATHS = ("H",)  # the zoo's CartPole-v1 ppo entry through the Trainer's host loop
MB = EPOCHS * MINIBATCHES
_NONE = {"K1f": 0, "K1b": 0, "K2f": 0, "K2b": 0, "K8f": 0, "K8b": 0, "K9s": 0, "K9m": 0, "K3f": 0, "K3b": 0, "K6": 0,
         "K7f": 0, **{key: 0 for key in BLOCK_REPLACES}}
# One update of TF: per minibatch the actor and the critic each run K4 pre
# and post forward and backward, K3f/K3b and the head's K1f/K1b; the value
# pass and its next-token pass (K6) and the KL pass run K4's forwards (post
# primal) and the head's K1f.  TJ runs each minibatch's two layers as one
# K5 pass (two K3f/K3b) and the MLP tails as one K2 pair with input
# gradients.
_TF_UPDATE = {"K1f": 3 + 2 * MB, "K1b": 2 * MB, "K3f": 2 + 2 * MB, "K3b": 2 * MB, "K6": 1,
              "K4pre_f": 3 + 2 * MB, "K4post_f": 3 + 2 * MB, "K4pre_b": 2 * MB, "K4post_b": 2 * MB}
_TJ_UPDATE = {"K1f": 3, "K2f": MB, "K2b": MB, "K3f": 2 + 2 * MB, "K3b": 2 * MB, "K6": 1, "K4pre_f": 3,
              "K4post_f": 3, "K5pre_f": MB, "K5pre_b": MB, "K5post_f": MB, "K5post_b": MB}
# TJC: TJ with each minibatch's pair attention as one K3f/K3b over 512 environments.
_TJC_UPDATE = {**_TJ_UPDATE, "K3f": 2 + MB, "K3b": MB}
# TL is TF with T = 256 > 64: every sequence pass's attention is K7f (its
# backward recomputes through the plain version: no launch), and the
# next-token pass takes the plain version (no K6).
TL_PRIMAL_K7F = 2  # path TL's K7f launches per iteration without a gradient: the value and KL passes
_TL_UPDATE = {"K1f": 3 + 2 * MB, "K1b": 2 * MB, "K7f": TL_PRIMAL_K7F + 2 * MB, "K4pre_f": 3 + 2 * MB, "K4post_f": 3 + 2 * MB,
              "K4pre_b": 2 * MB, "K4post_b": 2 * MB}
EXPECTED_ZOO_LAUNCHES = {  # per training iteration
    "A": {**_NONE, "K1f": STEPS + 3, "K2f": MB, "K2b": MB},
    "B": {**_NONE, "K1f": STEPS + 3, "K8f": MB, "K8b": MB},
    "C": {**_NONE, "K1f": STEPS + 3, "K2f": MB, "K9s": MB},
    "CM": {**_NONE, "K1f": STEPS + 3, "K9m": MB},
    # Path T: the actor's FFN (K1 gelu) and MLP head (K1 elu) per rollout
    # step; the value pass (sequence: K3f, FFN, head) and its next-token pass
    # (K6, FFN, head); per minibatch the actor and the critic in sequence
    # mode (K3f, FFN, head each) and their backward (K3b, FFN, head each);
    # the KL pass after the update (K3f, FFN, head).
    "T": {**_NONE, "K1f": 2 * STEPS + 4 + 4 * MB + 2, "K1b": 4 * MB, "K3f": 1 + 2 * MB + 1, "K3b": 2 * MB, "K6": 1},
    # Path TQ: QK-norm keeps the default route modular, so T's launches.
    "TQ": {**_NONE, "K1f": 2 * STEPS + 4 + 4 * MB + 2, "K1b": 4 * MB, "K3f": 1 + 2 * MB + 1, "K3b": 2 * MB, "K6": 1},
    # TF and TJ: the rollout's step (the fused step route is off by default)
    # runs the FFN and the head through K1f.
    "TF": {**_NONE, **_TF_UPDATE, "K1f": 2 * STEPS + _TF_UPDATE["K1f"]},
    "TJ": {**_NONE, **_TJ_UPDATE, "K1f": 2 * STEPS + _TJ_UPDATE["K1f"]},
    "TJC": {**_NONE, **_TJC_UPDATE, "K1f": 2 * STEPS + _TJC_UPDATE["K1f"]},
    "TL": {**_NONE, **_TL_UPDATE, "K1f": 2 * TL_STEPS + _TL_UPDATE["K1f"]},
    # Path R: per rollout step the actor's head, the per-step critic's head
    # (post_act) and its bootstrap head (post_step) on 1,024 rows; per
    # minibatch the actor's and the critic's heads forward (saving) and
    # backward with dX into the GRUs; the KL pass's head.  The GRUs' products
    # are fp32 matmuls (no kernel).  RJ: the minibatch's two heads as one K2
    # pair with input gradients.
    "R": {**_NONE, "K1f": 3 * STEPS + 2 * MB + 1, "K1b": 2 * MB},
    "RJ": {**_NONE, "K1f": 3 * STEPS + 1, "K2f": MB, "K2b": MB},
    # Path AMP (no joint evaluation): per rollout step the actor on 1,024
    # rows; the deferred value pass over observations and next observations
    # and the KL pass on 16,384; per minibatch the actor and the critic
    # forward (saving) and backward (skip_input_grad) on 4,096.  The
    # discriminator runs its plain layers (fused_kernel=False): no launch.
    "AMP": {**_NONE, "K1f": AMP_STEPS + 3 + 2 * AMP_MB, "K1b": 2 * AMP_MB},
    # Path F: A's launches at F's widths.
    "F": {**_NONE, "K1f": STEPS + 3, "K2f": MB, "K2b": MB},
    # Path H: the rollout's 8-row policy steps run plain layers (below the
    # training floor of 256 rows); the update's two value passes, per
    # minibatch the actor's and the critic's forward (saving) and backward
    # (skip_input_grad), and the KL pass run at 256 rows.
    "H": {**_NONE, "K1f": 2 + 2 * H_EPOCHS + 1, "K1b": 2 * H_EPOCHS},
    # Path D: per rollout step the student (relu 48-256-128) and the frozen
    # expert (post_step, no gradient) on 4,096 rows; per minibatch the
    # student forward (saving) and backward (skip_input_grad) on 12,288.  No
    # value pass (the Stub critic), no KL pass (no statistics hook).
    "D": {**_NONE, "K1f": 2 * STEPS + D_MB, "K1b": D_MB},
    # Path S: A's launches; the joint evaluation's pair takes the doubled
    # 2 x 49,152-row minibatch, the value and KL passes the rollout as is.
    "S": {**_NONE, "K1f": STEPS + 3, "K2f": MB, "K2b": MB},
    # Path X: A's, plus RND's target and predictor over the 98,304-row
    # rollout in pre_update, and per minibatch the target (primal) and the
    # predictor (saving, and its backward) on 24,576.  The return probe is
    # an fp32 Linear.
    "X": {**_NONE, "K1f": STEPS + 3 + 2 + 2 * MB, "K1b": MB, "K2f": MB, "K2b": MB},
    # Path SC at 32 steps (the timed chunk; the warm-up chunk's first two ran at 24): A's
    # launches, plus per minibatch the stage's estimator forward (saving) and
    # backward (skip_input_grad) on 32,768 rows.
    "SC": {**_NONE, "K1f": SC_STEPS + 3 + MB, "K1b": MB, "K2f": MB, "K2b": MB},
    # Path PO: A's rollout, value pass over the observations and KL pass; the
    # sparse bootstrap's two 4,096-row passes (the truncated next states, the
    # last step's; on an overflow the full pass and the last step's: the
    # same count); 16 minibatches of the pair.
    "PO": {**_NONE, "K1f": STEPS + 4, "K2f": PO_MB, "K2b": PO_MB},
    # Path IL (no joint evaluation): per rollout step the actor on 4,096
    # rows; the deferred value pass over the observations and the next
    # observations and the KL pass on 98,304; per minibatch the actor and the
    # critic forward (saving) and backward (skip_input_grad) on 24,576.
    "IL": {**_NONE, "K1f": STEPS + 3 + 2 * MB, "K1b": 2 * MB},
}


def _launch_counts() -> dict:
    from cusrl_tpu_torch.nn.kernels import banded_attention as ba
    from cusrl_tpu_torch.nn.kernels import fused_block as fb
    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    return {**fm.LAUNCHES, **la.LAUNCHES, **ba.LAUNCHES, **fb.LAUNCHES}


def _reset_launch_counts() -> None:
    from cusrl_tpu_torch.nn.kernels import banded_attention as ba
    from cusrl_tpu_torch.nn.kernels import fused_block as fb
    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm
    from cusrl_tpu_torch.nn.kernels import lane_attention as la

    fm.reset_launch_counts()
    la.reset_launch_counts()
    ba.reset_launch_counts()
    fb.reset_launch_counts()


PAIR_CONCAT = "CUSRL_TPU_PAIR_CONCAT"


@contextlib.contextmanager
def _pair_concat(path: str):
    """Sets ``CUSRL_TPU_PAIR_CONCAT=1`` for path TJC's block (unset for
    every other path) and restores it after."""
    old = os.environ.pop(PAIR_CONCAT, None)
    if path == "TJC":
        os.environ[PAIR_CONCAT] = "1"
    try:
        yield
    finally:
        os.environ.pop(PAIR_CONCAT, None)
        if old is not None:
            os.environ[PAIR_CONCAT] = old


def _qk_norm_factory(agent_factory):
    """Path TQ: the transformer entry's agent factory as its underlying
    ``ActorCriticFactory``, every encoder layer of both backbones with
    ``qk_norm=True`` (the preset has no such field)."""
    from cusrl_tpu_torch.nn.module.causal_attn import CausalTransformerEncoderLayerFactory

    def with_qk_norm(factory):
        if isinstance(factory, CausalTransformerEncoderLayerFactory):
            return dataclasses.replace(factory, qk_norm=True)
        if hasattr(factory, "factories"):  # Sequential(layer, Mlp)
            return dataclasses.replace(factory, factories=tuple(with_qk_norm(f) for f in factory.factories))
        return factory

    underlying = agent_factory.to_underlying()
    for network in (underlying.actor_factory, underlying.critic_factory):
        network.backbone_factory = with_qk_norm(network.backbone_factory)
    return underlying


def _with_path(agent_factory, path: str):
    """The zoo's agent factory for path A, B (joint evaluation with the heads
    in the kernel), C or CM (the fused PPO update; CM runs it in mono mode,
    set with ``_ppo_mode`` around the run)."""
    from cusrl_tpu_torch.hook.on_policy.joint_eval import JointPolicyValueEvaluation

    if path in ("C", "CM"):
        agent_factory.fused_ppo_update = True
    if path != "B":
        return agent_factory
    underlying = agent_factory.to_underlying()
    underlying.hooks = [JointPolicyValueEvaluation(fuse_heads=True) if isinstance(h, JointPolicyValueEvaluation)
                        else h for h in underlying.hooks]
    return underlying


def check_update_against_cpu(path: str, expert_path: str | None = None) -> None:
    """One whole update at full width on a small rollout (8 steps x 256
    environments: every backbone call is large enough for the kernels), on
    the card and through the plain CPU path, same weights, rollout (dones
    mid-rollout), rollout-initial memories and permutations, for the slice-1
    configuration, the zoo's paths A, B, C and CM (C in mono mode on both
    sides), path F (the zoo's Velocity-Flat ``ppo``), the auxiliary paths D,
    S, SL and X (``_aux_factory``; D with ``expert_path``) and RS (R with
    ``ActionSmoothnessLoss``), path T (the modular route on both sides) and paths TF, TJ and TL
    (the card's default route against the CPU under ``force``: the fused
    block's plain versions; TL at 256 steps on 32 environments).  Metrics agree
    within bf16 rounding carried through 20 Adam steps (rtol 2e-2, atol
    2e-3): KL and the importance-weighted advantage are small differences of
    nearly equal terms, and the CPU side's matmuls block differently on each
    host.  The transformer paths (T, TF, TJ, TL) update at lr 1e-4: at the
    zoo's 1e-3 one update moves the fresh policy to KL 0.19, and its metrics
    amplify rounding (on the CPU the fused and the modular route, the same
    arithmetic rounded in another order, read the importance-weighted
    advantage 3.0 % apart at 1e-3 and 0.33 % at 1e-4; on path T's CPU side
    alone, a 1e-7 relative change of every gradient moves it 7.5 % at 1e-3
    and 0.15 % at 1e-4); path PO updates at 1e-4 too (see its branch).  The
    recurrent paths (R, RJ, RL) update at the zoo's
    1e-3 on 256 environments x 8 steps; their per-step critic's values and
    bootstrap values come from the value hook's own ``post_act`` and
    ``post_step`` on each side, step by step.  After 20 Adam steps at 1e-4 the metrics barely
    see a wrong gradient, so every leaf of the first minibatch's gradient,
    taken before the first step, is held to the CPU's too (2e-2 of the
    leaf's largest element): a backward whose phase 2 leaves out a row split
    fails there (tests/test_torch_update_check_conditioning.py)."""
    import torch

    from cusrl_tpu_torch.zoo.registry import get_experiment

    # TL keeps its 256-step rollout (T > 64: the banded route) on 32
    # environments: 8 per minibatch, 2,048 rows.
    steps, envs = (TL_STEPS, 32) if path == "TL" else (8, 256)
    if path in RECURRENT_CHECKS:
        factory = get_experiment("Velocity-Flat", "recurrent_ppo").make_agent_factory()
        factory.num_steps_per_update = steps
        factory.fuse_actor_critic_evaluation = path == "RJ"
        factory.rnn_type = "lstm" if path == "RL" else "gru"
        if path == "RS":
            from cusrl_tpu_torch.hook import ActionSmoothnessLoss

            factory = factory.to_underlying()
            factory.register_hook(ActionSmoothnessLoss(weight_1st_order=0.1, weight_2nd_order=0.1),
                                  after="on_policy_preparation")
        # The update only (the per-step critic's values are the rollout's):
        # per minibatch both heads forward and backward, then the KL pass.
        expected = {"K1f": 1, "K2f": MB, "K2b": MB} if path == "RJ" else {"K1f": 2 * MB + 1, "K1b": 2 * MB}
    elif path == "slice 1":
        factory, expected = _slice_factory(num_steps_per_update=steps), {"K1f": 3, "K2f": MB, "K2b": MB}
    elif path in AMP_PATHS:
        # The update only: the value and KL passes, per minibatch actor and
        # critic forward and backward; the discriminator takes no kernel.
        factory = get_experiment("Velocity-Flat", "amp").make_agent_factory()
        factory.num_steps_per_update = steps
        expected = {"K1f": 3 + 2 * AMP_MB, "K1b": 2 * AMP_MB}
    elif path in F_PATHS:
        factory = get_experiment("Velocity-Flat", "ppo").make_agent_factory()
        factory.num_steps_per_update = steps
        expected = {"K1f": 3, "K2f": MB, "K2b": MB}
    elif path in AUX_CHECKS:
        # The update only: D per minibatch the student forward and backward
        # (its rollout's expert actions come from the hook's post_step); S,
        # SL and X path A's value passes, pair and KL pass, SL with the
        # mirrored actor pass and X with RND's passes.
        zoo = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
        zoo.num_steps_per_update = steps
        factory = _aux_factory(path, zoo, expert_path)
        if path == "D":
            factory.num_steps_per_update = steps
        expected = {"D": {"K1f": D_MB, "K1b": D_MB}, "S": {"K1f": 3, "K2f": MB, "K2b": MB},
                    "SL": {"K1f": 3 + MB, "K1b": MB, "K2f": MB, "K2b": MB},
                    "X": {"K1f": 3 + 2 + 2 * MB, "K1b": MB, "K2f": MB, "K2b": MB}}[path]
    elif path in CONTROL_PATHS:
        # The update only: A's value passes (PO: the observations' and the
        # sparse bootstrap's two), per minibatch the pair (SC: and the
        # stage's estimator forward and backward), the KL pass.
        zoo = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
        zoo.num_steps_per_update = steps
        if path == "PO":
            # At the zoo's 1e-3 Adam moves all 128 weights of the adaptive std
            # head at once: one update takes the std from 1 to about 0.7 and
            # the KL to 2.2 on both sides, where the ratio and the
            # importance-weighted advantage amplify rounding (the card and the
            # CPU 3.7 % and 7.1 % apart while every gradient leaf agrees to
            # 4.4e-3): PO's check updates at 1e-4, as the transformer paths'.
            zoo.lr = 1e-4
        factory = _control_factory(path, zoo)
        expected = {"SC": {"K1f": 3 + MB, "K1b": MB, "K2f": MB, "K2b": MB},
                    "PO": {"K1f": 4, "K2f": PO_MB, "K2b": PO_MB}}[path]
    elif path in PATH_ROUTES:
        factory = get_experiment("Velocity-Flat", "transformer_ppo").make_agent_factory()
        factory.num_steps_per_update = steps
        factory.fuse_actor_critic_evaluation = path in ("TJ", "TJC")
        factory.lr = 1e-4
        if path == "TQ":
            factory = _qk_norm_factory(factory)
        # T and TQ: the value pass (K3f, FFN, head) and its next-token pass
        # (K6, FFN, head); per minibatch actor and critic forward and
        # backward; the KL pass.  TF, TJ, TJC and TL: one training
        # iteration's update.
        modular = {"K1f": 4 + 4 * MB + 2, "K1b": 4 * MB, "K3f": 2 + 2 * MB, "K3b": 2 * MB, "K6": 1}
        expected = {"T": modular, "TQ": modular, "TF": _TF_UPDATE, "TJ": _TJ_UPDATE, "TJC": _TJC_UPDATE,
                    "TL": _TL_UPDATE}[path]
    elif path == "IL":
        # The update only: the value passes and the KL pass, per minibatch the
        # actor and the critic forward (saving) and backward (skip_input_grad)
        # on the 235-wide observation (no joint evaluation).
        factory = get_experiment(IL_TASK, "ppo").make_agent_factory()
        factory.num_steps_per_update = steps
        expected = {"K1f": 3 + 2 * MB, "K1b": 2 * MB}
    elif path == "SB":
        # Path A's entry with SimBa backbones: plain layers, no kernel launch.
        from cusrl_tpu_torch.nn.module.simba import SimbaFactory

        factory = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
        factory.num_steps_per_update = steps
        factory._backbone_factory = lambda hidden_dims: SimbaFactory()
        factory.fuse_actor_critic_evaluation = False  # the joint evaluation takes Mlp backbones only, in JAX too
        # At the zoo's 1e-3 one update takes SB's fresh policy to KL 0.25 and
        # ratio 0.72, where the importance-weighted advantage amplifies
        # rounding: 3.2 % apart between the card (an H100 80GB HBM3 at 700 W)
        # and the CPU while every gradient leaf agrees to 5.7e-3.  SB updates
        # at 1e-4, as the transformer paths and PO.
        factory.lr = 1e-4
        expected = {}
    else:
        zoo = get_experiment("Velocity-Rough", "ppo").make_agent_factory()
        zoo.num_steps_per_update = steps
        factory = _with_path(zoo, path)
        expected = {k: (3 if k == "K1f" else v) for k, v in EXPECTED_ZOO_LAUNCHES[path].items() if v}
    spec = None
    if path == "IL":  # the adapter's spec: 235-D observations, autoreset, missing final states
        from cusrl_tpu_torch.environment.isaaclab import IsaacLabEnvAdapter

        spec = IsaacLabEnvAdapter(_StandInAnymalEnv(envs, "cpu")).spec
    gen = torch.Generator().manual_seed(SEED + 1)
    obs = torch.tanh(torch.randn(steps + 1, envs, IL_OBS if path == "IL" else WIDTHS[0], generator=gen))
    terminated = torch.rand(steps, envs, 1, generator=gen) < 0.05
    truncated = torch.rand(steps, envs, 1, generator=gen) < 0.05
    done = terminated | truncated
    # The flat sampler permutes 128-row tiles; the temporal one environments.
    units = envs if path in PATH_ROUTES or path in RECURRENT_CHECKS else steps * envs // 128
    epochs = AMP_EPOCHS if path in AMP_PATHS else D_EPOCHS if path == "D" else EPOCHS
    perms = torch.stack([torch.randperm(units, generator=torch.Generator().manual_seed(e)) for e in range(epochs)])
    if path == "PO":  # two segments: three epochs of 4 minibatches, two of 2 (128-row tiles in both)
        perms = [perms[:3], perms[3:]]
    results, state = {}, None
    fused = path in PATH_ROUTES and PATH_ROUTES[path] is None
    for device, route in (("cpu", "force" if fused else PATH_ROUTES.get(path)), ("cuda", PATH_ROUTES.get(path))):
        with _fused_route(route), _ppo_mode("mono" if path == "CM" else "split"), _pair_concat(path):
            *results[device], initial = _small_update(factory, device, state, obs, terminated, truncated, done, perms,
                                                      spec)
        state = state or initial
    launched = {k: v for k, v in _launch_counts().items() if v}
    print(f"[update-check] {path}: cuda launches {launched}")
    if launched != expected:
        raise AssertionError(f"small update did not run through the kernels: {launched}, expected {expected}")
    failed = update_check_failures(*results["cpu"], *results["cuda"], report=True)
    if failed:
        raise AssertionError(f"update check of path {path}: {failed} disagree between the card and the CPU path")
    if path == "TJC":  # against TJ (two lane calls a pass) on the card, the same weights and batch
        with _fused_route(None), _pair_concat("TJ"):
            tj_metrics, tj_grads, _ = _small_update(factory, "cuda", state, obs, terminated, truncated, done, perms)
        tj_launched = {k: v for k, v in _launch_counts().items() if v}
        if tj_launched != _TJ_UPDATE or launched["K3f"] - 2 != (tj_launched["K3f"] - 2) // 2:
            raise AssertionError(f"TJ launched {tj_launched} against TJC's {launched}")
        metrics, grads = results["cuda"]
        bitwise = (metrics == tj_metrics and set(grads) == set(tj_grads)
                   and all(torch.equal(grads[k], tj_grads[k]) for k in grads))
        failed = update_check_failures(tj_metrics, tj_grads, metrics, grads)
        print(f"[update-check] TJC against TJ on the card: TJ launches {tj_launched}; the update's K3f "
              f"{launched['K3f'] - 2} against {tj_launched['K3f'] - 2}, K3b {launched['K3b']} against "
              f"{tj_launched['K3b']}; metrics and {len(grads)} gradient leaves "
              f"{'bit for bit equal' if bitwise else 'within the limits' if not failed else 'DISAGREE'}")
        if failed:
            raise AssertionError(f"TJC disagrees with TJ on the card: {failed}")


UPDATE_RTOL, UPDATE_ATOL = 2e-2, 2e-3  # the update's metrics
GRAD_RTOL = 2e-2  # the first minibatch's gradient, per leaf, of the leaf's largest element


def update_check_failures(ref_metrics: dict, ref_grads: dict, metrics: dict, grads: dict,
                          report: bool = False) -> list[str]:
    """The keys of ``check_update_against_cpu`` that disagree: each metric
    after the whole update within ``UPDATE_ATOL + UPDATE_RTOL * |ref|``, and
    each leaf of the first minibatch's gradient (before any step, so the
    learning rate does not enter) within ``GRAD_RTOL`` of the leaf's largest
    element.  With ``report`` every metric's gap beside its limit and the
    gradient leaves' worst ratio are printed."""
    failed = []
    for key, ref in sorted(ref_metrics.items()):
        got, limit = metrics[key], UPDATE_ATOL + UPDATE_RTOL * abs(ref)
        ok = math.isfinite(got) and abs(got - ref) <= limit
        if not ok:
            failed.append(key)
        if report:
            print(f"    {key:32s} cuda={got:.6f} cpu={ref:.6f} gap={abs(got - ref):.6f} limit={limit:.6f} "
                  f"{'ok' if ok else 'MISMATCH'}")
    if set(grads) != set(ref_grads):
        return failed + ["gradient leaves"]
    ratios = {}
    for name, ref in ref_grads.items():
        got = grads[name].float().cpu()
        scale = ref.float().abs().max().item()
        ratios[name] = (got - ref.float()).abs().max().item() / scale if scale > 0 else float(got.abs().max() > 0)
        if not (math.isfinite(ratios[name]) and ratios[name] <= GRAD_RTOL):
            failed.append(f"grad {name}")
    if report and ratios:
        worst = max(ratios, key=ratios.get)
        print(f"    first-minibatch gradient, {len(ratios)} leaves: worst {worst} max|diff| / max|cpu| = "
              f"{ratios[worst]:.3e} (limit {GRAD_RTOL:g})")
    return failed


def _small_update(factory, device, state, obs, terminated, truncated, done, perms, spec=None):
    """One update of ``check_update_against_cpu`` on ``device``, from
    ``state`` when given, for an environment of ``spec`` (Velocity-Rough's by
    default): ``(metrics, the first minibatch's gradient by parameter name,
    the agent's initial weights)``; the launch counters are set to 0 just
    before the update."""
    import torch
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.utils.nest import map_nested

    steps, envs = done.shape[:2]
    if spec is None:
        spec = VelocityLocomotionEnv(num_instances=envs, device=device).spec
    agent = factory(spec, device=device, seed=SEED)
    amp = next((hook for hook in agent.hooks if hook.hook_name == AMP_HOOK), None)
    if amp is not None:  # a live logit (see _amp_agent); the card's side loads it below
        with torch.no_grad():
            amp.discriminator.layers[-1].bias.fill_(0.5)
    # The weights and every hook's state (AMP's expert dataset among them,
    # drawn from each device's own stream) go from the first side to the second.
    initial = {"model": {k: v.detach().clone() for k, v in agent.model.state_dict().items()},
               "hooks": [{k: v.detach().clone() for k, v in hook.state_tensors().items()} for hook in agent.hooks]}
    if state is not None:
        agent.model.load_state_dict(state["model"])
        with torch.no_grad():
            for hook, tensors in zip(agent.hooks, state["hooks"]):
                for key, value in hook.state_tensors().items():
                    value.copy_(tensors[key])
    memories = agent.rollout_memory_entries()  # empty for the MLP paths
    with torch.no_grad():
        dist, _, _ = agent.actor(obs[:-1].to(device), memories.get("actor_memory"), sequential=True,
                                 done=done.to(device))
        # The per-step critic (a GRU's or an LSTM's) records its values and
        # bootstrap values in the rollout: its hook's post_act and post_step.
        per_step = {}
        hook = next((h for h in agent.hooks if h.hook_name == "value_computation"), None)  # D has none
        if hook is not None and hook.deferred is False:
            transitions = []
            for t in range(steps):
                transitions.append({"observation": obs[t].to(device), "next_observation": obs[t + 1].to(device),
                                    "done": done[t].to(device)})
                hook.post_act(agent, transitions[-1])
                hook.post_step(agent, transitions[-1])
            per_step = {k: torch.stack([tr[k] for tr in transitions]) for k in ("value", "bootstrap_value")}
    noise = torch.randn(steps, envs, 12, generator=torch.Generator().manual_seed(SEED + 2)).to(device)
    action = dist["mean"] + dist["std"] * noise
    if amp is not None:
        # The rollout's reward shaping and AMP post_step, step by step, with
        # the same expert rows on both sides; the update's subsamples too.
        gen = torch.Generator().manual_seed(SEED + 3)
        amp.queue_draws(expert=[torch.randint(0, amp.dataset.shape[0], (envs,), generator=gen) for _ in range(steps)],
                        subsample=[torch.randint(0, steps * envs // AMP_MINIBATCHES, (amp.batch_size,), generator=gen)
                                   for _ in range(AMP_MB)])
        with torch.no_grad():
            transitions = []
            for t in range(steps):
                transitions.append({"observation": obs[t].to(device), "next_observation": obs[t + 1].to(device),
                                    "reward": torch.ones(envs, 1, device=device)})
                for name in ("reward_shaping", AMP_HOOK):
                    agent.get_hook(name).post_step(agent, transitions[-1])
            per_step = {k: torch.stack([tr[k] for tr in transitions])
                        for k in ("reward", "agent_transition", "expert_transition")}
    aux = [hook for hook in agent.hooks if hook.hook_name in ("symmetric_data_augmentation", D_HOOK)]
    if aux:
        # Path S's augmented fields and path D's expert actions: the hooks'
        # post_step over the rollout, step by step (D's expert on 256 rows).
        with torch.no_grad():
            transitions = []
            for t in range(steps):
                transitions.append({"observation": obs[t].to(device), "next_observation": obs[t + 1].to(device),
                                    "action": action[t], "done": done[t].to(device)})
                for hook in aux:
                    hook.post_step(agent, transitions[-1])
            per_step.update({k: torch.stack([tr[k] for tr in transitions]) for k in transitions[0]
                             if k.startswith("augmented_") or k == "expert_action"})
    rollout = {
        "observation": obs[:-1].to(device),
        "next_observation": obs[1:].to(device),
        "action": action,
        "action_logp": agent.actor.compute_logp(dist, action),
        "action_dist": dist,
        "reward": torch.ones(steps, envs, 1, device=device),  # AMP's shaped reward comes in per_step
        "terminated": terminated.to(device),
        "truncated": truncated.to(device),
        "done": done.to(device),
        **per_step,
        **map_nested(lambda t: t[None], memories),  # a rollout stores them as [1, N, ...]
    }
    names = {id(p): name for name, p in agent.model.named_parameters()}
    # An optimization stage's first gradient and its optimizer's state after
    # the update are compared too (path SC).
    stage = next((h.stage_optimizer.optimizer for h in agent.hooks if getattr(h, "stage_optimizer", None)), None)
    first_grads, first_stage_grads = {}, {}

    def keep_first(optimizer, args, kwargs):
        kept, tag = (first_stage_grads, "stage grad ") if optimizer is stage else (first_grads, "")
        if not kept:
            kept.update({tag + names[id(p)]: p.grad.detach().clone() for group in optimizer.param_groups
                         for p in group["params"] if p.grad is not None})

    handle = register_optimizer_step_pre_hook(keep_first)
    _reset_launch_counts()
    try:
        metrics = {k: float(v) for k, v in agent.update_body(rollout, epoch_perms=perms).items()}
    finally:
        handle.remove()
    first_grads.update(first_stage_grads)
    if stage is not None:
        first_grads.update({f"stage {key} {names[id(p)]}": value.detach().clone()
                            for group in stage.param_groups for p in group["params"]
                            for key, value in stage.state.get(p, {}).items() if key in ("exp_avg", "exp_avg_sq")})
    if amp is not None and (amp._expert_draws or amp._subsample_draws):
        raise AssertionError("AMP's update check left draws unused")
    return metrics, {k: v.cpu() for k, v in first_grads.items()}, initial


def train(kind: str) -> None:
    """The slice-1 configuration's loop (no observation normalization, fixed
    learning rate) through ``RolloutDriver.collect_and_update``."""
    import torch

    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm
    from cusrl_tpu_torch.template.rollout import RolloutDriver

    env = VelocityLocomotionEnv(num_instances=NUM_ENVS, seed=SEED)  # device defaults to the card
    agent = _slice_factory()(env.spec, seed=SEED)
    driver = RolloutDriver(agent, env)
    start = time.perf_counter()
    driver.collect_and_update(STEPS)  # warm-up
    torch.cuda.synchronize()
    print(f"[train] slice 1: warm-up iteration {time.perf_counter() - start:.3f} s")

    fm.reset_launch_counts()
    start = time.perf_counter()
    history = []
    for _ in range(TIMED_ITERATIONS):
        aggregates, metrics = driver.collect_and_update(STEPS)
        history.append((aggregates, metrics))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = {k: v for k, v in fm.LAUNCHES.items() if k in EXPECTED_LAUNCHES_PER_ITERATION}

    expected = {k: v * TIMED_ITERATIONS for k, v in EXPECTED_LAUNCHES_PER_ITERATION.items()}
    print(f"[train] launches over {TIMED_ITERATIONS} iterations: {launches} (expected {expected})")
    if launches != expected or any(fm.LAUNCHES[k] for k in ("K8f", "K8b", "K9s", "K9m")):
        raise AssertionError("the training loop did not launch the kernels the expected number of times")
    for i, (aggregates, metrics) in enumerate(history):
        values = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()) or not torch.isfinite(aggregates).all():
            raise AssertionError(f"non-finite metrics at iteration {i}: {values}")
    steps_per_s = TIMED_ITERATIONS * STEPS * NUM_ENVS / elapsed
    print(f"[train] slice 1: {steps_per_s:.1f} env-steps/s ({elapsed / TIMED_ITERATIONS * 1e3:.2f} ms per iteration) "
          f"on {kind}")


def train_zoo(kind: str, path: str):
    """Path A, B, C or CM built through the port's zoo,
    ``get_experiment("Velocity-Rough", "ppo").to_training_factory()``, on the
    card: 4,096 environments, ``iterations_per_dispatch=10``, observation
    normalization and the KL-adaptive learning rate (CM: C with
    ``fused_ppo_step._PPO_MODE = "mono"``); or path T, TF, TJ or TL,
    ``get_experiment("Velocity-Flat", "transformer_ppo")``: 1,024
    environments, the same chunking, normalization and schedule, on the
    modular route (T, ``CUSRL_TPU_FUSED_TRANSFORMER=0``), the default route
    (TF), the default route with ``fuse_actor_critic_evaluation=True``
    set on the agent factory (TJ) or with ``num_steps_per_update=256``
    (TL); or path F, ``get_experiment("Velocity-Flat", "ppo")``: 4,096
    environments, ELU 128-128-128.  One warm-up chunk of
    ``WARMUP_ITERATIONS``, then one timed chunk through ``Trainer.rollout_and_update`` with the launch
    counters set to 0 just before and read just after, PyTorch's sync debug
    mode on (no synchronizing call but the chunk's one host transfer) and
    every metric finite.  Returns the launches and env-steps/s."""
    from cusrl_tpu_torch.zoo.registry import get_experiment

    if path in PATH_ROUTES:
        factory, envs = get_experiment("Velocity-Flat", "transformer_ppo").to_training_factory(), T_ENVS
        factory.agent.fuse_actor_critic_evaluation = path in ("TJ", "TJC")
        factory.agent.num_steps_per_update = PATH_STEPS.get(path, STEPS)
        if path == "TQ":
            factory.agent = _qk_norm_factory(factory.agent)
    elif path in RECURRENT_PATHS:
        factory, envs = get_experiment("Velocity-Flat", "recurrent_ppo").to_training_factory(), T_ENVS
        factory.agent.fuse_actor_critic_evaluation = path == "RJ"
    elif path in AMP_PATHS:
        factory, envs = get_experiment("Velocity-Flat", "amp").to_training_factory(), T_ENVS
        factory.iterations_per_dispatch = 10  # the entry dispatches one iteration at a time
    elif path in F_PATHS:
        factory, envs = get_experiment("Velocity-Flat", "ppo").to_training_factory(), NUM_ENVS
    elif path in H_PATHS:
        return train_host(kind)[:2]
    elif path in IL_PATHS:
        return train_il(kind)[:2]
    elif path in CONTROL_PATHS:
        factory, envs = get_experiment("Velocity-Rough", "ppo").to_training_factory(), NUM_ENVS
        factory.agent = _control_factory(path, factory.agent)
    elif path in AUX_PATHS:
        import tempfile

        factory, envs = get_experiment("Velocity-Rough", "ppo").to_training_factory(), NUM_ENVS
        if path != "D":
            factory.agent = _aux_factory(path, factory.agent)
            return _train_chunks(kind, path, factory, envs, factory.iterations_per_dispatch)
        # D's expert: the agent [train-zoo] A trained (a fresh path-A agent when A did not run), exported.
        with tempfile.TemporaryDirectory(prefix="cusrl_expert_") as tmp:
            expert = TRAINED.get("A") or _path_a_agent()
            factory.agent = _aux_factory("D", expert_path=_export_expert(expert, tmp))
            return _train_chunks(kind, path, factory, envs, factory.iterations_per_dispatch)
    else:
        factory, envs = get_experiment("Velocity-Rough", "ppo").to_training_factory(), NUM_ENVS
        factory.agent = _with_path(factory.agent, path)
    chunk = factory.iterations_per_dispatch
    factory.num_iterations = 2 * chunk
    with _fused_route(PATH_ROUTES.get(path)), _ppo_mode("mono" if path == "CM" else "split"), _pair_concat(path):
        if path in PROFILE_ONLY_PATHS:
            return _profile_only(path, factory, envs)
        return _train_chunks(kind, path, factory, envs, chunk)


def _profile_only(path: str, factory, envs: int):
    """Two warm-up iterations, then one profiled iteration with the launch
    counters set to 0 just before and read just after (its launches against
    ``EXPECTED_ZOO_LAUNCHES``, per iteration).  Returns the launches and
    None for the rate, which this run does not measure."""
    import torch

    steps = PATH_STEPS.get(path, STEPS)
    trainer = factory(verbose=False, seed=SEED)
    if trainer.environment.num_instances != envs or trainer.agent.device.type != "cuda":
        raise AssertionError("the zoo entry is not the uncut configuration on the card")
    start = time.perf_counter()
    for i in range(2):
        _, metrics = trainer.driver.collect_and_update(steps)
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            raise AssertionError(f"path {path}: non-finite metrics at iteration {i}: {metrics}")
    torch.cuda.synchronize()
    print(f"[train-zoo] {path} ({PATH_NAMES[path]}): two warm-up iterations {time.perf_counter() - start:.3f} s; one "
          f"iteration profiled, no timed chunk")
    _reset_launch_counts()
    profile_iteration(trainer.driver, path, steps)
    launches = _launch_counts()
    print(f"[train-zoo] {path}: launches in the profiled iteration {launches} (expected {EXPECTED_ZOO_LAUNCHES[path]})")
    if launches != EXPECTED_ZOO_LAUNCHES[path]:
        raise AssertionError(f"path {path} did not launch the kernels the expected number of times")
    return launches, None


def _train_chunks(kind: str, path: str, factory, envs: int, chunk: int, distribute: bool = False,
                  profile: bool = True):
    """The warm-up and the timed chunk of ``train_zoo``; with ``distribute``
    the Trainer's agent is distributed over the process group first and the
    timed chunk's collectives are counted (``[ddp] A1``)."""
    import warnings

    import torch

    from cusrl_tpu_torch.parallel import distribute_agent
    from cusrl_tpu_torch.utils import distributed

    steps = PATH_STEPS.get(path, STEPS)
    trainer = factory(verbose=False, seed=SEED)  # device defaults to the card
    if trainer.environment.num_instances != envs or chunk != 10 or trainer.agent.device.type != "cuda":
        raise AssertionError("the zoo entry is not the uncut configuration on the card")
    if distribute:
        distribute_agent(trainer.agent)
        path = f"{path} distributed"
    torch.cuda.reset_peak_memory_stats()  # DeviceMemoryStats (SC) reads the peak since this path began
    start = time.perf_counter()
    trainer.iterations_per_dispatch = WARMUP_ITERATIONS
    for _ in range(WARMUP_ITERATIONS):
        trainer.rollout_and_update()
    trainer.iterations_per_dispatch = chunk
    torch.cuda.synchronize()
    print(f"[train-zoo] {path} ({PATH_NAMES[path.split()[0]]}): warm-up chunk of {WARMUP_ITERATIONS} iterations "
          f"{time.perf_counter() - start:.3f} s")

    _reset_launch_counts()
    distributed.reset_collective_counts()
    transfers, reads = trainer.host_transfers, _host_reads(trainer.agent)
    torch.cuda.set_sync_debug_mode("warn")
    start = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rows = [trainer.rollout_and_update() for _ in range(chunk)]
    elapsed = time.perf_counter() - start
    torch.cuda.set_sync_debug_mode("default")
    launches = _launch_counts()
    collectives = {k: (v[0] / chunk, v[1] / chunk) for k, v in distributed.COLLECTIVES.items()}
    # The sparse bootstrap reads its overflow flag once an update (PO).
    reads = _host_reads(trainer.agent) - reads
    syncs = [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
    others = [site for site in syncs if "template/trainer.py:" not in site
              and not (reads and "hook/on_policy/value.py:" in site)]
    expected = {k: v * chunk for k, v in EXPECTED_ZOO_LAUNCHES[path.split()[0]].items()}
    print(f"[train-zoo] {path}: launches over {chunk} iterations {launches} (expected {expected}); "
          f"host transfers {trainer.host_transfers - transfers} (the Trainer's) + {reads} (the sparse bootstrap's "
          f"overflow flags); synchronizing calls {len(syncs)} ({len(others)} outside those transfers)")
    if launches != expected:
        raise AssertionError(f"path {path} did not launch the kernels the expected number of times")
    if trainer.host_transfers - transfers != 1 or others or reads != (chunk if path == "PO" else 0):
        raise AssertionError(f"path {path}: not one host transfer per chunk: {syncs}, {reads} flag reads")
    for i, row in enumerate(rows):
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"non-finite metrics at iteration {i}: {row}")
    print("    last iteration: " + " ".join(f"{k}={v:.5g}" for k, v in sorted(rows[-1].items())))
    peaks = [row["Memory/device_peak_bytes"] for row in rows if "Memory/device_peak_bytes" in row]
    if peaks:  # DeviceMemoryStats (SC): the caching allocator's peak since the process started
        print(f"[train-zoo] {path}: Memory/device_peak_bytes {max(peaks):.0f} ({max(peaks) / 2**30:.3f} GiB), "
              f"Memory/device_bytes_in_use {rows[0]['Memory/device_bytes_in_use']:.0f} (means over the chunk's "
              f"iterations)")
    steps_per_s = chunk * steps * envs / elapsed
    print(f"[train-zoo] {path}: {steps_per_s:.1f} env-steps/s ({elapsed / chunk * 1e3:.2f} ms per iteration) on {kind}")
    if distribute:
        if not collectives["all_reduce"][0] or not collectives["all_gather"][0]:
            raise AssertionError(f"path {path}: the distributed chunk ran no collective: {collectives}")
        print(f"[ddp] A1: collectives per iteration: " + ", ".join(
            f"{k} {n:g} calls, {b:,.0f} bytes" for k, (n, b) in collectives.items()))
    elif any(n for n, _ in collectives.values()):
        raise AssertionError(f"path {path}: an undistributed chunk ran collectives: {collectives}")
    if profile:
        profile_iteration(trainer.driver, path, steps)
    if path == "A":
        TRAINED["A"] = trainer.agent
    if path == "D":
        expert = trainer.agent.get_hook(D_HOOK).expert
        if next(expert.parameters()).device.type != "cuda" or any(
                p.requires_grad for p in expert.parameters()) or any(
                ".expert." in k for k in trainer.agent.optimizer.labels):
            raise AssertionError("path D: the expert is not frozen on the card, out of the optimizer")
    return launches, steps_per_s


def _host_reads(agent) -> int:
    """The agent's sparse-bootstrap overflow flags read on the host so far."""
    return sum(getattr(hook, "host_reads", 0) for hook in agent.hooks)


def _h_factory(kind: str):
    """The zoo's CartPole-v1 ``ppo`` entry's factory (``to_training_factory``
    or ``to_playing_factory``) on ``NativeCartPoleEnv(8)``: the card's
    machine has no gymnasium, and the C stepper simulates the same system."""
    from cusrl_tpu_torch.environment.native import NativeCartPoleEnv
    from cusrl_tpu_torch.zoo.registry import get_experiment

    factory = getattr(get_experiment("CartPole-v1", "ppo"), f"to_{kind}_factory")()
    factory.environment_factory, factory.environment_kwargs = NativeCartPoleEnv, {"num_instances": H_ENVS}
    return factory


def _h_rollout() -> dict:
    """Path H's rollout for ``[update-check] H``: 32 steps of the CPU agent on
    ``NativeCartPoleEnv(8)`` through the host API, actions from seeded
    Gumbel draws, finished instances reset by index."""
    import torch

    from cusrl_tpu_torch.template.environment import get_done_indices, update_observation_and_state

    factory = _h_factory("training")
    env = factory.environment_factory(**factory.environment_kwargs, seed=SEED)
    agent = factory.agent(env.spec, device="cpu", seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 5)
    observation, _, _ = env.reset()
    for _ in range(H_STEPS):
        gumbel = -torch.log(-torch.log(torch.rand(H_ENVS, 2, generator=gen).clamp_min(1e-12)))
        action = agent.act(observation, noise=gumbel)
        next_observation, _, reward, terminated, truncated, _ = env.step(action)
        agent.step(next_observation, reward, terminated, truncated)
        done = get_done_indices(terminated, truncated)
        if done.size:
            new, _, _ = env.reset(indices=done)
            next_observation, _ = update_observation_and_state(next_observation, None, new, None, done)
        observation = next_observation
    data = agent.buffer.data
    return {key: data[key] for key in ("observation", "next_observation", "action", "reward", "terminated",
                                       "truncated", "done")}


def _h_update(device, rollout: dict, perms, state=None):
    """One update of path H's agent on ``device`` (from the weights ``state``
    when given) on ``rollout``, each side's own ``action_dist`` and
    ``action_logp`` of the same one-hot actions: ``(metrics, the first
    minibatch's gradient by parameter name, the initial weights)``; the
    launch counters are set to 0 just before the update."""
    import torch
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    factory = _h_factory("training")
    agent = factory.agent(factory.environment_factory(**factory.environment_kwargs).spec, device=device, seed=SEED)
    initial = {k: v.detach().clone() for k, v in agent.model.state_dict().items()}
    if state is not None:
        agent.model.load_state_dict(state)
    rollout = {key: value.to(device) for key, value in rollout.items()}
    with torch.no_grad():
        dist, _, _ = agent.actor(rollout["observation"])
    rollout.update(action_dist=dist, action_logp=agent.actor.compute_logp(dist, rollout["action"]))
    names = {id(p): name for name, p in agent.model.named_parameters()}
    first_grads = {}

    def keep_first(optimizer, args, kwargs):
        if not first_grads:
            first_grads.update({names[id(p)]: p.grad.detach().clone() for group in optimizer.param_groups
                                for p in group["params"] if p.grad is not None})

    handle = register_optimizer_step_pre_hook(keep_first)
    _reset_launch_counts()
    try:
        metrics = {k: float(v) for k, v in agent.update_body(rollout, epoch_perms=perms).items()}
    finally:
        handle.remove()
    return metrics, {k: v.cpu() for k, v in first_grads.items()}, initial


def check_h_update_against_cpu() -> None:
    """``[update-check] H``: one update of path H on the card against the
    port's plain CPU path, same weights, the same rollout (the CPU agent's
    32 steps on the native CartPole, actions from the same Gumbel draws) and
    the same minibatch plan; ``update_check_failures``'s limits."""
    import torch

    rollout = _h_rollout()
    perms = torch.stack([torch.randperm(H_ROWS // 128, generator=torch.Generator().manual_seed(e))
                         for e in range(H_EPOCHS)])
    cpu_metrics, cpu_grads, state = _h_update("cpu", rollout, perms)
    cuda_metrics, cuda_grads, _ = _h_update("cuda", rollout, perms, state)
    launched = {k: v for k, v in _launch_counts().items() if v}
    expected = {k: v for k, v in EXPECTED_ZOO_LAUNCHES["H"].items() if v}
    print(f"[update-check] H: {int(rollout['done'].sum())} finished episodes in the rollout; cuda launches "
          f"{launched}")
    if launched != expected:
        raise AssertionError(f"path H's update did not run through the kernels: {launched}, expected {expected}")
    failed = update_check_failures(cpu_metrics, cpu_grads, cuda_metrics, cuda_grads, report=True)
    if failed:
        raise AssertionError(f"update check of path H: {failed} disagree between the card and the CPU path")


def _sync_sites(caught) -> dict:
    """``{file:line: count}`` of the synchronizing calls that PyTorch's sync
    debug mode reported."""
    sites: dict = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return sites


def _source_line(relative: str, text: str) -> str:
    """``relative:line`` of the one line of a port source that holds ``text``."""
    lines = [i + 1 for i, line in enumerate((REPO / relative).read_text().splitlines()) if text in line]
    if len(lines) != 1:
        raise AssertionError(f"{relative}: {len(lines)} lines hold {text!r}")
    return f"{relative}:{lines[0]}"


def train_host(kind: str):
    """``[train-zoo] H``: the zoo's CartPole-v1 ``ppo`` entry as registered
    (tanh 4-64-64, 8 environments, 32 steps, 20 epochs of one 256-row
    minibatch) on ``NativeCartPoleEnv(8)`` through the Trainer's host loop
    on the card: two warm-up iterations, then 10 with the launch counters
    set to 0 just before and read just after, PyTorch's sync debug mode on
    (the synchronizing calls by site: the action's transfer a step, the
    metrics' an update) and every metric finite; the Timer's environment
    and agent seconds; a profile of one iteration.  Returns the launches,
    env-steps/s and the trainer's checkpoint."""
    import warnings

    import torch

    factory = _h_factory("training")
    factory.num_iterations = 12
    trainer = factory(verbose=False, seed=SEED)  # device defaults to the card
    if (trainer.driver is not None or trainer.environment.num_instances != H_ENVS
            or trainer.agent.device.type != "cuda" or trainer.agent.num_steps_per_update != H_STEPS):
        raise AssertionError("path H is not the registered entry on the host loop on the card")
    start = time.perf_counter()
    for _ in range(2):
        trainer.rollout_and_update()
    torch.cuda.synchronize()
    print(f"[train-zoo] H ({PATH_NAMES['H']}): warm-up of 2 iterations {time.perf_counter() - start:.3f} s")
    iterations = 10
    _reset_launch_counts()
    trainer.timer.clear()
    torch.cuda.set_sync_debug_mode("warn")
    start = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rows = [trainer.rollout_and_update() for _ in range(iterations)]
    elapsed = time.perf_counter() - start
    torch.cuda.set_sync_debug_mode("default")
    launches = _launch_counts()
    expected = {k: v * iterations for k, v in EXPECTED_ZOO_LAUNCHES["H"].items()}
    sites = _sync_sites(caught)
    act_site = _source_line("cusrl_tpu_torch/template/actor_critic.py", "action.cpu().numpy()")
    update_site = _source_line("cusrl_tpu_torch/template/actor_critic.py", "values.tolist()")
    steps = iterations * H_STEPS
    per_step, per_update = sites.get(act_site, 0) / steps, sites.get(update_site, 0) / iterations
    others = {site: n for site, n in sites.items() if site not in (act_site, update_site)}
    print(f"[train-zoo] H: launches over {iterations} iterations {launches} (expected {expected}); synchronizing "
          f"calls: {per_step:g} a rollout step ({act_site}, the action's transfer), {per_update:g} an update "
          f"({update_site}, the metrics'), others {others or 'none'}")
    if launches != expected:
        raise AssertionError("path H did not launch the kernels the expected number of times")
    if per_step != 1 or per_update != 1:
        raise AssertionError(f"path H: not one host transfer a step and one an update: {sites}")
    for i, row in enumerate(rows):
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"non-finite metrics at iteration {i}: {row}")
    print("    last iteration: " + " ".join(f"{k}={v:.5g}" for k, v in sorted(rows[-1].items())))
    env_s, agent_s = trainer.timer.total("environment"), trainer.timer.total("agent")
    steps_per_s = steps * H_ENVS / elapsed
    print(f"[train-zoo] H: {steps_per_s:.1f} env-steps/s ({elapsed / iterations * 1e3:.2f} ms per iteration) on "
          f"{kind}; Timer: environment {env_s:.4f} s ({steps * H_ENVS / env_s:.1f} env-steps/s), agent "
          f"{agent_s:.4f} s over {iterations} iterations; episodes {trainer.stats.summary()}")
    profile_iteration(None, "H", fn=trainer.rollout_and_update)
    return launches, steps_per_s, trainer.make_checkpoint()


def play_h(kind: str, checkpoint: dict) -> dict:
    """``[play] H``: the Player, deterministic and unpaced, on
    ``NativeCartPoleEnv(8)`` from path H's trained checkpoint for 500 steps:
    one K1f launch a step (the 8-row step takes the kernel in inference
    mode), a finite summary, env-steps/s."""
    factory = _h_factory("playing")
    factory.num_steps, factory.timestep = H_PLAY_STEPS, 0.0
    player = factory(checkpoint, verbose=False, seed=SEED)
    _reset_launch_counts()
    summary = player.run_playing_loop()
    launched = {k: v for k, v in _launch_counts().items() if v}
    rate = player.steps_taken * H_ENVS / player.loop_seconds
    print(f"[play] H: {player.steps_taken} steps on {H_ENVS} environments in {player.loop_seconds:.3f} s: "
          f"{rate:.1f} env-steps/s (deterministic, unpaced) on {kind}; launches {launched}; summary {summary}")
    if (player.steps_taken != H_PLAY_STEPS or launched != {"K1f": H_PLAY_STEPS}
            or not all(math.isfinite(v) for v in summary.values()) or "episode_reward" not in summary):
        raise AssertionError("[play] H: not one K1f launch a step, or a non-finite or incomplete summary")
    return {"env_steps_per_s": rate, "launches_per_step": launched.get("K1f", 0) / player.steps_taken, **summary}


# -- Path IL: the IsaacLab adapter over a card-resident stand-in simulator ----

IL_TASK = "Isaac-Velocity-Rough-Anymal-C-v0"
IL_PLAY_TASK = "Isaac-Velocity-Rough-Anymal-C-Play-v0"
# LocomotionVelocityRoughEnvCfg (isaaclab_tasks/manager_based/locomotion/velocity/velocity_env_cfg.py) for ANYmal-C:
# the policy group holds the base's linear and angular velocity, the projected gravity and the velocity command (3
# each), the joint positions and velocities and the last action (12 each) and the height scan's 187 rays; 12 joint
# position actions; no critic group; decimation 4 x 0.005 s; 20 s episodes; 4,096 environments, 50 in its Play variant.
IL_STATE = 4 * 3 + 3 * 12  # the stand-in's state: the policy group less the height scan
IL_SCAN = 187
IL_OBS = IL_STATE + IL_SCAN  # 235
IL_ACT = 12
IL_WIDTHS = (IL_OBS, 512, 256, 128)
IL_ENVS, IL_PLAY_ENVS = 4096, 50
IL_DT = 4 * 0.005
IL_EPISODE_STEPS = round(20.0 / IL_DT)  # 1,000 steps, then the time-out truncates
IL_TERMINATION_P = 1 / 250  # the stand-in's chance a step that an episode ends in a base contact
IL_ITERATIONS = 10  # [train-zoo] IL's timed iterations, after one warm-up iteration
IL_PLAY_STEPS = 100
IL_PATHS = ("IL",)


class _Box:
    def __init__(self, shape):
        self.shape = shape


class _Dict:
    def __init__(self, spaces: dict):
        self.spaces = spaces

    def __getitem__(self, key):
        return self.spaces[key]


class _StandInAnymalEnv:
    """What the IsaacLab adapter reads of a ``ManagerBasedRLEnv`` on the
    Anymal-C rough task: ``num_envs``, ``device``, ``step_dt``, the spaces,
    ``reset``, ``step`` and ``close``, every tensor on the card.  Cheap
    dynamics driven by the action (the joints follow half the action as
    position targets, the base's velocities the first six joints), a fixed
    height scan per environment, the velocity-tracking and action-rate
    rewards (times ``step_dt``, as IsaacLab's reward manager weighs them),
    base contacts drawn from its own CUDA generator, the time-out at 1,000
    steps (episodes start at random lengths, as RSL-RL's ``init_at_random_ep_len``),
    autoreset (the observation returned for a finished episode is the next
    episode's first) and ``extras["log"]`` as the reward and termination
    managers write it, each a 0-d tensor; no step waits on the host.  As
    IsaacLab's environment does, it returns the same buffers every step
    (``obs_buf``, ``reward_buf``, ``reset_terminated``, ``reset_time_outs``),
    rewritten in place; ``history`` keeps copies of the last ``STEPS``
    steps' rewards and flags."""

    def __init__(self, num_envs: int, device, seed: int = SEED):
        import torch

        self.num_envs, self.device, self.step_dt = num_envs, str(device), IL_DT
        self.observation_space = _Dict({"policy": _Box((num_envs, IL_OBS))})
        self.action_space = _Box((num_envs, IL_ACT))
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.scan = (0.1 * torch.randn(num_envs, IL_SCAN, generator=self.generator, device=device)).clamp(-1, 1)
        self.state = self._fresh_state()
        self.length = torch.randint(0, IL_EPISODE_STEPS, (num_envs,), generator=self.generator, device=device)
        self.episode_reward = torch.zeros(num_envs, device=device)
        self.obs_buf = torch.empty(num_envs, IL_OBS, device=device)
        self.reward_buf = torch.empty(num_envs, device=device)
        self.reset_terminated = torch.empty(num_envs, dtype=torch.bool, device=device)
        self.reset_time_outs = torch.empty_like(self.reset_terminated)
        self.history = collections.deque(maxlen=STEPS)
        self.closed = False

    @property
    def unwrapped(self):
        return self

    def _fresh_state(self):
        """Zero velocities and joint positions, gravity straight down, a command drawn in [-1, 1]."""
        import torch

        state = torch.zeros(self.num_envs, IL_STATE, device=self.device)
        state[:, 8] = -1.0
        state[:, 9:12] = 2 * torch.rand(self.num_envs, 3, generator=self.generator, device=self.device) - 1
        return state

    def _observe(self) -> dict:
        import torch

        return {"policy": torch.cat([self.state, self.scan], dim=1, out=self.obs_buf)}

    def reset(self):
        return self._observe(), {"log": {}}

    def step(self, action):
        import torch

        s = self.state
        joints = s[:, 12:24]
        velocities = (0.5 * action - joints) * (0.2 / IL_DT)
        joints = joints + IL_DT * velocities
        base = 0.9 * s[:, :6] + 0.1 * joints[:, :6]
        reward = IL_DT * (torch.exp(-(base[:, :2] - s[:, 9:11]).square().sum(1) / 0.25)
                          + 0.5 * torch.exp(-(base[:, 5] - s[:, 11]).square() / 0.25)
                          - 0.01 * (action - s[:, 36:48]).square().sum(1))
        self.state = torch.cat([base, s[:, 6:12], joints, velocities, action], dim=1)
        self.length += 1
        self.episode_reward += reward
        terminated = torch.rand(self.num_envs, generator=self.generator, device=self.device) < IL_TERMINATION_P
        truncated = self.length >= IL_EPISODE_STEPS
        done = terminated | truncated
        finished = done.sum().clamp_min(1)
        log = {"Episode_Reward/track_lin_vel_xy_exp": torch.where(done, self.episode_reward, 0.0).sum() / finished
               / (IL_EPISODE_STEPS * IL_DT),
               "Episode_Termination/time_out": truncated.sum(), "Episode_Termination/base_contact": terminated.sum()}
        self.state = torch.where(done[:, None], self._fresh_state(), self.state)
        self.length.masked_fill_(done, 0)
        self.episode_reward.masked_fill_(done, 0.0)
        out = (self.reward_buf.copy_(reward), self.reset_terminated.copy_(terminated),
               self.reset_time_outs.copy_(truncated))
        self.history.append(tuple(x.clone() for x in out))
        return self._observe(), *out, {"log": log}

    def close(self):
        self.closed = True


@contextlib.contextmanager
def _stand_in_isaaclab():
    """Fake ``isaaclab``, ``isaaclab.app``, ``isaaclab_tasks`` (with its
    ``utils.parse_cfg``) and ``gymnasium`` modules, taken out again after:
    ``parse_env_cfg`` gives the Anymal-C task's and its Play variant's
    environment counts and ``gym.make`` a ``_StandInAnymalEnv`` on the card.
    Yields the list of the environments made."""
    import argparse
    import types

    made = []

    class AppLauncher:
        @staticmethod
        def add_app_launcher_args(parser: argparse.ArgumentParser) -> None:
            parser.add_argument("--headless", action="store_true")
            parser.add_argument("--device", default="cuda:0")

        def __init__(self, args):
            self.app = types.SimpleNamespace(close=lambda: None)

    def parse_env_cfg(task, device="cuda:0", num_envs=None):
        if task not in (IL_TASK, IL_PLAY_TASK):
            raise ValueError(f"the stand-in has no task {task!r}")
        default = IL_PLAY_ENVS if task == IL_PLAY_TASK else IL_ENVS
        return types.SimpleNamespace(device=device, num_envs=num_envs or default, episode_length_s=20.0)

    def make(task, cfg=None):
        made.append(_StandInAnymalEnv(cfg.num_envs, cfg.device))
        return made[-1]

    def module(name, **attrs):
        mod = types.ModuleType(name)
        mod.__dict__.update(attrs)
        return mod

    app = module("isaaclab.app", AppLauncher=AppLauncher)
    parse = module("isaaclab_tasks.utils.parse_cfg", parse_env_cfg=parse_env_cfg)
    modules = {"isaaclab": module("isaaclab", app=app), "isaaclab.app": app, "isaaclab_tasks": module("isaaclab_tasks"),
               "isaaclab_tasks.utils": module("isaaclab_tasks.utils", parse_cfg=parse),
               "isaaclab_tasks.utils.parse_cfg": parse, "gymnasium": module("gymnasium", make=make)}
    saved = {name: sys.modules.get(name) for name in modules}
    sys.modules.update(modules)
    try:
        yield made
    finally:
        for name, old in saved.items():
            if old is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = old


def check_il_kernels(device) -> dict:
    """K1f and K1b on the Anymal-C entry's ELU backbones (235 -> 512 -> 256
    -> 128, fp32 observations 235 wide: each launch pads x and W_0 to 240
    columns, so the first layer's K blocks end in a partial 48-column one) at
    the sizes path IL gives them: the forward primal at the rollout step's
    4,096 rows and the value and KL passes' 98,304, saving at the
    minibatch's 24,576 and a ragged 1,000 (checked, not timed), the backward
    with ``skip_input_grad``; and the pad's device time at each, apart from
    the kernels'.  Returns the ``il_`` fields of K1f and K1b."""
    import torch

    from cusrl_tpu_torch.nn.kernels import fused_mlp as fm

    print("[kernels] IL: K1f/K1b on the Anymal-C entry's ELU backbones 235-512-256-128 (fp32 input padded per launch "
          "to 240 columns; rollout step, minibatch, value and KL passes)")
    fields = _check_chain_kernels(device, "IL", "il_", IL_WIDTHS, torch.float32,
                                  ((NUM_ENVS, False, "step_", True), (MINIBATCH_ROWS, True, "", True),
                                   (F_PRIMAL_ROWS, False, "primal_", True), (RAGGED_ROWS, True, "ragged_", False)),
                                  seed=37, skip_input_grad=True)
    gen = torch.Generator().manual_seed(SEED + 38)
    ws = [(torch.randn(b, a, generator=gen) / math.sqrt(a)).to(device) for a, b in zip(IL_WIDTHS[:-1], IL_WIDTHS[1:])]
    pads = {}
    for rows in (NUM_ENVS, MINIBATCH_ROWS, F_PRIMAL_ROWS):
        x = torch.randn(rows, IL_OBS, generator=gen).to(device)
        pads[rows] = _queued_events_ms(lambda: fm.pad_input([x], [ws]))
        print(f"    the pad of x [{rows}, {IL_OBS}] and W_0 [512, {IL_OBS}] to 240 columns: {pads[rows]:.4f} device ms "
              f"(CUDA events behind a queued sleep; not in the kernels' device times)")
    for key in ("K1f", "K1b"):
        fields[key]["il_pad_device_ms"] = pads
        fields[key]["il_shape"] = (f"{IL_OBS}-512-256-128 ELU, fp32 input padded to 240 columns per launch: "
                                   + (f"primal at {NUM_ENVS} (the rollout step) and {F_PRIMAL_ROWS} (the value and KL "
                                      f"passes), saving at {MINIBATCH_ROWS} (the minibatch)" if key == "K1f" else
                                      f"{MINIBATCH_ROWS} rows (the minibatch), skip_input_grad")
                                   + f"; also {RAGGED_ROWS} rows, checked")
    return fields


def train_il(kind: str):
    """``[train-zoo] IL``, ``[profile] IL`` and ``[play] IL``: the zoo's
    uncut ``Isaac-Velocity-Rough-Anymal-C-v0``/``ppo`` entry through
    ``get_experiment(...).to_training_factory()`` with the fake IsaacLab
    modules installed: ``make_isaaclab_env`` -> ``IsaacLabEnvLauncher`` ->
    the adapter over ``_StandInAnymalEnv`` (4,096 environments on the card)
    -> the Trainer's host loop on the card's tensors.  One warm-up
    iteration, then 10 through ``run_training_loop`` (the adapter's
    ``get_metrics`` logged as ``Environment/<key>``) with the launch counters
    set to 0 just before and read just after, PyTorch's sync debug mode on
    (the synchronizing calls by site: the update's metrics transfer and the
    environment metrics' read, one each an iteration; none in a rollout
    step) and every logged value finite; the stand-in's and the policy
    step's device ms a step; a profile of one iteration; then the playing
    factory's ``-Play`` task (50 environments) for 100 deterministic,
    unpaced steps from the trained checkpoint, one K1f a step.  Also checks
    that the last iteration's rollout holds each step's own rewards and
    flags, which the stand-in rewrote in place.  Returns the launches,
    env-steps/s, the Player's env-steps/s and its K1f launches a step."""
    import warnings

    import torch

    from cusrl_tpu_torch.environment.isaaclab import IsaacLabEnvAdapter
    from cusrl_tpu_torch.template.trainer import TrainerHook
    from cusrl_tpu_torch.zoo.registry import get_experiment

    class Logged(TrainerHook):
        def __init__(self):
            self.rows = []

        def post_iteration(self, trainer, metrics):
            self.rows.append(metrics)

    update_site = _source_line("cusrl_tpu_torch/template/actor_critic.py", "values.tolist()")
    metrics_site = _source_line("cusrl_tpu_torch/environment/isaaclab.py", "means.tolist()")
    with _stand_in_isaaclab() as made:
        factory = get_experiment(IL_TASK, "ppo").to_training_factory()
        logged = Logged()
        factory.trainer_hooks, factory.num_iterations = (logged,), 1 + IL_ITERATIONS
        trainer = factory(verbose=False, seed=SEED)  # device defaults to the card
        env, agent, sim = trainer.environment, trainer.agent, made[0]
        if (trainer.driver is not None or not isinstance(env, IsaacLabEnvAdapter) or env.num_instances != IL_ENVS
                or (env.spec.observation_dim, env.spec.action_dim, env.spec.state_dim) != (IL_OBS, IL_ACT, None)
                or agent.device.type != "cuda" or torch.device(sim.device).type != "cuda"
                or agent.num_steps_per_update != STEPS or env.spec.timestep != IL_DT
                or [l.output_dim for l in agent.actor.backbone.layers] != list(IL_WIDTHS[1:])):
            raise AssertionError("path IL is not the uncut entry on the adapter's host loop on the card")
        start = time.perf_counter()
        trainer.rollout_and_update()
        torch.cuda.synchronize()
        print(f"[train-zoo] IL ({PATH_NAMES['IL']}): warm-up iteration {time.perf_counter() - start:.3f} s")
        _reset_launch_counts()
        torch.cuda.set_sync_debug_mode("warn")
        start = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.run_training_loop()
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        torch.cuda.set_sync_debug_mode("default")
        launches = _launch_counts()
        data = agent.buffer.data
        for i, key in enumerate(("reward", "terminated", "truncated")):
            want = torch.stack([step[i] for step in sim.history]).reshape(data[key].shape)
            if len(sim.history) != STEPS or not torch.equal(data[key], want.to(data[key].dtype)):
                raise AssertionError(f"path IL: the rollout's {key} is not each step's own (the stand-in rewrites "
                                     "its buffers in place)")
        print(f"[train-zoo] IL: the last rollout holds each of its {STEPS} steps' own rewards and flags, which the "
              "stand-in rewrote in place")
        expected = {k: v * IL_ITERATIONS for k, v in EXPECTED_ZOO_LAUNCHES["IL"].items()}
        sites = _sync_sites(caught)
        others = {site: n for site, n in sites.items() if site not in (update_site, metrics_site)}
        print(f"[train-zoo] IL: launches over {IL_ITERATIONS} iterations {launches} (expected {expected}); "
              f"synchronizing calls: {sites.get(update_site, 0) / IL_ITERATIONS:g} an iteration at {update_site} (the "
              f"update's metrics and the episode aggregates), {sites.get(metrics_site, 0) / IL_ITERATIONS:g} at "
              f"{metrics_site} (extras['log']), others {others or 'none'} (none in a rollout step)")
        if launches != expected:
            raise AssertionError("path IL did not launch the kernels the expected number of times")
        if sites.get(update_site) != IL_ITERATIONS or sites.get(metrics_site) != IL_ITERATIONS or others:
            raise AssertionError(f"path IL: not one metrics transfer and one extras read an iteration: {sites}")
        rows = logged.rows
        logged_keys = {"Environment/Episode_Reward/track_lin_vel_xy_exp", "Environment/episode_reward"}
        if (len(rows) != IL_ITERATIONS or not all(math.isfinite(v) for row in rows for v in row.values())
                or not logged_keys <= set(rows[-1])):
            raise AssertionError(f"path IL: non-finite or missing logged values: {rows[-1]}")
        print("    last iteration: " + " ".join(f"{k}={v:.5g}" for k, v in sorted(rows[-1].items())))
        steps_per_s = IL_ITERATIONS * STEPS * IL_ENVS / elapsed
        a_rate = ZOO_RATES.get("A")
        print(f"[train-zoo] IL: {steps_per_s:.1f} env-steps/s ({elapsed / IL_ITERATIONS * 1e3:.2f} ms per iteration, "
              f"logging included) on {kind}; [train-zoo] A: {'not run' if a_rate is None else f'{a_rate:.1f}'}; "
              f"episodes {trainer.stats.summary()}")
        observation = sim._observe()["policy"]
        action = torch.zeros(IL_ENVS, IL_ACT, device=agent.device)
        sim_ms, how = _device_ms_per_call(lambda: sim.step(action))
        act_ms, _ = _device_ms_per_call(lambda: agent.act_body(observation))
        print(f"[train-zoo] IL: the stand-in simulator {sim_ms:.4f} device ms a step, the policy step (act_body) "
              f"{act_ms:.4f} ({how})")
        profile_iteration(None, "IL", fn=trainer.rollout_and_update)

        play = get_experiment(IL_TASK, "ppo").to_playing_factory()
        play.num_steps, play.timestep = IL_PLAY_STEPS, 0.0
        player = play(trainer.make_checkpoint(), verbose=False, seed=SEED)
        if player.environment.num_instances != IL_PLAY_ENVS or made[-1].num_envs != IL_PLAY_ENVS:
            raise AssertionError("[play] IL: the playing factory did not build the Play task")
        _reset_launch_counts()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            summary = player.run_playing_loop()
        torch.cuda.set_sync_debug_mode("default")
        launched = {k: v for k, v in _launch_counts().items() if v}
        play_sites = _sync_sites(caught)
        rate = player.steps_taken * IL_PLAY_ENVS / player.loop_seconds
        print(f"[play] IL: {player.steps_taken} steps on {IL_PLAY_ENVS} environments ({IL_PLAY_TASK}) in "
              f"{player.loop_seconds:.3f} s: {rate:.1f} env-steps/s (deterministic, unpaced) on {kind}; launches "
              f"{launched}; synchronizing calls {play_sites}; summary {summary}")
        if (player.steps_taken != IL_PLAY_STEPS or launched != {"K1f": IL_PLAY_STEPS}
                or sum(play_sites.values()) >= IL_PLAY_STEPS
                or not all(math.isfinite(v) for v in summary.values())
                or not {"step_reward", "Episode_Reward/track_lin_vel_xy_exp"} <= set(summary)):
            raise AssertionError("[play] IL: not one K1f launch a step, a step that waits, or a bad summary")
    return launches, steps_per_s, rate, launched.get("K1f", 0) / player.steps_taken


# -- [cli]: the user surface on path F ---------------------------------------

CLI_ENTRY = ["-env", "Velocity-Flat", "-alg", "ppo"]
EXPORT_RTOL = EXPORT_ATOL = 2e-2  # the exported graph (plain bf16 layers) against the kernel route


def _cli(argv: list[str], timings: dict, label: str, capture: bool = False):
    """``cusrl_tpu_torch.__main__.main(argv)`` in this process, timed; with
    ``capture`` returns its standard output instead of its result."""
    import io

    from cusrl_tpu_torch.__main__ import main as cli_main

    start = time.perf_counter()
    if capture:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_main(argv)
        result = out.getvalue()
    else:
        result = cli_main(argv)
    timings[label] = time.perf_counter() - start
    print(f"[cli] {label}: {timings[label]:.2f} s")
    return result


def _fresh_f_agent(device):
    """The zoo's Velocity-Flat ppo agent for 4,096 environments on ``device``."""
    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.zoo.registry import get_experiment

    env = VelocityLocomotionEnv(num_instances=NUM_ENVS, device=device)
    return get_experiment("Velocity-Flat", "ppo").make_agent_factory()(env.spec, device=device, seed=SEED + 9)


def _check_round_trip(path: str, saving_agent=None) -> None:
    """A fresh card agent loads the checkpoint file and gives back its
    ``agent_state`` bit for bit (keys, dtypes, values); with
    ``saving_agent``, also its deterministic actions on a fixed batch."""
    import warnings

    import numpy as np
    import torch

    from cusrl_tpu_torch.template.logger import load_checkpoint_file

    saved = load_checkpoint_file(path)["agent"]
    agent = _fresh_f_agent(torch.device("cuda", 0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        agent.load_state_dict(saved)
    if caught:
        raise AssertionError(f"loading {os.path.basename(path)} warned: {[str(w.message) for w in caught]}")
    again = agent.state_dict()["agent_state"]
    differ = [p for p, v in saved["agent_state"].items()
              if p not in again or again[p].dtype != v.dtype or not np.array_equal(again[p], v)]
    if differ or set(again) != set(saved["agent_state"]):
        raise AssertionError(f"{os.path.basename(path)} does not round-trip bit for bit: {differ[:8]}")
    line = f"[cli] {os.path.basename(path)}: a fresh card agent gives back its {len(again)} agent_state paths bit for bit"
    if saving_agent is not None:
        obs = torch.tanh(torch.randn(NUM_ENVS, F_WIDTHS[0], generator=torch.Generator().manual_seed(SEED + 5)))
        obs = obs.to(agent.device)
        actions = []
        for a in (saving_agent, agent):
            a.set_inference_mode(True)
            actions.append(a.act(obs))
        if not torch.equal(*actions):
            raise AssertionError(f"{os.path.basename(path)}: the loaded agent's deterministic actions differ from the "
                                 f"saving agent's by {(actions[0] - actions[1]).abs().max().item():.3e}")
        line += f", and the saving agent's deterministic actions on {NUM_ENVS} observations bit for bit"
    print(line)


def _check_export(directory: str, checkpoint: str) -> dict:
    """The exported ``graph.pt2`` on the card and on the CPU against the card
    agent's kernel route (observation normalization, then the actor's mean;
    K1f at 4,096 rows) on the same observations, with the weights of the
    checkpoint the export read."""
    import torch

    from cusrl_tpu_torch.export import load_exported_graph
    from cusrl_tpu_torch.template.logger import load_checkpoint_file

    device = torch.device("cuda", 0)
    agent = _fresh_f_agent(device)
    agent.load_state_dict(load_checkpoint_file(checkpoint)["agent"])
    obs = torch.tanh(torch.randn(NUM_ENVS, F_WIDTHS[0], generator=torch.Generator().manual_seed(SEED + 6)))
    _reset_launch_counts()
    with torch.no_grad():
        normalized = agent.get_hook("observation_normalization").observation_rms.normalize(obs.to(device))
        want = agent.actor(normalized)[0]["mean"].float()
    if _launch_counts()["K1f"] != 1:
        raise AssertionError(f"the card agent's route did not launch K1f once: {_launch_counts()}")
    errors = {}
    for where in ("cuda", "cpu"):
        call, manifest = load_exported_graph(directory, device=where)
        if manifest["inputs"]["observation"]["shape"] != [NUM_ENVS, F_WIDTHS[0]]:
            raise AssertionError(f"unexpected manifest: {manifest}")
        _reset_launch_counts()
        with torch.no_grad():
            got = call({"observation": obs.to(where)})["action"].float().to(device)
        if any(_launch_counts().values()):
            raise AssertionError("the exported graph launched a kernel")
        errors[where] = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=EXPORT_RTOL, atol=EXPORT_ATOL)
    print(f"[cli] export: graph.pt2 against the card agent's kernel route, worst |error| on the card "
          f"{errors['cuda']:.3e}, on the CPU {errors['cpu']:.3e} (limit rtol/atol {EXPORT_RTOL})")
    return errors


def check_cli_sync(tmp: str) -> None:
    """A Trainer of path F with the jsonl logger: its second chunk of 10
    iterations, which ends at no checkpoint (the entry's interval is 50),
    makes one host transfer and no other synchronizing call, counted as
    ``[train-zoo]`` counts them, logging included."""
    import warnings

    import torch

    from cusrl_tpu_torch.template.logger import LoggerFactory
    from cusrl_tpu_torch.template.trainer import TrainerHook
    from cusrl_tpu_torch.zoo.registry import get_experiment

    class SyncWindow(TrainerHook):
        """Sync debug mode on from the pre_iteration of iteration 10 to the
        post_iteration of iteration 19."""

        def __init__(self):
            self.calls, self.caught, self.transfers = 0, None, 0

        def pre_iteration(self, trainer):
            if self.calls == 10:
                # The mode's own "prototype feature" warning comes before the record.
                torch.cuda.set_sync_debug_mode("warn")
                self._record = warnings.catch_warnings(record=True)
                self.caught = self._record.__enter__()
                warnings.simplefilter("always")
                self.transfers = trainer.host_transfers

        def post_iteration(self, trainer, metrics):
            if self.calls == 19:
                torch.cuda.set_sync_debug_mode("default")
                self._record.__exit__(None, None, None)
                self.transfers = trainer.host_transfers - self.transfers
            self.calls += 1

    window = SyncWindow()
    factory = get_experiment("Velocity-Flat", "ppo").to_training_factory()
    factory.num_iterations, factory.trainer_hooks = 30, (window,)
    trainer = factory(logger_factory=LoggerFactory("jsonl", log_dir=os.path.join(tmp, "sync")), verbose=False,
                      seed=SEED)
    trainer.run_training_loop()
    syncs = [f"{w.filename}:{w.lineno}" for w in window.caught if "synchroniz" in str(w.message)]
    others = [site for site in syncs if "template/trainer.py:" not in site]
    print(f"[cli] jsonl-logged chunk of 10 iterations ending at no checkpoint: host transfers {window.transfers}; "
          f"synchronizing calls {len(syncs)} ({len(others)} outside the Trainer's transfer)")
    if window.transfers != 1 or others:
        raise AssertionError(f"the logged chunk made more than one host sync: {syncs}")


def check_cli() -> dict:
    """``[cli]``: the port's CLI on path F in a temporary directory (the
    module docstring's phase 8).  Returns each subcommand's seconds and the
    benchmark's env-steps/s."""
    import math as _math
    import tempfile

    import torch

    timings: dict[str, float] = {}
    with tempfile.TemporaryDirectory(prefix="cusrl_cli_") as tmp:
        logs = os.path.join(tmp, "logs")
        argv = [sys.executable, "-m", "cusrl_tpu_torch", "train", *CLI_ENTRY, "--num-iterations", "20", "--logger",
                "jsonl", "--seed", "0", "--log-dir", logs, "--", "--checkpoint_interval", "10"]
        start = time.perf_counter()
        proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=600)
        timings["train (subprocess)"] = time.perf_counter() - start
        print(f"[cli] train (subprocess, 20 iterations): {timings['train (subprocess)']:.2f} s, exit {proc.returncode}")
        for line in proc.stdout.splitlines()[-2:]:
            print(f"    {line}")
        if proc.returncode != 0:
            raise AssertionError(f"train exited {proc.returncode}:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        run = os.path.realpath(os.path.join(logs, "latest"))
        for name in ("ckpt/ckpt_10.npz", "ckpt/ckpt_20.npz", "info/metadata.json", "metrics.jsonl"):
            if not os.path.isfile(os.path.join(run, name)):
                raise AssertionError(f"the run directory lacks {name}")
        rows = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
        if len(rows) != 20 or not all(_math.isfinite(v) for row in rows for v in row.values()):
            raise AssertionError(f"expected 20 finite jsonl lines, got {len(rows)}")
        print(f"[cli] run directory {os.path.basename(run)}: ckpt_10.npz, ckpt_20.npz, info/metadata.json, the "
              f"latest link, 20 finite jsonl lines")

        resumed = _cli(["train", *CLI_ENTRY, "--num-iterations", "25", "--logger", "jsonl", "--log-dir",
                        os.path.join(tmp, "resumed"), "--checkpoint", run, "--quiet"], timings, "train --checkpoint")
        resumed_rows = [json.loads(line) for line in open(os.path.join(resumed.logger.log_dir, "metrics.jsonl"))]
        if resumed.agent.iteration != 25 or [r["iteration"] for r in resumed_rows] != list(range(20, 25)):
            raise AssertionError(f"the resumed run did not go from 20 to 25: {[r['iteration'] for r in resumed_rows]}")
        print("[cli] train --checkpoint: resumed at 20, stopped at 25")
        _check_round_trip(os.path.join(run, "ckpt", "ckpt_20.npz"))
        _check_round_trip(os.path.join(resumed.logger.ckpt_dir, "ckpt_25.npz"), saving_agent=resumed.agent)

        # play runs the entry's training environments (4,096), paced at 1 / dt;
        # benchmark its 64 benchmarking environments, unpaced: K1f below the
        # 256-row floor, as inference mode allows.
        for label, extra, steps in (("play", ["--num-steps", "100"], 100),
                                    ("play --stochastic", ["--num-steps", "100", "--stochastic"], 100),
                                    ("benchmark", ["--num-steps", "1000"], 1000)):
            _reset_launch_counts()
            player = _cli([label.split()[0], *CLI_ENTRY, "--log-dir", logs, "--checkpoint", run, *extra], timings,
                          label)
            summary = player.metrics.summary()
            launched = {k: v for k, v in _launch_counts().items() if v}
            print(f"[cli] {label}: {player.steps_taken} steps on {player.environment.num_instances} environments, "
                  f"summary {summary}, launches {launched}")
            if not summary or not all(_math.isfinite(v) for v in summary.values()) or launched != {"K1f": steps}:
                raise AssertionError(f"{label}: a non-finite summary or not one K1f launch a step")
        rate = player.steps_taken * player.environment.num_instances / player.loop_seconds
        print(f"[cli] benchmark: {player.steps_taken} steps x {player.environment.num_instances} environments in "
              f"{player.loop_seconds:.3f} s of loop: {rate:.1f} env-steps/s (unpaced, deterministic)")
        found = _cli(["find-trial", "--log-dir", logs], timings, "find-trial", capture=True).strip()
        if found != os.path.join(run, "ckpt", "ckpt_20.npz"):
            raise AssertionError(f"find-trial printed {found}")
        listed = _cli(["list-experiments"], timings, "list-experiments", capture=True).split()
        if not {"Velocity-Flat_ppo", "CartPole-v1_ppo", "Pendulum-v1_ppo", f"{IL_TASK}_ppo"} <= set(listed):
            raise AssertionError(f"list-experiments printed {listed}")
        print(f"[cli] find-trial: {found}; list-experiments: {' '.join(listed)}")
        for fmt in ("torch_export", "package"):
            _cli(["export", *CLI_ENTRY, "--log-dir", logs, "--checkpoint", run, "-o", os.path.join(tmp, fmt),
                  "--format", fmt, "--batch-size", str(NUM_ENVS)], timings, f"export --format {fmt}")
        if not os.path.isfile(os.path.join(tmp, "package", "policy.pkl")):
            raise AssertionError("export --format package wrote no policy.pkl")
        errors = _check_export(os.path.join(tmp, "torch_export"), os.path.join(run, "ckpt", "ckpt_20.npz"))
        check_cli_sync(tmp)
        torch.cuda.synchronize()
    print("[cli] " + json.dumps({"seconds": timings, "benchmark_env_steps_per_s": rate, "export_max_abs_err": errors}))
    return timings


# -- [ddp]: data parallelism over torch.distributed -------------------------------

DDP_RANKS = 2
DDP_ENVS = NUM_ENVS  # path A's 4,096 environments on each rank
# Every other route at its zoo entry's environments a rank, from a rollout of the path's own agent and
# environment: the recurrent (R), fused-block (TF), joint sequential (TJ), AMP, auxiliary (X, S, D),
# control (SC, PO) paths, and the host loop's update() on a Buffer (H).
DDP_ROUTES = ("R", "TF", "TJ", "AMP", "X", "SC", "PO", "S", "D", "H")
DDP_PATHS = ("A", "CM", *DDP_ROUTES)  # A: the joint evaluation (K2f/K2b); CM: the fused PPO step, mono (K9m)
DDP_RANK_ROWS = STEPS * DDP_RANKS * DDP_ENVS // MINIBATCHES // DDP_RANKS  # 24,576: a rank's slice of a minibatch
DDP_RANK_TIMEOUT = 300.0  # seconds a rank process may take, its start and CUDA's included
DDP_PROBE_TIMEOUT = 90.0
DDP_GROUP_TIMEOUT = 120.0  # the process group's own limit on a collective
_DDP_UPDATE = {"A": {"K1f": 3, "K2f": MB, "K2b": MB}, "CM": {"K1f": 3, "K9m": MB}}  # one update's launches


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _group_env(rank: int, world: int, port: int, local_rank: int = 0) -> dict:
    """torchrun's variables for ``rank`` of ``world`` on card ``local_rank``."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(local_rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def _zoo_agent_factory(path: str):
    from cusrl_tpu_torch.zoo.registry import get_experiment

    return _with_path(get_experiment("Velocity-Rough", "ppo").make_agent_factory(), path)


def _agent_state(agent) -> dict:
    """Every leaf of the agent's state by its checkpoint path, on the host."""
    import numpy as np

    from cusrl_tpu_torch.utils.interop import state_entries

    return {path: np.array(entry.read()) for path, entry in state_entries(agent).items()}


def _load_state(agent, state: dict) -> None:
    import torch

    from cusrl_tpu_torch.utils.interop import state_entries

    with torch.no_grad():
        for path, entry in state_entries(agent).items():
            entry.write(path, state[path])


def _ddp_rollout(agent, envs: int, seed: int) -> dict:
    """A ``[STEPS, envs]`` rollout at path A's shapes on the agent's device:
    observations, rewards and episode ends from ``seed``, actions drawn from
    the agent's actor."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    obs = torch.tanh(torch.randn(STEPS + 1, envs, WIDTHS[0], generator=gen))
    terminated = torch.rand(STEPS, envs, 1, generator=gen) < 0.02
    truncated = torch.rand(STEPS, envs, 1, generator=gen) < 0.01
    noise = torch.randn(STEPS, envs, agent.action_dim, generator=gen)
    reward = torch.randn(STEPS, envs, 1, generator=gen)
    device = agent.device
    with torch.no_grad():
        dist, _, _ = agent.actor(obs[:-1].to(device))
        action = dist["mean"] + dist["std"] * noise.to(device)
        logp = agent.actor.compute_logp(dist, action)
    return {"observation": obs[:-1].to(device), "next_observation": obs[1:].to(device), "action": action,
            "action_logp": logp, "action_dist": dist, "reward": reward.to(device),
            "terminated": terminated.to(device), "truncated": truncated.to(device),
            "done": (terminated | truncated).to(device)}


def _ddp_perms(envs: int):
    import torch

    units = STEPS * envs // 128  # the sampler's 128-row tiles
    return torch.stack([torch.randperm(units, generator=torch.Generator().manual_seed(100 + e)) for e in range(EPOCHS)])


def _ddp_update(agent, rollout: dict, perms, distributed_update: bool, host: bool = False):
    """One update (``cross_process_update`` with ``distributed_update``, else
    ``update_body``; with ``host`` the rollout's steps are pushed into the
    agent's ``Buffer`` and ``agent.update()`` runs, the plan fed):
    ``(metrics, the first minibatch's gradient by parameter name, launches,
    each minibatch's rows)``; the launch counters are set to 0 just before
    it."""
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from cusrl_tpu_torch.parallel import cross_process_update
    from cusrl_tpu_torch.utils.nest import map_nested

    names = {id(p): name for name, p in agent.model.named_parameters()}
    first_grads, rows = {}, []

    def keep_first(optimizer, args, kwargs):
        if not first_grads:
            first_grads.update({names[id(p)]: p.grad.detach().clone() for group in optimizer.param_groups
                                for p in group["params"] if p.grad is not None})

    train_step = agent._train_step

    def count_rows(metadata, batch, *args):
        rows.append(batch["action"].shape[:-1].numel())  # [B] rows, or [T, B] under a temporal sampler
        return train_step(metadata, batch, *args)

    if host:
        memories = {k for k in rollout if k.endswith("memory")}
        for t in range(rollout["action"].shape[0]):
            agent.buffer.push({k: map_nested(lambda x: x[t], v) for k, v in rollout.items() if k not in memories})
        agent._initial_memories = {k: map_nested(lambda x: x[0], rollout[k]) for k in memories}
        update_body = agent.update_body
        agent.update_body = lambda r, **kw: update_body(r, **{**kw, "epoch_perms": perms})
    agent._train_step = count_rows
    handle = register_optimizer_step_pre_hook(keep_first)
    _reset_launch_counts()
    try:
        if host:
            metrics = agent.update()
        elif distributed_update:
            metrics = cross_process_update(agent, rollout, epoch_perms=perms)
        else:
            metrics = {k: float(v) for k, v in agent.update_body(rollout, epoch_perms=perms).items()}
    finally:
        handle.remove()
        del agent._train_step
        agent.__dict__.pop("update_body", None)
    launches = {k: v for k, v in _launch_counts().items() if v}
    return metrics, {k: v.cpu() for k, v in first_grads.items()}, launches, rows


def _ddp_factory(path: str, expert_path: str | None = None):
    """Path ``path``'s training factory as ``[train-zoo]`` builds it, its
    environments a rank (the zoo entry's) and its rollout steps (SC at 24,
    before its capacity schedule).  TF, TJ and PO update at lr 1e-4, as their
    ``[update-check]`` does."""
    from cusrl_tpu_torch.zoo.registry import get_experiment

    if path == "H":
        return _h_factory("training"), H_ENVS, H_STEPS
    if path in ("TF", "TJ"):
        factory, envs = get_experiment("Velocity-Flat", "transformer_ppo").to_training_factory(), T_ENVS
        factory.agent.fuse_actor_critic_evaluation = path == "TJ"
        factory.agent.lr = 1e-4
    elif path == "R":
        factory, envs = get_experiment("Velocity-Flat", "recurrent_ppo").to_training_factory(), T_ENVS
    elif path == "AMP":
        factory, envs = get_experiment("Velocity-Flat", "amp").to_training_factory(), T_ENVS
    else:
        factory, envs = get_experiment("Velocity-Rough", "ppo").to_training_factory(), NUM_ENVS
        if path in CONTROL_PATHS:
            factory.agent.lr = 1e-4 if path == "PO" else factory.agent.lr
            factory.agent = _control_factory(path, factory.agent)
        else:
            factory.agent = _aux_factory(path, factory.agent, expert_path)
    return factory, envs, factory.agent.num_steps_per_update


def _ddp_environment(factory, envs: int, seed: int = SEED):
    return factory.environment_factory(**{**factory.environment_kwargs, "num_instances": envs}, seed=seed)


def _ddp_collect(agent, env, steps: int) -> dict:
    """Two rollouts of ``agent`` on ``env`` (a tensor environment through
    ``RolloutDriver``, a host one through ``act``/``step``); returns the
    second, its memories warm, with every hook's rollout fields."""
    import torch

    from cusrl_tpu_torch.template.environment import TensorEnvironment, get_done_indices, update_observation_and_state
    from cusrl_tpu_torch.template.rollout import RolloutDriver

    if isinstance(env, TensorEnvironment):
        driver = RolloutDriver(agent, env)
        driver.collect(steps)
        return driver.collect(steps)[0]
    observation, _, _ = env.reset()
    for _ in range(2):
        for _ in range(steps):
            action = agent.act(observation)
            next_observation, _, reward, terminated, truncated, _ = env.step(action)
            agent.step(next_observation, reward, terminated, truncated)
            done = get_done_indices(terminated, truncated)
            if done.size:
                new, _, _ = env.reset(indices=done)
                next_observation, _ = update_observation_and_state(next_observation, None, new, None, done)
            observation = next_observation
        rollout, _ = agent.take_buffered_rollout()
    return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in rollout.items()}


def _ddp_route_inputs(path: str, world: int, workdir: Path, expert_path: str | None):
    """Path ``path``'s inputs for the ranks (written to ``<path>.pt``: the
    state after this process's rollout of ``world`` ranks' environments,
    that rollout, the plan and AMP's subsample draws) and this process's
    update of the whole rollout: ``(oracle, seconds)``."""
    import torch

    from cusrl_tpu_torch.utils.nest import map_nested

    factory, envs, steps = _ddp_factory(path, expert_path)
    env = _ddp_environment(factory, world * envs)
    agent = factory.agent(env.spec, seed=SEED)
    rollout = _ddp_collect(agent, env, steps)
    state = _agent_state(agent)
    plan = agent.sampler.resolve(rollout).make_epoch_plan(steps, world * envs,
                                                          torch.Generator().manual_seed(SEED + 3), "cpu")
    perms = [p.perms for p in plan] if isinstance(plan, list) else plan.perms
    draws = []
    if path == "AMP":  # one subsample of each global minibatch's rows, the same on every rank
        hook = agent.get_hook(AMP_HOOK)
        gen = torch.Generator().manual_seed(SEED + 4)
        draws = [torch.randint(0, world * envs * steps // AMP_MINIBATCHES, (hook.batch_size,), generator=gen)
                 for _ in range(AMP_MB)]
        hook.queue_draws(subsample=draws)
    torch.cuda.synchronize()
    start = time.perf_counter()
    oracle = _ddp_update(agent, rollout, perms, distributed_update=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    torch.save({"state": state, "rollout": map_nested(lambda x: x.cpu(), rollout), "perms": perms, "draws": draws,
                "expert_path": expert_path}, workdir / f"{path}.pt")
    return oracle, seconds


def _ddp_route_rank(path: str, workdir: Path, rank: int, world: int) -> dict:
    """One rank's update of path ``path`` on its environments' part of the
    rollout (``_ddp_route_inputs``): every rank loads the state, its own
    environments' rows of each per-environment entry (the memories, the
    episode flags)."""
    import numpy as np
    import torch

    from cusrl_tpu_torch.parallel import distribute_agent
    from cusrl_tpu_torch.utils import distributed
    from cusrl_tpu_torch.utils.interop import state_entries
    from cusrl_tpu_torch.utils.nest import map_nested

    inputs = torch.load(workdir / f"{path}.pt", weights_only=False)
    factory, envs, _ = _ddp_factory(path, inputs["expert_path"])
    agent = factory.agent(_ddp_environment(factory, envs, SEED + rank).spec, seed=SEED + 100 + rank)
    distribute_agent(agent)
    rows = np.arange(rank * envs, (rank + 1) * envs)
    per_env = []
    with torch.no_grad():
        for key, entry in state_entries(agent).items():
            value = inputs["state"][key]
            if tuple(value.shape) != tuple(entry.shape):
                value = np.take(value, rows, axis=[a != b for a, b in zip(value.shape, entry.shape)].index(True))
                per_env.append(key)
            entry.write(key, value)
    if inputs["draws"]:
        agent.get_hook(AMP_HOOK).queue_draws(subsample=inputs["draws"])
    rollout = map_nested(lambda x: x[:, rank * envs:(rank + 1) * envs].to(agent.device), inputs["rollout"])
    distributed.reset_collective_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    metrics, grads, launches, batch_rows = _ddp_update(agent, rollout, inputs["perms"], distributed_update=True,
                                                       host=path == "H")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    collectives = {k: tuple(v) for k, v in distributed.COLLECTIVES.items()}
    state = {k: v for k, v in _agent_state(agent).items() if k not in per_env}
    return {"metrics": metrics, "grads": grads, "launches": launches, "rows": batch_rows, "seconds": seconds,
            "state": state, "collectives": collectives, "per_env": len(per_env)}


def _states_differ(a: dict, b: dict) -> list[str]:
    import numpy as np

    if set(a) != set(b):
        return sorted(set(a) ^ set(b))
    return [path for path in sorted(a) if a[path].shape != b[path].shape or not np.array_equal(a[path], b[path])]


def check_ddp_world1(kind: str) -> dict:
    """``[ddp] A1``: a NCCL group of one in this process.  One update of
    path A (the zoo's Velocity-Rough ``ppo``, 4,096 environments x 24 steps)
    through ``distribute_agent`` / ``cross_process_update`` against the same
    update without a process group, from the same state, rollout and
    permutations: metrics and every leaf of the agent's state bit for bit
    (the collectives run, each the identity).  Then path A through the
    Trainer, undistributed and distributed, a warm-up and a timed chunk of
    10 iterations each: launches, one host transfer a chunk (sync debug
    mode), env-steps/s, and the distributed chunk's collectives (calls and
    bytes an iteration)."""
    import torch
    import torch.distributed as dist

    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.parallel import distribute_agent
    from cusrl_tpu_torch.utils import distributed
    from cusrl_tpu_torch.utils.config import configure_distributed
    from cusrl_tpu_torch.zoo.registry import get_experiment

    variables = _group_env(0, 1, _free_port())
    os.environ.update(variables)
    try:
        if not configure_distributed(timeout_s=DDP_GROUP_TIMEOUT) or dist.get_backend() != "nccl":
            raise AssertionError("[ddp] A1: no NCCL group of one")
        print(f"[ddp] A1: {dist.get_backend()} group of {dist.get_world_size()}, rank {dist.get_rank()} on "
              f"cuda:{torch.cuda.current_device()}")
        factory = _zoo_agent_factory("A")
        env = VelocityLocomotionEnv(num_instances=NUM_ENVS)  # the card
        plain = factory(env.spec, seed=SEED)
        state = _agent_state(plain)
        rollout, perms = _ddp_rollout(plain, NUM_ENVS, SEED + 7), _ddp_perms(NUM_ENVS)
        want = _ddp_update(plain, rollout, perms, distributed_update=False)
        agent = factory(env.spec, seed=SEED + 1)
        _load_state(agent, state)
        distribute_agent(agent)
        distributed.reset_collective_counts()
        got = _ddp_update(agent, rollout, perms, distributed_update=True)
        collectives = {k: tuple(v) for k, v in distributed.COLLECTIVES.items()}
        differ = [k for k in want[0] if got[0].get(k) != want[0][k]] + _states_differ(_agent_state(agent),
                                                                                      _agent_state(plain))
        differ += [f"grad {k}" for k in want[1] if not torch.equal(got[1][k], want[1][k])]
        print(f"[ddp] A1: one update, distributed against plain: {len(want[0])} metrics, {len(state)} state "
              f"leaves, {len(want[1])} first-minibatch gradient leaves; launches {got[2]} (plain {want[2]}); "
              f"collectives {collectives}; {'bit for bit' if not differ else 'DIFFER: ' + ', '.join(differ[:8])}")
        if differ or got[2] != want[2] or want[2] != _DDP_UPDATE["A"] or not collectives["all_reduce"][0]:
            raise AssertionError("[ddp] A1: the distributed update is not the plain one bit for bit")
        rates, chunk_launches = {}, None
        for distribute in (False, True):
            trainer_factory = get_experiment("Velocity-Rough", "ppo").to_training_factory()
            chunk = trainer_factory.iterations_per_dispatch
            trainer_factory.num_iterations = 2 * chunk
            # The undistributed chunk's profile is [train-zoo] A's; here the distributed one's.
            launches, rates[distribute] = _train_chunks(kind, "A", trainer_factory, NUM_ENVS, chunk,
                                                        distribute=distribute, profile=distribute)
            chunk_launches = launches if distribute else chunk_launches
        print(f"[ddp] A1: path A through the Trainer: {rates[True]:.1f} env-steps/s distributed over the group of "
              f"one, {rates[False]:.1f} undistributed, on {kind}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for name in variables:
            os.environ.pop(name, None)
    return {"launches": chunk_launches, "env_steps_per_s": rates[True], "undistributed_env_steps_per_s": rates[False]}


def _run_ranks(args: list[str], world: int, timeout: float, workdir: Path, tag: str,
               spread: bool = False) -> tuple[list, list[str]]:
    """``python3 chip_smoke.py *args`` as ``world`` rank processes, all on
    card 0 or (``spread``) each on its own card; waits for all of them, kills
    every one that is left once one fails or ``timeout`` passes.  Returns
    their exit codes (None: killed) and the end of each one's output."""
    return _wait_ranks(*_start_ranks(args, world, workdir, tag, spread), timeout)


def _start_ranks(args: list[str], world: int, workdir: Path, tag: str, spread: bool = False):
    """``_run_ranks``'s start: the processes and their logs."""
    port = _free_port()
    logs = [workdir / f"{tag}{rank}.log" for rank in range(world)]
    procs = []
    for rank in range(world):
        with open(logs[rank], "w") as log:
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *args],
                                          env={**os.environ, **_group_env(rank, world, port, rank * spread)},
                                          stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
    return procs, logs


def _wait_ranks(procs, logs, timeout: float) -> tuple[list, list[str]]:
    """``_run_ranks``'s wait, from now."""
    deadline = time.perf_counter() + timeout
    try:
        while any(p.poll() is None for p in procs) and time.perf_counter() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode if p.returncode >= 0 else None for p in procs]
    return codes, [log.read_text()[-2000:] for log in logs]


def ddp_probe() -> int:
    """One rank of the NCCL probe: the group and one all-reduce on the card."""
    import torch
    import torch.distributed as dist

    from cusrl_tpu_torch.utils.config import configure_distributed

    configure_distributed(backend="nccl", timeout_s=DDP_PROBE_TIMEOUT / 2)
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    ok = x.tolist() == [float(dist.get_world_size())] * 4
    dist.destroy_process_group()
    return 0 if ok else 1


def ddp_rank(workdir: str, backend: str) -> int:
    """One rank of ``[ddp] A2``: rank 0 loads the state, ``distribute_agent``
    broadcasts it, and each path's update runs on the rank's own 4,096
    environments; the results go to ``rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.parallel import distribute_agent
    from cusrl_tpu_torch.utils.config import configure_distributed
    from cusrl_tpu_torch.utils.nest import map_nested

    from cusrl_tpu_torch.utils import distributed

    configure_distributed(backend=backend, timeout_s=DDP_GROUP_TIMEOUT)
    rank = dist.get_rank()
    inputs = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    out = {}
    for path in DDP_PATHS:
        if path in DDP_ROUTES:
            out[path] = _ddp_route_rank(path, Path(workdir), rank, dist.get_world_size())
            continue
        with _ppo_mode("mono" if path == "CM" else "split"):
            env = VelocityLocomotionEnv(num_instances=DDP_ENVS)
            agent = _zoo_agent_factory(path)(env.spec, seed=SEED + 100 + rank)  # the broadcast replaces these
            if rank == 0:
                _load_state(agent, inputs[path]["state"])
            distribute_agent(agent)
            rollout = map_nested(lambda x: x[:, rank * DDP_ENVS:(rank + 1) * DDP_ENVS].to(agent.device),
                                 inputs[path]["rollout"])
            distributed.reset_collective_counts()
            start = time.perf_counter()
            metrics, grads, launches, rows = _ddp_update(agent, rollout, inputs[path]["perms"], distributed_update=True)
            seconds = time.perf_counter() - start
        out[path] = {"metrics": metrics, "grads": grads, "launches": launches, "rows": rows, "seconds": seconds,
                     "state": _agent_state(agent), "per_env": 0,
                     "collectives": {k: tuple(v) for k, v in distributed.COLLECTIVES.items()}}
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def check_ddp_ranks(kind: str, world: int = DDP_RANKS, spread: bool = False) -> dict:
    """``[ddp] A2``: ``world`` rank processes on this one card (or, with
    ``spread``, ``[ddp] cards``: each on its own card over NCCL), each with
    path A's 4,096 environments, take one update of path A and then one of
    path CM (the fused PPO step, mono mode: K9m) on their own rollouts, the
    permutations fed; held against this process's single update of all
    ranks' environments side by side, at ``[update-check]``'s limits
    (metrics and every leaf of the first minibatch's gradient), the ranks
    bit for bit equal, and each rank's K2f/K2b (A) or K9m (CM) launched on
    24,576-row slices.  On one card, first a NCCL probe: where NCCL refuses
    two ranks on one card, gloo moves the CUDA tensors through the host."""
    import shutil
    import tempfile

    import torch

    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.utils.nest import map_nested

    label = f"[ddp] {world} cards" if spread else "[ddp] A2"
    workdir = Path(tempfile.mkdtemp(prefix="ddp_"))
    try:
        envs = world * DDP_ENVS
        inputs, oracle, oracle_seconds = {}, {}, {}
        # Path D's expert: a fresh path-A agent, exported where the ranks read it.
        expert_path = _export_expert(_path_a_agent(), str(workdir / "expert"))
        for path in DDP_PATHS:
            if path in DDP_ROUTES:
                oracle[path], oracle_seconds[path] = _ddp_route_inputs(path, world, workdir, expert_path)
                print(f"{label}: {path} on one process of {world} ranks' environments: {oracle_seconds[path]:.3f} s "
                      f"for the update, launches {oracle[path][2]}")
                continue
            with _ppo_mode("mono" if path == "CM" else "split"):
                agent = _zoo_agent_factory(path)(VelocityLocomotionEnv(num_instances=DDP_ENVS).spec, seed=SEED)
                state = _agent_state(agent)
                rollout, perms = _ddp_rollout(agent, envs, SEED + 11), _ddp_perms(envs)
                start = time.perf_counter()
                oracle[path] = _ddp_update(agent, rollout, perms, distributed_update=False)
                torch.cuda.synchronize()
                oracle_seconds[path] = time.perf_counter() - start
                print(f"{label}: {path} on one process of {envs} environments: {oracle_seconds[path]:.3f} s, "
                      f"launches {oracle[path][2]}")
            inputs[path] = {"state": state, "rollout": map_nested(lambda x: x.cpu(), rollout), "perms": perms}
        torch.save(inputs, workdir / "inputs.pt")

        backend = "nccl"
        if not spread:
            start = time.perf_counter()
            codes, logs = _run_ranks(["--ddp-probe"], world, DDP_PROBE_TIMEOUT, workdir, "probe")
            if codes == [0] * world:
                print(f"{label}: NCCL accepts {world} ranks on one card ({time.perf_counter() - start:.1f} s): "
                      "the ranks run over NCCL")
            else:
                backend = "gloo"
                lines = [line.strip() for log in logs for line in log.splitlines()]
                reason = next((line for line in lines if "Duplicate GPU" in line or "ncclInvalidUsage" in line),
                              next((line for line in reversed(lines) if "Error" in line), "no error line"))
                print(f"{label}: NCCL refuses {world} ranks on one card (exit codes {codes}, "
                      f"{time.perf_counter() - start:.1f} s): {reason[:300]}; the ranks run over gloo")
        start = time.perf_counter()
        codes, logs = _run_ranks(["--ddp-rank", str(workdir), backend], world, DDP_RANK_TIMEOUT, workdir, "rank",
                                 spread=spread)
        elapsed = time.perf_counter() - start
        if codes != [0] * world:
            raise AssertionError(f"{label}: rank exit codes {codes} (None: killed at {DDP_RANK_TIMEOUT:g} s or "
                                 "after another rank failed):\n" + "\n".join(logs))
        ranks = [torch.load(workdir / f"rank{rank}.pt", weights_only=False) for rank in range(world)]
        print(f"{label}: {world} ranks over {backend}, {elapsed:.1f} s for the processes, start to exit")
        failures = []
        for path in DDP_PATHS:
            first = ranks[0][path]
            for rank, result in enumerate(ranks[1:], 1):
                differ = [k for k in first["metrics"] if result[path]["metrics"][k] != first["metrics"][k]]
                differ += _states_differ(result[path]["state"], first["state"])
                differ += [f"grad {k}" for k in first["grads"] if not torch.equal(result[path]["grads"][k],
                                                                                  first["grads"][k])]
                if differ:
                    failures.append(f"{path}: rank {rank} differs from rank 0 in {differ[:8]}")
            for rank, result in enumerate(ranks):
                r = result[path]
                print(f"{label}: {path} rank {rank}: launches {r['launches']}, minibatch rows "
                      f"{sorted(set(r['rows']))} x {len(r['rows'])}, collectives (calls, bytes) {r['collectives']}, "
                      f"{r['per_env']} per-environment state leaves its own, update {r['seconds']:.3f} s "
                      f"(one process {oracle_seconds[path]:.3f} s)")
                if path in DDP_ROUTES:
                    # Each kernel of one process's update launches on the rank too, on its slice.
                    ok = set(r["launches"]) == set(oracle[path][2]) and len(r["rows"]) == len(oracle[path][3])
                    ok = ok and all(world * n == m for n, m in zip(r["rows"], oracle[path][3]))
                else:
                    ok = r["launches"] == _DDP_UPDATE[path] and set(r["rows"]) == {DDP_RANK_ROWS} and len(
                        r["rows"]) == MB
                if not ok:
                    failures.append(f"{path}: rank {rank} launched {r['launches']} on rows {sorted(set(r['rows']))}")
            print(f"{label}: {path}, rank 0 against one process of {world} ranks' environments:")
            failed = update_check_failures(*oracle[path][:2], first["metrics"], first["grads"], report=True)
            failures += [f"{path}: {key}" for key in failed]
        if failures:
            raise AssertionError(f"{label} failed: " + "; ".join(failures))
        print(f"{label}: the ranks bit for bit equal; rank 0 within [update-check]'s limits of the single process "
              f"(rtol {UPDATE_RTOL:g}, atol {UPDATE_ATOL:g}; gradient leaves {GRAD_RTOL:g}) on {kind}")
        return {"backend": backend, "rank_launches": {p: ranks[0][p]["launches"] for p in DDP_PATHS},
                "seconds": elapsed, "rank_seconds": {p: ranks[0][p]["seconds"] for p in DDP_PATHS},
                "one_process_seconds": oracle_seconds}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# -- [tp]: tensor parallelism and the hierarchical mesh ----------------------------

# (case, world, model axis, dcn axis, path, environments a data rank).  A at 1 x 2 and 2 x 2 takes 4,096
# environments a data rank; on dcn=2 x data=2 each of the four data ranks takes 2,048, so 2 x 2 and the
# hierarchical mesh join the same 8,192 environments.
TP_CASES = (
    ("A 1x2", 2, 2, 1, "A", NUM_ENVS),
    ("TF 1x2", 2, 2, 1, "TF", T_ENVS),
    ("AMP 1x2", 2, 2, 1, "AMP", T_ENVS),
    ("A 2x2", 4, 2, 1, "A", NUM_ENVS),
    ("A dcn2x2", 4, 1, 2, "A", NUM_ENVS // 2),
)
TP_TRAINER_ITERATIONS = 3  # [tp] A 1x2 through the Trainer: one warm-up iteration, then a chunk of 3
TP_RANK_TIMEOUT = 420.0  # seconds a rank process may take, its start and CUDA's included
MLP_CHAIN_KERNELS = ("K1f", "K1b", "K2f", "K2b", "K8f", "K8b", "K9s", "K9m")
TP_WARNING = "disables the fused MLP chain kernels"


def _tp_inputs(workdir: Path, cases) -> tuple[dict, dict]:
    """This process's one-process updates of the ``[tp]`` cases' joined
    rollout (path A at 4,096 and 8,192 environments; TF and AMP from
    ``_ddp_route_inputs`` at their entries' 1,024), with the inputs the ranks
    read: ``({case: oracle}, {case: seconds})``."""
    import torch

    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.utils.nest import map_nested

    oracle, seconds, inputs = {}, {}, {}
    for name, world, model, dcn, path, envs in cases:
        total = world // model * envs
        if path != "A":
            oracle[name], seconds[name] = _ddp_route_inputs(path, world // model, workdir, None)
            continue
        if total not in inputs:
            # Built at the joined environments: a rank takes its rows of each per-environment leaf.
            agent = _zoo_agent_factory("A")(VelocityLocomotionEnv(num_instances=total).spec, seed=SEED)
            state = _agent_state(agent)
            rollout, perms = _ddp_rollout(agent, total, SEED + 13), _ddp_perms(total)
            torch.cuda.synchronize()
            start = time.perf_counter()
            inputs[total] = {"state": state, "rollout": map_nested(lambda x: x.cpu(), rollout), "perms": perms,
                             "oracle": _ddp_update(agent, rollout, perms, distributed_update=False)}
            torch.cuda.synchronize()
            inputs[total]["seconds"] = time.perf_counter() - start
        oracle[name], seconds[name] = inputs[total]["oracle"], inputs[total]["seconds"]
    torch.save({total: {k: v for k, v in case.items() if k not in ("oracle", "seconds")}
                for total, case in inputs.items()}, workdir / "A.pt")
    return oracle, seconds


def _tp_update(path: str, mesh, envs: int, workdir: Path) -> dict:
    """One rank's update of a ``[tp]`` case of path ``path`` on ``mesh``: the agent
    distributed (``tensor_parallel=True``), the state written (each rank its
    part of a sharded leaf), its data rank's environments' part of the
    rollout, the plan (and AMP's draws) fed.  Returns the metrics, the first
    minibatch's gradient (shards gathered), the launches, each minibatch's
    rows, the collectives by axis and the state (shards gathered)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cusrl_tpu_torch.environment.locomotion import VelocityLocomotionEnv
    from cusrl_tpu_torch.parallel import distribute_agent
    from cusrl_tpu_torch.parallel.tensor import shard_of
    from cusrl_tpu_torch.utils import distributed
    from cusrl_tpu_torch.utils.interop import state_entries
    from cusrl_tpu_torch.utils.nest import map_nested

    model = mesh.shape["model"] if hasattr(mesh, "shape") else 1
    data_rank = dist.get_rank() // model
    if path == "A":
        inputs = torch.load(workdir / "A.pt", weights_only=False)[envs * dist.get_world_size() // model]
        agent = _zoo_agent_factory("A")(VelocityLocomotionEnv(num_instances=envs).spec, seed=SEED + 100)
        draws = []
    else:
        inputs = torch.load(workdir / f"{path}.pt", weights_only=False)
        factory, _, _ = _ddp_factory(path)
        agent = factory.agent(_ddp_environment(factory, envs, SEED + data_rank).spec, seed=SEED + 100)
        draws = inputs["draws"]
    distribute_agent(agent, mesh, tensor_parallel=True)
    rows = np.arange(data_rank * envs, (data_rank + 1) * envs)
    per_env = []
    with torch.no_grad():
        for key, entry in state_entries(agent).items():
            value = inputs["state"][key]
            if tuple(value.shape) != tuple(entry.shape):
                value = np.take(value, rows, axis=[a != b for a, b in zip(value.shape, entry.shape)].index(True))
                per_env.append(key)
            entry.write(key, value)
    if draws:
        agent.get_hook(AMP_HOOK).queue_draws(subsample=draws)
    rollout = map_nested(lambda x: x[:, data_rank * envs:(data_rank + 1) * envs].to(agent.device), inputs["rollout"])
    distributed.reset_collective_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    metrics, grads, launches, batch_rows = _ddp_update(agent, rollout, inputs["perms"], distributed_update=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    collectives = {axis: {k: tuple(v) for k, v in kinds.items()}
                   for axis, kinds in distributed.COLLECTIVES_BY_AXIS.items()}
    params = dict(agent.model.named_parameters())
    sharded = sorted(k for k, p in params.items() if shard_of(p) is not None)
    for key in sharded:
        if key in grads:
            grads[key] = shard_of(params[key]).gather(grads[key].to(agent.device)).cpu()
    state = {k: v for k, v in _agent_state(agent).items() if k not in per_env}
    return {"metrics": metrics, "grads": grads, "launches": launches, "rows": batch_rows, "seconds": seconds,
            "collectives": collectives, "state": state, "sharded": sharded, "per_env": len(per_env)}


def _tp_trainer(mesh) -> dict:
    """``[tp] A 1x2`` through ``Trainer.rollout_and_update``: path A's zoo
    entry (4,096 environments) built with ``CONFIG.model_parallel_size`` set,
    so both model peers seed as data rank 0 and step the same environments;
    one warm-up iteration, then a timed chunk of ``TP_TRAINER_ITERATIONS``
    with the launch counters set to 0 just before.  Returns the launches,
    env-steps/s, the last observations and the state (shards gathered)."""
    import torch

    from cusrl_tpu_torch.parallel import distribute_agent
    from cusrl_tpu_torch.utils.config import CONFIG
    from cusrl_tpu_torch.zoo.registry import get_experiment

    CONFIG.model_parallel_size = mesh.shape["model"]
    try:
        factory = get_experiment("Velocity-Rough", "ppo").to_training_factory()
        factory.iterations_per_dispatch = 1
        trainer = factory(verbose=False)
        seed = trainer.agent.init_generator.initial_seed()
        distribute_agent(trainer.agent, mesh, tensor_parallel=True)
        trainer.rollout_and_update()
        trainer.iterations_per_dispatch = TP_TRAINER_ITERATIONS
        torch.cuda.synchronize()
        _reset_launch_counts()
        start = time.perf_counter()
        rows = [trainer.rollout_and_update() for _ in range(TP_TRAINER_ITERATIONS)]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        launches = {k: v for k, v in _launch_counts().items() if v}
        if not all(math.isfinite(v) for row in rows for v in row.values()):
            raise AssertionError(f"[tp] A 1x2 Trainer: non-finite metrics {rows}")
        return {"launches": launches, "seed": seed, "host_transfers": trainer.host_transfers,
                "env_steps_per_s": TP_TRAINER_ITERATIONS * STEPS * trainer.environment.num_instances / elapsed,
                "observation": trainer.driver._observation.cpu(), "state": _agent_state(trainer.agent)}
    finally:
        CONFIG.model_parallel_size = 1


def tp_rank(workdir: str, backend: str) -> int:
    """One rank of ``[tp]``: every case of this world size on its mesh (the
    groups made once a case, in the same order on every rank), and at world
    2 the Trainer; the results go to ``tp<W>_rank<r>.pt``."""
    import warnings

    import torch
    import torch.distributed as dist

    from cusrl_tpu_torch.parallel import get_mesh
    from cusrl_tpu_torch.utils.config import configure_distributed

    configure_distributed(backend=backend, timeout_s=DDP_GROUP_TIMEOUT)
    world, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for name, case_world, model, dcn, path, envs in TP_CASES:
            if case_world == world:
                out[name] = _tp_update(path, get_mesh(model, dcn_parallel_size=dcn), envs, Path(workdir))
        if world == 2:
            out["A 1x2 Trainer"] = _tp_trainer(get_mesh(2))
    out["warnings"] = [str(w.message) for w in caught if TP_WARNING in str(w.message)]
    torch.save(out, Path(workdir) / f"tp{world}_rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def _probe_backend(label: str, world: int, workdir: Path) -> str:
    """NCCL if it takes ``world`` ranks on this one card (``--ddp-probe``),
    else gloo, which moves CUDA tensors through the host."""
    start = time.perf_counter()
    codes, logs = _run_ranks(["--ddp-probe"], world, DDP_PROBE_TIMEOUT, workdir, "probe")
    if codes == [0] * world:
        print(f"{label}: NCCL accepts {world} ranks on one card ({time.perf_counter() - start:.1f} s): "
              "the ranks run over NCCL")
        return "nccl"
    lines = [line.strip() for log in logs for line in log.splitlines()]
    reason = next((line for line in lines if "Duplicate GPU" in line or "ncclInvalidUsage" in line),
                  next((line for line in reversed(lines) if "Error" in line), "no error line"))
    print(f"{label}: NCCL refuses {world} ranks on one card (exit codes {codes}, "
          f"{time.perf_counter() - start:.1f} s): {reason[:300]}; the ranks run over gloo")
    return "gloo"


def check_tp(kind: str, spread: bool = False) -> dict:
    """``[tp]``: tensor parallelism and the hierarchical mesh on rank
    processes of this one card (``spread``, ``--tp-cards``: the four-rank
    cases with one NCCL rank a card), every case against this process's
    one-process update of its joined rollout at ``[update-check]``'s limits
    (metrics and every leaf of the first minibatch's gradient, the shards
    gathered), every rank's state (shards gathered) bit for bit equal; 0
    MLP chain kernel launches on the sharded chains and the one-process
    counts of the kernels that keep whole weights (TF's fused block and
    attention kernels); the pure data-parallel hierarchical mesh A2's counts;
    the warning once a rank; the collectives' calls and bytes a minibatch by
    axis; path A through the Trainer (env-steps/s beside ``[train-zoo]
    A``'s, no claim).  A rank that fails or outlives its time fails the
    run."""
    import shutil

    import torch

    label = "[tp] cards" if spread else "[tp]"
    cases = [c for c in TP_CASES if not spread or c[1] == 4]
    workdir = Path(tempfile.mkdtemp(prefix="tp_"))
    try:
        start = time.perf_counter()
        oracle, oracle_seconds = _tp_inputs(workdir, cases)
        print(f"{label}: one-process updates of the joined rollouts, {time.perf_counter() - start:.1f} s: " + ", ".join(
            f"{name} {oracle_seconds[name]:.3f} s, launches {oracle[name][2]}" for name, *_ in cases))
        worlds = sorted({c[1] for c in cases})
        backend = "nccl" if spread else _probe_backend(label, 2, workdir)
        start = time.perf_counter()
        runs = {world: _start_ranks(["--tp-rank", str(workdir), backend], world, workdir, f"tp{world}_",
                                    spread=spread) for world in worlds}
        results = {world: _wait_ranks(*run, TP_RANK_TIMEOUT) for world, run in runs.items()}
        elapsed = time.perf_counter() - start
        for world, (codes, logs) in results.items():
            if codes != [0] * world:
                raise AssertionError(f"{label}: world {world} rank exit codes {codes} (None: killed at "
                                     f"{TP_RANK_TIMEOUT:g} s or after another rank failed):\n" + "\n".join(logs))
        ranks = {world: [torch.load(workdir / f"tp{world}_rank{r}.pt", weights_only=False) for r in range(world)]
                 for world in worlds}
        print(f"{label}: {' and '.join(f'{w} ranks' for w in worlds)} over {backend} side by side, {elapsed:.1f} s "
              "for the processes, start to exit")
        failures = []
        for world in worlds:
            for rank, result in enumerate(ranks[world]):
                warned = result["warnings"]
                print(f"{label}: world {world} rank {rank}: the tensor-parallel warning {len(warned)} time(s)"
                      + (f": {warned[0]}" if warned else ""))
                if len(warned) != 1:
                    failures.append(f"world {world} rank {rank}: warned {len(warned)} times")
        fields = {}
        for name, world, model, dcn, path, envs in cases:
            first = ranks[world][0][name]
            for rank, result in enumerate(ranks[world][1:], 1):
                r = result[name]
                differ = [k for k in first["metrics"] if r["metrics"][k] != first["metrics"][k]]
                differ += _states_differ(r["state"], first["state"])
                differ += [f"grad {k}" for k in first["grads"] if not torch.equal(r["grads"][k], first["grads"][k])]
                if differ:
                    failures.append(f"{name}: rank {rank} differs from rank 0 in {differ[:8]}")
            want = oracle[name][2]
            if model > 1:  # every Mlp sharded: no chain kernel; the kernels with whole weights as one process
                expected = {k: v for k, v in want.items() if k not in MLP_CHAIN_KERNELS}
            else:  # the hierarchical mesh is data parallelism: A2's counts on a rank's slices
                expected = _DDP_UPDATE["A"]
            per_mb = {axis: {kind: (n / len(first["rows"]), b / len(first["rows"])) for kind, (n, b) in kinds.items()}
                      for axis, kinds in first["collectives"].items()}
            print(f"{label}: {name} (world {world}: dcn {dcn} x data {world // model // dcn} x model {model}), "
                  f"{envs} environments a data rank: rank 0 launches {first['launches']} (one process {want}; "
                  f"expected {expected}), {len(first['sharded'])} sharded leaves, minibatch rows "
                  f"{sorted(set(first['rows']))} x {len(first['rows'])}, update {first['seconds']:.3f} s (one process "
                  f"{oracle_seconds[name]:.3f} s); collectives a minibatch (calls, bytes) by axis: " + "; ".join(
                      f"{axis} " + ", ".join(f"{kind} {n:g}, {b:,.0f}" for kind, (n, b) in kinds.items())
                      for axis, kinds in sorted(per_mb.items())))
            for rank, result in enumerate(ranks[world]):
                if result[name]["launches"] != expected:
                    failures.append(f"{name}: rank {rank} launched {result[name]['launches']}, expected {expected}")
            if (model > 1) != bool(first["sharded"]) or (model > 1 and "model" not in first["collectives"]):
                failures.append(f"{name}: {len(first['sharded'])} sharded leaves, collectives {first['collectives']}")
            print(f"{label}: {name}, rank 0 against one process of the joined rollout:")
            failed = update_check_failures(*oracle[name][:2], first["metrics"], first["grads"], report=True)
            failures += [f"{name}: {key}" for key in failed]
            fields[name] = {"launches": first["launches"], "seconds": first["seconds"], "collectives": per_mb}
        if 2 in ranks:
            first, second = (result["A 1x2 Trainer"] for result in ranks[2])
            differ = _states_differ(first["state"], second["state"])
            same_obs = torch.equal(first["observation"], second["observation"])
            chain = {k: v for k, v in first["launches"].items() if k in MLP_CHAIN_KERNELS}
            zoo = ZOO_RATES.get("A")
            print(f"{label}: A 1x2 through the Trainer: {first['env_steps_per_s']:.1f} env-steps/s over a "
                  f"{TP_TRAINER_ITERATIONS}-iteration chunk after a warm-up iteration (rank 1 "
                  f"{second['env_steps_per_s']:.1f}; [train-zoo] A "
                  f"{'not run in this call' if zoo is None else f'{zoo:.1f}'}; the ranks over {backend}, no claim); "
                  f"launches {first['launches']}; seeds {first['seed']}, {second['seed']}; the model peers' last "
                  f"observations {'bit for bit equal' if same_obs else 'DIFFER'}; state "
                  f"{'bit for bit equal' if not differ else 'DIFFERS: ' + ', '.join(differ[:8])}")
            if differ or not same_obs or chain or first["seed"] != second["seed"]:
                failures.append("A 1x2 Trainer: the model peers part or a chain kernel ran")
            fields["A 1x2 Trainer"] = {"env_steps_per_s": first["env_steps_per_s"], "launches": first["launches"]}
        if failures:
            raise AssertionError(f"{label} failed: " + "; ".join(failures))
        print(f"{label}: every case within [update-check]'s limits of its one process (rtol {UPDATE_RTOL:g}, atol "
              f"{UPDATE_ATOL:g}; gradient leaves {GRAD_RTOL:g}), the ranks bit for bit equal, on {kind}")
        return {"backend": backend, "cases": fields, "seconds": elapsed}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


MODULE_ROWS = 4096  # [modules]: the Cnn's images
MODULE_RTOL = 2e-2  # max |card - cpu| / max |cpu|: outputs and each gradient leaf (bf16 roundings that fall apart)


def _module_case(name: str, cpu_module, inputs: list, device, launches: dict | None = None) -> dict:
    """Forward and backward of ``cpu_module`` on the CPU and of its copy on
    the card, the same inputs: the output and every gradient (parameters
    and the inputs') within ``MODULE_RTOL`` of the CPU's largest element;
    the card's kernel launches of one call are ``launches`` when given;
    the device ms of one forward and backward."""
    import copy

    import torch

    card_module = copy.deepcopy(cpu_module).to(device)
    target = None

    def run(module, tensors):
        nonlocal target
        leaves = [t.clone().requires_grad_() if t.is_floating_point() else t for t in tensors]
        out = module(*leaves)
        out = out[0] if isinstance(out, tuple) else out
        if target is None:
            target = torch.randn(out.shape, generator=torch.Generator().manual_seed(SEED + 31))
        (out.float() - target.to(out.device)).square().mean().backward()
        grads = {f"input {i}": t.grad for i, t in enumerate(leaves) if t.requires_grad}
        grads.update({n: p.grad for n, p in module.named_parameters()})
        return out.detach(), grads

    ref, ref_grads = run(cpu_module, inputs)
    card_inputs = [t.to(device) for t in inputs]
    _reset_launch_counts()
    out, grads = run(card_module, card_inputs)
    launched = {k: v for k, v in _launch_counts().items() if v}
    worst = {}
    for key, want, got in (("output", ref, out), *((k, ref_grads[k], grads[k]) for k in ref_grads)):
        if got is None or not torch.isfinite(got).all():
            raise AssertionError(f"[modules] {name}: {key} missing or not finite on the card")
        scale = want.float().abs().max().item()
        worst[key] = (got.float().cpu() - want.float()).abs().max().item() / max(scale, 1e-30)
    key = max(worst, key=worst.get)
    leaves = [t.clone().requires_grad_() if t.is_floating_point() else t for t in card_inputs]
    params = [p for p in card_module.parameters() if p.requires_grad]

    def step():
        out = card_module(*leaves)
        out = out[0] if isinstance(out, tuple) else out
        torch.autograd.grad(out.float().square().mean(), [*params, *(t for t in leaves if t.requires_grad)])

    ms, by = _device_ms_per_call(step, repeats=5, warmup=2)
    print(f"[modules] {name}: output {tuple(out.shape)} {str(out.dtype).split('.')[-1]}; {len(worst)} values, worst "
          f"{key} max|card - cpu| / max|cpu| = {worst[key]:.3e} (limit {MODULE_RTOL:g}); kernel launches {launched}; "
          f"forward and backward {ms:.4f} device ms a call ({by})")
    if worst[key] > MODULE_RTOL:
        raise AssertionError(f"[modules] {name}: the card disagrees with the CPU on {key}")
    if launches is not None and launched != launches:
        raise AssertionError(f"[modules] {name}: launched {launched}, expected {launches}")
    return {"device_ms": ms, "worst": worst[key]}


def check_modules(device) -> dict:
    """The modules without a path of their own, on the card against the CPU
    at full width: ``Cnn`` at ``CnnFactory()``'s defaults (64x64x3 images ->
    256) on 4,096 rows, ``SeparableConv2d`` (16 -> 32 channels, 3x3, "SAME")
    on its first feature map, ``TransformerEncoderLayer`` (128 wide, 4
    heads, RoPE, gelu FFN 512 with bf16 layers: its FFN takes K1f and K1b)
    and ``TransformerDecoderLayer`` at that width on 24 x 1,024 tokens (a
    causal mask; the decoder's memory 24 tokens), and ``GeGlu``/``SwiGlu``
    on 24,576 rows of 1,024."""
    import torch

    from cusrl_tpu_torch.nn import GeGlu, SwiGlu, TransformerDecoderLayer, TransformerEncoderLayer
    from cusrl_tpu_torch.nn.layer.separable_conv import SeparableConv2d
    from cusrl_tpu_torch.nn.module.cnn import CnnFactory

    gen = torch.Generator().manual_seed(SEED + 30)
    results = {}
    cnn = CnnFactory()(64 * 64 * 3, None, generator=gen)
    images = torch.rand(MODULE_ROWS, 64 * 64 * 3, generator=gen)
    results["cnn"] = _module_case("Cnn (CnnFactory(): 64x64x3, 16-32-32, 8/4/3, 256)", cnn, [images], device)
    with torch.no_grad():
        first = torch.relu(cnn.convs[0](images.reshape(-1, 64, 64, 3))).float()
    results["separable_conv"] = _module_case(
        f"SeparableConv2d on the first feature map {tuple(first.shape)}",
        SeparableConv2d(16, 32, 3, generator=gen), [first], device)
    tokens = torch.randn(T_ENVS, STEPS, T_EMBED, generator=gen)
    causal = torch.tril(torch.ones(STEPS, STEPS, dtype=torch.bool))
    for label, layer, inputs in (
            ("TransformerEncoderLayer", TransformerEncoderLayer(T_EMBED, T_HEADS, ff_dim=T_FF, rope=True,
                                                                compute_dtype="bfloat16", generator=gen),
             [tokens, causal]),
            ("TransformerDecoderLayer", TransformerDecoderLayer(T_EMBED, T_HEADS, ff_dim=T_FF, rope=True,
                                                                compute_dtype="bfloat16", generator=gen),
             [tokens, torch.randn(T_ENVS, STEPS, T_EMBED, generator=gen), causal])):
        for linear in (layer.feed_forward.up, layer.feed_forward.down):
            linear.compute_dtype = "bfloat16"  # the FFN on K1f/K1b (JAX builds it fp32 by default)
        results[label] = _module_case(f"{label} (128 wide, 4 heads, gelu FFN 512) on 24 x 1,024 tokens", layer,
                                      inputs, device, launches={"K1f": 1, "K1b": 1})
    rows = torch.randn(STEPS * T_ENVS, 2 * T_FF, generator=gen).to(torch.bfloat16)
    for glu in (GeGlu(), SwiGlu()):
        results[type(glu).__name__] = _module_case(f"{type(glu).__name__} on {tuple(rows.shape)} bf16", glu, [rows],
                                                   device)
    return results


def check_library(kind: str) -> None:
    """The README's library snippet through the port's top-level names only,
    on the card, for 2 iterations: every metric finite, the agent on the
    card, its kernels launched."""
    import torch

    import cusrl_tpu_torch

    env = cusrl_tpu_torch.environment.VelocityLocomotionEnv(num_instances=NUM_ENVS)
    factory = cusrl_tpu_torch.PpoAgentFactory(
        num_steps_per_update=STEPS,
        actor_hidden_dims=(512, 256, 128),
        normalize_observation=True,
        desired_kl_divergence=0.01,
    )
    trainer = cusrl_tpu_torch.Trainer(environment=env, agent_factory=factory, num_iterations=2, verbose=False)
    _reset_launch_counts()
    start = time.perf_counter()
    trainer.run_training_loop()
    torch.cuda.synchronize()
    launched = {k: v for k, v in _launch_counts().items() if v}
    metrics = trainer.rollout_and_update()
    print(f"[library] cusrl_tpu_torch.environment.VelocityLocomotionEnv, cusrl_tpu_torch.PpoAgentFactory, "
          f"cusrl_tpu_torch.Trainer on {kind}: 2 iterations {time.perf_counter() - start:.3f} s, launches {launched}; "
          f"a third iteration's metrics: " + " ".join(f"{k}={v:.5g}" for k, v in sorted(metrics.items())))
    if trainer.agent.device.type != "cuda" or trainer.agent.iteration != 3 or not launched:
        raise AssertionError("the library snippet did not train on the card through the kernels")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"[library] non-finite metrics: {metrics}")


PROFILES: dict = {}  # [profile]'s band attention kernels by path: {key: (device ms, launches)} an iteration


def profile_iteration(driver, label: str, steps: int = STEPS, fn=None) -> None:
    """Device time by kernel over one training iteration (torch.profiler:
    ``fn()``, else ``driver.collect_and_update(steps)``), and the device's
    idle share of the iteration's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn() if fn is not None else driver.collect_and_update(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    rows, spans = [], []
    for event in prof.key_averages():
        # Device-side events only (kernels, copies, fills): a CPU op's device
        # time repeats the time of the kernels it launched, and so does a
        # range's span on the device (listed apart).
        if getattr(event, "is_user_annotation", False) and event.device_type == torch.autograd.DeviceType.CUDA:
            spans.append(event)
        if not _is_device_work(event):
            continue
        device_us = getattr(event, "self_device_time_total", 0) or getattr(event, "self_cuda_time_total", 0)
        if device_us > 0:
            rows.append((device_us / 1e3, event.count, event.key))
    rows.sort(reverse=True)
    if not rows:
        print(f"[profile] {label}, one iteration: wall {wall_ms:.2f} ms; the profiler saw no device event, device "
              f"busy and idle share not measured")
        return
    busy_ms = sum(r[0] for r in rows)
    print(f"[profile] {label}, one iteration: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} (profiler on)")
    for ms, count, name in rows[:12]:
        print(f"    {ms:9.3f} ms {count:6d}x  {name[:90]}")
    for event in spans:
        us = getattr(event, "self_device_time_total", 0) or getattr(event, "self_cuda_time_total", 0)
        print(f"[profile] {label}, range {event.key} on the device: {us / 1e3:.3f} ms over {event.count} calls, first "
              f"kernel to last (not counted in device busy)")
    # The optimizer's updates: PyTorch's foreach kernels (multi_tensor_apply), whatever their rank.
    foreach = [r for r in rows if "multi_tensor_apply" in r[2]]
    print(f"[profile] {label}, foreach (multi_tensor_apply) kernels, the optimizer's among them: "
          f"{sum(r[1] for r in foreach)} launches, {sum(r[0] for r in foreach):.3f} ms per iteration")
    # The library's matrix products (cuBLAS and CUTLASS, by name), whatever their rank.
    gemms = [r for r in rows if "gemm" in r[2].lower()]
    print(f"[profile] {label}, library matrix products: {sum(r[1] for r in gemms)} launches of {len(gemms)} kernels, "
          f"{sum(r[0] for r in gemms):.3f} ms per iteration")
    # Phase 2 of the backwards (csrc/dw_phase2.cuh), listed whatever its rank.
    phase2 = [r for r in rows if _in_namespaces(r[2], ("dw",))]
    for ms, count, name in phase2:
        if (ms, count, name) not in rows[:12]:
            print(f"    {ms:9.3f} ms {count:6d}x  {name[:90]}")
    print(f"[profile] {label}, phase 2 of the backwards: {sum(r[0] for r in phase2):.3f} ms over "
          f"{sum(r[1] for r in phase2)} launches per iteration")
    # The wgmma kernels by name: the fused block's forwards and post backward
    # (csrc/fused_block.cu, namespaces fbf and fbb) and the MLP chain's
    # forward and backward (csrc/mlp_chain_fwd.cu, mlpf; mlp_chain_bwd.cu, mlpb).
    for namespace, what in (("fbf", "the fused block's forwards"), ("mlpf", "the MLP chain forward"),
                            ("fbp", "the pre backward's phase 1"), ("fbb", "the post backward's phase 1"),
                            ("mlpb", "the MLP chain backward's phase 1"),
                            ("mlpm", "the single-launch PPO step's phase 1 (K9m, its pack included)")):
        forwards = [r for r in rows if _in_namespaces(r[2], (namespace,))]  # by name: a signature names fbf::Layout
        if forwards:
            print(f"[profile] {label}, {what}: "
                  + "; ".join(f"{name.split('(')[0]} {ms:.3f} ms ({count})" for ms, count, name in forwards)
                  + f"; together {sum(r[0] for r in forwards):.3f} ms per iteration")
    # The band attention kernels by name, and each one's share of the device's busy time.
    for key, symbol in (("K3f", "lane::lane_fwd_kernel"), ("K3b", "lane::lane_bwd_kernel"),
                        ("K6", "lane::lane_next_kernel"), ("K7f", "banded::banded_fwd_kernel")):
        found = [r for r in rows if symbol.split("::")[1] in r[2]]
        if found:
            ms = sum(r[0] for r in found)
            PROFILES.setdefault(label, {})[key] = (ms, sum(r[1] for r in found))
            print(f"[profile] {label}, {key} ({symbol}): {ms:.3f} ms over {sum(r[1] for r in found)} launches per "
                  f"iteration, {ms / busy_ms:.4f} of the device's busy time")


PHASE_SECONDS: dict = {}


@contextlib.contextmanager
def _phase(name: str):
    """Prints the seconds the block took on a line of its own and keeps
    them for the ``[seconds]`` summary."""
    start = time.perf_counter()
    yield
    seconds = time.perf_counter() - start
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + seconds
    print(f"[seconds] {name}: {seconds:.1f} s")


def main(argv: list[str]) -> int:
    import torch

    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "cusrl_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the cusrl_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions run true fp32 products
    torch.backends.cudnn.allow_tf32 = False

    if argv[:1] == ["--ddp-rank"]:  # a rank process of [ddp] A2
        return ddp_rank(argv[1], argv[2])
    if argv[:1] == ["--ddp-probe"]:  # a rank process of [ddp] A2's NCCL probe
        return ddp_probe()
    if argv[:1] == ["--tp-rank"]:  # a rank process of [tp]
        return tp_rank(argv[1], argv[2])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {smi} | {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    from cusrl_tpu_torch.nn.kernels import build

    start = time.perf_counter()
    build.build_all()
    PHASE_SECONDS["[build]"] = time.perf_counter() - start
    print(f"[build] {time.perf_counter() - start:.1f} s (nvcc, sources compiled in parallel)")
    for log in sorted(build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {log.stem}: {line.strip()}")

    if argv == ["--ddp-cards"]:  # path A's update on every card of the machine, one rank each, over NCCL
        check_ddp_ranks(kind, torch.cuda.device_count(), spread=True)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip())
        return 0
    if argv == ["--tp-cards"]:  # [tp]'s four-rank cases with one NCCL rank on each of four cards
        check_tp(kind, spread=True)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip())
        return 0
    if argv == ["--tp"]:  # only the [tp] phase
        with _phase("[tp]"):
            check_tp(kind)
        print(f"[total] {time.perf_counter() - started:.1f} s, the build included")
        print(smi)
        return 0
    if argv == ["--ddp"]:  # only the [ddp] phase
        with _phase("[ddp] A1"):
            check_ddp_world1(kind)
        with _phase("[ddp] A2"):
            check_ddp_ranks(kind)
        print(f"[total] {time.perf_counter() - started:.1f} s, the build included")
        print(smi)
        return 0
    if argv:  # --paths P ...: only the named paths' [train-zoo] chunks and profiles (comparing two checkouts)
        every = (*PATH_ROUTES, *PATHS, *RECURRENT_PATHS, *AMP_PATHS, *F_PATHS, *H_PATHS, *AUX_PATHS, *CONTROL_PATHS,
                 *IL_PATHS)
        if argv[0] != "--paths" or not set(argv[1:]) <= set(every):
            print(f"usage: chip_smoke.py [--ddp | --ddp-cards | --tp | --tp-cards | --paths {' '.join(every)} ...]",
                  file=sys.stderr)
            return 2
        for path in argv[1:]:
            train_zoo(kind, path)
        print(smi)
        return 0
    device = torch.device("cuda", 0)
    with _phase("[kernels]"):
        results = check_kernels(device)
        results.update(check_head_kernels(device))
        results.update(check_lane_kernels(device))
        results.update(check_banded_kernels(device))
        results.update(check_block_kernels(device))
        gelu = check_gelu_kernels(device)
        # K1b's ELU timing at the MLP's widths is off every path: kept under its own name.
        results["K1b"] = {f"offpath_elu_{k}": v for k, v in results["K1b"].items()}
        results["K1b"]["max_abs_err"] = results["K1b"].pop("offpath_elu_max_abs_err")
        for key, fields in gelu.items():
            results[key].update(fields)
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"], fields["gelu_max_abs_err"])
        for key, fields in check_tl_head_kernels(device).items():
            results[key].update(fields)
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"], fields["tl_head_max_abs_err"])
        for prefix, check in (("r_head_", check_r_head_kernels), ("rj_pair_", check_rj_pair_kernels),
                              ("amp_", check_amp_kernels)):
            for key, fields in check(device).items():
                results[key].update(fields)
                results[key]["max_abs_err"] = max(results[key]["max_abs_err"], fields[prefix + "max_abs_err"])
        for key, fields in check_f_kernels(device).items():
            results[key].update(fields)
            prefix = "f_" if key == "K1f" else "f_pair_"
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"], fields[prefix + "max_abs_err"])
        for key, fields in check_h_kernels(device).items():
            results[key].update(fields)
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"], fields["h_max_abs_err"])
        for key, fields in check_aux_kernels(device).items():
            results[key].update(fields)
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"], fields["aux_max_abs_err"])
        for key, fields in check_control_kernels(device).items():
            results[key].update(fields)
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"], fields["control_max_abs_err"])
        for key, fields in check_lane_routes(device).items():
            results[key].update(fields)
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"], fields["lane_routes_max_abs_err"])
    with _phase("[kernels] IL"):
        for key, fields in check_il_kernels(device).items():
            results[key].update(fields)
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"], fields["il_max_abs_err"])
    with _phase("[wrappers]"):
        for key, err in (*check_wrappers(device).items(), *check_head_wrappers(device).items()):
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)
        for key, err in check_block_wrappers(device).items():
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)
    with _phase("[redesign queue]"):
        time_redesign_queue(results)
    with _phase("[second-order]"):
        check_second_order(device)
    with _phase("[optimizer]"):
        optimizer_fields = check_optimizer(device)
    with _phase("[update-check]"):
        for path in ("slice 1", *PATHS, *(p_ for p_ in PATH_ROUTES if p_ not in QK_PAIR_PATHS), *RECURRENT_CHECKS,
                     *AMP_PATHS, *F_PATHS):
            check_update_against_cpu(path)
        check_h_update_against_cpu()
    with _phase("[update-check] TQ TJC SB"):
        for path in (*QK_PAIR_PATHS, "SB"):
            check_update_against_cpu(path)
    with _phase("[update-check] D S SL X"), tempfile.TemporaryDirectory(prefix="cusrl_expert_") as tmp:
        expert_path = _export_expert(_path_a_agent(), tmp)
        for path in AUX_CHECKS:
            check_update_against_cpu(path, expert_path)
    with _phase("[update-check] SC PO"):
        for path in CONTROL_PATHS:
            check_update_against_cpu(path)
    with _phase("[update-check] IL"):
        check_update_against_cpu("IL")
    with _phase("[train]"):
        train(kind)
    path_launches = {}
    for path in (*PATH_ROUTES, *PATHS, *RECURRENT_PATHS, *AMP_PATHS, *F_PATHS, *AUX_PATHS, *CONTROL_PATHS):
        with _phase(f"[train-zoo] {path}"):
            path_launches[path], ZOO_RATES[path] = train_zoo(kind, path)
    with _phase("[train-zoo] H, [play] H"):
        path_launches["H"], h_rate, h_checkpoint = train_host(kind)
        h_play = play_h(kind, h_checkpoint)
    with _phase("[train-zoo] IL, [play] IL"):
        path_launches["IL"], ZOO_RATES["IL"], il_play_rate, il_play_per_step = train_il(kind)
    tj, tjc = PROFILES.get("TJ", {}), PROFILES.get("TJC", {})
    print("[profile] TJ against TJC, one iteration each in this run: " + "; ".join(
        f"{key} {tj.get(key, (None, 0))[1]} against {tjc.get(key, (None, 0))[1]} launches, "
        f"{_ms(tj.get(key, (None,))[0])} against {_ms(tjc.get(key, (None,))[0])} device ms" for key in ("K3f", "K3b")))
    with _phase("[modules]"):
        check_modules(device)
    with _phase("[library]"):
        check_library(kind)
    with _phase("[cli]"):
        check_cli()
    with _phase("[ddp] A1"):
        ddp_a1 = check_ddp_world1(kind)
    with _phase("[ddp] A2"):
        ddp_a2 = check_ddp_ranks(kind)
    with _phase("[tp]"):
        tp = check_tp(kind)
    path_launches["A ddp"] = ddp_a1["launches"]  # A1's distributed Trainer chunk
    # [tp]: each case's update on rank 0, and A 1x2's Trainer chunk.
    for name, fields in tp["cases"].items():
        path_launches[f"{name} tp"] = {**_NONE, **fields["launches"]}
    for key in results:  # each kernel's launches in each path's update on rank 0 of [ddp] A2
        if launched := {p_: n for p_, launches in ddp_a2["rank_launches"].items() if (n := launches.get(key))}:
            results[key]["ddp_rank_launches"] = launched
            results[key]["ddp_backend"] = ddp_a2["backend"]

    # TL's rollout step runs the FFN and the ELU head through K1f at 1,024 rows:
    # half of its K1f launches per iteration beyond the update's are the head's.
    results["K1f"]["tl_head_step_launches"] = (path_launches["TL"]["K1f"] // 10 - _TL_UPDATE["K1f"]) // 2
    # Every K1f and K1b launch of path R is the head's (256 -> 128): per iteration.
    for key in ("K1f", "K1b"):
        results[key]["r_head_launches"] = path_launches["R"][key] // 10
    # Every K2f and K2b launch of path RJ is its pair of heads: per iteration.
    for key in ("K2f", "K2b"):
        results[key]["rj_pair_launches"] = path_launches["RJ"][key] // 10
    # Every K1f and K1b launch of path AMP is a relu 48-512-256 backbone's: per iteration.
    for key in ("K1f", "K1b"):
        results[key]["amp_launches"] = path_launches["AMP"][key] // 10
    # Every K1f, K2f and K2b launch of path F is an ELU 48-128-128-128 backbone's: per iteration.
    for key in ("K1f", "K2f", "K2b"):
        results[key]["f_launches"] = path_launches["F"][key] // 10
    # Every K1f and K1b launch of path H is a tanh 4-64-64 backbone's at 256 rows: per iteration.
    for key in ("K1f", "K1b"):
        results[key]["h_launches"] = path_launches["H"][key] // 10
    results["K1f"]["h_play_launches_per_step"] = h_play["launches_per_step"]
    # Paths D, S and X per iteration (D: student and expert; X: A's and RND's).
    for path in (*AUX_PATHS, *CONTROL_PATHS):
        for key in ("K1f", "K1b", "K2f", "K2b"):
            if path_launches[path][key]:
                results[key][f"{path.lower()}_launches"] = path_launches[path][key] // 10
    results["K1f"]["h_env_steps_per_s"], results["K1f"]["h_play_env_steps_per_s"] = h_rate, h_play["env_steps_per_s"]
    # Every K1f and K1b launch of path IL is a 235-512-256-128 ELU backbone's: per iteration.
    for key in ("K1f", "K1b"):
        results[key]["il_launches"] = path_launches["IL"][key] // IL_ITERATIONS
    results["K1f"]["il_play_launches_per_step"] = il_play_per_step
    results["K1f"]["il_env_steps_per_s"], results["K1f"]["il_play_env_steps_per_s"] = ZOO_RATES["IL"], il_play_rate
    # Paths TQ (a 10-iteration chunk) and TJC (one profiled iteration): K3f/K3b launches per iteration.
    for key in ("K3f", "K3b"):
        results[key]["tq_launches"] = path_launches["TQ"][key] // 10
        results[key]["tjc_launches"] = path_launches["TJC"][key]
    # TL's recomputing K7 backward runs once for each K7f launch that takes a
    # gradient: the run's launches per iteration less the value and KL passes'.
    bwd_ms, grad_calls = results["K7f"]["tl_recompute_bwd_device_ms"], path_launches["TL"]["K7f"] / 10 - TL_PRIMAL_K7F
    print(f"[estimate] TL's recomputing K7 backward per iteration: {grad_calls:g} calls (TL's K7f launches per "
          f"iteration in this run, less its {TL_PRIMAL_K7F} primal ones) x {_ms(bwd_ms)} device ms (one call timed "
          f"alone) = {_ms(None if bwd_ms is None else grad_calls * bwd_ms)} ms; extrapolated, not measured in the loop")
    kernels = []
    main_path = {"K8f": "B", "K8b": "B", "K9s": "C", "K9m": "CM", "K1b": "T", "K3f": "TF", "K3b": "TF", "K6": "TF",
                 "K7f": "TL", **{key: ("TF" if key.startswith("K4") else "TJ") for key in BLOCK_REPLACES}}
    for key in ("K1f", "K1b", "K2f", "K2b", "K8f", "K8b", "K9s", "K9m", "K3f", "K3b", "K6", "K7f", *BLOCK_REPLACES):
        r = results[key]
        path = main_path.get(key, "A")
        kernels.append({
            "name": key, "route": "cuda", "source": SOURCES.get(key, "cusrl_tpu_torch/csrc/fused_block.cu"),
            "replaces": {**REPLACES, **BLOCK_REPLACES}[key],
            "launches": path_launches[path][key], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"], "path": f"{path}: {PATH_NAMES[path]}",
            "launches_by_path": {p_: path_launches[p_][key] for p_ in path_launches if path_launches[p_][key]},
            **{k: v for k, v in r.items()
               if k.startswith(("gelu", "primal", "offpath", "tl_", "r_head", "rj_pair", "amp_", "f_", "h_", "ddp_",
                                "d_", "s_pair_", "s_launches", "sl_", "x_", "aux_", "sc_", "po_", "control_",
                                "tq_", "tjc_", "lane_routes_", "il_",
                                "phase", "bitwise",
                                "grid", "ring", "smem", "regs", "spills", "device", "pack", "rollout", "queue", "host",
                                "plan"))},
            "status": "ported and checked",
        })
    print("[optimizer] " + json.dumps(optimizer_fields))
    print("[seconds] " + json.dumps({name: round(seconds, 1) for name, seconds in PHASE_SECONDS.items()}))
    print(f"[total] {time.perf_counter() - started:.1f} s, the build included")
    print(smi)
    print(json.dumps({"kernels": kernels, "not_ported": []}))  # every TPU kernel has its counterpart
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
