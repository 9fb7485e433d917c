#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``) and the torch/CUDA
   versions;
2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   (all sources at once) and print ptxas's register/shared-memory report;
3. hold each kernel against its plain PyTorch version on the card at
   fixed edge-case shapes: triage (3D Q=3 fold, one row, capacity
   overflow, all-pad rows, NaN lanes, 2^17 rows, every width of
   ``TRIAGE_WIDTHS`` at every row count of ``TRIAGE_ROWS`` with capacity
   0 and overflow, pointers the vector loads cannot take) must agree
   exactly, the Platt fit (R in {4, 64} x ``CALIBRATE_WIDTHS``, both of
   its paths, with degenerate rows) within ``CAL_ATOL`` with exact
   counts; the pixel cascade, framediff, dilate
   and erode exactly, at ``PIXEL_SHAPES`` and ``PIXEL_TILE_SHAPES``, on
   sparse motion, on a static scene and at 1080p (``HD``), with the fused
   cascade also held against the staged framediff -> dilate -> erode
   launches, and on the uint8 camera views ``detect`` passes, over
   consecutive calls and after a call with more cameras; the scan superstep
   bit for bit (routes, slots and f32 thresholds) at ``SUPERSTEP_SHAPES``
   — the metropolis cap slab among them — with masks all off and all on,
   drains on both sides of the interval and capacity overflow; the track
   association at ``ASSOC_SHAPES`` (the reference test's, several row
   tiles, several track chunks, ``MAX_TRACKS``), K = 0, an all-masked
   query, a tie and ``assoc_cases`` (a rescan after a claim, a chain of
   crops contending for one track, a tie only after a claim, a query
   with no tracks, a floor below NEG_INF), ``assign`` exactly and ``sim``
   within ``SIM_ATOL``; flash
   attention, causal and not, within ``FLASH_ATOL`` at ``FLASH_SHAPES``
   (the reference test's, Sq 64 against Sk 256, Sq = Sk = 1000, head dims
   16 to 256, qwen1.5-0.5b's and qwen3-8b's prefill, chatglm3-6b's GQA
   16:1 and command-r-35b's 8:1 at hd 128) and in bf16 (hd 128 included),
   and on the model's (B, S, H, hd) views;
4. the main path: ``run_query(city_scale(), device="cuda")`` at full size
   (64 edges, 512 cameras, 60 s) with the launch counters zeroed just
   before and read just after; the same run with ``device="cpu"`` must
   give the identical summary, and the triage launches must equal the
   run's ``kernel_launches``;
5. the feedback path: ``drifting_city(num_cameras=8, duration_s=60)`` on
   the card — calibrate launches must equal ``model_updates`` (> 0), the
   closed loop's F2 must beat the ``update_period_s=None`` ablation, and
   the summary must equal the same run's with ``device="cpu"``, or differ
   only in keys that lie within their ``GATE_BANDS``;
6. the pixel path: ``run_query(pixel_city(), frontend=PixelFrontend(seed=0,
   device="cuda"), device="cuda")`` at the preset's full size (12
   cameras, 4 edges, 12 s) — one pixel-cascade launch per tick, one
   classifier batch per tick with crops; the same run with
   ``device="cpu"`` must give the same stream (``conf`` within
   ``CONF_ATOL``) and the same summary, or differ only within
   ``GATE_BANDS``; ``PixelFrontend(fused=False)`` on the card must give
   the identical stream from one framediff and two morphology launches a
   tick.  One ``ops.pixel_cascade`` call on the tick's uint8 views must
   be one device operation under ``torch.profiler``.  Prints the render /
   framediff / CCL / classify split of the card's run, of a second card
   run and of the host's;
7. the superstep path: ``run_query(metropolis(duration_s=METRO_S))`` at the
   preset's full fleet (10,240 cameras, 1,024 edges, 24 queries, 10 Hz):
   superstep launches must equal ``supersteps`` and each must fuse >= 10
   triaged ticks on average; at the smoke size (1,024 cameras, 12 s) the
   card's report must equal the CPU's, and ``superstep=1`` must be
   bit-identical to the preset's ``superstep=128``;
8. the track path: ``vehicle_pursuit()`` and ``crowd_flow()`` on the card:
   one associate launch per tick with crops and a live table, summaries
   equal to the CPU's, fewer ID switches than the ``predictive_handoff=
   False`` ablation, and ``AsyncDriver(VirtualClock())`` identical to
   ``SimDriver`` on ``vehicle_pursuit``;
9. the serving path: ``CascadeServer`` with full-width qwen1.5-0.5b (24
   layers, ~464M parameters, ``attn_impl="flash"``) as the cloud model
   behind its edge variant, 16 prompts of 64 to 1,024 tokens, 16 new
   tokens each, 8 slots, thresholds that answer six at the edge: flash
   launches must equal 24 x cloud prefills; routes and tokens must equal
   the same run's under ``attn_impl="chunked"`` on the card, and, at
   ``num_layers=2``, the host's, a token differing only after a step
   whose top-2 margin is below ``LOGIT_ATOL``, prefill logits within it.
   Prints prefill and decode tokens/s and the edge/cloud split.  Then
   qwen3-8b at full depth and width (36 layers), one 2,048-token prefill
   under the chunked path, under flash (36 launches) and under flash with
   SDPA in the kernel's place: finite logits, and the kernel's drift from
   the chunked path's logits within ``DEEP_DRIFT_RATIO`` x SDPA's;
10. the dense family (``dense_family_phase``): speculative decoding on
   full-width qwen1.5-0.5b (flash) with its edge variant, at the cloud's
   vocabulary, as the draft, 4 prompts of 64 to 1,024 tokens, 16 tokens,
   k = 4: tokens equal to ``cloud_greedy_generate`` on the card under the
   near-tie rule, the cloud drafting for itself accepts everything, flash
   launches 24 x cloud prefills (twice that self-drafting), the card's
   tokens equal the host's at 2 layers; the int8 KV cache through
   ``CascadeServer`` on the serving phase's prompts (a 1,024-token
   prefill and decode step within ``INT8_KV_RTOL`` of the f32 cache's,
   card against host at 2 layers); int8 weights (prefill logits within
   ``INT8_WEIGHT_RTOL`` of the f32 model's, 24 bf16 flash launches, 16
   decode steps through ``DecodeEngine``); chatglm3-6b and command-r-35b
   at full width, 2 layers, drawn on the host (a 1,024-token prefill and
   16 decode steps, flash against chunked on the card);
11. the remaining families (``families_phase``), each drawn on the card
   from a seed and freed before the next: granite-moe-1b-a400m at full
   width and depth (24 layers, 32 experts top-8, flash) behind its edge
   variant through ``CascadeServer`` on the serving phase's prompts,
   against the same run under chunked attention (routes, tokens under the
   near-tie rule, prefill logits within ``MOE_LOGIT_ATOL``), with each
   prefill's expert choices dropped over capacity and its aux loss;
   phi3.5-moe-42b-a6.6b at full width, ``PHI_LAYERS`` layers (a
   1,024-token prefill and 16 decode steps, flash against chunked);
   mamba2-2.7b at full width and depth (64 layers) through
   ``DecodeEngine`` on ``FAMILY_LENGTHS`` prompts, its 16-step decode
   chain against the forward's logits within ``MAMBA_CHAIN_RTOL`` and one
   layer's ``ssd_chunked`` against ``ssd_reference`` on the engine's
   1,024-token inputs within ``SSD_RTOL``; hymba-1.5b (32 layers, 25
   query heads over 5) through ``CascadeServer`` on the same lengths;
   whisper-large-v3 (32 + 32 layers) on 1,500 stub frames and
   internvl2-1b (24 layers) behind 256 stub image embeddings, flash
   against chunked.  Flash launches = layers x cloud prefills on every
   path (whisper's decoder only; none on mamba2).  Each family also runs
   at 2 layers on the card against the host: tokens under the near-tie
   rule, logits within ``LOGIT_ATOL``;
12. the training path (paper §IV-A/B): ``build_workload`` at
   ``benchmarks/common.py::shared_workload``'s settings (``WORKLOAD``: 8
   cameras, 3 edges, 240 s, 80 AdamW steps of the full-width CQ edge
   model) on the card and on the host — integer fields identical, the
   fine-tune's loss over its first ``TRAIN_LOSS_STEPS`` steps within
   ``TRAIN_LOSS_ATOL``, the card's trained model scoring the same crops on
   both devices within ``CONF_ATOL``, accuracy >= 0.65 and query items' mean
   ``conf`` above the others' by > 0.1 on both; prints the build's split
   (fine-tune, stream, scoring) and the steady train step beside
   ``scheme_train_time``'s assumed 50 ms.  Then Table II's four schemes
   over the card's stream through ``run_query`` on both devices
   (identical summaries; ``surveiledge`` faster than ``cloud_only`` and
   more accurate than ``edge_only``; ``cloud_only`` F2 1.0, ``edge_only``
   0 MB; triage launches == ``kernel_launches`` > 0 for the two
   surveiledge schemes), and the three Fig. 5 schemes from a backbone
   pretrained on the card (step counts 40, 4 x 40, 0; All-Fine-tune's
   summed time above SurveilEdge's);
13. the LLM training stack (``llm_training_phase``): full-width
   qwen1.5-0.5b (24 layers, 463,989,762 parameters, chunked attention)
   trained through ``launch/train.py``'s functions for ``LLM_STEPS``
   steps of ``LLM_BATCH`` x ``LLM_SEQ`` tokens — every loss finite, the
   last below the first, no kernel launched; printed: every loss, the
   first and steady step ms, tokens/s and peak memory — then one step at
   microbatches 2 against 1 (``LLM_MICRO_RTOL``), a checkpoint of the
   trained parameters restored bit for bit; the same weights at 2 layers
   and every reduced ``ASSIGNED`` config, one step on the card against
   the host (``LLM_LOSS_ATOL``, ``LLM_GNORM_RTOL``,
   ``LLM_MOE_LOSS_ATOL``); flash refusing a gradient on the card; one
   step profiled (``train_step_trace``);
14. time the card's launch floor (an empty kernel), then each kernel and
   its plain version on the inputs the main paths gave it (triage and
   calibrate at every recorded shape with its launches, calibrate also at
   ``CALIBRATE_WIDE``; the pixel kernels also at 1080p, the cascade on
   the tick's uint8 views, on int32 frames and beside the five operations
   that widened the views first; flash attention
   and SDPA at
   every prefill length of the serving run and of the speculative runs,
   summed over their launches, at qwen3-8b's prefill, in f32 and in bf16,
   at the dense family's prefills and at every prefill shape of the
   remaining families (with the plain version at each one's largest);
   the superstep at every
   slab shape of the three metropolis runs and the association at every
   (M, K, D) of the track runs, each with its launches, bound and the
   run's sum), and print
   ``{"kernels": [...], "launch_floor_ms": ...}`` (per kernel: launches
   per path, max error against the plain version, kernel/plain ms with
   the stream pre-loaded and the kernel's ms over the floor, the bound
   from the bytes and operations of the timed inputs, and the one
   PyTorch call that computes the same function, where there is one),
   then, last, ``{"ok": true, "device": {...}}``;
15. multi-device (``multi_device_phase``, run before 14's timing so that
   its launches join the kernels line): the full-fleet ``metropolis`` with
   its row axis in ``FLEET_SHARDS`` shards on cuda:0 — the report equal to
   phase 7's unsharded run but for the launch count, superstep launches =
   ``FLEET_SHARDS`` x supersteps — and ``_superstep_fn(cap, n)`` on the cap
   slab bit-identical for every n of ``SHARD_COUNTS``; full-width
   ``LLM_ARCH`` on a (1, 1) device mesh over a one-rank NCCL group:
   ``MESH_STEPS`` train steps with DTensor parameters and AdamW state
   placed by the train rules and ``ActCtx`` within ``MESH_RTOL`` of the
   same steps without a mesh (step ms of both printed),
   ``remat_policy="dots"`` for ``REMAT_STEPS`` steps (the same losses, its
   peak memory against remat alone), one ``MESH_PROMPT``-token prefill and
   ``MESH_NEW`` greedy decode steps under the serve rules with flash on
   the local heads (the plain path's tokens); the same for full-width
   ``MESH_MOE_ARCH`` (``MESH_MOE_STEPS`` train steps: the MoE's row-local
   dispatch on the mesh, its aux loss beside the loss); then the
   production-shape dry-runs of ``DRYRUN_CALLS``, each a process started
   after the build that runs beside phases 3-14 on fake tensors in a
   fake process group of 256 or 512 ranks: chips, per-device peak bytes
   against the card's memory, per-device FLOPs and collective bytes by
   kind printed, each call failing the script unless it wrote its record
   by ``DRYRUN_DEADLINE_S``; a decode's record also unless it gathered no
   cache leaf, moved under ``DRYRUN_COLL_LIMIT`` bytes a device (where
   its serve weights are 1-D: 2-D serve weights are gathered a layer at
   a time, by the rules) and counted its per-device FLOPs within
   ``DRYRUN_FLOPS_RTOL`` of ``roofline.decode_flops_per_device``.

Exits non-zero, printing no result, where torch finds no CUDA device or
the port's sources are not beside this script.  Imports nothing of JAX.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the
#: tensor cores — the two rates a bound is taken against
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12  # also taken as the scalar integer rate
#: dense TF32 FLOP/s of the tensor cores, the rate of the flash kernel's
#: split-TF32 products (three TF32 products stand for one f32 product)
TF32_FLOP_S = 495e12
#: dense bf16 FLOP/s of the tensor cores, the rate of the bf16 flash kernel
BF16_FLOP_S = 989e12
#: params tolerance, kernel vs plain version on the card: both are f32
#: Newton fits of one function, but the kernel sums in a tree of warp
#: shuffles and contracts multiply-adds, and 8 Newton steps carry those
#: ulps forward
CAL_ATOL = 1e-4
#: summary key -> (kind, band, floor of a relative band): the bands of
#: ``benchmarks/report_gate.py`` for the keys a ``drifting_city`` summary
#: carries, copied so that this script reads nothing of the reference
GATE_BANDS = {
    "accuracy_F2": ("abs", 0.05, 0.0),
    "avg_latency_s": ("rel", 0.25, 0.05),
    "p99_latency_s": ("rel", 0.25, 0.10),
    "bandwidth_MB": ("rel", 0.25, 0.05),
    "lan_MB": ("rel", 0.25, 0.05),
    "downloaded_MB": ("rel", 0.25, 0.05),
    "downlink_fp_MB": ("rel", 0.25, 0.05),
    "uplink_bytes_per_TP": ("rel", 0.25, 256.0),
    "reconciliation_flip_rate": ("abs", 0.05, 0.0),
    "provisional_latency_s": ("rel", 0.25, 0.05),
}
#: confidence tolerance, card vs host on the pixel path: the CQ classifier
#: runs in f32 on both (TF32 off), its matmul and softmax sums in another
#: order
CONF_ATOL = 1e-5
#: (B, H, W) of ``tests/test_pixel_cascade.py``'s fixed cases: the default
#: camera frame, a sub-band height, non-lane widths
PIXEL_SHAPES = [(2, 96, 128), (1, 33, 40), (3, 16, 300), (2, 100, 96),
                (1, 64, 129)]
#: (B, H, W) on the edges of the kernels' tiles: the cascade's 28 x 16
#: (frames under 32,768 pixels) and 60 x 32 tiles and the stencil's
#: 128 x 16, at exact multiples and one past them, W * 3 odd
PIXEL_TILE_SHAPES = [(2, 16, 28), (1, 17, 29), (3, 33, 57), (2, 16, 128),
                     (1, 17, 257), (1, 128, 256), (2, 161, 241),
                     (1, 96, 600)]
#: eight 1080p cameras: ~0.6 GB of int32 frames a tick
HD = (8, 1080, 1920)
#: bytes a pixel each pixel kernel must move: three (.., 3) pixels read
#: (12 bytes each in int32, 3 in uint8) and one int32 mask value
#: written; morphology reads and writes one.  The cascade's bound follows
#: its frames' element type, so a bound is the same work whatever
#: computes it
PIXEL_BYTES = {"pixel_cascade": 3 * 12 + 4, "pixel_cascade_uint8": 3 * 3 + 4,
               "framediff": 3 * 12 + 4, "morph3x3": 4 + 4}
#: integer operations a pixel: framediff's 3 x (2 sub, 2 abs, and) + gray
#: (3 mul, 2 add, div) + compare; a 3x3 stencil's 9 compares; the cascade
#: does both stencils
PIXEL_OPS = {"pixel_cascade": 22 + 18, "pixel_cascade_uint8": 22 + 18,
             "framediff": 22, "morph3x3": 9}
#: a pending kernel that holds the stream while the host enqueues a timed
#: loop, so the events time the device, not the Python launch path
HOLD_CYCLES = 500_000_000
#: triage widths and row counts held against the plain version: one to
#: four of a row's lanes a lane (N <= 128), the chunk walk (200, 1024),
#: widths off the buckets (13, 21, 33, 200) as ``ops.triage`` passes
#: them, and R from one row to 2^17
TRIAGE_WIDTHS = [1, 2, 3, 8, 13, 16, 21, 32, 33, 64, 80, 100, 128, 200,
                 1024]
TRIAGE_ROWS = [1, 7, 64, 1 << 17]
#: calibrate widths: the warp-a-row path (8..256) and the block path
#: (257..``MAX_LANES``)
CALIBRATE_WIDTHS = [8, 16, 64, 100, 200, 256, 257, 2048]
#: (R, N) calibrate shape timed beside the main paths': the feedback
#: window's full width (``feedback_window`` = 256), eight edges
CALIBRATE_WIDE = (8, 256)
#: sim tolerance, association kernel vs plain version: the same f32 dots,
#: a chain of FMAs on the card and a matmul in the plain version
#: (``tests/test_track_query.py``'s tolerance)
SIM_ATOL = 1e-5
#: (S, R, N) superstep slabs: one row, metropolis's smallest and largest
#: smoke-size slabs, the cap slab (``MAX_SUPERSTEP_ELEMS``), an odd S;
#: every packed width (N = 1, 3, 16, 32: 32, 8, 2 and 1 rows a warp) and
#: the chunk walk (N = 33, 64), with R not a multiple of the rows a warp
#: packs, and an odd S at the cap slab's size
SUPERSTEP_SHAPES = [(1, 1, 8), (2, 16, 8), (64, 8192, 8), (32, 16384, 8),
                    (7, 100, 8), (7, 101, 1), (9, 37, 3), (5, 203, 16),
                    (3, 66, 32), (5, 19, 33), (3, 66, 64), (33, 16381, 8)]
#: (M, K, D) association problems: ``tests/test_track_query.py``'s, the
#: track presets' largest, crop rows over several shared-memory tiles, K
#: over several staged track chunks, ``similarity.MAX_TRACKS`` (one row a
#: tile), D over several column chunks, and a D the 16-byte loads cannot
#: take
ASSOC_SHAPES = [(5, 7, 16), (1, 1, 4), (16, 16, 32), (128, 128, 32),
                (1024, 128, 32), (64, 4096, 32), (16, 32768, 32),
                (40, 300, 72), (24, 50, 37)]
#: simulated seconds of the full-fleet metropolis run: only the duration
#: of the preset (60 s) is cut, never its fleet
METRO_S = 12.0
#: metropolis at the smoke size of the reference's tests and runner
METRO_SMOKE = dict(num_cameras=1024, duration_s=12.0)
#: seconds into the script after which the host's full-fleet metropolis
#: run (a comparison, ~1.5 minutes) is skipped to stay inside the limit
HOST_METRO_BUDGET_S = 420.0
#: flash attention vs its plain version on the card (the reference test's
#: tolerances, as atol and rtol): the same f32 function with the sums in
#: another order; bf16 rounds the output
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: (B, H, KV, Sq, Sk, hd): ``tests/test_flash_attention.py``'s shapes, a
#: query chunk against a longer cache, non-tile lengths, the head dims of
#: the other tilings, qwen1.5-0.5b's 1,024-token prefill, qwen3-8b's GQA
#: prefill, and the dense-family phase's: chatglm3-6b's GQA 16:1 and
#: command-r-35b's 8:1 at hd 128, on and off the tile; the remaining
#: families': granite-moe's 2:1, phi3.5-moe's 4:1 at hd 128, hymba's 25
#: heads over 5 (on and off the tile), whisper's 20-head MHA and
#: internvl2's 7:1 behind its image prefix
FLASH_SHAPES = [(1, 2, 2, 128, 128, 32), (2, 4, 2, 256, 256, 64),
                (1, 8, 2, 128, 128, 32), (1, 2, 1, 192, 192, 16),
                (1, 4, 4, 64, 256, 32), (1, 4, 2, 1000, 1000, 64),
                (1, 2, 2, 300, 300, 96), (1, 2, 1, 130, 130, 256),
                (1, 16, 16, 1024, 1024, 64), (1, 32, 8, 2048, 2048, 128),
                (1, 32, 2, 1024, 1024, 128), (1, 64, 8, 1024, 1024, 128),
                (1, 32, 2, 1001, 1001, 128), (1, 16, 8, 1024, 1024, 64),
                (1, 32, 8, 1024, 1024, 128), (1, 25, 5, 1024, 1024, 64),
                (1, 25, 5, 777, 777, 64), (1, 20, 20, 64, 64, 64),
                (1, 14, 2, 1024, 1024, 64)]
#: bf16 (int8 weights compute in bf16): the same edge and serving shapes,
#: and the dense family's GQA at hd 128
FLASH_BF16_SHAPES = [(1, 2, 2, 128, 128, 32), (1, 16, 16, 1024, 1024, 64),
                     (1, 32, 2, 1024, 1024, 128), (1, 64, 8, 1024, 1024, 128),
                     (1, 64, 8, 1001, 1001, 128)]
#: qwen3-8b's GQA prefill (B, H, KV, Sq, Sk, hd), timed beside the serving
#: shapes
QWEN3_8B_PREFILL = (1, 32, 8, 2048, 2048, 128)
#: the serving phase: requests, their prompt lengths, decode steps, slots
SERVE_REQUESTS = 16
SERVE_LENGTHS = (64, 1024)
SERVE_NEW = 16
SERVE_SLOTS = 8
#: decode ticks timed on the host clock, then as many under the profiler
DECODE_TICKS = 8
#: logits tolerance between two serving runs that differ only in the
#: attention path (flash vs chunked on the card) or the device (card vs
#: host at cut depth): f32 everywhere, TF32 off, the sums in another
#: order; the logits have a standard deviation near 1.  A greedy token may
#: differ only after a step whose top-2 margin in the plain run is below it
LOGIT_ATOL = 1e-4
#: the qwen3-8b full-depth prefill: its prompt (qwen3-8b's prefill shape
#: above), and how far its logits may drift from the chunked path's, as a
#: multiple of the drift with SDPA in the kernel's place
DEEP_PROMPT = 2048
DEEP_DRIFT_RATIO = 1.5
#: the training phase's workload: ``benchmarks/common.py::shared_workload``
#: (8 cameras, 3 edges, 240 s, 80 fine-tune steps, seed 0), the stream
#: every paper table runs over, at the edge model's full width
WORKLOAD = dict(num_cameras=8, num_edges=3, duration_s=240.0,
                finetune_steps=80, seed=0)
#: the workload built on the card against the host's build: the same init
#: and batches, f32 on both (TF32 off).  Adam's step is about lr * sign(g),
#: so an entry whose gradient cancels to a few ulps moves by 2 lr on one
#: side only, and the 80-step fine-tune amplifies that: two host builds
#: that differ only in their thread count (8 against 1) agree in loss to
#: 1.2e-7 over steps 1-20, part past 1e-3 at step 76 and end with
#: confidences 0.077 apart (``tools/train_divergence.py`` on an 8-core
#: CPU host; card against host, 0.35-0.42).  So the fine-tune's
#: loss is held over its first ``TRAIN_LOSS_STEPS`` steps within
#: ``TRAIN_LOSS_ATOL``, the card's trained model must score the same crops
#: on both devices within ``CONF_ATOL``, and the two streams' largest
#: ``conf`` gap is printed, not held
TRAIN_LOSS_STEPS = 20
TRAIN_LOSS_ATOL = 1e-4
#: Table II's single-edge setting (``benchmarks/table2_single_edge.py``
#: through ``common.calibrated_scenario``, copied): a 1.0x edge serving
#: at ``EDGE_UTILIZATION`` of the stream's mean arrival rate
EDGE_UTILIZATION = 0.9
TABLE2 = dict(edge_speeds=(1.0,), cloud_speedup=6.0, uplink_MBps=0.5,
              seed=11)
#: Fig. 5's setting (``benchmarks/fig5_training_schemes.py``): cameras,
#: generic pretraining steps of the shared backbone
FIG5_CAMERAS = 4
FIG5_PRETRAIN_STEPS = 20
#: the dense-family phase: speculative decoding's prompt lengths, new
#: tokens and draft length on full-width qwen1.5-0.5b; the prompt and
#: decode steps of chatglm3-6b and command-r-35b at full width, cut to
#: ``DENSE_LAYERS`` layers
SPEC_LENGTHS = (64, 256, 512, 1024)
SPEC_STEPS = 16
SPEC_K = 4
#: the speculative runs' cloud is the serving phase's qwen1.5-0.5b with
#: its layer matrices scaled by ``SPEC_GAIN``: at the init scale a
#: tied-embedding model's greedy token is its input token, so every draft
#: is accepted; scaled, the trunk picks the token
SPEC_GAIN = 3.0
GAINED = ("wq", "wk", "wv", "wo", "wi", "wg")
DENSE_PROMPT = 1024
DENSE_NEW = 16
DENSE_LAYERS = 2
#: the reference's own bounds (``tests/test_quantize.py``), relative to
#: the largest logit: int8-KV decode logits against the f32 cache's, and
#: int8-weight logits against the f32 model's
INT8_KV_RTOL = 0.02
INT8_WEIGHT_RTOL = 0.06
#: a shorter hold for sweeps over many small flash shapes: it covers the
#: enqueue of a few dozen launches
SHORT_HOLD_CYCLES = 20_000_000
#: the families phase: mamba2's and hymba's prompt lengths (multiples of
#: the 256-token SSD chunk, as ``ssd_chunked`` requires above one chunk),
#: decode steps, the 2-layer card-vs-host prompt, whisper's decoder
#: prompt, internvl2's text behind its 256 image tokens, and the depth
#: phi3.5-moe is cut to (its 32 layers would be 167 GB in f32)
FAMILY_LENGTHS = (256, 512, 768, 1024)
FAMILY_NEW = 16
FAMILY_HOST_PROMPT = 256
WHISPER_PROMPT = 64
INTERNVL2_TEXT = 768
PHI_LAYERS = 2
#: granite-moe at full depth, flash against chunked prefill logits: the
#: attention paths differ by ~1e-6 in f32, and across 24 layers x 32
#: experts that moves some router near-ties to the other side of the
#: top-8 (and so which choices pass an expert's capacity), each moving
#: that token's hidden state by a few percent; tokens keep the near-tie
#: rule at ``LOGIT_ATOL``
MOE_LOGIT_ATOL = 5e-2
#: mamba2 (64 layers): decode steps (the per-token recurrence) against
#: the forward's logits (the chunked dual form), relative to the largest
#: logit; and one layer's ``ssd_chunked`` against ``ssd_reference`` at
#: full width (80 heads of 64, N 128, S 1,024), relative to the largest
#: output and state: f32 both, sums in another order
MAMBA_CHAIN_RTOL = 1e-3
SSD_RTOL = 1e-4
#: phase 13, the LLM training stack: full-width qwen1.5-0.5b trained
#: through ``launch/train.py``'s own functions (seed-0 weights drawn on
#: the card, the loader's seed-0 stream, AdamW under the launcher's
#: cosine schedule, every layer rematerialized), ``LLM_BATCH`` x
#: ``LLM_SEQ`` tokens a step for ``LLM_STEPS`` steps at ``LLM_LR``
LLM_ARCH = "qwen1.5-0.5b"
LLM_BATCH, LLM_SEQ, LLM_STEPS, LLM_LR = 8, 512, 30, 3e-4
#: one step at microbatches 2 against microbatches 1 on one state and
#: batch, loss and grad_norm relative: the same f32 sums taken over two
#: halves of the batch, then averaged
LLM_MICRO_RTOL = 1e-4
#: the same weights cut to 2 layers, one step on the card and on the
#: host at ``LLM_HOST_BATCH`` x ``LLM_HOST_SEQ``; and one step of every
#: reduced ``ASSIGNED`` config (2 x ``LLM_REDUCED_SEQ``), card against
#: host: f32 on both, sums in another order (loss absolute, grad_norm
#: relative)
LLM_HOST_BATCH, LLM_HOST_SEQ, LLM_REDUCED_SEQ = 2, 128, 32
LLM_LOSS_ATOL = 1e-4
LLM_GNORM_RTOL = 1e-4
#: the MoEs' loss, card against host: a router near-tie that falls the
#: other way sends one token to another expert (as ``MOE_LOGIT_ATOL``)
LLM_MOE_LOSS_ATOL = 1e-2
#: phase 15, multi-device: the full-fleet metropolis with its row axis
#: in ``FLEET_SHARDS`` shards on cuda:0, and the superstep program at the
#: cap slab over each of ``SHARD_COUNTS`` shards
FLEET_SHARDS = 4
SHARD_COUNTS = (1, 2, 4, 8)
#: full-width ``LLM_ARCH`` on a (1, 1) device mesh over a one-rank NCCL
#: group: ``MESH_STEPS`` train steps of ``LLM_BATCH`` x ``LLM_SEQ``
#: tokens against the same steps without a mesh (loss and grad_norm
#: relative: the same local operations, so bit for bit is expected),
#: ``REMAT_STEPS`` steps under ``remat_policy="dots"`` against remat
#: alone, and one ``MESH_PROMPT``-token prefill and ``MESH_NEW`` greedy
#: decode steps under the serve rules (flash attention on the local
#: heads) against the plain path
MESH_STEPS, REMAT_STEPS = 5, 2
MESH_RTOL = 1e-5
MESH_PROMPT, MESH_NEW = 1024, 16
#: the MoE on the same (1, 1) mesh: full-width granite-moe, its train
#: steps (of ``LLM_BATCH`` x ``LLM_SEQ``) and the same serve run
MESH_MOE_ARCH, MESH_MOE_STEPS = "granite-moe-1b-a400m", 3
#: the production-shape dry-runs (``launch/dryrun.py``), each a process
#: of its own started after the build and read in phase 15: qwen3-8b's
#: train step first (the longest), the reference test's three calls, the
#: reference's two MoE records on the multi mesh, and the decodes whose
#: caches are context-parallel (qwen3-8b, hymba, whisper)
DRYRUN_CALLS = [
    ("qwen3-8b", "train_4k", "single", ()),
    ("qwen1.5-0.5b", "long_500k", "single", ()),
    ("qwen1.5-0.5b", "long_500k", "multi", ()),
    ("qwen1.5-0.5b", "decode_32k", "single", ("--kv-dtype", "int8",
                                              "--serve-1d")),
    ("granite-moe-1b-a400m", "prefill_32k", "multi", ()),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", "multi", ()),
    ("qwen3-8b", "decode_32k", "single", ()),
    ("hymba-1.5b", "decode_32k", "single", ()),
    ("whisper-large-v3", "decode_32k", "single", ()),
]
#: seconds from the script's start by which every dry-run must be done
DRYRUN_DEADLINE_S = 1050.0
#: a decode record's collective bytes a device a step, and its FLOPs
#: against the per-device analytic count (relative)
DRYRUN_COLL_LIMIT = 100e6
DRYRUN_FLOPS_RTOL = 0.01


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(msg: str) -> None:
    print(f"== {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int, hold: int = HOLD_CYCLES) -> float:
    """Stream time per call of ``fn``: a held stream lets the host enqueue
    all ``reps`` calls before the first runs."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_within_gate(what: str, got: dict, want: dict) -> None:
    """The card's summary against the CPU's where they differ (floats
    summed in another order): every differing key must carry a
    ``GATE_BANDS`` band and lie within it; counts must match exactly."""
    diff = {k: (got.get(k), want[k]) for k in want if got.get(k) != want[k]}
    print(f"differing keys (cuda, cpu): {diff}", flush=True)
    for k, (g, w) in diff.items():
        if k not in GATE_BANDS:
            fail(f"{what} {k} differs between cuda and cpu and has no "
                 f"band: {g} vs {w}")
        kind, band, floor = GATE_BANDS[k]
        tol = band if kind == "abs" else max(band * abs(w), floor)
        if not abs(g - w) <= tol:
            fail(f"{what} {k}: cuda {g} vs cpu {w} outside +-{tol}")


def max_err(got, want) -> float:
    """Largest absolute difference over matching output tensors."""
    return max(float((g.double() - w.double()).abs().max()) if g.numel()
               else 0.0 for g, w in zip(got, want))


def check_triage(torch, T, ops, dev) -> None:
    """Kernel == plain version on the card, integers exactly."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def same(got, want, what):
        for a, b in zip(got, want):
            if not torch.equal(a, b.to(a.device)):
                fail(f"triage {what}: kernel and plain version differ")

    def case(rows, n, capacities, what, pad_rows=0, nan=False, offset=0):
        conf = torch.rand((rows, n), generator=g)
        if pad_rows:
            conf[-pad_rows:] = -1.0
        if nan:
            conf[0, :3] = float("nan")
        thr = torch.stack([0.5 + 0.5 * torch.rand(rows, generator=g),
                           0.45 * torch.rand(rows, generator=g)], dim=1)
        conf, thr = conf.to(dev), thr.to(dev)
        if offset:  # the same values `offset` floats into a larger buffer
            conf = torch.cat([conf.new_zeros(offset), conf.flatten()])[
                offset:].view(rows, n)
            thr = torch.cat([thr.new_zeros(offset), thr.flatten()])[
                offset:].view(rows, 2)
        for cap in capacities:
            same(T.triage_fleet(conf, thr, capacity=cap),
                 T.triage_fleet_torch(conf, thr, capacity=cap),
                 f"{what} capacity {cap}")

    case(64, 32, (64,), "64x32")
    case(64, 200, (4,), "capacity overflow")
    case(16, 40, (8,), "all-pad rows", pad_rows=5)
    case(8, 33, (8,), "NaN lanes", nan=True)
    case(1 << 17, 8, (8,), "2^17 rows")
    # every path of the kernel (a row's lanes in a lane, chunk walk)
    # at widths on and off the buckets, with NaN lanes, an all-pad row,
    # capacity 0 and overflow
    for n in TRIAGE_WIDTHS:
        for rows in TRIAGE_ROWS:
            case(rows, n, (0, max(1, n // 4), n), f"{rows}x{n}",
                 pad_rows=int(rows > 1), nan=n >= 3)
    # pointers the vector loads and the float2 thresholds cannot take
    case(64, 64, (0, 16, 64), "unaligned 64x64", offset=1)
    case(7, 128, (40,), "unaligned 7x128", offset=2)
    conf3 = torch.rand((3, 5, 21), generator=g)
    thr3 = torch.stack([0.5 + 0.5 * torch.rand((3, 5), generator=g),
                        0.45 * torch.rand((3, 5), generator=g)], dim=2)
    same(ops.triage_fleet(conf3, thr3, capacity=6, device=dev),
         ops.triage_fleet(conf3, thr3, capacity=6, device="cpu"),
         "3D Q=3 fold")
    one = torch.rand(13, generator=g)
    same(ops.triage_batched(one, alpha=0.7, beta=0.2, capacity=3,
                            device=dev),
         ops.triage_batched(one, alpha=0.7, beta=0.2, capacity=3,
                            device="cpu"), "one row (triage_batched)")


def label_rows(torch, rows: int, n: int, seed: int):
    """Scores/truths from a known logistic, with degenerate rows: too few
    labels, one class only, and all pad."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = 0.02 + 0.96 * torch.rand((rows, n), generator=g)
    logit = torch.log(s / (1 - s))
    p = torch.sigmoid(2.0 * logit + 0.5)
    truths = (torch.rand((rows, n), generator=g) < p).float()
    lengths = torch.randint(n // 4, n + 1, (rows,), generator=g)
    lengths[1] = 4                      # below min_count
    lengths[-1] = 0                     # all pad
    truths[2] = 1.0                     # one class only
    lane = torch.arange(n)[None, :]
    scores = torch.where(lane < lengths[:, None], s, -1.0)
    truths = torch.where(lane < lengths[:, None], truths, 0.0)
    return scores, truths


def check_calibrate(torch, C, dev) -> None:
    """Kernel vs plain version on the card: counts exact, params within
    CAL_ATOL, degenerate rows exactly (1, 0), on both paths (a warp a row
    up to 256 lanes, a block a row beyond)."""
    for n in CALIBRATE_WIDTHS:
        for rows in (4, 64):
            seed = rows if n == 256 else rows * n
            scores, truths = (t.to(dev) for t in label_rows(torch, rows, n,
                                                            seed))
            kp, kc = C.calibrate_fleet(scores, truths, iters=8, min_count=8)
            pp, pc = C.calibrate_fleet_torch(scores, truths, iters=8,
                                             min_count=8)
            what = f"calibrate R={rows} N={n}"
            if not torch.equal(kc.cpu(), pc.cpu()):
                fail(f"{what}: counts differ")
            err = float((kp - pp).abs().max())
            if not err <= CAL_ATOL:
                fail(f"{what}: params differ by {err} > {CAL_ATOL}")
            ident = torch.tensor([1.0, 0.0], device=dev)
            for r in (1, 2, rows - 1):
                if not torch.equal(kp[r], ident):
                    fail(f"{what}: degenerate row {r} fitted to "
                         f"{kp[r].tolist()}, not the identity")


def pixel_frames(torch, g, B: int, H: int, W: int, kind: str = "random"):
    """Three (B, H, W, 3) int32 frames in [0, 255] on the CPU.  ``sparse``:
    a flat scene where only camera 0 has a moving block; ``static``: three
    copies of one random frame."""
    if kind == "random":
        return [torch.randint(0, 256, (B, H, W, 3), generator=g,
                              dtype=torch.int32) for _ in range(3)]
    if kind == "static":
        f = torch.randint(0, 256, (B, H, W, 3), generator=g,
                          dtype=torch.int32)
        return [f, f.clone(), f.clone()]
    base = torch.full((B, H, W, 3), 30, dtype=torch.int32)
    f1 = base.clone()
    f1[0, H // 3:H // 3 + 16, W // 2:W // 2 + 16] = 200
    return [base, f1, base.clone()]


def check_pixel(torch, FD, MO, PC, ops, dev) -> None:
    """Kernels == plain versions on the card, exactly (integers), and the
    fused cascade == the staged framediff -> dilate -> erode launches."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def same(what, got, want):
        for a, b in zip(got, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"pixel {what}: kernel and plain version differ")

    def case(fs, threshold, what):
        fs = [f.to(dev) for f in fs]
        kw = dict(threshold=threshold, maxval=255)
        fused = PC.pixel_cascade(*fs, **kw)
        same(f"cascade {what}", fused, PC.pixel_cascade_torch(*fs, **kw))
        fd = FD.framediff(*fs, **kw)
        same(f"framediff {what}", (fd,), (FD.framediff_torch(*fs, **kw),))
        di = MO.dilate3x3(fd)
        same(f"dilate {what}", (di,),
             (MO.morph3x3_torch(fd, op="max", fill=0),))
        er = MO.erode3x3(di, 255)
        same(f"erode {what}", (er,),
             (MO.morph3x3_torch(di, op="min", fill=255),))
        staged = ops.pixel_cascade(*fs, threshold=threshold, fused=False,
                                   device=dev)
        same(f"fused vs staged {what}", fused, staged)
        same(f"fused vs staged mask {what}", (fused[0],), (er,))
        return fused

    for i, (B, H, W) in enumerate(PIXEL_SHAPES):
        for threshold in (0, 40, 200):
            case(pixel_frames(torch, g, B, H, W), threshold,
                 f"{(B, H, W)} threshold {threshold}")
    _, counts = case(pixel_frames(torch, g, 2, 96, 128, "sparse"), 40,
                     "sparse motion")
    if not (int(counts[0]) > 0 and int(counts[1]) == 0):
        fail(f"pixel sparse motion: counts {counts.tolist()}")
    mask, counts = case(pixel_frames(torch, g, 2, 40, 50, "static"), 0,
                        "static scene")
    if bool(mask.any()) or bool(counts.any()):
        fail("pixel static scene: foreground on a motionless scene")
    for shape in PIXEL_TILE_SHAPES:
        case(pixel_frames(torch, g, *shape), 40, f"tile edge {shape}")
    u8 = [f.to(torch.uint8) for f in pixel_frames(torch, g, 3, 96, 128)]
    same("uint8 frames",
         [t.cpu() for t in ops.pixel_cascade(*u8, device=dev)],
         ops.pixel_cascade(*u8, device="cpu"))
    # the views detect passes: uint8 camera slices of one (B, 3, H, W, 3)
    # batch, a camera stride of three frames; the kernel against the plain
    # version on the same views and on the int32 frames they widen to
    kw = dict(threshold=40, maxval=255)
    for shape in PIXEL_SHAPES + PIXEL_TILE_SHAPES:
        views = camera_views(torch, g, *shape, dev)
        want = PC.pixel_cascade_torch(*(v.to(torch.int32) for v in views),
                                      **kw)
        same(f"uint8 views {shape}", PC.pixel_cascade(*views, **kw), want)
        same(f"uint8 views {shape} (plain)",
             PC.pixel_cascade_torch(*views, **kw), want)
        same(f"ops on uint8 views {shape}",
             ops.pixel_cascade(*views, device=dev), want)
    # the count words left zeroed: consecutive calls, then more cameras
    # than any call before (a grown workspace), then fewer again
    for i, B in enumerate((2, 2, 2, 9, 3)):
        views = camera_views(torch, g, B, 96, 128, dev)
        same(f"call {i} ({B} cameras)", PC.pixel_cascade(*views, **kw),
             PC.pixel_cascade_torch(*views, **kw))
    # more frames than CUDA's grid z limit: blocks loop over cameras
    x = (torch.randint(0, 2, (65537, 5, 7), generator=g,
                       dtype=torch.int32) * 255).to(dev)
    for op, fill in (("max", 0), ("min", 255)):
        same(f"morph3x3 {op} on {tuple(x.shape)}",
             (MO.morph3x3(x, op=op, fill=fill),),
             (MO.morph3x3_torch(x, op=op, fill=fill),))
    _, counts = case(pixel_frames(torch, g, *HD), 40, f"1080p {HD}")
    views = camera_views(torch, g, *HD, dev)
    same(f"uint8 views {HD}", PC.pixel_cascade(*views, **kw),
         PC.pixel_cascade_torch(*views, **kw))
    print(f"pixel kernels exact at {len(PIXEL_SHAPES)} shapes x 3 "
          f"thresholds, sparse, static, {len(PIXEL_TILE_SHAPES)} tile-edge "
          f"shapes, uint8 frames and camera views, 5 consecutive calls, "
          f"morph3x3 on 65,537 frames and {HD} (foreground "
          f"{counts.tolist()})", flush=True)


def camera_views(torch, g, B: int, H: int, W: int, dev):
    """The three uint8 frames ``detect`` passes: camera slices ``batch[:,
    k]`` of one random (B, 3, H, W, 3) uint8 batch on ``dev``."""
    batch = torch.randint(0, 256, (B, 3, H, W, 3), generator=g,
                          dtype=torch.uint8).to(dev)
    return [batch[:, k] for k in range(3)]


def tick_views(torch, rec):
    """The cascade's largest recorded input (``rec``, a ``Recorder``) laid
    out as the main path passed it: the three frames stacked into one
    (B, 3, H, W, 3) batch and sliced again, whose strides must be the
    recorded ones.  Returns (views, keywords)."""
    key = max(rec.inputs, key=lambda s: s[0] * s[1] * s[2])
    *frames, kw = rec.inputs[key]
    views = [v for v in torch.stack(frames, dim=1).unbind(1)]
    got = [(tuple(v.stride()), v.dtype) for v in views]
    if got != rec.layouts[key]:
        fail(f"pixel_city's cascade input {key} was laid out as "
             f"{rec.layouts[key]}, rebuilt as {got}")
    return views, kw


def device_ops(torch, fn) -> list:
    """The names of the device operations (kernels, copies, memsets) of
    one call of ``fn``, warmed up first, under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def parent_tick(torch, PC, views, kw):
    """The five device operations a tick made before the cascade read
    uint8 views: each view widened to a contiguous int32 copy, a zeroed
    ``counts``, and the kernel on the copies."""
    wide = [v.to(torch.int32) for v in views]
    torch.zeros((wide[0].shape[0],), dtype=torch.int32, device=wide[0].device)
    return PC.pixel_cascade(*wide, **kw)


class StageClock:
    """Wraps ``module.attr`` to add its synchronised wall time to
    ``seconds`` (``label_components``: the CCL share of framediff_s)."""

    def __init__(self, torch, module, attr: str):
        self.torch, self.module, self.attr = torch, module, attr
        self.inner = getattr(module, attr)
        self.seconds, self.calls = 0.0, 0

    def __enter__(self):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = self.inner(*args, **kw)
            if out.is_cuda:
                self.torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.inner)


def count_batches(model) -> list:
    """Record the token shape of every call of ``model`` (one classifier
    batch each) in the returned list."""
    shapes = []
    inner = model.forward

    def counted(tokens):
        shapes.append(tuple(tokens.shape))
        return inner(tokens)
    model.forward = counted
    return shapes


def stream_diff(got, want) -> float:
    """Max |conf| difference of two item streams whose other fields must
    be identical."""
    if len(got) != len(want):
        fail(f"pixel_city streams differ in length: {len(got)} vs "
             f"{len(want)}")
    for a, b in zip(got, want):
        for f in ("t_arrival", "camera", "edge_device", "is_query",
                  "nbytes"):
            if getattr(a, f) != getattr(b, f):
                fail(f"pixel_city streams differ in {f}: {a} vs {b}")
    return max((abs(a.conf - b.conf) for a, b in zip(got, want)),
               default=0.0)


def pixel_bound_ms(name: str, shape, dtype=None) -> tuple:
    """Least time for ``name`` over (B, H, W) pixels: bytes over HBM rate
    or integer operations over the scalar rate, whichever is larger; the
    cascade's bytes follow its frames' ``dtype``."""
    if name == "pixel_cascade" and str(dtype) == "torch.uint8":
        name = "pixel_cascade_uint8"
    px = shape[0] * shape[1] * shape[2]
    t_b = px * PIXEL_BYTES[name] / HBM_BYTES_S
    t_o = px * PIXEL_OPS[name] / F32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


class Recorder:
    """Wraps a kernel wrapper to keep the first input of every distinct
    first-argument shape the main path gives it (copies of the tensors,
    then the keywords, for timing afterwards; the strides and dtypes the
    tensors came with in ``layouts``) and count the calls of each
    (``counts``); with ``keep_all`` also every call's input, in order, in
    ``calls``."""

    def __init__(self, module, attr: str, keep_all: bool = False):
        self.module, self.attr = module, attr
        self.inputs = {}
        self.layouts = {}
        self.counts = {}
        self.keep_all = keep_all
        self.calls = []

    def __enter__(self):
        self.inner = getattr(self.module, self.attr)

        def wrapped(*args, **kw):
            key = tuple(args[0].shape)
            self.counts[key] = self.counts.get(key, 0) + 1
            self.layouts.setdefault(key, [(tuple(a.stride()), a.dtype)
                                          for a in args])
            if key not in self.inputs or self.keep_all:
                copy = (*(a.clone() for a in args), kw)
                self.inputs.setdefault(key, copy)
                if self.keep_all:
                    self.calls.append(copy)
            return self.inner(*args, **kw)
        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.inner)


def triage_bound_ms(rows: int, n: int) -> tuple:
    nbytes = rows * n * 12 + rows * 12
    ops = rows * n * 4
    return max(nbytes / HBM_BYTES_S, ops / F32_FLOP_S) * 1e3, \
        "bytes" if nbytes / HBM_BYTES_S >= ops / F32_FLOP_S else "operations"


def calibrate_bound_ms(rows: int, n: int, iters: int) -> tuple:
    nbytes = rows * n * 8 + rows * 12
    ops = rows * n * (8 + 20 * iters)   # prologue + one Newton step a lane
    t_b, t_o = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def superstep_slab(torch, g, S: int, R: int, N: int, mask: str = "random"):
    """A superstep input on the CPU: confidences with pad lanes, start
    thresholds, a tick mask (``random``, all ``off`` or all ``on``), and
    drains below, at and above the interval."""
    conf = torch.rand((S, R, N), generator=g)
    lengths = torch.randint(0, N + 1, (S, R), generator=g)
    conf[torch.arange(N)[None, None, :] >= lengths[..., None]] = -1.0
    th0 = torch.stack([0.5 + 0.5 * torch.rand(R, generator=g),
                       0.45 * torch.rand(R, generator=g)], dim=1)
    masks = {"random": lambda: torch.rand((S, R), generator=g) < 0.6,
             "off": lambda: torch.zeros((S, R), dtype=torch.bool),
             "on": lambda: torch.ones((S, R), dtype=torch.bool)}
    interval = 0.1
    drain = 0.3 * torch.rand(R, generator=g)
    drain[: R // 4] = interval
    gains = torch.tensor([0.05, 0.2, 0.3, interval])
    return conf, th0, masks[mask](), drain, gains


def same_superstep(torch, SS, args) -> None:
    """Kernel == plain version on one input, every output bit for bit."""
    *ts, kw = args
    got, want = SS.superstep(*ts, **kw), SS.superstep_torch(*ts, **kw)
    for a, b, what in zip(got, want, ("routes", "slots", "ths")):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"superstep {what} differ from the plain version at "
                 f"{tuple(ts[0].shape)}")


def check_superstep(torch, SS, dev) -> None:
    g = torch.Generator(device="cpu").manual_seed(2)
    cases = [(shape, 8, "random") for shape in SUPERSTEP_SHAPES]
    cases += [((5, 64, 8), 8, "off"), ((5, 64, 8), 8, "on"),
              ((3, 32, 40), 3, "on")]            # the last overflows
    for (S, R, N), capacity, mask in cases:
        ins = [t.to(dev) for t in superstep_slab(torch, g, S, R, N, mask)]
        same_superstep(torch, SS, (*ins, {"capacity": capacity}))
    print(f"superstep bit-exact at {SUPERSTEP_SHAPES}, masks off/on and "
          f"capacity overflow", flush=True)


def assoc_problem(torch, F, g, m: int, k: int, d: int, nq: int = 2):
    emb = F.normalize(torch.randn((m, d), generator=g), dim=1)
    trk = F.normalize(torch.randn((k, d), generator=g), dim=1)
    cq = torch.randint(0, nq, (m,), generator=g, dtype=torch.int32)
    tq = torch.randint(0, nq, (k,), generator=g, dtype=torch.int32)
    thr = -0.5 + 1.4 * torch.rand(m, generator=g)
    return emb, trk, cq, tq, thr


def assoc_diff(torch, got, want) -> float:
    """``assign`` must be equal; returns max |sim difference|."""
    if not torch.equal(got[0].cpu(), want[0].cpu()):
        flips = int((got[0].cpu() != want[0].cpu()).sum())
        fail(f"associate: {flips} assignments differ from the plain "
             f"version")
    return float((got[1].cpu() - want[1].cpu()).abs().max()) \
        if got[1].numel() else 0.0


def assoc_cases(torch) -> dict:
    """``tests/torch_kernel_cases.py``'s association problems whose greedy
    order the kernel's claim shortcuts must not change, as CPU tensors,
    with the plain version's ``assign``: name -> (emb, trk, crop_q, trk_q,
    thr, assign)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_kernel_cases import ASSOC_CASES
    return {name: (*(torch.from_numpy(a) for a in case[:5]), case[5])
            for name, case in ASSOC_CASES.items()}


def check_associate(torch, F, SIM, ops, dev) -> None:
    g = torch.Generator(device="cpu").manual_seed(3)
    problems = [assoc_problem(torch, F, g, *mkd) for mkd in ASSOC_SHAPES]
    problems.append(assoc_problem(torch, F, g, 4, 0, 8))          # K = 0
    emb, trk, cq, tq, thr = assoc_problem(torch, F, g, 6, 5, 8)
    cq[::2] = 7                      # a query that owns no track
    problems.append((emb, trk, cq, tq, torch.full((6,), -0.9)))
    trk = torch.tensor([[0.0, 1, 0, 0], [1, 0, 0, 0], [1, 0, 0, 0]])
    emb = torch.tensor([[1.0, 0, 0, 0], [1, 0, 0, 0]])
    tie = (emb, trk, torch.zeros(2, dtype=torch.int32),
           torch.zeros(3, dtype=torch.int32), torch.full((2,), 0.5))
    problems.append(tie)
    cases = assoc_cases(torch)
    problems += [c[:5] for c in cases.values()]
    err = 0.0
    for problem in problems:
        ins = [t.to(dev) for t in problem]
        err = max(err, assoc_diff(torch, SIM.associate(*ins),
                                  SIM.associate_torch(*ins)))
        err = max(err, assoc_diff(
            torch, ops.associate_tracks(*problem, device=dev),
            ops.associate_tracks(*problem, device="cpu")))
    if not err <= SIM_ATOL:
        fail(f"associate sim differs by {err} > {SIM_ATOL}")
    assign = SIM.associate(*(t.to(dev) for t in tie))[0].tolist()
    if assign != [1, 2]:
        fail(f"associate tie: {assign}, want the lowest index first [1, 2]")
    for name, (*problem, want) in cases.items():
        got = SIM.associate(*(t.to(dev) for t in problem))[0].tolist()
        if got != want:
            fail(f"associate {name}: {got}, want {want}")
    print(f"associate exact at {ASSOC_SHAPES}, K=0, a masked query, a tie "
          f"and {sorted(cases)}; sim within {err:.3g}", flush=True)


def qkv(torch, g, shape, dtype, dev):
    B, H, KV, Sq, Sk, hd = shape
    return [torch.randn(sh, generator=g).to(dtype).to(dev)
            for sh in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd))]


def flash_diff(torch, FA, q, k, v, causal: bool) -> float:
    """Max |kernel - plain|; fails outside the dtype's tolerance."""
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_torch(q, k, v, causal)
    tol = FLASH_ATOL[str(q.dtype).split(".")[1]]
    if got.dtype != q.dtype or got.shape != q.shape:
        fail(f"flash_attention gave {got.dtype} {tuple(got.shape)} for "
             f"{q.dtype} {tuple(q.shape)}")
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        fail(f"flash_attention differs from its plain version at q "
             f"{tuple(q.shape)} k {tuple(k.shape)} {q.dtype} causal="
             f"{causal}: max err {float((got.float() - want.float()).abs().max())}")
    return float((got.float() - want.float()).abs().max())


def check_flash(torch, FA, dev) -> None:
    g = torch.Generator(device="cpu").manual_seed(4)
    errs = {}
    for dtype, shapes in ((torch.float32, FLASH_SHAPES),
                          (torch.bfloat16, FLASH_BF16_SHAPES)):
        for shape in shapes:
            q, k, v = qkv(torch, g, shape, dtype, dev)
            for causal in (True, False):
                errs[(str(dtype), shape, causal)] = flash_diff(
                    torch, FA, q, k, v, causal)
    # the model's layout: a transposed (B, S, H, hd) view goes in as it is
    q, k, v = qkv(torch, g, FLASH_SHAPES[5], torch.float32, dev)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    if not torch.equal(FA.flash_attention(*views), FA.flash_attention(q, k, v)):
        fail("flash_attention on (B, S, H, hd) views differs from the "
             "contiguous input")
    for dt in ("torch.float32", "torch.bfloat16"):
        worst = max((e, key) for key, e in errs.items() if key[0] == dt)
        print(f"flash_attention {dt}: within {FLASH_ATOL[dt[6:]]} at "
              f"{sum(key[0] == dt for key in errs)} (shape, causal) cases, "
              f"max err {worst[0]:.3g} at {worst[1][1:]}", flush=True)


def flash_bound_ms(shape, nbytes_el: int, causal: bool = True) -> dict:
    """Least time for one attention call: 4 operations per (query, visible
    key, head-dim lane) — QK^T and PV — or q, k, v and o moved once over
    HBM, whichever takes longer.  ``ms``/``by``: the operations as three
    TF32 products each on the tensor cores (the kernel's split TF32), or
    in bf16 (2-byte elements) as one bf16 product;
    ``f32_simt_ms``: as f32 operations outside the tensor cores; and the
    bytes bound alone."""
    B, H, KV, Sq, Sk, hd = shape
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    ops = 4 * B * H * hd * pairs
    nbytes = (2 * B * H * Sq + 2 * B * KV * Sk) * hd * nbytes_el
    t_tc = 3 * ops / TF32_FLOP_S if nbytes_el == 4 else ops / BF16_FLOP_S
    t_b, t_o = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
    return {"ms": max(t_b, t_tc) * 1e3,
            "by": "bytes" if t_b >= t_tc else "operations",
            "f32_simt_ms": max(t_b, t_o) * 1e3, "bytes_ms": t_b * 1e3}


class ServeTap:
    """Wraps one ``CascadeServer``'s engine for a run: per request the
    prefill logits and the top-2 logit margin of every greedy step (the
    prefill's, then one a decode tick), and the seconds and tokens of
    prefill (admissions) and decode (ticks).  ``admit`` and ``step``
    already wait for the device (they read the argmax back)."""

    def __init__(self, torch, TR, engine):
        self.torch, self.TR, self.engine = torch, TR, engine
        self.logits, self.margins = {}, {}
        self.prefill_s = self.decode_s = 0.0
        self.prefill_tokens = self.decode_tokens = self.prefills = 0

    def margin(self, logits):
        top = self.torch.topk(logits.float(), 2, dim=-1).values
        return (top[..., 0] - top[..., 1]).tolist()

    def __enter__(self):
        TR, eng = self.TR, self.engine
        self.orig = (TR.prefill, TR.decode_step)
        admit, step, last = eng.admit, eng.step, {}

        def prefill(*a, **kw):
            out = self.orig[0](*a, **kw)
            last["prefill"] = out[0]
            return out

        def decode(*a, **kw):
            out = self.orig[1](*a, **kw)
            last["decode"] = out[0]
            return out

        def timed_admit(req):
            t0 = time.perf_counter()
            ok = admit(req)
            self.prefill_s += time.perf_counter() - t0
            if ok:
                self.prefills += 1
                self.prefill_tokens += len(req.tokens)
                self.logits[req.rid] = last["prefill"][0].float().cpu()
                self.margins[req.rid] = self.margin(last["prefill"][0:1])
            return ok

        def timed_step():
            rids = [s.rid for s in eng.slots]
            t0 = time.perf_counter()
            done = step()
            self.decode_s += time.perf_counter() - t0
            for rid, m in zip(rids, self.margin(last["decode"])):
                if rid >= 0:
                    self.margins[rid].append(m)
                    self.decode_tokens += 1
            return done

        TR.prefill, TR.decode_step = prefill, decode
        eng.admit, eng.step = timed_admit, timed_step
        return self

    def __exit__(self, *exc):
        self.TR.prefill, self.TR.decode_step = self.orig
        del self.engine.admit, self.engine.step


def same_tokens(what: str, got, want, margins) -> list:
    """Token rows (tensors, arrays or lists) equal, or differing first where the
    plain run's (``want``'s) top-2 margin is below ``LOGIT_ATOL``, after
    which a flip is allowed.  Returns the flips, [(position, margin)]."""
    g, w = (list(t) if isinstance(t, list) else t.flatten().tolist()
            for t in (got, want))
    if g == w:
        return []
    k = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
             min(len(g), len(w)))
    margin = margins[k] if k < len(margins) else float("inf")
    print(f"{what}: first differs at step {k}: {g[k:k + 3]} vs "
          f"{w[k:k + 3]}, top-2 margin {margin:.3g} in the plain run",
          flush=True)
    if len(g) != len(w) or not margin < LOGIT_ATOL:
        fail(f"{what}: tokens differ at step {k} where the plain run's "
             f"top-2 margin {margin} is not below {LOGIT_ATOL}")
    return [(k, margin)]


def edge_thresholds(torch, edge_cfg, edge, prompts, n_edge: int,
                    min_gap: float) -> dict:
    """Thresholds halfway between the edge model's confidences in the
    prompts (computed on ``edge``'s device): the ``n_edge`` most confident
    accepted at the edge, the ``n_edge`` least rejected, the rest to the
    cloud.  Fails where a split lies within ``min_gap``."""
    from repro_torch.core import cascade as CC
    from repro_torch.models import transformer as TR
    dev = edge["embed"].device
    with torch.no_grad():
        conf = sorted(float(CC.confidence_from_logits(TR.classify(
            edge_cfg, edge, TR.forward(edge_cfg, edge, torch.as_tensor(
                p).long()[None].to(dev))[0]))[0]) for p in prompts)
    k = n_edge
    gaps = (conf[-k] - conf[-k - 1], conf[k] - conf[k - 1])
    if not min(gaps) > min_gap:
        fail(f"edge confidences too close to split robustly: {conf}")
    return dict(alpha=(conf[-k - 1] + conf[-k]) / 2,
                beta=(conf[k - 1] + conf[k]) / 2)


def same_serving(what: str, got: dict, want: dict, got_tap, want_tap,
                 logit_atol: float = LOGIT_ATOL) -> dict:
    """Routes equal; a cloud request's tokens equal up to the first step
    whose top-2 margin in the plain run (``want``) is below
    ``LOGIT_ATOL``, where a flip is allowed; prefill logits within
    ``logit_atol``.  Returns what was compared."""
    if sorted(got) != sorted(want):
        fail(f"{what}: answered requests {sorted(got)} vs {sorted(want)}")
    ties, logit_err = [], 0.0
    for rid in sorted(want):
        g, w = got[rid], want[rid]
        if g.route != w.route:
            fail(f"{what}: request {rid} routed {g.route} vs {w.route}")
        margins = []
        if w.route == "cloud":
            logit_err = max(logit_err, float(
                (got_tap.logits[rid] - want_tap.logits[rid]).abs().max()))
            margins = want_tap.margins[rid]
        ties += [(rid, *flip) for flip in same_tokens(
            f"{what}: request {rid}", g.output, w.output, margins)]
    if not logit_err <= logit_atol:
        fail(f"{what}: prefill logits differ by {logit_err} > {logit_atol}")
    min_margin = min(m for rid, ms in want_tap.margins.items() for m in ms)
    print(f"{what}: same routes and tokens ({len(ties)} near-tie flips), "
          f"prefill logits within {logit_err:.3g}, smallest top-2 margin "
          f"{min_margin:.3g}", flush=True)
    return {"prefill_logits_max_abs_err": logit_err, "near_tie_flips": ties,
            "min_top2_margin": min_margin}


class TickAudit:
    """Wraps ``TrackStage.tick`` to check the launch budget tick by tick:
    exactly one associate launch where the tick has crops and a live
    track table, none elsewhere."""

    def __init__(self, TK, SIM):
        self.TK, self.SIM = TK, SIM
        self.inner = TK.TrackStage.tick
        self.ticks = self.expected = self.bad = 0

    def __enter__(self):
        audit = self

        def wrapped(stage, t, batches):
            crops = any(it.emb is not None for b in batches.values()
                        for it in b)
            live = any(tr.last_seen >= t - stage.sc.track_ttl_s
                       for tr in stage.tracks.values())
            before = audit.SIM.LAUNCHES
            out = audit.inner(stage, t, batches)
            want = int(crops and live)
            audit.ticks += 1
            audit.expected += want
            audit.bad += int(audit.SIM.LAUNCHES - before != want)
            return out
        self.TK.TrackStage.tick = wrapped
        return self

    def __exit__(self, *exc):
        self.TK.TrackStage.tick = self.inner


def superstep_bound_ms(S: int, R: int, N: int) -> tuple:
    nbytes = S * R * N * 12 + S * R * 9 + R * 12
    ops = S * R * N * 4 + S * R * 6
    t_b, t_o = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def associate_bound_ms(M: int, K: int, D: int) -> tuple:
    nbytes = (M + K) * D * 4 + M * 8 + K * 4 + M * 8
    ops = 2 * M * K * D
    t_b, t_o = nbytes / HBM_BYTES_S, ops / F32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def time_shapes(torch, inputs: dict, counts: dict, kernel, bound,
                reps: int, floor_ms: float) -> dict:
    """Per main-path shape (``inputs``: shape -> one recorded input, the
    tensors then the keywords; ``counts``: shape -> launches on the main
    paths): the kernel's stream ms on that input, its bound and the
    bound's share of the time, and the time over ``floor_ms`` (the empty
    launch's ms); and the run's sums, launches x ms."""
    rows = []
    for shape in sorted(inputs):
        *ts, kw = inputs[shape]
        ms = device_ms(torch, lambda: kernel(*ts, **kw), reps)
        b_ms, by = bound(*shape)
        rows.append({"shape": list(shape), "launches": counts[shape],
                     "ms": ms, "bound_ms": b_ms, "bound_by": by,
                     "share_of_bound": b_ms / ms,
                     "over_floor_ms": ms - floor_ms})
    run = {key: sum(r["launches"] * r[key] for r in rows)
           for key in ("ms", "bound_ms")}
    run["launches"] = sum(r["launches"] for r in rows)
    return {"run": run, "shapes": rows}


def time_pixel_kernels(torch, F, FD, MO, PC, dev, recorders: dict,
                       counts: dict, tick: tuple, tick_ops: int,
                       parent_ops: int, floor_ms: float) -> list:
    """The ``{"kernels": [...]}`` rows of the three pixel kernels.  The
    cascade is timed on ``tick`` (the uint8 camera views ``pixel_city``
    passed it, and its keywords; ``tick_ops`` device operations a call),
    on the same frames widened to int32, at ``HD`` in int32 and on uint8
    views, and beside the sequence that widened the views first
    (``parent_tick``, ``parent_ops`` device operations); framediff and the
    dilate binding of morph3x3 on the largest input the staged run gave
    each (``recorders``) and at ``HD``.
    Every recorded input is first re-checked against the plain version.
    ``counts`` holds each path's launches."""
    g = torch.Generator(device="cpu").manual_seed(1)
    hd = [f.to(dev) for f in pixel_frames(torch, g, *HD)]
    hd_views = list(torch.stack([f.to(torch.uint8) for f in hd],
                                dim=1).unbind(1))
    fd_kw = dict(threshold=40, maxval=255)
    dilate_kw = dict(op="max", fill=0)
    specs = {   # name: (source, TPU kernel, kernel, plain, 1080p args)
        "pixel_cascade": ("pixel_cascade.cu", "pixel_cascade.py:151",
                          PC.pixel_cascade, PC.pixel_cascade_torch,
                          (*hd, fd_kw)),
        "framediff": ("framediff.cu", "framediff.py:55", FD.framediff,
                      FD.framediff_torch, (*hd, fd_kw)),
        "morph3x3": ("morphology.cu", "morphology.py:96", MO.morph3x3,
                     MO.morph3x3_torch,
                     (FD.framediff(*hd, **fd_kw), dilate_kw)),
    }

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def check(name, kernel, plain, args) -> float:
        *ts, kw = args
        got, want = as_tuple(kernel(*ts, **kw)), as_tuple(plain(*ts, **kw))
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                fail(f"{name} differs from its plain version at "
                     f"{tuple(ts[0].shape)} {ts[0].dtype}")
        return max_err(got, want)

    def measure(name, kernel, plain, args) -> dict:
        *ts, kw = args
        library_ms = None
        if name == "morph3x3":
            if kw != dilate_kw:
                fail(f"morph3x3 timed at {kw}, not the dilate binding")
            # the same dilate of a 0/255 mask: -inf padding == fill 0
            xf = ts[0].float()[:, None]
            if not torch.equal(F.max_pool2d(xf, 3, 1, 1)[:, 0],
                               plain(*ts, **kw).float()):
                fail("max_pool2d is not the dilate on this mask")
            library_ms = device_ms(torch, lambda: F.max_pool2d(xf, 3, 1, 1),
                                   100)
        bound, by = pixel_bound_ms(name, ts[0].shape, ts[0].dtype)
        ms = device_ms(torch, lambda: kernel(*ts, **kw), 100)
        return {"shape": list(ts[0].shape[:3]), "dtype": str(ts[0].dtype),
                "strides": list(ts[0].stride()),
                "max_abs_err": check(name, kernel, plain, args), "ms": ms,
                "plain_ms": device_ms(torch, lambda: plain(*ts, **kw), 10),
                "bound_ms": bound, "bound_by": by, "share_of_bound": bound / ms,
                "over_floor_ms": ms - floor_ms, "library_ms": library_ms}

    out = []
    for name, (source, replaces, kernel, plain, hd_args) in specs.items():
        rec = recorders[name]
        for args in rec.inputs.values():
            check(name, kernel, plain, args)
        if name == "pixel_cascade":
            views, kw = tick
            main = (*views, kw)
        else:
            main = rec.inputs[max(rec.inputs,
                                  key=lambda s: s[0] * s[1] * s[2])]
        by_path = {path: c["morphology" if name == "morph3x3" else name]
                   for path, c in counts.items()}
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **measure(name, kernel, plain, main),
            "library": "F.max_pool2d(x.float()[:, None], 3, 1, 1)"
            if name == "morph3x3" else None,
            "at_1080p": measure(name, kernel, plain, hd_args)}
        if name == "pixel_cascade":
            row["device_ops"] = tick_ops
            row["int32"] = measure(name, kernel, plain,
                                   (*(v.to(torch.int32) for v in views),
                                    kw))
            # the operations of parent_tick, timed as one unit
            row["widened_first"] = {**measure(
                name, lambda *v, **k: parent_tick(torch, PC, v, k), plain,
                (*views, kw)), "device_ops": parent_ops}
            row["at_1080p_uint8"] = measure(name, kernel, plain,
                                            (*hd_views, fd_kw))
            print("pixel cascade (B, H, W) dtype: ms, bound ms, share; "
                  + "; ".join(f"{k} {tuple(r['shape'])} {r['dtype']} "
                              f"{r['ms']:.5f} {r['bound_ms']:.5f} "
                              f"{r['share_of_bound']:.3f}"
                              for k, r in (("tick", row),
                                           ("int32", row["int32"]),
                                           ("widened first",
                                            row["widened_first"]),
                                           ("1080p", row["at_1080p"]),
                                           ("1080p uint8",
                                            row["at_1080p_uint8"]))),
                  flush=True)
        out.append(row)
    return out


def decode_tick_trace(torch, cfg, params, prompts) -> dict:
    """Where a decode tick's time goes: a ``DecodeEngine`` with every slot
    filled, two warm-up ticks, ``DECODE_TICKS`` ticks on the host clock,
    then as many under ``torch.profiler``.  The device is busy for the
    union of its kernel, copy and memset intervals; the idle share is the
    rest of the unprofiled tick.  The bound is the larger of the tick's
    bytes (every weight and the whole K/V cache read once) over the HBM
    rate and its FLOPs (the GEMMs, and attention over the whole cache) over
    the f32 rate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import meta as M
    from repro_torch.serving.engine import DecodeEngine, Request
    n, W = DECODE_TICKS, SERVE_LENGTHS[1] + SERVE_NEW
    eng = DecodeEngine(cfg, params, slots=SERVE_SLOTS, cache_len=W,
                       device="cuda")
    for i, p in enumerate(prompts[:SERVE_SLOTS]):
        if not eng.admit(Request(rid=i, tokens=p, max_new=4 * n)):
            fail("decode trace: a slot was not free")
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / n
    if eng.active != SERVE_SLOTS:
        fail(f"decode trace: {eng.active} of {SERVE_SLOTS} slots active")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    n_params = sum(t.numel() for _, t in M.leaves(params))
    cache_el = 2 * cfg.num_layers * SERVE_SLOTS * W * cfg.num_kv_heads * \
        cfg.head_dim
    t_b = 4 * (n_params + cache_el) / HBM_BYTES_S
    t_o = (2 * n_params * SERVE_SLOTS + 4 * cfg.num_layers * SERVE_SLOTS *
           cfg.num_heads * W * cfg.head_dim) / F32_FLOP_S
    busy_ms = busy_us / 1e3 / n if spans else None
    row = {"slots": SERVE_SLOTS, "cache_len": W, "ticks": n,
           "wall_ms_per_tick": wall_ms,
           "profiled_wall_ms_per_tick": profiled_ms,
           "device_busy_ms_per_tick": busy_ms,
           "device_ops_per_tick": len(spans) / n,
           "idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
           "bound_ms_per_tick": max(t_b, t_o) * 1e3,
           "bound_by": "bytes" if t_b >= t_o else "operations"}
    print(f"decode tick ({cfg.num_layers} layers, {SERVE_SLOTS} slots): "
          f"{json.dumps(row)}" + ("" if spans else
                                  "; device busy time not measured: the "
                                  "profiler recorded no device events"),
          flush=True)
    del eng
    return row


def serve_run(torch, bench: dict, cfg, params, device, zero_counts,
              read_counts):
    """One ``CascadeServer`` run of ``bench``'s prompts (the serving
    phase's edge model, thresholds and cache length) with ``cfg`` as the
    cloud model on ``device``, the launch counters zeroed just before and
    read just after.  Fails unless every cloud request had one prefill,
    flash launched layers x prefills times (on the card under flash, else
    never) and every request was answered in full.  Returns the results,
    the ``ServeTap`` and the run's row."""
    from repro_torch.core.thresholds import ThresholdState
    from repro_torch.models import transformer as TR
    from repro_torch.serving.engine import CascadeServer, Request
    prompts = bench["prompts"]
    srv = CascadeServer(bench["edge_cfg"], bench["edge"], cfg, params,
                        slots=SERVE_SLOTS, cache_len=bench["cache_len"],
                        device=device,
                        thresholds=ThresholdState(**bench["thresholds"]))
    reqs = [Request(rid=i, tokens=p, max_new=SERVE_NEW)
            for i, p in enumerate(prompts)]
    with ServeTap(torch, TR, srv.engine) as tap:
        zero_counts()
        t0 = time.perf_counter()
        res = srv.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    del srv
    routes = [res[i].route for i in range(len(prompts))]
    n_cloud = routes.count("cloud")
    row = {"wall_s": wall, "prefill_s": tap.prefill_s,
           "decode_s": tap.decode_s, "cloud_prefills": tap.prefills,
           "prefill_tokens": tap.prefill_tokens,
           "decode_tokens": tap.decode_tokens,
           "prefill_tok_s": tap.prefill_tokens / tap.prefill_s,
           "decode_tok_s": tap.decode_tokens / tap.decode_s,
           "split": {r: routes.count(r) for r in sorted(set(routes))},
           "flash_launches": counts["flash_attention"]}
    print(f"{cfg.num_layers} layers, {cfg.attn_impl}, kv "
          f"{cfg.kv_cache_dtype}, {device}: {json.dumps(row)}", flush=True)
    if tap.prefills != n_cloud or not 0 < n_cloud < len(prompts):
        fail(f"{n_cloud} cloud routes, {tap.prefills} prefills: want "
             f"one prefill a cloud request, and both edge and cloud")
    want = cfg.num_layers * n_cloud if cfg.attn_impl == "flash" and \
        torch.device(device).type == "cuda" else 0
    if counts["flash_attention"] != want:
        fail(f"flash launches {counts['flash_attention']} != {want} "
             f"({cfg.num_layers} layers x {n_cloud} cloud prefills)")
    for r in res.values():
        n = SERVE_NEW if r.route == "cloud" else 1
        if r.output is None or len(r.output) != n:
            fail(f"request {r.rid} ({r.route}) answered {r.output}")
    return res, tap, row


def serving_phase(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 9: ``CascadeServer`` on full-width qwen1.5-0.5b (24 layers,
    ``attn_impl="flash"``) behind its edge variant, ``SERVE_REQUESTS``
    prompts; against the same run under ``"chunked"`` on the card, and at
    ``num_layers=2`` against the host."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import meta as M
    t_phase = time.perf_counter()
    full = get_config("qwen1.5-0.5b")
    cloud_cfg = dataclasses.replace(full, attn_impl="flash")
    edge_cfg = full.edge_variant()
    if (cloud_cfg.num_layers, cloud_cfg.d_model, cloud_cfg.num_heads,
            cloud_cfg.num_kv_heads, cloud_cfg.head_dim, cloud_cfg.d_ff,
            cloud_cfg.vocab_size) != (24, 1024, 16, 16, 64, 2816, 151936):
        fail(f"qwen1.5-0.5b is not at full width: {cloud_cfg}")
    t0 = time.perf_counter()
    cloud = M.tree_map(lambda t: t.to(dev), M.init_params(
        cloud_cfg, torch.Generator().manual_seed(0)))
    edge = M.init_params(edge_cfg, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in M.leaves(cloud))
    g = torch.Generator().manual_seed(5)
    lo, hi = SERVE_LENGTHS
    lengths = torch.randint(lo, hi + 1, (SERVE_REQUESTS,), generator=g)
    lengths[0], lengths[1] = hi, lo
    prompts = [torch.randint(0, edge_cfg.vocab_size, (int(n),), generator=g)
               .to(torch.int32).numpy() for n in lengths]
    # thresholds halfway between the host's edge confidences: three
    # requests accepted and three rejected at the edge, ten to the cloud
    th = edge_thresholds(torch, edge_cfg, edge, prompts, 3, 1e-3)

    bench = {"edge_cfg": edge_cfg, "edge": edge, "prompts": prompts,
             "thresholds": th, "cache_len": hi + SERVE_NEW}

    def serve(cfg, params, device):
        return serve_run(torch, bench, cfg, params, device, zero_counts,
                         read_counts)

    recorded = Recorder(FA, "flash_attention")
    with recorded:
        res_f, tap_f, row_f = serve(cloud_cfg, cloud, "cuda")
    res_c, tap_c, row_c = serve(full, cloud, "cuda")
    cmp_chunked = same_serving("24 layers: flash vs chunked on the card",
                               res_f, res_c, tap_f, tap_c)
    tick = decode_tick_trace(torch, cloud_cfg, cloud, prompts)
    cut = dataclasses.replace(cloud_cfg, num_layers=2)
    cut_params = {**cloud, "layers": M.tree_map(lambda t: t[:2],
                                                cloud["layers"])}
    res_2, tap_2, row_2 = serve(cut, cut_params, "cuda")
    host_params = M.tree_map(lambda t: t.cpu(), cut_params)
    res_h, tap_h, row_h = serve(cut, host_params, "cpu")
    cmp_host = same_serving("2 layers: card vs host", res_2, res_h, tap_2,
                            tap_h)
    del cut_params
    phase_s = time.perf_counter() - t_phase
    print(f"serving phase {phase_s:.1f} s (parameter init {init_s:.1f} s), "
          f"{n_params} cloud parameters, prompt lengths "
          f"{lengths.tolist()}, thresholds {th}", flush=True)
    return {"recorder": recorded, "bench": bench, "cloud": cloud,
            "flash_tokens": {rid: [int(t) for t in r.output]
                             for rid, r in res_f.items()
                             if r.route == "cloud"},
            "phase_s": phase_s, "init_s": init_s,
            "cloud_params": n_params, "prompt_lengths": lengths.tolist(),
            "thresholds": th, "flash_24": row_f, "chunked_24": row_c,
            "flash_2_cuda": row_2, "host_2": row_h, "decode_tick": tick,
            "flash_vs_chunked": cmp_chunked, "card_vs_host_2": cmp_host}


class FlashClock:
    """Wraps ``flash_attention.flash_attention`` for a run: CUDA events
    just before and after every call (one kernel launch each), so
    ``ms()`` is the device time of the run's launches; ``dtypes`` counts
    the calls by q's dtype.  Enter it before a ``Recorder`` of the same
    function, so the recorder's copies fall outside the events."""

    def __init__(self, torch, FA):
        self.torch, self.FA = torch, FA
        self.events, self.dtypes = [], {}

    def __enter__(self):
        torch, inner = self.torch, self.FA.flash_attention
        self.inner = inner

        def timed(q, k, v, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = inner(q, k, v, **kw)
            b.record()
            self.events.append((a, b))
            self.dtypes[str(q.dtype)] = self.dtypes.get(str(q.dtype), 0) + 1
            return out
        self.FA.flash_attention = timed
        return self

    def __exit__(self, *exc):
        self.FA.flash_attention = self.inner

    def ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


class MarginTap:
    """Wraps ``transformer.prefill`` and ``decode_step`` for a run: the
    top-2 logit margin of row 0 after every call, in call order (for
    ``cloud_greedy_generate``, one a greedy token)."""

    def __init__(self, torch, TR):
        self.torch, self.TR, self.margins = torch, TR, []

    def __enter__(self):
        self.orig = (self.TR.prefill, self.TR.decode_step)

        def tapped(fn):
            def call(*a, **kw):
                out = fn(*a, **kw)
                top = self.torch.topk(out[0][0].float(), 2).values
                self.margins.append(float(top[0] - top[1]))
                return out
            return call
        self.TR.prefill, self.TR.decode_step = map(tapped, self.orig)
        return self

    def __exit__(self, *exc):
        self.TR.prefill, self.TR.decode_step = self.orig


def rel_gap(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def dense_family_phase(torch, dev, serving, zero_counts, read_counts
                       ) -> dict:
    """Phase 10: the rest of the dense serving family on the card.

    Speculative decoding with full-width qwen1.5-0.5b (24 layers, flash,
    its layer matrices scaled by ``SPEC_GAIN``) as the cloud and its edge
    variant, at the cloud's vocabulary, as the draft, on ``SPEC_LENGTHS``
    prompts: tokens equal to ``cloud_greedy_generate``'s on the card under
    the near-tie rule; the cloud drafting for itself accepts everything;
    flash launches 24 x the cloud prefills (twice that for the
    self-draft); at 2 layers the card's tokens equal the host's.  The int8 KV cache through ``CascadeServer``
    on the serving phase's prompts, one 1,024-token prefill and decode
    step within ``INT8_KV_RTOL`` of the f32 cache's, the card against the
    host at 2 layers.  int8 weights (``quantize_tree`` of the bf16 model):
    prefill logits within ``INT8_WEIGHT_RTOL`` of the f32 model's, 24 bf16
    flash launches, ``DENSE_NEW`` decode steps through ``DecodeEngine``.
    chatglm3-6b and command-r-35b at full width, cut to ``DENSE_LAYERS``
    layers: a ``DENSE_PROMPT``-token prefill and ``DENSE_NEW`` decode steps
    through ``DecodeEngine``, flash against chunked on the card."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import speculative as SP
    from repro_torch.distributed import quantize as QZ
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import meta as M
    from repro_torch.models import transformer as TR
    from repro_torch.serving.engine import DecodeEngine, Request
    t_phase = time.perf_counter()
    full = get_config("qwen1.5-0.5b")
    cloud_cfg = dataclasses.replace(full, attn_impl="flash")
    cloud, bench = serving["cloud"], serving["bench"]
    out = {"draw_s": {}}

    def on_host(tree):
        return M.tree_map(lambda t: t.cpu(), tree)

    # --- speculative decoding ------------------------------------------------
    # the draft reads the cloud's tokens, so it keeps the cloud's
    # vocabulary (edge_variant() alone cuts it to 512)
    draft_cfg = dataclasses.replace(full.edge_variant(),
                                    vocab_size=full.vocab_size)
    t0 = time.perf_counter()
    draft = M.tree_map(lambda t: t.to(dev), M.init_params(
        draft_cfg, torch.Generator().manual_seed(1)))
    torch.cuda.synchronize()
    out["draw_s"]["draft"] = time.perf_counter() - t0
    g = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, full.vocab_size, (1, n), generator=g)
               for n in SPEC_LENGTHS]

    def greedy_runs(cfg, params, device):
        toks, margins = [], []
        for p in prompts:
            with MarginTap(torch, TR) as tap:
                toks.append(SP.cloud_greedy_generate(
                    cfg, params, p.to(device), SPEC_STEPS).cpu())
            margins.append(tap.margins)
        return toks, margins

    spec_rec = Recorder(FA, "flash_attention")

    def spec_runs(what, edge_cfg, edge, cfg, params, device):
        toks, stats = [], []
        on_card = torch.device(device).type == "cuda"
        rec = spec_rec if on_card else contextlib.nullcontext()
        with FlashClock(torch, FA) as clock, rec:
            zero_counts()
            t0 = time.perf_counter()
            for p in prompts:
                o, st = SP.speculative_generate(
                    edge_cfg, edge, cfg, params, p.to(device),
                    steps=SPEC_STEPS, k=SPEC_K)
                toks.append(o.cpu())
                stats.append(st)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()["flash_attention"]
        rounds = sum(st.cloud_steps for st in stats)
        per_prefill = cfg.num_layers * (1 + (edge_cfg.attn_impl == "flash"))
        want = per_prefill * (len(prompts) + rounds) if on_card else 0
        row = {"wall_s": wall, "rounds": rounds,
               "proposed": sum(st.proposed for st in stats),
               "accepted": sum(st.accepted for st in stats),
               "acceptance": [st.acceptance_rate for st in stats],
               "tokens_per_cloud_step": [st.tokens_per_cloud_step
                                         for st in stats],
               "flash_launches": launches,
               "flash_device_ms": clock.ms() if on_card else None}
        print(f"speculative, {what}, {cfg.num_layers} layers, {device}: "
              f"{json.dumps(row)}", flush=True)
        if launches != want:
            fail(f"speculative ({what}): flash launches {launches} != {want}"
                 f" ({per_prefill} a prefill x {len(prompts)} + {rounds} "
                 f"cloud prefills)")
        return toks, stats, row

    spec_cloud = {**cloud, "layers": {
        block: {name: t * SPEC_GAIN if name in GAINED else t
                for name, t in leaves.items()}
        for block, leaves in cloud["layers"].items()}}
    greedy, margins = greedy_runs(cloud_cfg, spec_cloud, dev)
    out["greedy_distinct_tokens"] = [len(set(t.flatten().tolist()))
                                     for t in greedy]
    spec, _, out["speculative_24"] = spec_runs(
        "edge draft", draft_cfg, draft, cloud_cfg, spec_cloud, dev)
    flips = [f for i in range(len(prompts)) for f in same_tokens(
        f"speculative prompt {i}: card vs cloud-greedy", spec[i], greedy[i],
        margins[i])]
    self_spec, self_stats, out["self_draft_24"] = spec_runs(
        "self-draft", cloud_cfg, spec_cloud, cloud_cfg, spec_cloud, dev)
    flips += [f for i in range(len(prompts)) for f in same_tokens(
        f"self-draft prompt {i}: card vs cloud-greedy", self_spec[i],
        greedy[i], margins[i])]
    if any(st.acceptance_rate != 1.0 or not st.tokens_per_cloud_step > 1.5
           for st in self_stats):
        fail(f"self-draft: acceptance {out['self_draft_24']['acceptance']}, "
             f"tokens per cloud step "
             f"{out['self_draft_24']['tokens_per_cloud_step']} (want 1.0 "
             f"and > 1.5)")
    cut_cfg = dataclasses.replace(cloud_cfg, num_layers=2)
    cut = {**spec_cloud, "layers": M.tree_map(lambda t: t[:2],
                                              spec_cloud["layers"])}
    cut_spec, cut_stats, out["speculative_2_cuda"] = spec_runs(
        "edge draft", draft_cfg, draft, cut_cfg, cut, dev)
    host_spec, host_stats, out["speculative_2_host"] = spec_runs(
        "edge draft", draft_cfg, on_host(draft), cut_cfg, on_host(cut),
        "cpu")
    if cut_stats != host_stats or any(
            not torch.equal(a, b) for a, b in zip(cut_spec, host_spec)):
        _, host_margins = greedy_runs(cut_cfg, on_host(cut), "cpu")
        for i in range(len(prompts)):
            flips += same_tokens(f"speculative 2 layers prompt {i}: card vs "
                                 f"host", cut_spec[i], host_spec[i],
                                 host_margins[i])
    out["speculative_flips"] = flips
    out["speculative_recorder"] = spec_rec
    print(f"speculative: tokens equal to cloud-greedy on the card and to the "
          f"host's at 2 layers ({len(flips)} near-tie flips), self-draft "
          f"acceptance 1.0", flush=True)
    del draft, cut, spec_cloud

    # --- int8 KV cache -------------------------------------------------------
    kv_cfg = dataclasses.replace(cloud_cfg, kv_cache_dtype="int8")
    res8, _, out["int8_kv_24"] = serve_run(torch, bench, kv_cfg, cloud,
                                           dev, zero_counts, read_counts)
    f32_tokens = serving["flash_tokens"]
    out["int8_kv_24"]["same_tokens_as_f32_cache"] = sum(
        [int(t) for t in r.output] == f32_tokens.get(rid)
        for rid, r in res8.items() if r.route == "cloud")
    long_prompt = torch.as_tensor(bench["prompts"][0]).long()[None].to(dev)
    logits = {}
    for name, cfg in (("f32", cloud_cfg), ("int8", kv_cfg)):
        _, cache = TR.prefill(cfg, cloud, long_prompt[:, :-1],
                              cache_len=long_prompt.shape[1])
        logits[name] = TR.decode_step(cfg, cloud, cache,
                                      long_prompt[:, -1])[0]
    del cache
    kv_gap = rel_gap(logits["int8"], logits["f32"])
    print(f"int8 KV cache, one {long_prompt.shape[1] - 1}-token prefill and a "
          f"decode step: logits {kv_gap:.4g} of the largest from the f32 "
          f"cache's (bound {INT8_KV_RTOL})", flush=True)
    if not kv_gap < INT8_KV_RTOL:
        fail(f"int8 KV decode logits {kv_gap} from the f32 cache's, not "
             f"under {INT8_KV_RTOL}")
    cut8 = dataclasses.replace(kv_cfg, num_layers=2)
    cut = {**cloud, "layers": M.tree_map(lambda t: t[:2], cloud["layers"])}
    res_c, tap_c, out["int8_kv_2_cuda"] = serve_run(
        torch, bench, cut8, cut, dev, zero_counts, read_counts)
    res_h, tap_h, out["int8_kv_2_host"] = serve_run(
        torch, bench, cut8, on_host(cut), "cpu", zero_counts, read_counts)
    out["int8_kv_card_vs_host_2"] = same_serving(
        "int8 KV, 2 layers: card vs host", res_c, res_h, tap_c, tap_h)
    out["int8_kv_decode_rel_gap"] = kv_gap
    del cut

    # --- int8 weights --------------------------------------------------------
    t0 = time.perf_counter()
    q8 = QZ.quantize_tree(M.tree_map(lambda t: t.to(torch.bfloat16), cloud),
                          cloud_cfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for _, t in M.leaves(tree))
    w8_rec = Recorder(FA, "flash_attention")
    with FlashClock(torch, FA) as clock8, w8_rec:
        zero_counts()
        l8 = TR.prefill(cloud_cfg, q8, long_prompt)[0]
        launches8 = read_counts()["flash_attention"]
    l32 = TR.prefill(cloud_cfg, cloud, long_prompt)[0]
    w_gap = rel_gap(l8, l32)

    def engine_tokens(params):
        """One request, the long prompt, through ``DecodeEngine``: its
        tokens, decode steps, prefill and decode seconds."""
        eng = DecodeEngine(cloud_cfg, params, slots=1,
                           cache_len=long_prompt.shape[1] + DENSE_NEW,
                           device=dev)
        t0 = time.perf_counter()
        eng.admit(Request(rid=0, tokens=bench["prompts"][0],
                          max_new=DENSE_NEW + 1))
        t1 = time.perf_counter()
        done = []
        while eng.active:
            done += eng.step()
        return (done[0][1] if done else [], eng.ticks, t1 - t0,
                time.perf_counter() - t1)

    w8_tokens, ticks, prefill_s, decode_s = engine_tokens(q8)
    f32_engine_tokens = engine_tokens(cloud)[0]
    out["int8_weights_24"] = {
        "param_bytes": nbytes(q8), "f32_param_bytes": nbytes(cloud),
        "quantize_s": quant_s, "prefill_rel_gap": w_gap,
        "flash_launches": launches8, "flash_dtypes": clock8.dtypes,
        "flash_bf16_device_ms": clock8.ms(), "prefill_s": prefill_s,
        "decode_steps": ticks, "decode_s": decode_s,
        "tokens_equal_to_f32_model": sum(
            a == b for a, b in zip(w8_tokens, f32_engine_tokens))}
    print(f"int8 weights: {json.dumps(out['int8_weights_24'])}", flush=True)
    if not w_gap < INT8_WEIGHT_RTOL:
        fail(f"int8-weight prefill logits {w_gap} from the f32 model's, not "
             f"under {INT8_WEIGHT_RTOL}")
    if launches8 != cloud_cfg.num_layers * (dev.type == "cuda") or \
            clock8.dtypes != {"torch.bfloat16": cloud_cfg.num_layers}:
        fail(f"int8-weight prefill: {launches8} flash launches, dtypes "
             f"{clock8.dtypes} (want {cloud_cfg.num_layers} in bf16)")
    if ticks != DENSE_NEW or len(w8_tokens) != DENSE_NEW + 1:
        fail(f"int8-weight engine: {ticks} decode steps, "
             f"{len(w8_tokens)} tokens")
    out["int8_weights_recorder"] = w8_rec
    del q8, l8, l32

    # --- chatglm3-6b and command-r-35b ---------------------------------------
    dense_recs = {}
    for arch, seed, widths in (
            ("chatglm3-6b", 11, (4096, 32, 2, 128, 13696, 65024)),
            ("command-r-35b", 12, (8192, 64, 8, 128, 22528, 256000))):
        cfg = dataclasses.replace(get_config(arch), num_layers=DENSE_LAYERS)
        if (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                cfg.d_ff, cfg.vocab_size) != widths:
            fail(f"{arch} is not at full width: {cfg}")
        t0 = time.perf_counter()
        host = M.init_params(cfg, torch.Generator().manual_seed(seed))
        out["draw_s"][arch] = time.perf_counter() - t0
        params = M.tree_map(lambda t: t.to(dev), host)
        del host
        n_params = sum(t.numel() for _, t in M.leaves(params))
        prompt = torch.randint(0, cfg.vocab_size, (DENSE_PROMPT,),
                               generator=torch.Generator().manual_seed(seed)
                               ).to(torch.int32).numpy()
        runs, rows = {}, {}
        for impl in ("flash", "chunked"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            eng = DecodeEngine(c, params, slots=1,
                               cache_len=DENSE_PROMPT + DENSE_NEW, device=dev)
            rec = Recorder(FA, "flash_attention")
            with FlashClock(torch, FA) as clock, rec, \
                    ServeTap(torch, TR, eng) as tap:
                zero_counts()
                eng.admit(Request(rid=0, tokens=prompt,
                                  max_new=DENSE_NEW + 1))
                done = []
                while eng.active:
                    done += eng.step()
                torch.cuda.synchronize()
                launches = read_counts()["flash_attention"]
            res = {0: Request(rid=0, tokens=prompt, route="cloud",
                              output=np.asarray(done[0][1]))}
            runs[impl] = (res, tap)
            rows[impl] = {"prefill_s": tap.prefill_s,
                          "decode_tok_s": tap.decode_tokens / tap.decode_s,
                          "flash_launches": launches,
                          "flash_device_ms": clock.ms()}
            if impl == "flash":
                dense_recs[arch] = rec
            want = DENSE_LAYERS * tap.prefills \
                if impl == "flash" and dev.type == "cuda" else 0
            if launches != want or tap.prefills != 1 or \
                    len(done[0][1]) != DENSE_NEW + 1:
                fail(f"{arch} {impl}: {launches} flash launches for "
                     f"{tap.prefills} prefills (want {want}), "
                     f"{len(done[0][1])} tokens")
            del eng
        cmp = same_serving(f"{arch}, {DENSE_LAYERS} layers: flash vs chunked "
                           f"on the card", runs["flash"][0],
                           runs["chunked"][0], runs["flash"][1],
                           runs["chunked"][1])
        out[arch] = {"params": n_params, "draw_s": out["draw_s"][arch],
                     **{f"{k}_{impl}": v for impl, r in rows.items()
                        for k, v in r.items()}, "flash_vs_chunked": cmp}
        print(f"{arch}, {DENSE_LAYERS} layers at full width: "
              f"{json.dumps(out[arch])}", flush=True)
        del params, runs
        torch.cuda.empty_cache()
    out["dense_recorders"] = dense_recs
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"dense family phase {out['phase_s']:.1f} s (draws "
          f"{json.dumps(out['draw_s'])})", flush=True)
    return out


def stub_inputs(torch, cfg, seed: int, dev) -> dict:
    """The stubbed frontends' outputs a config takes, for one sequence:
    seeded normal audio frames (1, enc_seq, d_model) or image embeddings
    (1, num_img_tokens, 1024), drawn on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = {}
    if cfg.is_encdec:
        kw["audio_frames"] = torch.randn((1, cfg.enc_seq, cfg.d_model),
                                         generator=g, device=dev)
    if cfg.num_img_tokens:
        kw["img_embeds"] = torch.randn((1, cfg.num_img_tokens, 1024),
                                       generator=g, device=dev)
    return kw


def cut_layers(M, params, cfg, n: int):
    """(cfg, params) with the decoder (and any encoder) cut to ``n``
    layers, the rest of the tree shared."""
    cut = dict(params, layers=M.tree_map(lambda t: t[:n], params["layers"]))
    if cfg.is_encdec:
        cut["enc_layers"] = M.tree_map(lambda t: t[:n], params["enc_layers"])
    return dataclasses.replace(
        cfg, num_layers=n,
        num_enc_layers=min(n, cfg.num_enc_layers)), cut


def generate(torch, TR, cfg, params, prompt, kw: dict, steps: int,
             zero_counts, read_counts) -> dict:
    """Greedy decoding through ``transformer.prefill`` and ``decode_step``
    (one prefill of ``prompt`` (1, S) with the stub inputs ``kw``, then
    ``steps`` decode steps), the launch counters zeroed just before and
    read just after: the tokens, every step's logits (host f32) and top-2
    margin, the flash launches and the prefill and decode seconds."""
    out = {"tokens": [], "logits": [], "margins": []}

    def take(logits):
        top = torch.topk(logits[0].float(), 2).values
        out["margins"].append(float(top[0] - top[1]))
        out["logits"].append(logits[0].float().cpu())
        tok = torch.argmax(logits, dim=-1)
        out["tokens"].append(int(tok[0]))
        return tok

    with torch.no_grad():
        zero_counts()
        t0 = time.perf_counter()
        logits, cache = TR.prefill(cfg, params, prompt,
                                   cache_len=prompt.shape[1] + steps, **kw)
        tok = take(logits)
        t1 = time.perf_counter()
        for _ in range(steps):
            logits, cache = TR.decode_step(cfg, params, cache, tok)
            tok = take(logits)
        t2 = time.perf_counter()
        out["flash_launches"] = read_counts()["flash_attention"]
    out.update(prefill_s=t1 - t0, decode_s=t2 - t1,
               cache_len=int(cache["kpos"].shape[1]))
    return out


def same_generation(what: str, got: dict, want: dict, atol: float) -> dict:
    """Tokens equal under the near-tie rule (the plain run ``want``'s
    margins); logits within ``atol`` at every step up to the first token
    that differs.  Returns what was compared."""
    flips = same_tokens(what, got["tokens"], want["tokens"], want["margins"])
    upto = flips[0][0] + 1 if flips else len(want["logits"])
    gap = max(float((a - b).abs().max()) for a, b in zip(
        got["logits"][:upto], want["logits"][:upto]))
    scale = max(float(w.abs().max()) for w in want["logits"][:upto])
    print(f"{what}: tokens equal ({len(flips)} near-tie flips), logits "
          f"within {gap:.3g} over {upto} steps (largest logit "
          f"{scale:.3g}), smallest top-2 margin {min(want['margins']):.3g}",
          flush=True)
    if not gap <= atol:
        fail(f"{what}: logits differ by {gap} > {atol}")
    return {"logits_max_abs_err": gap, "largest_logit": scale,
            "near_tie_flips": flips, "min_top2_margin": min(want["margins"])}


class MoeTap:
    """Wraps ``layers.moe_apply`` for a run: for every call on a
    multi-token input (a prefill or the edge's forward) of the model
    ``name``, the tokens' expert choices over capacity (an expert's
    choices past ``moe_capacity`` are dropped) and the aux loss; a
    prefill's calls are its layers, in order."""

    def __init__(self, torch, L, name: str):
        self.torch, self.L, self.name = torch, L, name
        self.calls = []

    def __enter__(self):
        torch, L, inner = self.torch, self.L, self.L.moe_apply
        self.inner = inner

        def tapped(cfg, p, x, **kw):
            y, aux = inner(cfg, p, x, **kw)
            if cfg.name == self.name and x.shape[1] > 1:
                probs = torch.softmax(torch.einsum(
                    "bsd,de->bse", x.float(), p["router"].float()), -1)
                topi = torch.topk(probs, cfg.top_k, dim=-1).indices
                per_expert = torch.nn.functional.one_hot(
                    topi, cfg.num_experts).sum(dim=(1, 2))   # (B, E)
                cap = L.moe_capacity(cfg, x.shape[1])
                self.calls.append((x.shape[1], int(torch.clamp(
                    per_expert - cap, min=0).sum()), float(aux)))
            return y, aux
        L.moe_apply = tapped
        return self

    def __exit__(self, *exc):
        self.L.moe_apply = self.inner

    def per_prefill(self, layers: int) -> list:
        """[(S, dropped choices, aux summed over the layers)] a prefill."""
        return [(chunk[0][0], sum(c[1] for c in chunk),
                 sum(c[2] for c in chunk))
                for chunk in (self.calls[i:i + layers]
                              for i in range(0, len(self.calls), layers))]


class SsdCapture:
    """Wraps ``ssm.ssd_chunked`` for a run: keeps (on the card) the inputs
    of its first call at ``S`` tokens."""

    def __init__(self, SSM, S: int):
        self.SSM, self.S, self.args = SSM, S, None

    def __enter__(self):
        inner = self.inner = self.SSM.ssd_chunked

        def captured(cfg, x, *rest, **kw):
            if self.args is None and x.shape[1] == self.S:
                self.args = (cfg, x.clone(), *(a.clone() for a in rest), kw)
            return inner(cfg, x, *rest, **kw)
        self.SSM.ssd_chunked = captured
        return self

    def __exit__(self, *exc):
        self.SSM.ssd_chunked = self.inner


def families_phase(torch, dev, serve_prompts, zero_counts,
                   read_counts) -> dict:
    """Phase 11: the remaining model families on the card, drawn on the
    card from seeds, each freed before the next.

    granite-moe-1b-a400m at full width and depth (24 layers, 32 experts
    top-8) under flash behind its edge variant through ``CascadeServer``
    on the serving phase's prompts, against the same run under chunked
    attention (routes, tokens under the near-tie rule), with the expert
    choices capacity dropped and the aux loss of each prefill;
    phi3.5-moe-42b-a6.6b at full width cut to ``PHI_LAYERS`` layers, one
    ``DENSE_PROMPT``-token prefill and ``FAMILY_NEW`` decode steps, flash
    against chunked; mamba2-2.7b at full width and depth through
    ``DecodeEngine`` on ``FAMILY_LENGTHS`` prompts, its decode chain
    against the forward's logits and one layer's ``ssd_chunked`` against
    ``ssd_reference`` on the engine's 1,024-token prefill inputs;
    hymba-1.5b at full width and depth through ``CascadeServer`` on
    ``FAMILY_LENGTHS`` prompts; whisper-large-v3 (32 + 32 layers) on
    1,500 stub frames and a ``WHISPER_PROMPT``-token prompt, and
    internvl2-1b behind 256 stub image embeddings and
    ``INTERNVL2_TEXT`` text tokens, flash against chunked.  Flash
    launches equal layers x cloud prefills on every path.  Then each
    family at 2 layers, card against host on a ``FAMILY_HOST_PROMPT``-
    token prompt: tokens under the near-tie rule, logits within
    ``LOGIT_ATOL``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L
    from repro_torch.models import meta as M
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TR
    from repro_torch.serving.engine import DecodeEngine, Request
    t_phase = time.perf_counter()
    out, recs, host_runs = {"draw_s": {}}, {}, {}

    def draw(arch, seed, widths, **change):
        cfg = dataclasses.replace(get_config(arch), **change)
        got = (cfg.num_layers, cfg.num_enc_layers, cfg.d_model,
               cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size)
        if got != widths:
            fail(f"{arch} is not at the width and depth it should be: {got}")
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed))
        torch.cuda.synchronize()
        secs = out["draw_s"][arch] = time.perf_counter() - t0
        n = sum(t.numel() for _, t in M.leaves(params))
        out[arch] = {"params": n}
        print(f"{arch}: {n} parameters drawn on the card in {secs:.2f} s",
              flush=True)
        return cfg, params

    def gen(cfg, params, prompt, kw, rec=None):
        with rec or contextlib.nullcontext():
            return generate(torch, TR, cfg, params, prompt, kw, FAMILY_NEW,
                            zero_counts, read_counts)

    def flash_vs_chunked(arch, cfg, params, prompt, kw, layers):
        """The model under flash (recorded) and under chunked attention:
        tokens and logits the same, ``layers`` flash launches."""
        rec = Recorder(FA, "flash_attention")
        runs = {impl: gen(dataclasses.replace(cfg, attn_impl=impl), params,
                          prompt, kw, rec if impl == "flash" else None)
                for impl in ("flash", "chunked")}
        recs[arch] = rec
        if runs["flash"]["flash_launches"] != layers or \
                runs["chunked"]["flash_launches"] != 0:
            fail(f"{arch}: {runs['flash']['flash_launches']} flash launches "
                 f"for one prefill (want {layers}), "
                 f"{runs['chunked']['flash_launches']} under chunked")
        out[arch].update(
            prompt=int(prompt.shape[1]), cache_len=runs["flash"]["cache_len"],
            flash_launches=runs["flash"]["flash_launches"],
            prefill_s=runs["flash"]["prefill_s"],
            decode_tok_s=FAMILY_NEW / runs["flash"]["decode_s"],
            tokens=runs["flash"]["tokens"],
            flash_vs_chunked=same_generation(
                f"{arch}, {cfg.num_layers} layers: flash vs chunked on the "
                f"card", runs["flash"], runs["chunked"], LOGIT_ATOL))
        return runs

    def host_pair(arch, cfg, params, kw):
        """The model cut to 2 layers, flash on the card against the host
        on one ``FAMILY_HOST_PROMPT``-token prompt."""
        cut_cfg, cut = cut_layers(M, params, cfg, 2)
        cut_cfg = dataclasses.replace(cut_cfg, attn_impl="flash")
        prompt = torch.randint(0, cfg.vocab_size, (1, FAMILY_HOST_PROMPT),
                               generator=torch.Generator().manual_seed(9))
        card = gen(cut_cfg, cut, prompt.to(dev), kw)
        host = gen(cut_cfg, M.tree_map(lambda t: t.cpu(), cut), prompt,
                   {k: v.cpu() for k, v in kw.items()})
        want = 2 if cfg.has_attn else 0
        if card["flash_launches"] != want or host["flash_launches"] != 0:
            fail(f"{arch}, 2 layers: {card['flash_launches']} flash "
                 f"launches on the card (want {want}), "
                 f"{host['flash_launches']} on the host")
        host_runs[arch] = card["flash_launches"]
        out[arch]["card_vs_host_2"] = same_generation(
            f"{arch}, 2 layers: card vs host", card, host, LOGIT_ATOL)

    def served(arch, cfg, params, edge_seed, prompts, n_edge):
        """``CascadeServer`` behind the arch's edge variant (drawn on the
        host) on ``prompts``: under flash (recorded), then chunked."""
        edge_cfg = get_config(arch).edge_variant()
        edge = M.init_params(edge_cfg, torch.Generator().manual_seed(
            edge_seed))
        th = edge_thresholds(torch, edge_cfg, M.tree_map(
            lambda t: t.to(dev), edge), prompts, n_edge, 1e-5)
        bench = {"edge_cfg": edge_cfg, "edge": edge, "prompts": prompts,
                 "thresholds": th,
                 "cache_len": max(len(p) for p in prompts) + SERVE_NEW}
        rec = Recorder(FA, "flash_attention")
        with rec:
            res_f, tap_f, row_f = serve_run(
                torch, bench, dataclasses.replace(cfg, attn_impl="flash"),
                params, dev, zero_counts, read_counts)
        recs[arch] = rec
        res_c, tap_c, row_c = serve_run(torch, bench, cfg, params, dev,
                                        zero_counts, read_counts)
        out[arch].update(thresholds=th, flash=row_f, chunked=row_c)
        return res_f, tap_f, res_c, tap_c

    # --- granite-moe-1b-a400m: 24 layers, 32 experts top-8 -----------------
    arch = "granite-moe-1b-a400m"
    cfg, params = draw(arch, 21,
                       (24, 0, 1024, 16, 8, 512, 49155))
    with MoeTap(torch, L, cfg.name) as moe:
        res_f, tap_f, res_c, tap_c = served(arch, cfg, params, 22,
                                            serve_prompts, 3)
    out[arch]["flash_vs_chunked"] = same_serving(
        f"{arch}, 24 layers: flash vs chunked on the card", res_f, res_c,
        tap_f, tap_c, MOE_LOGIT_ATOL)
    prefills = moe.per_prefill(cfg.num_layers)
    out[arch]["prefills_dropped_aux"] = prefills
    print(f"{arch} prefills (S, expert choices dropped over capacity, "
          f"aux over the layers), both runs: {prefills}", flush=True)
    if len(prefills) != 2 * out[arch]["flash"]["cloud_prefills"] or \
            not all(np.isfinite(a) and a > 0 for _, _, a in prefills):
        fail(f"{arch}: MoE prefill stats {prefills}")
    host_pair(arch, cfg, params, {})
    del params, res_f, res_c, tap_f, tap_c
    torch.cuda.empty_cache()

    # --- phi3.5-moe-42b-a6.6b: full width, cut to PHI_LAYERS layers --------
    arch = "phi3.5-moe-42b-a6.6b"
    cfg, params = draw(arch, 23,
                       (PHI_LAYERS, 0, 4096, 32, 8, 6400, 32064),
                       num_layers=PHI_LAYERS)
    prompt = torch.randint(0, cfg.vocab_size, (1, DENSE_PROMPT),
                           generator=torch.Generator().manual_seed(24))
    flash_vs_chunked(arch, cfg, params, prompt.to(dev), {}, PHI_LAYERS)
    host_pair(arch, cfg, params, {})
    del params
    torch.cuda.empty_cache()

    # --- mamba2-2.7b: 64 layers of SSD, no attention ------------------------
    arch = "mamba2-2.7b"
    cfg, params = draw(arch, 25, (64, 0, 2560, 0, 1, 0, 50280))
    g = torch.Generator().manual_seed(26)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).to(
        torch.int32).numpy() for n in FAMILY_LENGTHS]
    eng = DecodeEngine(cfg, params, slots=len(prompts),
                       cache_len=max(FAMILY_LENGTHS) + FAMILY_NEW, device=dev)
    with SsdCapture(SSM, max(FAMILY_LENGTHS)) as ssd:
        zero_counts()
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            if not eng.admit(Request(rid=i, tokens=p,
                                     max_new=FAMILY_NEW + 1)):
                fail("mamba2: a free slot refused a request")
        t1 = time.perf_counter()
        done = {}
        while eng.active:
            done.update(eng.step())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = read_counts()
    if sorted(done) != list(range(len(prompts))) or counts[
            "flash_attention"] or any(len(v) != FAMILY_NEW + 1
                                      for v in done.values()):
        fail(f"mamba2 engine: {done}, {counts['flash_attention']} flash")
    out[arch].update(
        engine_prefill_s=t1 - t0, engine_decode_s=t2 - t1,
        decode_tok_s=len(prompts) * FAMILY_NEW / (t2 - t1),
        prefill_tok_s=sum(FAMILY_LENGTHS) / (t1 - t0),
        flash_launches=counts["flash_attention"])
    del eng
    # one layer's SSD at full width: the chunked dual form against the
    # per-step recurrence on the engine's 1,024-token prefill inputs
    scfg, *args, skw = ssd.args
    y1, s1 = SSM.ssd_chunked(scfg, *args, **skw)
    y2, s2 = SSM.ssd_reference(scfg, *args, **skw)
    ssd_gap = (rel_gap(y1, y2), rel_gap(s1, s2))
    out[arch]["ssd_chunked_vs_reference"] = {
        "shape": list(args[0].shape), "state": list(s1.shape),
        "y_rel_gap": ssd_gap[0], "state_rel_gap": ssd_gap[1]}
    print(f"{arch}: ssd_chunked vs ssd_reference at x "
          f"{tuple(args[0].shape)}, N {args[3].shape[-1]}: y {ssd_gap[0]:.3g}"
          f", state {ssd_gap[1]:.3g} of the largest (bound {SSD_RTOL})",
          flush=True)
    if not max(ssd_gap) < SSD_RTOL:
        fail(f"mamba2: ssd_chunked differs from ssd_reference by {ssd_gap}")
    del ssd, args, y1, y2, s1, s2
    # the decode chain: prefill 256 tokens, decode the next FAMILY_NEW one
    # by one, against the forward's logits over 512 (two whole chunks)
    n0 = FAMILY_LENGTHS[0]
    chain_toks = torch.as_tensor(np.concatenate(prompts[:2])[:2 * n0]).long(
    )[None].to(dev)
    with torch.no_grad():
        want = TR.lm_logits(cfg, params, TR.forward(cfg, params,
                                                    chain_toks)[0])[0]
        _, cache = TR.prefill(cfg, params, chain_toks[:, :n0],
                              cache_len=n0 + FAMILY_NEW)
        chain = 0.0
        for i in range(n0, n0 + FAMILY_NEW):
            got, cache = TR.decode_step(cfg, params, cache, chain_toks[:, i])
            chain = max(chain, rel_gap(got[0], want[i]))
    del cache, want
    out[arch]["decode_chain_rel_gap"] = chain
    print(f"{arch}: {FAMILY_NEW}-step decode chain vs forward logits "
          f"{chain:.3g} of the largest (bound {MAMBA_CHAIN_RTOL}); engine "
          f"{json.dumps({k: v for k, v in out[arch].items() if k.startswith('engine') or k.endswith('tok_s')})}",
          flush=True)
    if not chain < MAMBA_CHAIN_RTOL:
        fail(f"mamba2: decode chain {chain} from the forward's logits")
    host_pair(arch, cfg, params, {})
    del params
    torch.cuda.empty_cache()

    # --- hymba-1.5b: attention (25 heads over 5) beside SSM heads ----------
    arch = "hymba-1.5b"
    cfg, params = draw(arch, 27, (32, 0, 1600, 25, 5, 5504, 32001))
    g = torch.Generator().manual_seed(28)
    prompts = [torch.randint(0, 512, (n,), generator=g).to(
        torch.int32).numpy() for n in FAMILY_LENGTHS]
    res_f, tap_f, res_c, tap_c = served(arch, cfg, params, 29, prompts,
                                        1)
    out[arch]["flash_vs_chunked"] = same_serving(
        f"{arch}, 32 layers: flash vs chunked on the card", res_f, res_c,
        tap_f, tap_c)
    host_pair(arch, cfg, params, {})
    del params, res_f, res_c, tap_f, tap_c
    torch.cuda.empty_cache()

    # --- whisper-large-v3: 32 encoder + 32 decoder layers ------------------
    arch = "whisper-large-v3"
    cfg, params = draw(arch, 30,
                       (32, 32, 1280, 20, 20, 5120, 51866))
    kw = stub_inputs(torch, cfg, 31, dev)
    prompt = torch.randint(0, cfg.vocab_size, (1, WHISPER_PROMPT),
                           generator=torch.Generator().manual_seed(32))
    flash_vs_chunked(arch, cfg, params, prompt.to(dev), kw,
                     cfg.num_layers)
    host_pair(arch, cfg, params, kw)
    del params, kw
    torch.cuda.empty_cache()

    # --- internvl2-1b: 24 layers behind a 256-token image prefix -----------
    arch = "internvl2-1b"
    cfg, params = draw(arch, 33, (24, 0, 896, 14, 2, 4864, 151655))
    kw = stub_inputs(torch, cfg, 34, dev)
    prompt = torch.randint(0, cfg.vocab_size, (1, INTERNVL2_TEXT),
                           generator=torch.Generator().manual_seed(35))
    runs = flash_vs_chunked(arch, cfg, params, prompt.to(dev), kw,
                            cfg.num_layers)
    want_len = INTERNVL2_TEXT + FAMILY_NEW + cfg.num_img_tokens
    if runs["flash"]["cache_len"] != want_len:
        fail(f"internvl2: cache length {runs['flash']['cache_len']}, want "
             f"{want_len} (the image prefix counted)")
    host_pair(arch, cfg, params, kw)
    del params, kw, runs
    torch.cuda.empty_cache()

    out["recorders"] = recs
    out["host_pair_flash_launches"] = host_runs
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"families phase {out['phase_s']:.1f} s (draws "
          f"{json.dumps(out['draw_s'])})", flush=True)
    return out


def deep_logit_gap(torch, dev) -> dict:
    """Flash vs chunked prefill logits at qwen3-8b's full depth and width
    (36 layers, GQA 32/8, hd 128), seeded random weights drawn on the
    card: one ``DEEP_PROMPT``-token prompt through ``transformer.prefill``
    under the chunked path, under flash (36 launches), and under flash
    with ``F.scaled_dot_product_attention`` in the kernel's place.  Even
    exact f32 attention drifts from the chunked path over 36 layers
    (``LOGIT_ATOL`` gates 24 in the serving phase), so the kernel's drift
    is held to ``DEEP_DRIFT_RATIO`` times SDPA's."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import meta as M
    from repro_torch.models import transformer as TR
    cfg = get_config("qwen3-8b")
    gen = torch.Generator(device=dev).manual_seed(9)

    def leaf(m):
        if m.init in ("zeros", "ones"):
            return getattr(torch, m.init)(m.shape, device=dev)
        return torch.randn(m.shape, generator=gen, device=dev) * m.scale

    def sdpa(q, k, v, *, causal=True):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)

    params = M.tree_map(leaf, M.model_meta(cfg))
    tokens = torch.randint(0, cfg.vocab_size, (1, DEEP_PROMPT),
                           generator=torch.Generator().manual_seed(10)
                           ).to(dev)
    logits, launches = {}, {}
    kernel = FA.flash_attention
    with torch.no_grad():
        for run, impl in (("chunked", "chunked"), ("flash", "flash"),
                          ("sdpa", "flash")):
            FA.flash_attention = sdpa if run == "sdpa" else kernel
            before = FA.LAUNCHES
            try:
                logits[run] = TR.prefill(dataclasses.replace(
                    cfg, attn_impl=impl), params, tokens)[0]
            finally:
                FA.flash_attention = kernel
            launches[run] = FA.LAUNCHES - before
    del params
    torch.cuda.empty_cache()
    if launches != {"chunked": 0, "flash": cfg.num_layers, "sdpa": 0}:
        fail(f"qwen3-8b prefill: flash launches {launches}, want "
             f"{cfg.num_layers} under flash and none otherwise")
    lc = logits["chunked"]
    for run in ("flash", "sdpa"):
        if logits[run].shape != (1, cfg.vocab_size) or \
                not bool(torch.isfinite(logits[run]).all()):
            fail(f"qwen3-8b prefill logits ({run}) "
                 f"{tuple(logits[run].shape)} not finite")
    drift = {run: float((logits[run] - lc).abs().max())
             for run in ("flash", "sdpa")}
    top2 = lc[0].topk(2).values
    row = {"layers": cfg.num_layers, "prompt": DEEP_PROMPT,
           "max_abs_err": drift["flash"], "sdpa_max_abs_err": drift["sdpa"],
           "logit_std": float(lc.std()),
           "same_argmax": bool(logits["flash"].argmax() == lc.argmax()),
           "top2_margin": float(top2[0] - top2[1])}
    print(f"qwen3-8b, {cfg.num_layers} layers, one {DEEP_PROMPT}-token "
          f"prefill: logits vs the chunked path's within "
          f"{drift['flash']:.3g} (flash), {drift['sdpa']:.3g} (SDPA in its "
          f"place); logit std {row['logit_std']:.3g}, same argmax "
          f"{row['same_argmax']}", flush=True)
    if not drift["flash"] <= DEEP_DRIFT_RATIO * drift["sdpa"]:
        fail(f"qwen3-8b prefill: the flash kernel's logits drift "
             f"{drift['flash']} from the chunked path's, over "
             f"{DEEP_DRIFT_RATIO} x SDPA's {drift['sdpa']}")
    return row


def training_phase(torch, T, zero_counts) -> dict:
    """Cloud-side training on the card (paper §IV-A/B): the shared
    workload built on the card and on the host (``WORKLOAD``), Table II's
    four schemes over the card's stream through ``run_query`` on both
    devices, and the three Fig. 5 training schemes on the card.  Returns
    the phase's numbers and the recorder of its triage launches."""
    import numpy as np
    from repro_torch.core import finetune as FT
    from repro_torch.data import synthetic_video as SV
    from repro_torch.models.transformer import CQClassifier
    from repro_torch.serving.workload import _binary_batches, build_workload
    from repro_torch.system import SCHEMES, Scenario, run_query
    from repro_torch.system.pixel_frontend import cq_config

    def fields(wl):
        return [(i.t_arrival, i.camera, i.edge_device, i.is_query, i.nbytes,
                 i.query) for i in wl.items]

    t0 = time.perf_counter()
    wl = build_workload(**WORKLOAD, device="cuda")
    torch.cuda.synchronize()
    wl_cuda_s = time.perf_counter() - t0
    if wl.edge_params["embed"].device.type != "cuda":
        fail("the workload's edge model was not trained on the card")
    t0 = time.perf_counter()
    wl_cpu = build_workload(**WORKLOAD, device="cpu")
    wl_cpu_s = time.perf_counter() - t0
    if len(wl.items) != len(wl_cpu.items) or fields(wl) != fields(wl_cpu):
        fail(f"workload integer fields differ between cuda and cpu "
             f"({len(wl.items)} against {len(wl_cpu.items)} items)")
    gap = max(abs(a.conf - b.conf) for a, b in zip(wl.items, wl_cpu.items))
    loss_gap = [abs(a - b) for a, b in zip(wl.step_losses,
                                           wl_cpu.step_losses)]
    first_far = next((i + 1 for i, g in enumerate(loss_gap) if g > 1e-3),
                     None)
    # the card's trained model on both devices, over the eval crops and a
    # fresh batch of every class
    crops = [next(_binary_batches(np.random.default_rng(WORKLOAD["seed"] + 99),
                                  wl.edge_cfg, np.full(SV.NUM_CLASSES, 1.0),
                                  None, SV.QUERY_CLASS, batch=256))[0],
             torch.from_numpy(SV.labeled_crop_batch(
                 np.arange(256) % SV.NUM_CLASSES, np.random.default_rng(5),
                 wl.edge_cfg.vocab_size)[0])]
    on_card = CQClassifier(wl.edge_cfg, wl.edge_params, device="cuda")
    on_host = CQClassifier(wl.edge_cfg, wl.edge_params, device="cpu")
    score_gap = max(float((on_card(t).cpu() - on_host(t)).abs().max())
                    for t in crops)
    step_ms = [1e3 * s for s in wl.step_seconds]
    steady_ms = float(np.median(step_ms[5:]))
    assumed_ms = 1e3 * FT.scheme_train_time("surveiledge", 1) / FT.FIG5_STEPS
    sep = {}
    for name, w in (("cuda", wl), ("cpu", wl_cpu)):
        conf = np.asarray([i.conf for i in w.items])
        truth = np.asarray([i.is_query for i in w.items])
        sep[name] = float(conf[truth].mean() - conf[~truth].mean())
        if not w.edge_accuracy >= 0.65:
            fail(f"{name} edge model accuracy {w.edge_accuracy} < 0.65")
        if not sep[name] > 0.1:
            fail(f"{name} query items' mean conf exceeds the others' by "
                 f"{sep[name]} <= 0.1")
    print(f"workload: {len(wl.items)} items; cuda {wl_cuda_s:.2f} s "
          f"(fine-tune {wl.timings['finetune_s']:.3f} s, stream "
          f"{wl.timings['stream_s']:.3f} s, scoring "
          f"{wl.timings['score_s']:.3f} s), cpu {wl_cpu_s:.2f} s "
          f"(fine-tune {wl_cpu.timings['finetune_s']:.3f} s); clusters "
          f"{wl.clusters.tolist()}; accuracy cuda {wl.edge_accuracy:.4f} "
          f"cpu {wl_cpu.edge_accuracy:.4f}; conf separation cuda "
          f"{sep['cuda']:.4f} cpu {sep['cpu']:.4f}; integer fields "
          f"identical, max |dconf| {gap:.3g} (not held)", flush=True)
    print(f"fine-tune loss, card vs host: steps 1-{TRAIN_LOSS_STEPS} within "
          f"{max(loss_gap[:TRAIN_LOSS_STEPS]):.3g}, first gap over 1e-3 at "
          f"step {first_far}, step {len(loss_gap)} gap {loss_gap[-1]:.3g}; "
          f"the card's trained model scores 512 crops on both devices "
          f"within {score_gap:.3g}", flush=True)
    print(f"train step on the card: first {step_ms[0]:.2f} ms, steady "
          f"(median of steps 6-{len(step_ms)}) {steady_ms:.3f} ms, against "
          f"scheme_train_time's assumed {assumed_ms:.0f} ms a step",
          flush=True)
    if not max(loss_gap[:TRAIN_LOSS_STEPS]) <= TRAIN_LOSS_ATOL:
        fail(f"fine-tune losses of steps 1-{TRAIN_LOSS_STEPS} differ by "
             f"{max(loss_gap[:TRAIN_LOSS_STEPS])} > {TRAIN_LOSS_ATOL} "
             f"between cuda and cpu")
    if not score_gap <= CONF_ATOL:
        fail(f"the trained model's conf differs by {score_gap} > "
             f"{CONF_ATOL} between cuda and cpu")

    duration = max(it.t_arrival for it in wl.items)
    rate = len(wl.items) / duration
    sc = Scenario(name="table2_single_edge", duration_s=duration,
                  edge_service_s=EDGE_UTILIZATION
                  * len(TABLE2["edge_speeds"]) / rate, **TABLE2)
    rows, launches, run_s = {}, {}, {}
    with Recorder(T, "triage_fleet") as tri:
        for scheme in SCHEMES:
            zero_counts()
            t0 = time.perf_counter()
            rows[scheme] = run_query(sc.with_scheme(scheme), items=wl.items,
                                     device="cuda").summary()
            torch.cuda.synchronize()
            run_s[scheme] = time.perf_counter() - t0
            launches[scheme] = T.LAUNCHES
    for scheme in SCHEMES:
        s_cpu = run_query(sc.with_scheme(scheme), items=wl.items,
                          device="cpu").summary()
        if rows[scheme] != s_cpu:
            diff = {k: (rows[scheme][k], s_cpu.get(k)) for k in rows[scheme]
                    if rows[scheme][k] != s_cpu.get(k)}
            fail(f"Table II {scheme} summary differs between cuda and cpu: "
                 f"{diff}")
    print("Table II (single edge, the card's stream): " + "; ".join(
        f"{k} F2 {r['accuracy_F2']} avg {r['avg_latency_s']} s p99 "
        f"{r['p99_latency_s']} s {r['bandwidth_MB']} MB triage launches "
        f"{launches[k]} in {run_s[k]:.3f} s" for k, r in rows.items())
        + "; every summary identical to cpu", flush=True)
    se, co, eo = rows["surveiledge"], rows["cloud_only"], rows["edge_only"]
    if not se["avg_latency_s"] < co["avg_latency_s"]:
        fail("Table II: surveiledge is not faster than cloud_only")
    if not se["accuracy_F2"] > eo["accuracy_F2"]:
        fail("Table II: surveiledge is not more accurate than edge_only")
    if co["accuracy_F2"] != 1.0 or eo["bandwidth_MB"] != 0:
        fail(f"Table II: cloud_only F2 {co['accuracy_F2']} (want 1.0), "
             f"edge_only bandwidth {eo['bandwidth_MB']} MB (want 0)")
    for scheme in ("surveiledge", "surveiledge_fixed"):
        if not 0 < launches[scheme] == rows[scheme]["kernel_launches"]:
            fail(f"Table II {scheme}: triage launches {launches[scheme]} vs "
                 f"kernel_launches {rows[scheme]['kernel_launches']} (must "
                 f"be equal and > 0)")

    cfg = cq_config()
    cams = SV.make_cameras(FIG5_CAMERAS, seed=0)
    profile = np.mean([c.class_mix for c in cams], axis=0)

    def pretrain_iter():
        r = np.random.default_rng(1)
        while True:
            cls = r.integers(0, SV.NUM_CLASSES, size=64)
            tokens, labels = SV.labeled_crop_batch(cls, r, cfg.vocab_size)
            yield torch.from_numpy(tokens), torch.from_numpy(
                (labels == SV.QUERY_CLASS).astype(np.int32))

    def batches(seed, mix):
        return lambda: _binary_batches(np.random.default_rng(seed), cfg, mix,
                                       None, SV.QUERY_CLASS)

    t0 = time.perf_counter()
    pre = FT.pretrain_backbone(cfg, torch.Generator().manual_seed(0),
                               pretrain_iter(), steps=FIG5_PRETRAIN_STEPS,
                               device="cuda")
    pre_s = time.perf_counter() - t0
    ev = next(_binary_batches(np.random.default_rng(99), cfg, profile, None,
                              SV.QUERY_CLASS, batch=256))
    cam_fns = {c.cam_id: batches(10 + c.cam_id, c.class_mix) for c in cams}
    fig5 = {s: FT.run_scheme(s, cfg, pre, batches(2, profile), cam_fns, ev)
            for s in FT.FIG5_SCHEMES}
    fig5_rows = {s: {"steps": [r.steps for r in res.values()],
                     "train_s": sum(r.train_seconds for r in res.values()),
                     "accuracy": float(np.mean([r.accuracy
                                                for r in res.values()]))}
                 for s, res in fig5.items()}
    print(f"Fig. 5 ({FIG5_CAMERAS} cameras, pretrained {FIG5_PRETRAIN_STEPS} "
          f"steps in {pre_s:.2f} s): " + "; ".join(
              f"{s} accuracy {r['accuracy']:.4f} train {r['train_s']:.3f} s "
              f"steps {r['steps']}" for s, r in fig5_rows.items()),
          flush=True)
    want = {"surveiledge": [FT.FIG5_STEPS],
            "all_finetune": [FT.FIG5_STEPS] * FIG5_CAMERAS,
            "no_finetune": [0]}
    if {s: r["steps"] for s, r in fig5_rows.items()} != want:
        fail(f"Fig. 5 step counts {fig5_rows}, want {want}")
    if not fig5_rows["all_finetune"]["train_s"] > \
            fig5_rows["surveiledge"]["train_s"]:
        fail("Fig. 5: all_finetune trained no longer than surveiledge")
    return {"recorder": tri, "triage_launches": launches,
            "workload": {"items": len(wl.items), "cuda_s": wl_cuda_s,
                         "cpu_s": wl_cpu_s, "split_cuda_s": wl.timings,
                         "split_cpu_s": wl_cpu.timings,
                         "accuracy_cuda": wl.edge_accuracy,
                         "accuracy_cpu": wl_cpu.edge_accuracy,
                         "conf_separation": sep, "max_abs_dconf": gap,
                         "loss_gap": loss_gap, "score_gap": score_gap,
                         "step_ms": step_ms, "steady_step_ms": steady_ms,
                         "assumed_step_ms": assumed_ms},
            "table2": {k: {**r, "cuda_s": run_s[k]} for k, r in rows.items()},
            "fig5": {"pretrain_s": pre_s, **fig5_rows}}


def train_step_trace(torch, cfg, step_fn, state, batch,
                     steady_ms: float) -> dict:
    """Where one LLM train step's time goes: the step under
    ``torch.profiler`` (its result dropped), the device busy for the union
    of its kernel, copy and memset intervals, the idle share against the
    unprofiled steady step, the device time of the GEMMs (cuBLAS kernels)
    and the kernels that took most.  The bound is the step's f32
    operations over the f32 rate: every matmul weight (the tied head
    included) twice a token in each of the forward, the rematerialized
    forward and the backward's two products, and the chunked attention's
    full (S x S) score and value products in each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    del out
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = {}                 # kernel names cut to 96 characters
    for e in kernels:
        by_name[e.name[:96]] = by_name.get(e.name[:96], 0.0) \
            + e.time_range.elapsed_us()
    gemm = ("gemm", "cutlass", "xmma", "nvjet", "sm90_")
    gemm_us = sum(us for n, us in by_name.items()
                  if any(g in n.lower() for g in gemm))
    B, S = batch["tokens"].shape
    tokens = B * S
    mm = (cfg.num_layers * (cfg.d_model * (cfg.num_heads + 2
                                           * cfg.num_kv_heads)
                            * cfg.head_dim
                            + cfg.num_heads * cfg.head_dim * cfg.d_model
                            + 3 * cfg.d_model * cfg.d_ff)
          + cfg.vocab_size * cfg.d_model)
    flops = 8 * tokens * mm + 16 * cfg.num_layers * B * cfg.num_heads \
        * S * S * cfg.head_dim
    busy_ms = busy_us / 1e3 if spans else None
    row = {"profiled_wall_ms": profiled_ms, "device_busy_ms": busy_ms,
           "device_ops": len(spans),
           "idle_share": None if busy_ms is None else 1 - busy_ms / steady_ms,
           "gemm_ms": gemm_us / 1e3, "flops": flops,
           "bound_ms": flops / F32_FLOP_S * 1e3, "bound_by": "operations",
           "top_kernels_ms": {n: us / 1e3 for n, us in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:8]}}
    print(f"train step trace: {json.dumps(row)}" + (
        "" if spans else "; device busy time not measured: the profiler "
        "recorded no device events"), flush=True)
    return row


def llm_training_phase(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 13: the LLM training stack on the card.  Full-width
    ``LLM_ARCH`` (chunked attention) trained for ``LLM_STEPS`` steps
    through ``launch/train.py``'s functions: every loss finite and the
    last below the first, no kernel of the port launched; one step at
    microbatches 2 against 1 on the trained state and a fresh batch
    (``LLM_MICRO_RTOL``); the trained parameters saved and restored bit
    for bit with ``latest_step`` = ``LLM_STEPS``.  Then the same initial
    weights cut to 2 layers and every reduced ``ASSIGNED`` config, one
    step on the card against the host (``LLM_LOSS_ATOL``,
    ``LLM_GNORM_RTOL``; ``LLM_MOE_LOSS_ATOL`` for the MoEs), the
    parameters moved; and flash refusing a gradient on the card."""
    import numpy as np
    from repro_torch.checkpoint import checkpoint as CK
    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as LT
    from repro_torch.models import layers as L
    from repro_torch.models import meta as M
    from repro_torch.optim import adamw as A
    from repro_torch.train import steps as ST
    t_phase = time.perf_counter()
    cfg = get_config(LLM_ARCH)
    widths = (cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.attn_impl)
    if widths != (24, 1024, 151936, "chunked"):
        fail(f"{LLM_ARCH} is not at the width and depth it should be: "
             f"{widths}")

    def to_host(tree):
        return M.tree_map(lambda t: t.cpu(), tree)

    def fresh(params):
        """A launcher's state at step 0 around ``params``."""
        return ST.TrainState(params, A.init(params), torch.zeros(
            (), dtype=torch.int32, device=next(M.leaves(params))[1].device))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = LT.init_state(cfg, dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in M.leaves(state.params))
    step_fn = LT.make_step(cfg, lr=LLM_LR, steps=LLM_STEPS)
    data = LT.batches(cfg, LLM_BATCH, LLM_SEQ, dev)
    losses, step_ms = [], []
    zero_counts()
    t_train = time.perf_counter()
    for _ in range(LLM_STEPS):
        batch = next(data)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))       # waits for the step
        step_ms.append(1e3 * (time.perf_counter() - t0))
    train_s = time.perf_counter() - t_train
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady_ms = float(np.median(step_ms[5:]))
    tokens_s = LLM_BATCH * LLM_SEQ / (steady_ms / 1e3)
    print(f"{LLM_ARCH} training: {n_params} parameters drawn on the card in "
          f"{draw_s:.2f} s; {LLM_STEPS} steps of {LLM_BATCH} x {LLM_SEQ} "
          f"tokens in {train_s:.2f} s: first step {step_ms[0]:.1f} ms, "
          f"steady (median of steps 6-{LLM_STEPS}) {steady_ms:.1f} ms, "
          f"{tokens_s:.0f} tokens/s; peak memory {peak_gb:.2f} GB; "
          f"launches {launches}", flush=True)
    print("losses: " + " ".join(f"{x:.4f}" for x in losses), flush=True)
    if not all(np.isfinite(losses)):
        fail(f"{LLM_ARCH} training: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{LLM_ARCH} training: the loss did not fall ({losses[0]} -> "
             f"{losses[-1]})")
    if any(launches.values()):
        fail(f"the training path launched a kernel: {launches}")

    batch = next(data)
    trace = train_step_trace(torch, cfg, step_fn, state, batch, steady_ms)
    _, m1 = step_fn(state, batch)
    _, m2 = LT.make_step(cfg, lr=LLM_LR, steps=LLM_STEPS,
                         microbatches=2)(state, batch)
    micro = {k: abs(float(m2[k]) - float(m1[k])) / abs(float(m1[k]))
             for k in ("loss", "grad_norm")}
    print(f"microbatches 2 against 1: loss {float(m1['loss']):.6f}, "
          f"grad_norm {float(m1['grad_norm']):.6f}; relative gaps "
          f"{json.dumps(micro)}", flush=True)
    if not max(micro.values()) <= LLM_MICRO_RTOL:
        fail(f"microbatches 2 differ from 1 by {micro} > {LLM_MICRO_RTOL}")
    del m1, m2, batch

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "params.npz")
        t0 = time.perf_counter()
        CK.save(path, state.params, step=LLM_STEPS)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = CK.restore(path, state.params)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        nbytes = Path(path).stat().st_size
        if CK.latest_step(path) != LLM_STEPS:
            fail(f"checkpoint step {CK.latest_step(path)}, want {LLM_STEPS}")
    same = [name for (name, a), (_, b) in zip(M.leaves(back),
                                              M.leaves(state.params))
            if a.device == b.device and torch.equal(a, b)]
    if len(same) != len(list(M.leaves(state.params))):
        fail("the checkpoint did not restore the trained parameters bit for "
             "bit on the card")
    print(f"checkpoint: {nbytes} bytes saved in {save_s:.2f} s, restored to "
          f"the card in {restore_s:.2f} s, {len(same)} leaves bitwise equal, "
          f"latest_step {LLM_STEPS}", flush=True)
    del back, state, metrics, data
    torch.cuda.empty_cache()

    def card_and_host(cfg, params, batch, what):
        """One launcher step from (params, fresh AdamW state) on the card
        and the host; fails past the tolerances; returns the gaps."""
        step = LT.make_step(cfg, lr=LLM_LR, steps=LLM_STEPS)
        t0 = time.perf_counter()
        new, mc = step(fresh(params), batch)
        loss_c = float(mc["loss"])
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, mh = step(fresh(to_host(params)), to_host(batch))
        host_s = time.perf_counter() - t0
        moved = max(float((a - b).abs().max()) for (_, a), (_, b) in
                    zip(M.leaves(new.params), M.leaves(params)))
        gaps = {"loss": abs(loss_c - float(mh["loss"])),
                "grad_norm": abs(float(mc["grad_norm"])
                                 - float(mh["grad_norm"]))
                / float(mh["grad_norm"]),
                "loss_card": loss_c, "moved": moved, "card_s": card_s,
                "host_s": host_s}
        atol = LLM_MOE_LOSS_ATOL if cfg.is_moe else LLM_LOSS_ATOL
        if not gaps["loss"] <= atol:
            fail(f"{what}: loss differs by {gaps['loss']} > {atol} between "
                 f"card and host")
        if not cfg.is_moe and not gaps["grad_norm"] <= LLM_GNORM_RTOL:
            fail(f"{what}: grad_norm differs by {gaps['grad_norm']} > "
                 f"{LLM_GNORM_RTOL} (relative) between card and host")
        if not moved > 0:
            fail(f"{what}: the train step moved no parameter")
        return gaps

    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    cut_cfg, cut = cut_layers(M, params, cfg, 2)
    two = card_and_host(cut_cfg, cut, next(LT.batches(
        cut_cfg, LLM_HOST_BATCH, LLM_HOST_SEQ, dev)), f"{LLM_ARCH}, 2 layers")
    print(f"{LLM_ARCH}, 2 layers, {LLM_HOST_BATCH} x {LLM_HOST_SEQ}: card "
          f"vs host {json.dumps(two)}", flush=True)
    del params, cut
    torch.cuda.empty_cache()
    reduced = {}
    for seed, arch in enumerate(ASSIGNED):
        rcfg = get_config(arch).reduced()
        rp = M.init_params(rcfg, torch.Generator(device=dev).manual_seed(
            seed))
        reduced[arch] = card_and_host(rcfg, rp, next(LT.batches(
            rcfg, 2, LLM_REDUCED_SEQ, dev)), f"{arch} reduced")
    print("reduced, one step, card vs host (loss gap, grad_norm relative "
          "gap): " + "; ".join(f"{a} {g['loss']:.3g} {g['grad_norm']:.3g}"
                               for a, g in reduced.items()), flush=True)

    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((1, 4, 64, 64), generator=g, device=dev)
               for _ in range(3))
    before = FA.LAUNCHES
    refused = []
    for what, call in (
            ("flash_attention", lambda: FA.flash_attention(
                q.requires_grad_(), k, v)),
            ("layers.attention", lambda: L.attention(
                dataclasses.replace(cut_cfg, attn_impl="flash"),
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                torch.arange(64, device=dev), torch.arange(64, device=dev)))):
        try:
            call()
        except RuntimeError as exc:
            refused.append(what)
            msg = str(exc)
    if refused != ["flash_attention", "layers.attention"] or \
            FA.LAUNCHES != before:
        fail(f"flash on the card refused a gradient only in {refused}, "
             f"launches {FA.LAUNCHES - before}")
    print(f"flash refuses a gradient on the card ({', '.join(refused)}; no "
          f"launch): {msg}", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"LLM training phase {phase_s:.1f} s", flush=True)
    return {"arch": LLM_ARCH, "params": n_params, "batch": LLM_BATCH,
            "seq": LLM_SEQ, "steps": LLM_STEPS, "lr": LLM_LR,
            "draw_s": draw_s, "train_s": train_s, "losses": losses,
            "step_ms": step_ms, "steady_step_ms": steady_ms,
            "tokens_per_s": tokens_s, "peak_memory_gb": peak_gb,
            "trace": trace,
            "launches": launches, "microbatch_gaps": micro,
            "checkpoint": {"bytes": nbytes, "save_s": save_s,
                           "restore_s": restore_s},
            "two_layers_card_vs_host": two, "reduced_card_vs_host": reduced,
            "phase_s": phase_s}


def start_dryruns(out: Path) -> list:
    """Start every ``DRYRUN_CALLS`` call, a process of its own on one CPU
    thread, its record under ``out``/<n> and its output in ``out``/<n>.log:
    [(call, process, log path, record dir)]."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    runs = []
    for i, (arch, shape, mesh, extra) in enumerate(DRYRUN_CALLS):
        rec_dir, log = out / str(i), out / f"{i}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", mesh,
                 "--out", str(rec_dir), *extra],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        runs.append(((arch, shape, mesh, extra), proc, log, rec_dir))
    return runs


def stop_dryruns(runs: list, out: Path) -> None:
    """Kill any dry-run still running and remove their directory (at
    exit, whatever the script's outcome)."""
    for _, proc, _, _ in runs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(out, ignore_errors=True)


def finish_dryruns(runs: list, t_all: float) -> list:
    """Wait for the dry-runs (until ``DRYRUN_DEADLINE_S`` into the
    script), fail on any that did not end with its record, print each
    record's numbers; returns the records."""
    recs = []
    for (arch, shape, mesh, extra), proc, log, rec_dir in runs:
        left = DRYRUN_DEADLINE_S - (time.perf_counter() - t_all)
        try:
            rc = proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            proc.kill()
            fail(f"dry-run {arch} {shape} {mesh} still running "
                 f"{DRYRUN_DEADLINE_S:.0f} s into the script")
        text = log.read_text()
        if rc != 0:
            fail(f"dry-run {arch} {shape} {mesh} {' '.join(extra)} exited "
                 f"{rc}:\n{text[-3000:]}")
        files = list(rec_dir.glob("*.json"))
        if len(files) != 1:
            fail(f"dry-run {arch} {shape} {mesh} wrote {len(files)} records")
        rec = json.loads(files[0].read_text())
        coll = {k: v for k, v in rec["collectives"].items()
                if isinstance(v, dict) and v.get("count")}
        mem = rec["memory"]
        print(f"dry-run {arch} {shape} {mesh} {' '.join(extra)}: chips "
              f"{rec['chips']}, params {rec['params']}, window "
              f"{rec['window']}, per-device peak "
              f"{mem['peak_bytes'] / 1e9:.3f} GB of the card's "
              f"{mem['card_bytes'] / 1e9:.1f} GB (fits {mem['fits']}), "
              f"per-device FLOPs {rec['cost']['flops']:.4e}, collective "
              f"bytes {rec['collectives']['total_bytes']:.4e} by kind "
              f"{json.dumps(coll)}, run {rec['run_s']} s", flush=True)
        want_chips = 512 if mesh == "multi" else 256
        if rec["chips"] != want_chips or not mem["peak_bytes"] > 0 \
                or not rec["cost"]["flops"] > 0:
            fail(f"dry-run {arch} {shape} {mesh}: record {rec}")
        if shape == "long_500k" and rec["window"] != 8192:
            fail(f"dry-run {arch} long_500k window {rec['window']}")
        if rec["device"] != "cuda":
            fail(f"dry-run {arch} {shape} {mesh} ran on {rec['device']}")
        if rec["shape"] in ("decode_32k", "long_500k"):
            check_decode_record(rec)
        recs.append(rec)
    return recs


def check_decode_record(rec: dict) -> None:
    """A decode's dry-run record: no cache leaf gathered (no all-gather
    returns the elements and dims of one layer's cache leaf whole for the
    device's rows, and, where the serve weights are 1-D, all of them
    together move less than the largest such leaf), per-device FLOPs
    within ``DRYRUN_FLOPS_RTOL`` of the analytic count over the shards,
    and collective bytes a device under ``DRYRUN_COLL_LIMIT``: all of
    them where the serve weights are 1-D; where they are 2-D (split on
    "data" too, so each step gathers them), all but one pass over the
    weights (``dryrun.serve_weight_pass_bytes``), which the all-gathers
    must cover."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import INPUT_SHAPES
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as MESH
    what = f"dry-run {rec['arch']} {rec['shape']} {rec['mesh']}"
    cfg, sh = get_config(rec["arch"]), INPUT_SHAPES[rec["shape"]]
    if rec["overrides"].get("kv_dtype"):
        cfg = dataclasses.replace(cfg, kv_cache_dtype=rec["overrides"][
            "kv_dtype"])
    mesh = MESH.make_production_mesh(multi_pod=rec["mesh"] == "multi")
    leaves = D.cache_leaf_sizes(cfg, sh, mesh)
    ag = rec["collectives"]["all-gather"]
    hits = D.gathers_of(leaves, ag["shapes"])
    two_d = SH.logical_to_mesh(cfg, mesh, "serve", rec["overrides"].get(
        "serve_1d", False))["embed"] == "data"
    weights = D.serve_weight_pass_bytes(cfg, mesh) if two_d else 0.0
    rest = rec["collectives"]["total_bytes"] - weights
    ratio = rec["cost"]["flops"] / rec["analytic"]["decode_flops_per_device"]
    print(f"  {what}: {hits} all-gathers of a cache leaf, all-gathers "
          f"{ag['bytes']:.4e} B (largest {ag['largest_bytes']:.4e}); 2-D "
          f"serve weights {two_d} (one pass {weights:.4e} B), collectives "
          f"beside it {rest:.4e} B; FLOPs / per-device analytic "
          f"{ratio:.6f}", flush=True)
    if hits or ag["cache_leaf_gathers"]:
        fail(f"{what} gathered a cache leaf {hits} times")
    if not two_d and not ag["bytes"] < max(n for n, _ in leaves) * 2:
        fail(f"{what} all-gathered {ag['bytes']} bytes a device")
    if not (rest < DRYRUN_COLL_LIMIT and ag["bytes"] >= weights):
        fail(f"{what} moved {rec['collectives']['total_bytes']} collective "
             f"bytes a device, {rest} beside one pass over its 2-D serve "
             f"weights ({weights}), over {DRYRUN_COLL_LIMIT:.0e}")
    if not abs(ratio - 1) < DRYRUN_FLOPS_RTOL:
        fail(f"{what}: FLOPs {rec['cost']['flops']} against the analytic "
             f"{rec['analytic']['decode_flops_per_device']}")


def mesh_train(torch, cfg, mesh, dev, steps: int, zero_counts,
               read_counts) -> dict:
    """``steps`` train steps of full-width ``cfg`` with and without the
    (1, 1) ``mesh``: (loss, grad_norm, moe_aux) a step within
    ``MESH_RTOL``, step ms.  A MoE's steps run under
    ``torch.use_deterministic_algorithms``: its combine is a scatter-add,
    whose order is not fixed on the card, and a router near-tie amplifies
    an ulp into another expert's choice within a step or two."""
    import numpy as np
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import train as LT
    runs = {}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(cfg.is_moe or was, warn_only=True)
    for name, m, c in (("plain", None, None),
                       ("mesh", mesh, SH.ActCtx(cfg, mesh))):
        state = LT.init_state(cfg, dev, m)
        step = LT.make_step(cfg, lr=LLM_LR, steps=LLM_STEPS, ctx=c)
        data = LT.batches(cfg, LLM_BATCH, LLM_SEQ, dev, m)
        metrics, ms = [], []
        zero_counts()
        for _ in range(steps):
            batch = next(data)
            t0 = time.perf_counter()
            state, mt = step(state, batch)
            metrics.append((float(mt["loss"]), float(mt["grad_norm"]),
                            float(mt["moe_aux"])))
            ms.append(1e3 * (time.perf_counter() - t0))
        if any(read_counts().values()):
            fail(f"the {name} train steps of {cfg.name} launched a "
                 f"kernel")
        if name == "mesh" and not SH.is_dtensor(state.params["embed"]):
            fail("the mesh train step did not keep DTensor parameters")
        runs[name] = (metrics, float(np.median(ms[1:])))
        del state, step, data, batch
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(was)
    gaps = [max(abs(a - b) / abs(b) if b else abs(a)
                for a, b in zip(x, y))
            for x, y in zip(runs["mesh"][0], runs["plain"][0])]
    print(f"{cfg.name} train on a (1, 1) mesh, {steps} steps of "
          f"{LLM_BATCH} x {LLM_SEQ}: (loss, grad_norm, moe_aux) mesh "
          f"{runs['mesh'][0]} plain {runs['plain'][0]}, largest "
          f"relative gap {max(gaps):.3g}; step ms (median of steps 2-"
          f"{steps}) mesh {runs['mesh'][1]:.1f} plain "
          f"{runs['plain'][1]:.1f} (DTensor's dispatch "
          f"{runs['mesh'][1] - runs['plain'][1]:.1f})", flush=True)
    if not max(gaps) <= MESH_RTOL:
        fail(f"the mesh train steps of {cfg.name} differ from the "
             f"plain ones by {max(gaps)} > {MESH_RTOL}")
    return {"steps": steps, "mesh": runs["mesh"][0],
            "plain": runs["plain"][0], "rel_gap": max(gaps),
            "mesh_step_ms": runs["mesh"][1],
            "plain_step_ms": runs["plain"][1]}


def mesh_serve(torch, cfg, mesh, dev, zero_counts, read_counts) -> dict:
    """One ``MESH_PROMPT``-token prefill and ``MESH_NEW`` greedy decode
    steps of full-width ``cfg`` under flash, with and without the (1, 1)
    ``mesh``: tokens equal, prefill logits within ``LOGIT_ATOL``, one
    flash launch a layer each."""
    import numpy as np
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import meta as M
    from repro_torch.train import steps as ST
    fcfg = dataclasses.replace(cfg, attn_impl="flash")
    params = M.init_params(fcfg, torch.Generator(device=dev)
                           .manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (1, MESH_PROMPT)).astype(np.int32)).to(dev)
    serve = {}
    for name, c in (("plain", None), ("mesh", SH.ActCtx(fcfg, mesh))):
        p = params if c is None else SH.distribute_tree(
            params, SH.param_shardings(fcfg, mesh, "serve"))
        toks = prompt if c is None else SH.distribute(
            prompt, SH.batch_specs(fcfg, mesh, 1,
                                   {"t": prompt})["t"])
        prefill = ST.make_prefill_step(
            fcfg, cache_len=MESH_PROMPT + MESH_NEW, ctx=c)
        decode = ST.make_decode_step(fcfg, ctx=c)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(p, {"tokens": toks})
        got, margins, first = [], [], None
        for _ in range(MESH_NEW):
            full = logits.full_tensor() if SH.is_dtensor(logits) \
                else logits
            if first is None:
                first = full.float().cpu()
            top = torch.topk(full[0].float(), 2).values
            margins.append(float(top[0] - top[1]))
            tok = torch.argmax(full, dim=-1).to(torch.int32)
            got.append(int(tok[0]))
            if c is not None:
                tok = SH.distribute(tok, SH.batch_specs(
                    fcfg, mesh, 1, {"t": tok})["t"])
            logits, cache = decode(p, cache, tok)
        torch.cuda.synchronize()
        serve[name] = (got, margins, first,
                       time.perf_counter() - t0,
                       read_counts()["flash_attention"])
        del cache, logits
    flips = same_tokens(f"{cfg.name} serve on the mesh",
                        serve["mesh"][0], serve["plain"][0],
                        serve["plain"][1])
    lgap = float((serve["mesh"][2] - serve["plain"][2]).abs().max())
    print(f"{cfg.name} serve on a (1, 1) mesh under the serve rules "
          f"(flash on the local heads): a {MESH_PROMPT}-token prefill "
          f"and {MESH_NEW} decode steps, tokens "
          f"{'equal to' if not flips else 'near-tie flips from'} the "
          f"plain path's ({serve['mesh'][0][:6]}...), prefill logits "
          f"within {lgap:.3g}; flash launches mesh {serve['mesh'][4]} "
          f"plain {serve['plain'][4]}; {serve['mesh'][3]:.2f} s vs "
          f"{serve['plain'][3]:.2f} s", flush=True)
    if not lgap <= LOGIT_ATOL:
        fail(f"{cfg.name}: mesh prefill logits differ by {lgap} > "
             f"{LOGIT_ATOL}")
    if serve["mesh"][4] != cfg.num_layers or \
            serve["plain"][4] != cfg.num_layers:
        fail(f"{cfg.name}: flash launches {serve['mesh'][4]} (mesh) and "
             f"{serve['plain'][4]} (plain), want {cfg.num_layers} each")
    del params
    torch.cuda.empty_cache()
    return {"tokens": serve["mesh"][0], "flips": flips,
            "prefill_logit_gap": lgap,
            "flash_launches": serve["mesh"][4],
            "plain_flash_launches": serve["plain"][4],
            "mesh_s": serve["mesh"][3], "plain_s": serve["plain"][3]}


def multi_device_phase(torch, SS, mrep, cap_args, zero_counts,
                       read_counts) -> dict:
    """Phase 15: the multi-device slice on the one card.

    1. The full-fleet ``metropolis(duration_s=METRO_S)`` with its row axis
       in ``FLEET_SHARDS`` shards on cuda:0: the report equal to the
       unsharded run's (``mrep``, phase 7) but for the launch count,
       superstep launches = ``FLEET_SHARDS`` x supersteps; and
       ``_superstep_fn(cap, n)`` on the cap slab (``cap_args``)
       bit-identical for every n of ``SHARD_COUNTS``.
    2. Full-width ``LLM_ARCH`` on a (1, 1) ``DeviceMesh`` over a one-rank
       NCCL group: ``MESH_STEPS`` train steps with DTensor parameters and
       AdamW state placed by the train rules and ``ActCtx`` against the
       same steps without a mesh (``MESH_RTOL``), step ms with and
       without; ``REMAT_STEPS`` steps under ``remat_policy="dots"``
       against remat alone, with their peak memory; one
       ``MESH_PROMPT``-token prefill and ``MESH_NEW`` greedy decode steps
       under the serve rules (flash attention on the local heads) against
       the plain path's tokens; the same train steps (``MESH_MOE_STEPS``
       of them, the aux loss held too) and serve run for full-width
       ``MESH_MOE_ARCH``.
    Returns the numbers, and the recorder of the sharded run's superstep
    launches."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import multihost
    from repro_torch.launch import train as LT
    from repro_torch.system import metropolis, run_query
    from repro_torch.system.superstep import _superstep_fn
    out = {}

    # 1. the fleet's row axis in shards on one card
    msc = metropolis(duration_s=METRO_S, shard_fleet=FLEET_SHARDS)
    with Recorder(SS, "superstep") as rec_shard:
        zero_counts()
        t0 = time.perf_counter()
        srep = run_query(msc, device="cuda")
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        shard_counts = read_counts()
    launch_keys = ("kernel_launches", "launches_per_tick")

    def view(r):
        return ({k: v for k, v in r.summary().items()
                 if k not in launch_keys}, r.per_query_summary(),
                r.accuracy_timeline(), r.thresholds, r.queries)
    print(f"metropolis, fleet in {FLEET_SHARDS} row shards on cuda:0: "
          f"{shard_s:.2f} s, {srep.n_items} items, supersteps "
          f"{srep.supersteps}, superstep launches "
          f"{shard_counts['superstep']}, slab shards "
          f"{sorted(rec_shard.counts)}", flush=True)
    if view(srep) != view(mrep):
        fail("metropolis with its fleet in row shards differs from the "
             "unsharded run")
    if not 0 < shard_counts["superstep"] == FLEET_SHARDS * srep.supersteps \
            == srep.summary()["kernel_launches"]:
        fail(f"sharded metropolis: {shard_counts['superstep']} superstep "
             f"launches for {srep.supersteps} supersteps x {FLEET_SHARDS}")
    *cap_in, cap_kw = cap_args
    outs = {}
    for n in SHARD_COUNTS:
        outs[n] = _superstep_fn(cap_kw["capacity"], n)(*cap_in)
        for a, b, what in zip(outs[n], outs[1], ("routes", "slots", "ths")):
            if not torch.equal(a, b):
                fail(f"_superstep_fn over {n} shards differs in {what} from "
                     f"one launch at {tuple(cap_in[0].shape)}")
    S, R, N = cap_in[0].shape
    k = R // FLEET_SHARDS           # the first shard's rows of each operand
    conf, th0, mask, drain, gains = cap_in
    shard_in = [conf[:, :k], th0[:k], mask[:, :k], drain[:k], gains]
    shard_ms = device_ms(torch, lambda: SS.superstep(*shard_in, **cap_kw),
                         100)
    split_ms = device_ms(torch, lambda: _superstep_fn(
        cap_kw["capacity"], FLEET_SHARDS)(*cap_in), 50)
    one_ms = device_ms(torch, lambda: SS.superstep(*cap_in, **cap_kw), 100)
    print(f"superstep cap slab {(S, R, N)}: bit-identical over "
          f"{list(SHARD_COUNTS)} shards; one launch {one_ms:.5f} ms, a "
          f"{(S, R // FLEET_SHARDS, N)} shard launch {shard_ms:.5f} ms, "
          f"the {FLEET_SHARDS}-shard program {split_ms:.5f} ms", flush=True)
    out["fleet"] = {"shards": FLEET_SHARDS, "cuda_s": shard_s,
                    "supersteps": srep.supersteps,
                    "superstep_launches": shard_counts["superstep"],
                    "cap_slab": [S, R, N], "one_launch_ms": one_ms,
                    "shard_launch_ms": shard_ms,
                    "sharded_program_ms": split_ms,
                    "bit_identical_shards": list(SHARD_COUNTS)}

    # 2. the sharded train and serve path at full width on a (1, 1) mesh
    cfg = get_config(LLM_ARCH)
    dev = multihost.initialize(f"localhost:{LT.free_port()}", 1, 0,
                               device="cuda")
    try:
        mesh = MESH.make_host_mesh("cuda")
        out["train"] = mesh_train(torch, cfg, mesh, dev, MESH_STEPS,
                                  zero_counts, read_counts)

        remat = {}
        for policy in (None, "dots"):
            state = LT.init_state(cfg, dev)
            step = LT.make_step(cfg, lr=LLM_LR, steps=LLM_STEPS,
                                remat_policy=policy)
            data = LT.batches(cfg, LLM_BATCH, LLM_SEQ, dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            losses = []
            for _ in range(REMAT_STEPS):
                state, mt = step(state, next(data))
                losses.append(float(mt["loss"]))
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            remat[policy or "remat"] = (losses, peak)
            del state, step, data
            torch.cuda.empty_cache()
        rgap = max(abs(a - b) / abs(b) for a, b in
                   zip(remat["dots"][0], remat["remat"][0]))
        print(f"remat_policy='dots' against remat alone, {REMAT_STEPS} "
              f"steps: losses {remat['dots'][0]} vs {remat['remat'][0]} "
              f"(relative gap {rgap:.3g}); peak memory over the state "
              f"{remat['dots'][1]:.2f} GB vs {remat['remat'][1]:.2f} GB",
              flush=True)
        if not rgap <= MESH_RTOL:
            fail(f"remat_policy='dots' moved the loss by {rgap}")
        out["remat_dots"] = {"losses": remat["dots"][0],
                             "remat_losses": remat["remat"][0],
                             "peak_gb": remat["dots"][1],
                             "remat_peak_gb": remat["remat"][1]}
        out["serve"] = mesh_serve(torch, cfg, mesh, dev, zero_counts,
                                  read_counts)
        moe = get_config(MESH_MOE_ARCH)
        out["moe_train"] = mesh_train(torch, moe, mesh, dev, MESH_MOE_STEPS,
                                      zero_counts, read_counts)
        out["moe_serve"] = mesh_serve(torch, moe, mesh, dev, zero_counts,
                                      read_counts)
    finally:
        dist.destroy_process_group()
    out["superstep_recorder"] = rec_shard
    return out


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    import torch
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F
    from repro_torch.detection import components
    from repro_torch.kernels import calibrate as C
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import framediff as FD
    from repro_torch.kernels import morphology as MO
    from repro_torch.kernels import ops, runtime
    from repro_torch.kernels import pixel_cascade as PC
    from repro_torch.kernels import similarity as SIM
    from repro_torch.kernels import superstep as SS
    from repro_torch.kernels import triage as T
    from repro_torch.serving.engine import AsyncDriver, VirtualClock
    from repro_torch.system import (PixelFrontend, city_scale, crowd_flow,
                                    drifting_city, metropolis, pixel_city,
                                    run_query, vehicle_pursuit)
    from repro_torch.system import tracks as TK
    from repro_torch.system.scenario import frame_schedule
    counters = (T, C, FD, MO, PC, SS, SIM, FA)

    def zero_counts():
        for mod in counters:
            mod.LAUNCHES = 0

    def read_counts():
        return {mod.__name__.rsplit(".", 1)[1]: mod.LAUNCHES
                for mod in counters}

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    phase("card")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    built = runtime.build(runtime.KERNELS)
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, info in sorted(built.items()):
        print(f"-- {name}: {info['path']}\n{info['log'].strip()}")
        runtime.library(name)
    # the production-shape dry-runs work on the host's cores beside the
    # card's phases; phase 15 reads them
    dry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    dryruns = start_dryruns(dry_dir)
    atexit.register(stop_dryruns, dryruns, dry_dir)

    phase("kernels vs plain versions")
    check_triage(torch, T, ops, dev)
    check_calibrate(torch, C, dev)
    torch.cuda.synchronize()
    print("triage exact, calibrate within", CAL_ATOL, flush=True)
    check_pixel(torch, FD, MO, PC, ops, dev)
    torch.cuda.synchronize()
    check_superstep(torch, SS, dev)
    check_associate(torch, F, SIM, ops, dev)
    torch.cuda.synchronize()
    check_flash(torch, FA, dev)
    torch.cuda.synchronize()

    phase("main path: city_scale (64 edges, 512 cameras, 60 s)")
    sc = city_scale(duration_s=60.0)
    with Recorder(T, "triage_fleet") as tri_city:
        zero_counts()
        t0 = time.perf_counter()
        rep = run_query(sc, device="cuda")
        torch.cuda.synchronize()
        city_cuda_s = time.perf_counter() - t0
        city_launches = (T.LAUNCHES, C.LAUNCHES)
    s_cuda = rep.summary()
    t0 = time.perf_counter()
    s_cpu = run_query(sc, device="cpu").summary()
    city_cpu_s = time.perf_counter() - t0
    print(f"cuda {city_cuda_s:.2f} s, cpu {city_cpu_s:.2f} s, "
          f"{rep.n_items} items, launches {city_launches}, "
          f"shapes {sorted(tri_city.inputs)}", flush=True)
    if city_launches[0] == 0:
        fail("city_scale launched the triage kernel no time")
    if city_launches[0] != s_cuda["kernel_launches"]:
        fail(f"triage launches {city_launches[0]} != kernel_launches "
             f"{s_cuda['kernel_launches']}")
    if s_cuda != s_cpu:
        diff = {k: (s_cuda[k], s_cpu.get(k)) for k in s_cuda
                if s_cuda[k] != s_cpu.get(k)}
        fail(f"city_scale summary differs between cuda and cpu: {diff}")
    if rep.n_items == 0 or not all(
            v == v for v in s_cuda.values() if isinstance(v, float)):
        fail("city_scale answered nothing or reported NaN")

    phase("feedback path: drifting_city (8 cameras, 60 s)")
    dsc = drifting_city(num_cameras=8, duration_s=60.0)
    with Recorder(T, "triage_fleet") as tri_drift, \
            Recorder(C, "calibrate_fleet") as cal_drift:
        zero_counts()
        t0 = time.perf_counter()
        d_cuda = run_query(dsc, device="cuda").summary()
        torch.cuda.synchronize()
        drift_cuda_s = time.perf_counter() - t0
        drift_launches = (T.LAUNCHES, C.LAUNCHES)
    d_open = run_query(dataclasses.replace(dsc, update_period_s=None),
                       device="cuda").summary()
    d_cpu = run_query(dsc, device="cpu").summary()
    drift_same = d_cuda == d_cpu
    print(f"cuda {drift_cuda_s:.2f} s, launches {drift_launches}, "
          f"model_updates {d_cuda['model_updates']}, F2 closed "
          f"{d_cuda['accuracy_F2']} vs open {d_open['accuracy_F2']}, "
          f"calibrate shapes {sorted(cal_drift.inputs)}, summary "
          f"{'identical to' if drift_same else 'differs from'} cpu",
          flush=True)
    if not drift_same:
        check_within_gate("drifting_city", d_cuda, d_cpu)
    if drift_launches[0] == 0 or drift_launches[0] != d_cuda["kernel_launches"]:
        fail(f"drifting_city triage launches {drift_launches[0]} vs "
             f"kernel_launches {d_cuda['kernel_launches']}")
    if not 0 < d_cuda["model_updates"] == drift_launches[1]:
        fail(f"calibrate launches {drift_launches[1]} vs model_updates "
             f"{d_cuda['model_updates']} (must be equal and > 0)")
    if not d_cuda["accuracy_F2"] > d_open["accuracy_F2"]:
        fail("the closed feedback loop did not beat the open-loop ablation")

    phase("pixel path: pixel_city (12 cameras, 4 edges, 12 s)")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: they would move the classifier's "
             "confidences")
    psc = pixel_city()
    ticks = frame_schedule(psc).shape[0]
    fe = PixelFrontend(seed=0, device="cuda")
    batches = count_batches(fe.model)
    with Recorder(PC, "pixel_cascade") as pc_rec, \
            Recorder(T, "triage_fleet") as tri_pixel, \
            StageClock(torch, components, "label_components") as ccl:
        zero_counts()
        t0 = time.perf_counter()
        prep = run_query(psc, frontend=fe, device="cuda")
        torch.cuda.synchronize()
        pixel_cuda_s = time.perf_counter() - t0
        pixel_counts = read_counts()
    p_cuda = prep.summary()
    split_cuda = {**fe.timings, "ccl_s": ccl.seconds}
    print(f"cuda {pixel_cuda_s:.2f} s, {prep.n_items} items, {ticks} ticks, "
          f"launches {pixel_counts}, classifier batches {batches}",
          flush=True)
    print(f"card split: render {split_cuda['render_s']:.3f} s, framediff "
          f"{split_cuda['framediff_s']:.3f} s (CCL {ccl.seconds:.3f} s in "
          f"{ccl.calls} calls), classify {split_cuda['classify_s']:.3f} s, "
          f"triage {prep.stage_timings['triage_s']:.3f} s", flush=True)
    if pixel_counts["pixel_cascade"] != ticks or ticks == 0:
        fail(f"pixel_cascade launches {pixel_counts['pixel_cascade']} != "
             f"ticks {ticks}")
    if not 0 < len(batches) == fe.launches:
        fail(f"classifier batches {len(batches)} vs fe.launches "
             f"{fe.launches} (must be equal and > 0)")
    if any(n < 8 or n & (n - 1) for n, _ in batches):
        fail(f"classifier batches not bucket-padded: {batches}")
    if pixel_counts["triage"] != p_cuda["kernel_launches"]:
        fail(f"pixel_city triage launches {pixel_counts['triage']} != "
             f"kernel_launches {p_cuda['kernel_launches']}")
    if pixel_counts["framediff"] or pixel_counts["morphology"]:
        fail("the fused pixel path launched a staged kernel")
    if prep.n_items == 0 or not all(
            v == v for v in p_cuda.values() if isinstance(v, float)):
        fail("pixel_city answered nothing or reported NaN")
    # the same stream again on the card, set-up paid (cuBLAS, allocator):
    # the steady-state split
    fe_warm = PixelFrontend(seed=0, device="cuda")
    with StageClock(torch, components, "label_components") as ccl_warm:
        fe_warm.stream(psc)
        torch.cuda.synchronize()
    split_warm = {**fe_warm.timings, "ccl_s": ccl_warm.seconds}
    print(f"card split, second run: render {split_warm['render_s']:.3f} s, "
          f"framediff {split_warm['framediff_s']:.3f} s (CCL "
          f"{ccl_warm.seconds:.3f} s), classify "
          f"{split_warm['classify_s']:.3f} s", flush=True)
    fe_cpu = PixelFrontend(seed=0, device="cpu")
    with StageClock(torch, components, "label_components") as ccl_cpu:
        t0 = time.perf_counter()
        p_cpu = run_query(psc, frontend=fe_cpu, device="cpu").summary()
        pixel_cpu_s = time.perf_counter() - t0
    split_cpu = {**fe_cpu.timings, "ccl_s": ccl_cpu.seconds}
    dconf = stream_diff(fe.stream(psc), fe_cpu.stream(psc))
    pixel_same = p_cuda == p_cpu
    print(f"cpu {pixel_cpu_s:.2f} s; host split: render "
          f"{split_cpu['render_s']:.3f} s, framediff "
          f"{split_cpu['framediff_s']:.3f} s (CCL {ccl_cpu.seconds:.3f} s), "
          f"classify {split_cpu['classify_s']:.3f} s; stream max |dconf| "
          f"{dconf:.3g}; summary "
          f"{'identical to' if pixel_same else 'differs from'} cpu",
          flush=True)
    if not dconf <= CONF_ATOL:
        fail(f"pixel_city conf differs by {dconf} > {CONF_ATOL} between "
             f"cuda and cpu")
    if not pixel_same:
        check_within_gate("pixel_city", p_cuda, p_cpu)
    fe_staged = PixelFrontend(seed=0, fused=False, device="cuda")
    with Recorder(FD, "framediff") as fd_rec, \
            Recorder(MO, "morph3x3") as mo_rec:
        zero_counts()
        t0 = time.perf_counter()
        staged_items = fe_staged.stream(psc)
        torch.cuda.synchronize()
        staged_s = time.perf_counter() - t0
        staged_counts = read_counts()
    print(f"staged (fused=False) stream in {staged_s:.2f} s, launches "
          f"{staged_counts}", flush=True)
    if staged_items != fe.stream(psc):
        fail("fused=False gave another stream than the fused cascade")
    if (staged_counts["framediff"], staged_counts["morphology"],
            staged_counts["pixel_cascade"]) != (ticks, 2 * ticks, 0):
        fail(f"staged launches {staged_counts} vs {ticks} ticks (want "
             f"framediff = ticks, morphology = 2 x ticks, cascade 0)")
    # one tick's pixel stage on the card: the device operations of one
    # ops.pixel_cascade call on the views the main path passed, against
    # the five of the sequence that widened them first
    views, tick_kw = tick_views(torch, pc_rec)
    tick_ops = device_ops(torch, lambda: ops.pixel_cascade(
        *views, **tick_kw, device=dev))
    parent_ops = device_ops(torch, lambda: parent_tick(torch, PC, views,
                                                       tick_kw))
    print(f"pixel stage device operations a tick on "
          f"{[tuple(v.stride()) for v in views]} uint8 views: "
          f"{len(tick_ops)} {tick_ops}; widened first: {len(parent_ops)} "
          f"{parent_ops}", flush=True)
    if len(tick_ops) != 1:
        fail(f"one ops.pixel_cascade call made {len(tick_ops)} device "
             f"operations, not 1: {tick_ops}")
    if len(parent_ops) != 5:
        fail(f"the widened-first tick made {len(parent_ops)} device "
             f"operations, not the parent's 5: {parent_ops}")

    phase(f"superstep path: metropolis, full fleet, {METRO_S} s")
    msc = metropolis(duration_s=METRO_S)
    with Recorder(SS, "superstep", keep_all=True) as ss_full:
        zero_counts()
        t0 = time.perf_counter()
        mrep = run_query(msc, device="cuda")
        torch.cuda.synchronize()
        metro_cuda_s = time.perf_counter() - t0
        metro_counts = read_counts()
    m_cuda = mrep.summary()
    print(f"cuda {metro_cuda_s:.2f} s for {METRO_S} s of {msc.num_cameras} "
          f"cameras, {msc.num_edges} edges, {len(msc.queries)} queries: "
          f"{mrep.n_items} items, triaged_ticks {mrep.triaged_ticks}, "
          f"supersteps {mrep.supersteps}, superstep launches "
          f"{metro_counts['superstep']}, triage launches "
          f"{metro_counts['triage']}, stage_timings {mrep.stage_timings}, "
          f"slabs {[list(a[0].shape) for a in ss_full.calls]}", flush=True)
    if (msc.num_cameras, msc.num_edges, len(msc.queries)) != (10240, 1024, 24):
        fail("metropolis is not at the preset's full fleet")
    if not 0 < metro_counts["superstep"] == mrep.supersteps:
        fail(f"superstep launches {metro_counts['superstep']} != supersteps "
             f"{mrep.supersteps} (must be equal and > 0)")
    if not mrep.triaged_ticks / mrep.supersteps >= 10.0:
        fail(f"metropolis fused only {mrep.triaged_ticks} / "
             f"{mrep.supersteps} triaged ticks per superstep")
    if mrep.n_items == 0 or not all(
            v == v for v in m_cuda.values() if isinstance(v, float)):
        fail("metropolis answered nothing or reported NaN")
    metro_cpu_s = None
    if time.perf_counter() - t_all < HOST_METRO_BUDGET_S:
        t0 = time.perf_counter()
        m_cpu = run_query(msc, device="cpu").summary()
        metro_cpu_s = time.perf_counter() - t0
        print(f"cpu {metro_cpu_s:.2f} s, summary "
              f"{'identical to' if m_cpu == m_cuda else 'differs from'} "
              f"cuda", flush=True)
        if m_cpu != m_cuda:
            diff = {k: (m_cuda[k], m_cpu.get(k)) for k in m_cuda
                    if m_cuda[k] != m_cpu.get(k)}
            fail(f"full-fleet metropolis differs between cuda and cpu: {diff}")
    else:
        print(f"cpu run of the full fleet skipped: "
              f"{time.perf_counter() - t_all:.0f} s into the script",
              flush=True)

    def report_view(r):
        return (r.summary(), r.per_query_summary(), r.accuracy_timeline(),
                r.thresholds, r.queries)

    ssc = metropolis(**METRO_SMOKE)
    with Recorder(SS, "superstep", keep_all=True) as ss_smoke:
        zero_counts()
        t0 = time.perf_counter()
        rs_cuda = run_query(ssc, device="cuda")
        torch.cuda.synchronize()
        smoke_cuda_s = time.perf_counter() - t0
        smoke_counts = read_counts()
    t0 = time.perf_counter()
    rs_cpu = run_query(ssc, device="cpu")
    smoke_cpu_s = time.perf_counter() - t0
    if report_view(rs_cuda) != report_view(rs_cpu):
        fail("metropolis smoke report differs between cuda and cpu")
    with Recorder(SS, "superstep") as ss_k1:
        zero_counts()
        r1 = run_query(dataclasses.replace(ssc, superstep=1), device="cuda")
        k1_counts = read_counts()
    launch_keys = ("kernel_launches", "launches_per_tick", "supersteps")
    v128, v1 = report_view(rs_cuda), report_view(r1)
    if ({k: v for k, v in v1[0].items() if k not in launch_keys}
            != {k: v for k, v in v128[0].items() if k not in launch_keys}
            or v1[1:] != v128[1:]):
        fail("metropolis superstep=1 is not bit-identical to superstep=128")
    if not k1_counts["superstep"] == r1.supersteps == r1.triaged_ticks:
        fail(f"superstep=1 launched {k1_counts['superstep']} times for "
             f"{r1.triaged_ticks} triaged ticks")
    print(f"smoke size: cuda {smoke_cuda_s:.2f} s, cpu {smoke_cpu_s:.2f} s, "
          f"{rs_cuda.n_items} items, supersteps {rs_cuda.supersteps} "
          f"(launches {smoke_counts['superstep']}) for "
          f"{rs_cuda.triaged_ticks} triaged ticks; report identical to cpu; "
          f"superstep=1 ({k1_counts['superstep']} launches) bit-identical "
          f"to superstep=128", flush=True)
    if smoke_counts["superstep"] != rs_cuda.supersteps:
        fail("smoke superstep launches != supersteps")

    phase("track path: vehicle_pursuit (12 cameras, 6 edges, 60 s), "
          "crowd_flow (8 cameras, 4 edges, 45 s)")
    track = {}
    assoc_recs = {}
    for name, make in (("vehicle_pursuit", vehicle_pursuit),
                       ("crowd_flow", crowd_flow)):
        tsc = make()
        with Recorder(SIM, "associate", keep_all=True) as rec, \
                TickAudit(TK, SIM) as audit:
            zero_counts()
            t0 = time.perf_counter()
            tr = run_query(tsc, device="cuda")
            torch.cuda.synchronize()
            cuda_s = time.perf_counter() - t0
            counts = read_counts()
        assoc_recs[name] = rec
        t_cuda = tr.summary()
        t0 = time.perf_counter()
        t_cpu = run_query(tsc, device="cpu").summary()
        cpu_s = time.perf_counter() - t0
        track[name] = {"cuda_s": cuda_s, "cpu_s": cpu_s, "items": tr.n_items,
                       "ticks": tr.ticks, "track_items": tr.track_items,
                       "track_launches": tr.track_launches,
                       "associate_launches": counts["similarity"],
                       "triage_launches": counts["triage"],
                       "id_switches": tr.id_switches,
                       "prewarm_hits": tr.prewarm_hits,
                       "associate_s": tr.stage_timings["associate_s"],
                       "identical_to_cpu": t_cuda == t_cpu}
        print(f"{name}: {json.dumps(track[name])}; crop shapes "
              f"{sorted(rec.inputs)}", flush=True)
        if t_cuda != t_cpu:
            flips, first = 0, None
            for emb, trk, cq, tq, thr, _ in rec.calls:
                got = SIM.associate(emb, trk, cq, tq, thr)[0].cpu()
                want = SIM.associate_torch(
                    *(t.cpu() for t in (emb, trk, cq, tq, thr)))[0]
                bad = (got != want).nonzero().flatten().tolist()
                flips += len(bad)
                if bad and first is None:
                    first = (tuple(emb.shape), bad[0], int(got[bad[0]]),
                             int(want[bad[0]]))
            fail(f"{name} summary differs between cuda and cpu: "
                 f"{flips} flipped assignments on the recorded inputs, first "
                 f"(shape, crop, cuda, cpu) {first}")
        if not 0 < counts["similarity"] == tr.track_launches <= tr.ticks:
            fail(f"{name}: associate launches {counts['similarity']} vs "
                 f"track_launches {tr.track_launches} vs ticks {tr.ticks}")
        if audit.bad or audit.expected != counts["similarity"]:
            fail(f"{name}: {audit.bad} of {audit.ticks} track ticks broke "
                 f"the one-launch-per-tick-with-crops-and-tracks budget")
    psc_t = vehicle_pursuit()
    off = run_query(dataclasses.replace(psc_t, predictive_handoff=False),
                    device="cuda")
    if not track["vehicle_pursuit"]["id_switches"] < off.id_switches:
        fail(f"vehicle_pursuit: hand-off {track['vehicle_pursuit']['id_switches']}"
             f" id switches, not fewer than the ablation's {off.id_switches}")
    sim_r = run_query(psc_t, device="cuda")
    async_r = run_query(psc_t, driver=AsyncDriver(VirtualClock()),
                        device="cuda")
    if async_r.summary() != sim_r.summary() or not (
            async_r.latencies.shape == sim_r.latencies.shape
            and (async_r.latencies == sim_r.latencies).all()):
        fail("vehicle_pursuit: AsyncDriver(VirtualClock()) differs from "
             "SimDriver on the card")
    print(f"vehicle_pursuit: {track['vehicle_pursuit']['id_switches']} id "
          f"switches with hand-off vs {off.id_switches} without; "
          f"AsyncDriver identical to SimDriver", flush=True)

    phase("serving path: CascadeServer, full-width qwen1.5-0.5b (24 layers, "
          "flash) behind its edge variant, 16 requests, 8 slots")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: they would move the logits")
    serving = serving_phase(torch, dev, zero_counts, read_counts)
    deep = deep_logit_gap(torch, dev)

    phase("dense family: speculative decoding, the int8 KV cache and int8 "
          "weights on full-width qwen1.5-0.5b; chatglm3-6b and command-r-35b "
          f"at full width, {DENSE_LAYERS} layers")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: they would move the logits")
    dense = dense_family_phase(torch, dev, serving, zero_counts, read_counts)
    serve_prompts = serving["bench"]["prompts"]
    del serving["cloud"], serving["bench"]
    torch.cuda.empty_cache()

    phase("the remaining families: granite-moe (24 layers) and hymba (32) "
          "through CascadeServer, mamba2 (64) through DecodeEngine, "
          f"phi3.5-moe at full width ({PHI_LAYERS} layers), whisper (32 + "
          "32) and internvl2 (24) through prefill and decode")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: they would move the logits")
    families = families_phase(torch, dev, serve_prompts, zero_counts,
                              read_counts)

    phase("training path: the shared workload (8 cameras, 3 edges, 240 s, "
          "80 steps) trained and scored on the card, Table II, Fig. 5")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: they would move the trained weights")
    training = training_phase(torch, T, zero_counts)
    tri_train = training.pop("recorder")

    phase(f"LLM training: full-width {LLM_ARCH} ({LLM_STEPS} steps of "
          f"{LLM_BATCH} x {LLM_SEQ} tokens), microbatches, checkpoint; 2 "
          "layers and every reduced config, card vs host")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: they would move the losses")
    llm = llm_training_phase(torch, dev, zero_counts, read_counts)

    phase(f"multi-device (15): metropolis with its fleet in {FLEET_SHARDS} "
          f"row shards; full-width {LLM_ARCH} and {MESH_MOE_ARCH} train "
          f"and serve on a (1, 1) device mesh; the production-shape "
          f"dry-runs")
    multi = multi_device_phase(
        torch, SS, mrep, max(ss_full.calls, key=lambda a: a[0].numel()),
        zero_counts, read_counts)
    ss_shard = multi.pop("superstep_recorder")
    multi["dryruns"] = finish_dryruns(dryruns, t_all)

    phase("timing on the main paths' inputs")
    # the card's launch floor: triage.cu's empty kernel, the same build,
    # hold and reps as the kernels it is read against
    floor_ms = device_ms(torch, lambda: T.empty_launch(dev), 200)
    print(f"launch floor (empty kernel, one warp): {floor_ms:.5f} ms",
          flush=True)
    # triage: every recorded main-path input re-checked, every shape
    # timed with its launches, city_scale's largest (64, 64) the row's
    tri_recs = (tri_city, tri_drift, tri_pixel, tri_train)
    tri_inputs, tri_counts = {}, {}
    for rec in tri_recs:
        for shape, n in rec.counts.items():
            tri_inputs.setdefault(shape, rec.inputs[shape])
            tri_counts[shape] = tri_counts.get(shape, 0) + n
    for conf, thr, kw in (a for rec in tri_recs for a in rec.inputs.values()):
        want = T.triage_fleet_torch(conf, thr, **kw)
        if max_err(T.triage_fleet(conf, thr, **kw), want) != 0.0:
            fail(f"triage differs on a main-path input {tuple(conf.shape)}")
    tri_shapes = time_shapes(torch, tri_inputs, tri_counts, T.triage_fleet,
                             triage_bound_ms, 200, floor_ms)
    conf, thr, kw = tri_city.inputs[max(tri_city.inputs,
                                        key=lambda s: s[0] * s[1])]
    t_ms = device_ms(torch, lambda: T.triage_fleet(conf, thr, **kw), 200)
    t_plain = device_ms(torch, lambda: T.triage_fleet_torch(conf, thr, **kw),
                        50)
    t_err = max_err(T.triage_fleet(conf, thr, **kw),
                    T.triage_fleet_torch(conf, thr, **kw))
    t_bound, t_by = triage_bound_ms(*conf.shape)
    # calibrate: every recorded input re-checked, every shape and the
    # feedback window's full width timed, the largest recorded the row's
    cal_err = 0.0
    for scores, truths, ckw in cal_drift.inputs.values():
        kp, kc = C.calibrate_fleet(scores, truths, **ckw)
        pp, pc = C.calibrate_fleet_torch(scores, truths, **ckw)
        if not torch.equal(kc, pc):
            fail("calibrate counts differ on a main-path input")
        cal_err = max(cal_err, float((kp - pp).abs().max()))
    if not cal_err <= CAL_ATOL:
        fail(f"calibrate params differ by {cal_err} on main-path inputs")
    scores, truths, ckw = cal_drift.inputs[max(cal_drift.inputs,
                                               key=lambda s: s[0] * s[1])]
    wide = tuple(t.to(dev) for t in label_rows(torch, *CALIBRATE_WIDE, 3))
    cal_shapes = time_shapes(
        torch, {**cal_drift.inputs, CALIBRATE_WIDE: (*wide, ckw)},
        {**cal_drift.counts, CALIBRATE_WIDE: 0}, C.calibrate_fleet,
        lambda r, n: calibrate_bound_ms(r, n, ckw["iters"]), 200, floor_ms)
    c_ms = device_ms(torch, lambda: C.calibrate_fleet(scores, truths, **ckw),
                     200)
    c_plain = device_ms(
        torch, lambda: C.calibrate_fleet_torch(scores, truths, **ckw), 20)
    c_bound, c_by = calibrate_bound_ms(*scores.shape, ckw["iters"])
    print("triage shapes (R, N): launches, kernel ms, over the floor ms: "
          + "; ".join(f"{tuple(r['shape'])} {r['launches']} {r['ms']:.5f} "
                      f"{r['over_floor_ms']:.5f}"
                      for r in tri_shapes["shapes"])
          + "\ncalibrate shapes (R, N): " + "; ".join(
              f"{tuple(r['shape'])} {r['launches']} {r['ms']:.5f} "
              f"{r['over_floor_ms']:.5f}" for r in cal_shapes["shapes"]),
          flush=True)
    # the one-row launch (ops.triage / triage_batched, the port of
    # triage_dynamic_pallas): not on the main paths, timed at its bucket
    one = torch.rand((1, 16), device=dev)
    one_thr = torch.tensor([[0.7, 0.2]], device=dev)
    one_ms = device_ms(torch, lambda: T.triage_fleet(one, one_thr,
                                                     capacity=8), 200)
    one_plain = device_ms(
        torch, lambda: T.triage_fleet_torch(one, one_thr, capacity=8), 50)
    pixel_rows = time_pixel_kernels(
        torch, F, FD, MO, PC, dev,
        {"pixel_cascade": pc_rec, "framediff": fd_rec, "morph3x3": mo_rec},
        {"pixel_city": pixel_counts, "pixel_city_staged": staged_counts},
        (views, tick_kw), len(tick_ops), len(parent_ops), floor_ms)
    # the scan superstep: every recorded metropolis slab re-checked bit for
    # bit (the superstep=1 run's first of each shape), every slab shape
    # timed with its launches, the largest (the cap slab where the run
    # reaches it) the row's
    ss_calls = (ss_full.calls + ss_smoke.calls
                + list(ss_k1.inputs.values())
                + list(ss_shard.inputs.values()))
    for args in ss_calls:
        same_superstep(torch, SS, args)
    ss_inputs, ss_counts = {}, {}
    for rec in (ss_full, ss_smoke, ss_k1, ss_shard):
        for shape, n in rec.counts.items():
            ss_inputs.setdefault(shape, rec.inputs[shape])
            ss_counts[shape] = ss_counts.get(shape, 0) + n
    ss_shapes = time_shapes(torch, ss_inputs, ss_counts, SS.superstep,
                            superstep_bound_ms, 100, floor_ms)
    print("superstep slabs (S, R, N): launches, kernel ms, bytes bound ms, "
          "share of the bound: " + "; ".join(
              f"{tuple(r['shape'])} {r['launches']} {r['ms']:.5f} "
              f"{r['bound_ms']:.5f} {r['share_of_bound']:.3f}"
              for r in ss_shapes["shapes"]), flush=True)
    print(f"superstep device ms per metropolis runs "
          f"({ss_shapes['run']['launches']} launches over "
          f"{len(ss_shapes['shapes'])} slab shapes): kernel "
          f"{ss_shapes['run']['ms']:.4f}, bound "
          f"{ss_shapes['run']['bound_ms']:.4f}", flush=True)
    *ss_in, ss_kw = max(ss_full.calls, key=lambda a: a[0].numel())
    ss_ms = device_ms(torch, lambda: SS.superstep(*ss_in, **ss_kw), 100)
    ss_plain = device_ms(torch, lambda: SS.superstep_torch(*ss_in, **ss_kw),
                         5)
    ss_bound, ss_by = superstep_bound_ms(*ss_in[0].shape)
    # the association: every recorded track input re-checked, every
    # (M, K, D) timed with its launches, the largest the row's; the
    # library yardstick is the score step alone
    assoc_calls = [c for rec in assoc_recs.values() for c in rec.calls]
    a_err = 0.0
    a_inputs, a_counts = {}, {}
    for call in assoc_calls:
        emb, trk = call[0], call[1]
        a_err = max(a_err, assoc_diff(torch, SIM.associate(*call[:-1]),
                                      SIM.associate_torch(*call[:-1])))
        shape = (emb.shape[0], trk.shape[0], emb.shape[1])
        a_inputs.setdefault(shape, call)
        a_counts[shape] = a_counts.get(shape, 0) + 1
    if not a_err <= SIM_ATOL:
        fail(f"associate sim differs by {a_err} on main-path inputs")
    a_shapes = time_shapes(torch, a_inputs, a_counts, SIM.associate,
                           associate_bound_ms, 200, floor_ms)
    print("associate shapes (M, K, D): launches, kernel ms, bound ms: "
          + "; ".join(f"{tuple(r['shape'])} {r['launches']} {r['ms']:.5f} "
                      f"{r['bound_ms']:.3g}" for r in a_shapes["shapes"]),
          flush=True)
    print(f"associate device ms per track runs "
          f"({a_shapes['run']['launches']} launches over "
          f"{len(a_shapes['shapes'])} shapes): kernel "
          f"{a_shapes['run']['ms']:.4f}, bound "
          f"{a_shapes['run']['bound_ms']:.3g}", flush=True)
    *a_in, _ = max(assoc_calls, key=lambda a: a[0].shape[0] * a[1].shape[0])
    a_ms = device_ms(torch, lambda: SIM.associate(*a_in), 200)
    a_plain = device_ms(torch, lambda: SIM.associate_torch(*a_in), 10)
    a_lib = device_ms(torch, lambda: torch.matmul(a_in[0], a_in[1].T), 200)
    (am, ad), ak = a_in[0].shape, a_in[1].shape[0]
    a_bound, a_by = associate_bound_ms(am, ak, ad)
    # flash attention: every distinct prefill shape of the serving run
    # re-checked and timed against SDPA, in the model's (B, S, H, hd)
    # layout as the layers pass it; the largest (the 1,024-token prompt)
    # is the row's
    fl_rec = serving["recorder"]
    fl_err = max(flash_diff(torch, FA, q, k, v, kw["causal"])
                 for q, k, v, kw in fl_rec.inputs.values())

    def flash_times(q, k, v, reps=20):
        """(kernel ms, SDPA ms) for one causal call."""
        return (device_ms(torch, lambda: FA.flash_attention(q, k, v), reps),
                device_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), reps))

    def geometry(q, k):
        return (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3])

    fl_shapes = []
    for key, (q, k, v, _) in sorted(fl_rec.inputs.items(),
                                    key=lambda kv: kv[0][2]):
        ms, lib = flash_times(q, k, v)
        fl_shapes.append({"shape": list(geometry(q, k)),
                          "launches": fl_rec.counts[key], "ms": ms,
                          "sdpa_ms": lib, "bound_ms": flash_bound_ms(
                              geometry(q, k), q.element_size())["ms"]})
    fl_run = {key: sum(r["launches"] * r[key] for r in fl_shapes)
              for key in ("ms", "sdpa_ms", "bound_ms")}
    fl_run["launches"] = sum(r["launches"] for r in fl_shapes)
    if fl_run["launches"] != serving["flash_24"]["flash_launches"]:
        fail(f"the recorder saw {fl_run['launches']} flash calls, the "
             f"counter {serving['flash_24']['flash_launches']}")
    print(f"flash device ms per serving run ({fl_run['launches']} launches "
          f"over {len(fl_shapes)} prompt lengths): kernel {fl_run['ms']:.4f}"
          f", SDPA {fl_run['sdpa_ms']:.4f}, bound {fl_run['bound_ms']:.4f}",
          flush=True)
    fq, fk, fv, fkw = fl_rec.inputs[max(fl_rec.inputs, key=lambda s: s[2])]
    fl_ms, fl_lib = flash_times(fq, fk, fv)
    fl_plain = device_ms(
        torch, lambda: FA.flash_attention_torch(fq, fk, fv, True), 5)
    fl_lib_err = float((F.scaled_dot_product_attention(
        fq, fk, fv, is_causal=True, enable_gqa=True)
        - FA.flash_attention_torch(fq, fk, fv, True)).abs().max())
    fl_shape = geometry(fq, fk)
    fl_bound = flash_bound_ms(fl_shape, fq.element_size())
    # qwen3-8b's GQA prefill (not on the main path), in the model's layout
    g8 = torch.Generator(device="cpu").manual_seed(8)
    q8, k8, v8 = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in
                  qkv(torch, g8, QWEN3_8B_PREFILL, torch.float32, dev))
    q8_ms, q8_lib = flash_times(q8, k8, v8)
    q8_bound = flash_bound_ms(QWEN3_8B_PREFILL, 4)
    fl_qwen3 = {"shape": list(QWEN3_8B_PREFILL), "ms": q8_ms,
                "sdpa_ms": q8_lib, "bound_ms": q8_bound["ms"],
                "bound_f32_simt_ms": q8_bound["f32_simt_ms"]}
    del q8, k8, v8
    # bf16 (not on the main path) at the same two shapes, against SDPA's
    fl_bf16 = []
    for shape in (fl_shape, QWEN3_8B_PREFILL):
        qb, kb, vb = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in
                      qkv(torch, g8, shape, torch.bfloat16, dev))
        err_b = flash_diff(torch, FA, qb, kb, vb, True)
        ms_b, lib_b = flash_times(qb, kb, vb)
        fl_bf16.append({"shape": list(shape), "ms": ms_b, "sdpa_ms": lib_b,
                        "bound_ms": flash_bound_ms(shape, 2)["ms"],
                        "max_abs_err": err_b})
        del qb, kb, vb
    print(f"flash at (1, 16, 16, 1024, 1024, 64): kernel {fl_ms:.4f} ms, "
          f"SDPA {fl_lib:.4f} ms, 3xTF32 bound {fl_bound['ms']:.4f} ms, "
          f"bytes bound {fl_bound['bytes_ms']:.4f} ms, f32-SIMT bound "
          f"{fl_bound['f32_simt_ms']:.4f} ms; qwen3-8b {QWEN3_8B_PREFILL}: "
          f"kernel {q8_ms:.4f} ms, SDPA {q8_lib:.4f} ms, 3xTF32 bound "
          f"{fl_qwen3['bound_ms']:.4f} ms; bf16: " + ", ".join(
              f"{tuple(r['shape'])} kernel {r['ms']:.4f} ms, SDPA "
              f"{r['sdpa_ms']:.4f} ms, bf16 bound {r['bound_ms']:.4f} ms"
              for r in fl_bf16), flush=True)
    # the dense-family phase's launches: every speculative prefill shape
    # (the prompts grow by the accepted tokens each round, mostly off the
    # tile) re-checked and timed beside SDPA, summed over its launches;
    # the int8-weight bf16 prefill and the chatglm3-6b and command-r-35b
    # prefills (GQA 16:1 and 8:1 at hd 128) in f32 and in bf16
    sp_rec = dense.pop("speculative_recorder")
    sp_rows = []
    for key, (q, k, v, _) in sorted(sp_rec.inputs.items(),
                                    key=lambda kv: kv[0][2]):
        err = flash_diff(torch, FA, q, k, v, True)
        ms = device_ms(torch, lambda: FA.flash_attention(q, k, v), 20,
                       SHORT_HOLD_CYCLES)
        lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20, SHORT_HOLD_CYCLES)
        sp_rows.append({"S": q.shape[2], "launches": sp_rec.counts[key],
                        "ms": ms, "sdpa_ms": lib, "max_abs_err": err,
                        "bound_ms": flash_bound_ms(geometry(q, k), 4)["ms"]})
    sp_run = {key: sum(r["launches"] * r[key] for r in sp_rows)
              for key in ("ms", "sdpa_ms", "bound_ms")}
    sp_run.update(launches=sum(r["launches"] for r in sp_rows),
                  shapes=len(sp_rows), geometry=[1, 16, 16, "S", "S", 64],
                  max_abs_err=max(r["max_abs_err"] for r in sp_rows))
    sp_launches = sum(dense[k]["flash_launches"] for k in (
        "speculative_24", "self_draft_24", "speculative_2_cuda"))
    if sp_run["launches"] != sp_launches:
        fail(f"the recorder saw {sp_run['launches']} speculative flash "
             f"calls, the counter {sp_launches}")
    print(f"flash at the speculative prefill lengths (S, launches, kernel "
          f"ms, SDPA ms): " + "; ".join(
              f"{r['S']} {r['launches']} {r['ms']:.4f} {r['sdpa_ms']:.4f}"
              for r in sp_rows), flush=True)
    print(f"flash device ms per speculative runs ({sp_run['launches']} "
          f"launches over {len(sp_rows)} lengths, max err "
          f"{sp_run['max_abs_err']:.3g}): kernel {sp_run['ms']:.4f}, SDPA "
          f"{sp_run['sdpa_ms']:.4f}, bound {sp_run['bound_ms']:.4f}",
          flush=True)
    dense_recs = dense.pop("dense_recorders")
    dense_shapes = []
    for name, rec, dtypes in (
            ("qwen1.5-0.5b int8 weights", dense.pop("int8_weights_recorder"),
             (torch.bfloat16,)),
            ("chatglm3-6b", dense_recs["chatglm3-6b"],
             (torch.float32, torch.bfloat16)),
            ("command-r-35b", dense_recs["command-r-35b"],
             (torch.float32, torch.bfloat16))):
        (key, (q, k, v, _)), = rec.inputs.items()
        for dt in dtypes:
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            err = flash_diff(torch, FA, qd, kd, vd, True)
            ms, lib = flash_times(qd, kd, vd)
            bound = flash_bound_ms(geometry(qd, kd), qd.element_size())
            dense_shapes.append({
                "model": name, "dtype": str(dt)[6:],
                "shape": list(geometry(qd, kd)),
                "launches": rec.counts[key] if dt == q.dtype else 0,
                "ms": ms, "sdpa_ms": lib, "bound_ms": bound["ms"],
                "bound_by": bound["by"], "max_abs_err": err})
            del qd, kd, vd
    print("flash at the dense family's prefills: " + "; ".join(
        f"{r['model']} {r['dtype']} {tuple(r['shape'])} kernel "
        f"{r['ms']:.4f} ms, SDPA {r['sdpa_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms, err {r['max_abs_err']:.3g}"
        for r in dense_shapes), flush=True)
    # the remaining families' prefills: every recorded shape re-checked
    # against the plain version and timed beside SDPA, summed over its
    # launches (granite-moe's ten prompt lengths, hymba's two cloud
    # prompts, one prefill each of phi3.5-moe, whisper's decoder and
    # internvl2 behind its image prefix)
    family_shapes = {}
    for name, rec in families.pop("recorders").items():
        rows = []
        for key, (q, k, v, _) in sorted(rec.inputs.items(),
                                        key=lambda kv: kv[0][2]):
            err = flash_diff(torch, FA, q, k, v, True)
            ms = device_ms(torch, lambda: FA.flash_attention(q, k, v), 20,
                           SHORT_HOLD_CYCLES)
            lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 20,
                SHORT_HOLD_CYCLES)
            bound = flash_bound_ms(geometry(q, k), q.element_size())
            rows.append({"shape": list(geometry(q, k)),
                         "launches": rec.counts[key], "ms": ms,
                         "sdpa_ms": lib, "bound_ms": bound["ms"],
                         "bound_by": bound["by"], "max_abs_err": err})
        q, k, v, _ = rec.inputs[max(rec.inputs, key=lambda s: s[2])]
        plain = device_ms(torch, lambda: FA.flash_attention_torch(
            q, k, v, True), 5)
        family_shapes[name] = {
            "launches": sum(r["launches"] for r in rows),
            **{f"run_{key}": sum(r["launches"] * r[key] for r in rows)
               for key in ("ms", "sdpa_ms", "bound_ms")},
            "largest": {**rows[-1], "plain_ms": plain},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "shapes": rows}
        del q, k, v
        print(f"flash at {name}'s prefills ({family_shapes[name]['launches']}"
              f" launches over {len(rows)} shapes, max err "
              f"{family_shapes[name]['max_abs_err']:.3g}): largest "
              f"{tuple(rows[-1]['shape'])} kernel {rows[-1]['ms']:.4f} ms, "
              f"plain {plain:.4f} ms, SDPA {rows[-1]['sdpa_ms']:.4f} ms, "
              f"bound {rows[-1]['bound_ms']:.4f} ms; the run's launches: "
              f"kernel {family_shapes[name]['run_ms']:.4f} ms, SDPA "
              f"{family_shapes[name]['run_sdpa_ms']:.4f} ms", flush=True)
    fam_paths = {
        "granite_moe_24_layers_flash":
        families["granite-moe-1b-a400m"]["flash"]["flash_launches"],
        "granite_moe_24_layers_chunked":
        families["granite-moe-1b-a400m"]["chunked"]["flash_launches"],
        "phi35_moe_2_layers":
        families["phi3.5-moe-42b-a6.6b"]["flash_launches"],
        "mamba2_64_layers": families["mamba2-2.7b"]["flash_launches"],
        "hymba_32_layers_flash":
        families["hymba-1.5b"]["flash"]["flash_launches"],
        "hymba_32_layers_chunked":
        families["hymba-1.5b"]["chunked"]["flash_launches"],
        "whisper_32_layers": families["whisper-large-v3"]["flash_launches"],
        "internvl2_24_layers": families["internvl2-1b"]["flash_launches"],
        **{"card_vs_host_2_layers_" + arch.replace("-", "_").replace(
            ".", ""): n
           for arch, n in families.pop("host_pair_flash_launches").items()}}
    for name, row in family_shapes.items():
        want = fam_paths[{"granite-moe-1b-a400m": "granite_moe_24_layers_flash",
                          "phi3.5-moe-42b-a6.6b": "phi35_moe_2_layers",
                          "hymba-1.5b": "hymba_32_layers_flash",
                          "whisper-large-v3": "whisper_32_layers",
                          "internvl2-1b": "internvl2_24_layers"}[name]]
        if row["launches"] != want:
            fail(f"the recorder saw {row['launches']} flash calls on "
                 f"{name}, the counters {want}")
    fl_paths = {"multi_device_serve_24_layers_mesh":
                multi["serve"]["flash_launches"],
                "multi_device_serve_24_layers_plain":
                multi["serve"]["plain_flash_launches"],
                "multi_device_serve_granite_moe_24_layers_mesh":
                multi["moe_serve"]["flash_launches"],
                "multi_device_serve_granite_moe_24_layers_plain":
                multi["moe_serve"]["plain_flash_launches"],
                "serving_24_layers_flash":
                serving["flash_24"]["flash_launches"],
                "serving_24_layers_chunked":
                serving["chunked_24"]["flash_launches"],
                "serving_2_layers_flash_cuda":
                serving["flash_2_cuda"]["flash_launches"],
                "speculative_24_layers":
                dense["speculative_24"]["flash_launches"],
                "speculative_self_draft_24_layers":
                dense["self_draft_24"]["flash_launches"],
                "speculative_2_layers_cuda":
                dense["speculative_2_cuda"]["flash_launches"],
                "int8_kv_24_layers": dense["int8_kv_24"]["flash_launches"],
                "int8_kv_2_layers_cuda":
                dense["int8_kv_2_cuda"]["flash_launches"],
                "int8_weights_24_layers":
                dense["int8_weights_24"]["flash_launches"],
                "chatglm3_6b_2_layers":
                dense["chatglm3-6b"]["flash_launches_flash"],
                "command_r_35b_2_layers":
                dense["command-r-35b"]["flash_launches_flash"],
                **fam_paths,
                "llm_training_24_layers":
                llm["launches"]["flash_attention"]}
    ss_paths = {"metropolis": metro_counts["superstep"],
                "metropolis_smoke": smoke_counts["superstep"],
                "metropolis_smoke_superstep1": k1_counts["superstep"],
                f"metropolis_fleet_in_{FLEET_SHARDS}_shards":
                multi["fleet"]["superstep_launches"]}
    a_paths = {n: t["associate_launches"] for n, t in track.items()}
    if a_shapes["run"]["launches"] != sum(a_paths.values()):
        fail(f"the recorders saw {a_shapes['run']['launches']} associate "
             f"calls, the counter {sum(a_paths.values())}")
    if ss_shapes["run"]["launches"] != sum(ss_paths.values()):
        fail(f"the recorders saw {ss_shapes['run']['launches']} superstep "
             f"calls, the counter {sum(ss_paths.values())}")
    tri_train_paths = {f"table2_{k}": n for k, n in
                       training["triage_launches"].items()}
    kernels = [
        {"name": "triage_fleet", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/triage.cu",
         "replaces": "src/repro/kernels/triage.py:118",
         "launches": city_launches[0] + drift_launches[0]
         + pixel_counts["triage"] + sum(tri_train_paths.values()),
         "launches_by_path": {"city_scale": city_launches[0],
                              "drifting_city": drift_launches[0],
                              "pixel_city": pixel_counts["triage"],
                              **tri_train_paths},
         "shape": list(conf.shape), "max_abs_err": t_err,
         "checked_inputs": sum(len(r.inputs) for r in tri_recs),
         "ms": t_ms, "plain_ms": t_plain, "bound_ms": t_bound,
         "bound_by": t_by, "library_ms": None,
         "main_path_runs": tri_shapes["run"],
         "shapes": tri_shapes["shapes"],
         "one_row": {"shape": [1, 16], "ms": one_ms, "plain_ms": one_plain,
                     "bound_ms": triage_bound_ms(1, 16)[0],
                     "over_floor_ms": one_ms - floor_ms}},
        {"name": "calibrate_fleet", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/calibrate.cu",
         "replaces": "src/repro/kernels/calibrate.py:111",
         "launches": city_launches[1] + drift_launches[1],
         "launches_by_path": {"city_scale": city_launches[1],
                              "drifting_city": drift_launches[1],
                              "pixel_city": pixel_counts["calibrate"]},
         "shape": list(scores.shape), "max_abs_err": cal_err,
         "ms": c_ms, "plain_ms": c_plain, "bound_ms": c_bound,
         "bound_by": c_by, "library_ms": None,
         "main_path_runs": cal_shapes["run"],
         "shapes": cal_shapes["shapes"]},
        *pixel_rows,
        {"name": "superstep", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/superstep.cu",
         "replaces": "src/repro/system/superstep.py:89",
         "launches": sum(ss_paths.values()), "launches_by_path": ss_paths,
         "shape": list(ss_in[0].shape), "checked_inputs": len(ss_calls),
         "max_abs_err": 0.0, "ms": ss_ms, "plain_ms": ss_plain,
         "bound_ms": ss_bound, "bound_by": ss_by, "library_ms": None,
         "metropolis_runs": ss_shapes["run"],
         "slab_shapes": ss_shapes["shapes"],
         "fleet_shards": multi["fleet"]},
        {"name": "associate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/associate.cu",
         "replaces": "src/repro/kernels/similarity.py:104",
         "launches": sum(a_paths.values()), "launches_by_path": a_paths,
         "shape": [am, ak, ad], "checked_inputs": len(assoc_calls),
         "max_abs_err": a_err, "ms": a_ms, "plain_ms": a_plain,
         "bound_ms": a_bound, "bound_by": a_by, "library_ms": a_lib,
         "library": "torch.matmul(emb, trk.T): the score step only",
         "track_runs": a_shapes["run"], "track_shapes": a_shapes["shapes"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:91",
         "launches": sum(fl_paths.values()), "launches_by_path": fl_paths,
         "shape": list(fl_shape), "checked_inputs": len(fl_rec.inputs),
         "max_abs_err": fl_err, "ms": fl_ms, "plain_ms": fl_plain,
         "bound_ms": fl_bound["ms"], "bound_by": fl_bound["by"],
         "bound_f32_simt_ms": fl_bound["f32_simt_ms"],
         "bound_bytes_ms": fl_bound["bytes_ms"], "library_ms": fl_lib,
         "library": "F.scaled_dot_product_attention(q, k, v, "
                    "is_causal=True, enable_gqa=True)",
         "library_max_abs_err": fl_lib_err, "serving_run": fl_run,
         "serving_shapes": fl_shapes, "qwen3_8b": fl_qwen3,
         "qwen3_8b_prefill_logits": deep, "bf16": fl_bf16,
         "speculative_runs": sp_run, "dense_family_shapes": dense_shapes,
         "family_shapes": family_shapes},
    ]
    print(json.dumps({"paths": {
        "city_scale": {"cuda_s": city_cuda_s, "cpu_s": city_cpu_s,
                       "items": rep.n_items,
                       "kernel_launches": s_cuda["kernel_launches"]},
        "drifting_city": {"cuda_s": drift_cuda_s,
                          "model_updates": d_cuda["model_updates"],
                          "f2_closed": d_cuda["accuracy_F2"],
                          "f2_open": d_open["accuracy_F2"],
                          "identical_to_cpu": drift_same},
        "pixel_city": {"cuda_s": pixel_cuda_s, "cpu_s": pixel_cpu_s,
                       "staged_cuda_stream_s": staged_s,
                       "items": prep.n_items, "ticks": ticks,
                       "classifier_batches": len(batches),
                       "split_cuda_s": split_cuda,
                       "split_cuda_second_s": split_warm,
                       "split_cpu_s": split_cpu,
                       "max_abs_dconf": dconf,
                       "identical_to_cpu": pixel_same},
        "metropolis": {"cuda_s": metro_cuda_s, "cpu_s": metro_cpu_s,
                       "duration_s": METRO_S, "cameras": msc.num_cameras,
                       "edges": msc.num_edges, "queries": len(msc.queries),
                       "items": mrep.n_items,
                       "triaged_ticks": mrep.triaged_ticks,
                       "supersteps": mrep.supersteps,
                       "superstep_launches": metro_counts["superstep"],
                       "triage_s": mrep.stage_timings["triage_s"],
                       "slabs": [list(a[0].shape) for a in ss_full.calls]},
        "metropolis_smoke": {"cuda_s": smoke_cuda_s, "cpu_s": smoke_cpu_s,
                             "items": rs_cuda.n_items,
                             "triaged_ticks": rs_cuda.triaged_ticks,
                             "supersteps": rs_cuda.supersteps,
                             "superstep1_launches": k1_counts["superstep"],
                             "identical_to_cpu": True,
                             "superstep1_bit_identical": True},
        **track,
        "serving": {k: v for k, v in serving.items() if k != "recorder"},
        "dense_family": dense,
        "families": families,
        "training": training,
        "llm_training": llm,
        "multi_device": multi},
        "total_s": time.perf_counter() - t_all}))
    for row in kernels:
        row["over_floor_ms"] = row["ms"] - floor_ms
    print(card)
    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor_ms}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
