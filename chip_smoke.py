#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (dlimgedit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU,
nvcc and PyTorch built for CUDA. It imports nothing of JAX or of the JAX
package. The port's eleven kernels (dlimgedit_tpu_torch/csrc/; phase 8's
BiRefNet launches none of them; phase 12's schedules run K1-K5 at the
shapes of their shards and mesh rows, phase 13's TinyViT row bands K1
and K2 at the bands' rows and windows):

  K1 fused_layer_norm, K3 fused_add_layer_norm   fused_layer_norm.cu
  K2 levit_window_attention                      levit_attention_tc.cu (bf16,
                                                 tensor cores), levit_attention.cu
                                                 (float32)
  K4 relpos_attention_global, K5 ..._windowed,  relpos_attention_tc.cu (bf16,
  K7 relpos_attention_qkv                        tensor cores), relpos_attention.cu
                                                 (float32)
  K6 windowed_attention_fused                    relpos_attention_tc.cu (bf16),
                                                 window_strip_attention.cu (float32)
  K8 smem_gather (the gather probe)              gather_probe.cu
  greedy_nms (AMG's exact greedy box NMS; not    greedy_nms.cu
  a TPU kernel: JAX runs a lax.fori_loop)
  quantize_rows_int8 (P2), int8_epilogue (P3)   quantize_rows.cu
  (the s8 x s8 linears' passes over the
  activations; not TPU kernels: XLA fuses them)

Phases, each of which fails the run (non-zero exit) on any error, each
printing its seconds:

  1. builds the kernels (nvcc, sm_90a, one process per source) and prints
     nvcc's register and spill report, one line per kernel instance; it
     fails if a tensor-core kernel (relpos_attention_tc.cu: bf16 K4 on
     wgmma; K5, K7 and K6 on mma.sync; levit_attention_tc.cu: bf16 K2 on
     mma.sync) spills or is missing from the report;
  2. holds each kernel against its plain PyTorch version on the card, in
     bfloat16 and float32, at every shape the main paths give it (also
     the batched shapes of phases 10 and 11: MobileSAM's K1 and K2 and
     ViT-B's K1, K3, K4 and K5 at 4 frames, ViT-H's at 2, K5 without the
     pad-query skip)
     (MobileSAM: K1, K2 - bf16 on the tensor cores, float32 on the CUDA
     cores; SAM ViT-B, ViT-L (C 1024, 16 heads of 64) and ViT-H (C 1280,
     16 heads of 80): K1, K3, K4, K5; ViT-B with fused_window_blocks: K6 on
     the strips of a (1, 70, 70, 2304) qkv; K6 also at ViT-H's shape, with
     0 launches), with nonzero rel-pos tables; K4 also at grid 32 (ViT-B
     at 512, held with 0 launches: the
     general bias path of the bf16 kernel, a key tile spanning two grid
     rows); K7 at ViT-B's and ViT-H's windows ((25, 3, 12, 196, 64) and
     (25, 3, 16, 196, 80)); K8 at the gather probe's shapes (4096 x 128,
     row-replicated and per-lane indices, reps 8 and 16), bit for bit;
     greedy_nms (an IoU bitmask kernel, then a one-warp scan, one call) at M = 256, 2304, 9216 and 14400 on seeded overlapping boxes,
     keep flags bit for bit against the plain row loop and a numpy
     mirror, each timed; then K1's time at
     each of MobileSAM's shapes, back to back and inside a CUDA graph of
     100 launches (as the graphed main path runs it), beside an empty
     kernel's both ways (the launch floor); P2 and P3 at every (M, K, N)
     of the w8a8 main paths of phase 9, bit for bit against their plain
     versions in bf16 and float32 (P2's row scales spread over e^{+-2}),
     each bf16 linear shape also timed as cuBLASLt's s8 x s8 product
     (torch._int_mm) and as the bf16 x @ w it replaces, with their bounds
     at the int8 and bf16 tensor-core peaks; K1-K5 at phase 12's shapes
     (the sp shards' windows, rows of two frames; a shape timed already
     takes phase 12's launches too); K1 and K2 at phase 13's band shapes. Phase 2 alone runs with the
     TF32 flags off (its plain versions are float32 references); every
     other phase runs with PyTorch's defaults, under which the port's
     entry points keep float32 at full precision themselves (every
     executable enters models/common.py::full_precision). In
     bf16 it times kernel, plain version, the library yardstick
     (F.layer_norm; x + d then F.layer_norm, two calls;
     F.scaled_dot_product_attention with the materialised float bias, on
     the partitioned windows for K6 - it also prints SDPA's time with
     that partition, which K6 does not need, and of the partition alone;
     none for K8; timed only, never used by the port) and computes the
     least time the card could take
     (bound); it prints kernel / library for each attention shape;
  3. checks the port on the card against the port on the CPU (float32,
     PyTorch's default TF32 flags in force):
     MobileSAM at image size 64 (embedding within 1e-4, masks equal) and
     ViT-B at 512, full width and depth, with seeded nonzero rel-pos
     tables, pos_embed and qkv biases (embedding within relative L2 1e-5;
     mask pixels that differ at most 1e-4 of the mask, threshold noise),
     once as the Environment builds it (the global blocks take K4, N =
     1024; the windowed blocks K5 with the pad-query skip, grid 32 -> 42,
     valid_rows 4) and once with fused_window_blocks (the windowed blocks
     take K6);
  4. drives each main path at full width and full depth with seeded random
     weights: MobileSAM at 1024 in bfloat16, then ViT-B at 1024 (embed 768,
     depth 12, 12 heads) in bfloat16 with seeded nonzero rel-pos tables,
     pos_embed and qkv biases (JAX's init zeroes them, which would leave the
     rel-pos indexing unchecked), the same ViT-B with its bundle's
     fused_window_blocks set, then ViT-L (embed 1024, depth 24, 16 heads of
     64) and ViT-H (embed 1280, depth 32, 16 heads of 80) as ViT-B. Per
     path: `process` on a 1024x768 and a 1500x1000 image (canvas buckets
     1024 and 2048), and per image `compute_mask(Point)`,
     `compute_mask(Region)` with largest_region_object, `compute_masks` and
     `compute_mask_batch` of 4 prompts, in three rounds: every executable
     is a CUDA graph (Environment.executable; a decode with
     largest_component two, the labelling eager between them), so round
     1 warms each key up eagerly and captures it, rounds 2 and 3 replay. After each image
     of each round every graph, replayed on its last inputs, must equal
     its eager program (`.eager`) on the same inputs bit for bit, and
     rounds 2 and 3 must give round 1's embeddings and masks. The launch
     counters are zeroed before each round and read after it (a replay
     adds the launches its capture recorded); the counted main-path run
     is round 2, replays only. Per `process`: MobileSAM 22 K1
     and 10 K2 launches; a ViT of depth d 1 K1 (block 0's norm1), 2d - 1 K3
     (every other block LayerNorm), 4 K4 (the global blocks) and d - 4 K5
     (the windowed blocks, one launch each): 23 K3 and 8 K5 for ViT-B, 47
     and 20 for ViT-L, 63 and 28 for ViT-H; the fused-window ViT-B the same
     as ViT-B with 8 K6 in place of the 8 K5. No path
     launches K7 (no path of either package calls JAX's
     windowed_attention_qkv) or K8 (a measurement tool). Masks must be
     {0, 255} at the original extent. The embedding is held against the
     plain path (kernels off): in float32 within relative L2 1e-5; in bf16
     its relative L2 distance to the float32 result may be at most 1.1x the
     bf16 plain path's (the two bf16 paths round independently). It
     prints each path's device memory (max_memory_allocated above what
     was resident before the path). On MobileSAM: `process` A, then B in
     A's canvas bucket, then a click on A: A's embedding and mask must
     be unchanged; and C5, JAX's contract for `compute_mask_batch`
     (tests/test_segmentation.py::test_compute_mask_batch_matches_individual)
     on A: 16 seeded points and boxes (tools/probe_batch_masks.py), every
     batch size 1-8 with each prompt at every position, each mask
     byte-equal to `compute_mask` of its prompt, with
     largest_region_object on and off (each batched prompt is decoded
     and upsampled at the shapes `compute_mask` uses);
  5. runs the gather probe (dlimgedit_tpu_torch.tools.probe_smem_gather)
     at small reps: K8 against its plain version and torch's gathers from
     device memory, printed;
  6. times `process` and one mask query per path and image, graphed and
     eager (the same entry points with each executable's `graphed` set
     False, so its eager program runs), medians of 20, host clock around
     work that ends in a device synchronise, with the device memory each
     mode allocates while timed; and, on a MobileSAM region click with
     largest_component, the eager early-exit labelling between two graphs
     (the port) against the fixed 64 sweeps inside the decode's graph
     (estimated: the graphed decode without labelling plus a graph of the
     64 sweeps on its masks, which must label alike);
  7. automatic mask generation (`Segmentation.generate_masks`, grid 32,
     64 slots, the IoU and stability filters off): MobileSAM (bf16
     encoder, f32 decoder) on 1024x768, per round `process` and three
     calls (nms 0.7; nms 1.0, 64 winners; nms 1.0 with
     min_mask_region_area 1000, the program head, eager labelling, tail),
     three rounds: every replay bit-equal to its eager program, the
     winners equal to a numpy mirror of the selection fed with the card's
     own pass-A statistics (`amg_candidates`, M = 2304), rounds 2 and 3
     equal to round 1, exact launches per round (greedy_nms one a call);
     a threshold change makes no new key and no new capture; the graphs'
     node counts; the NMS kernel timed on round 2's pools; wall times
     graphed and eager, medians of 5, with peak device memory;
     generate_masks_image with one crop layer; ViT-B (partitioned, bf16)
     once on 1500x1000 (bucket 2048) at nms 1.0;
  8. BiRefNet `segment_objects` (dichotomous foreground segmentation) at
     the full BiRefNet_lite width (swin_v1_tiny; mul_scl_ipt 'cat',
     cxt_num 3, decoder inter 64, ASPP 256 wide with kernels 1/3/7, gdt
     16) in bf16 with seeded nonzero offset and modulator convs, biases,
     LayerNorms and rel-pos tables: `general` (resolution 1024) on 1024x768 (bucket
     1024) and 1500x1000 (bucket 2048), `high_res` (resolution 2048) on
     2000x1500, which escalates; three rounds, every replay bit-equal to
     its key's eager program, rounds 2 and 3 equal to round 1, uint8
     masks at the extent, not constant, and no launch of the port's
     kernels (BiRefNet reaches no TPU kernel); the graphs' node counts;
     the int8 deform option at 1024 (every deform conv of one forward
     both ways on its own inputs, within 2% of the output range; the
     int8 model's mask against the exact one, printed); float32 on the
     card against the CPU at resolution 256, full width, under PyTorch's
     default TF32 flags: logits within relative L2 1e-4 (also printed
     outside the port's full-precision scope: the TF32 it repairs),
     masks within 1 quantum; `birefnet_ms` graphed and eager (host
     clock, medians of 10), the host's resize of the mask back to the
     extent alone (and once as the dense products), and each key's peak
     device memory;
  9. quantised serving (Options.quantize_encoder, quantize_activations):
     first the quantised encoders on the card against the same models on
     the CPU in float32 (MobileSAM at 256, ViT-B at 512, full width and
     depth): w8 `process` embeddings within phase 3's limits; w8a8 the
     encoder on one input with the card's P2 counting its tie flips
     against the CPU's quanta (each |dq| = 1 within 1e-3 of a .5, at most
     1e-3 of the quanta) and continuing from the CPU's, within the same
     limits. Then MobileSAM, ViT-B (partitioned and fused_window_blocks),
     ViT-L and ViT-H at 1024 on 1024x768 in bf16, w8 and w8a8 (seeded
     random weights): `process` and `compute_mask(Point)` in three rounds,
     every replay bit-equal to its eager program, rounds 2 and 3 equal to
     round 1, exact launches per round (the float path's, and under w8a8
     P2 and P3 once per quantised linear: 40 for MobileSAM, 48 ViT-B, 96
     ViT-L, 128 ViT-H), the s8 x s8 shapes those phase 2 held, w_scale
     float32 in the bf16 bundles; `process_ms` and `mask_ms` graphed per
     mode (medians of 20) and the encoder's parameter bytes; last the
     canvas pack, native against numpy, at 1024x768 and 2000x1500 RGBA;
     and one w8a8 MobileSAM `process` and mask at sam_image_size 64, whose
     16-token linears ``int8_mm`` pads to cuBLASLt's 17 rows;
 10. batched frames (parallel/batch.py): `encode_frames` at 1024 in bf16
     with the serving flags on MobileSAM and ViT-B at B = 1 and 4, three
     rounds a key (warm-up and capture, replays; exact launches, replays
     bit-equal to `.eager`), each frame of the batch within relative L2
     2e-2 of its B = 1 call, ms per call and frames/s; `segment_frames`
     (BiRefNet_lite, 1024, bf16, B = 2) on frames made by
     `segment_objects`' own input stage, each frame within 2e-2 of B = 1
     and its mask within 1 quantum of `segment_objects`' (all but 0.1% of
     the pixels); `scaleout_devices=0` serving as 1 on the one card;
 11. the single-device train tier at full width, float32 masters, plain
     paths: the MobileSAM fine-tune at 1024, B = 4 (float32 and bf16
     encoder x accum_steps 1, 2 x remat_encoder off, on), distillation of
     the TinyViT student against ViT-H teacher embeddings (the teacher on
     its kernels through `teacher_embeddings`, B = 2), the BiRefNet_lite
     fine-tune at 1024 at the largest batch of (6, 5, 4, 2, 1) that fits: per
     run `train_step_ms` (median of 5 after 2 warm-ups), `train_peak_gib`,
     the losses (falling) and 0 kernel launches in a step; float32 card
     against CPU (MobileSAM at 256, the slim BiRefNet at 256): loss and
     every leaf's gradient within relative L2 1e-5 (an attention key
     bias, whose exact gradient is zero, below 1e-6 of the largest leaf's
     norm on both devices; BiRefNet at its init, offsets zero, and again
     with seeded nonzero offsets: within 1e-3 where a ReLU input within
     1e-5 of zero changed sign between the devices, which moves every
     leaf upstream of it, and with nonzero offsets, whose gradient jumps
     where a sample crosses a pixel edge); a checkpoint round
     trip resuming to the same next-step loss; `export_serving_bundle`
     loaded by an Environment (sha256 pin) and served;
 12. the multi-device tier's explicit schedules (parallel/mesh.py, sp.py,
     batch.py, multihost.py) over meshes whose devices are all cuda:0:
     the sequence-parallel ViT-B and ViT-H at 1024 (bf16, kernels on, B =
     1) over 2 and 4 shards, exact launches per run (every shard K1 twice
     and K5 once per windowed block on its windows, and each global block
     whole: K1, K3, K4), the embedding held against the float32 plain path
     by phase 4's 1.1x rule, and ViT-B in float32 (kernels off: the
     row-sharded global blocks) within atol 1e-5, rtol 1e-5 of the dense
     path; `encode_frames` of 4 frames (MobileSAM, ViT-B; bf16, the
     serving flags) over (dp 4, tp 1), every frame bit for bit its B = 1
     call, and over (dp 2, tp 2) finite, then in float32 (MobileSAM,
     ViT-B; 2 frames) within atol 2e-4, rtol 1e-3 of the dense call;
     `segment_frames`
     (BiRefNet_lite, 1024, B = 2) over dp 2, bit for bit; an NCCL group of
     one (``multihost.initialize``) running the dp step's all-reduce; two
     processes on the card in one gloo group taking the MobileSAM dp train
     step at 1024 (2 frames each): the same loss on both ranks,
     parameters bit-equal across them and, with the gradients, within
     the train tier's tolerances of one process on the whole batch; each
     call's wall time (no speed-up: one card does every shard's work);
 13. canvas-row sharding (parallel/spatial.py) over meshes of cuda:0
     repeated, through the public entry points (``scaleout_devices``,
     the ('dp', 'sp') train placement): MobileSAM `process` at 1024 over
     2 and 4 row bands in float32 (the embedding within atol 2e-4, rtol
     1e-4 of the dense call) and bf16 (phase 4's 1.1x rule), masks of 3
     clicks flipped on under 5e-3 of the pixels, K1 and K2 launches per
     band exactly the geometry's (22 and 10 a band, each band's windows
     printed); BiRefNet_lite `segment_objects` `general` on 1024x768
     over 2 and 4 bands and `high_res` on 2000x1500 over 2: float32 masks
     within 1 quantum on under 5e-3 of the pixels of the dense call's,
     bf16 timed and its logits held by the 1.1x rule (float32 logits
     within relative L2 1e-5); the BiRefNet_lite train step at 1024 over
     (dp 1, sp 2) and (dp 2, sp 2) against the dense step: loss relative
     1e-5, parameters atol 5e-5, rtol 1e-4; `mesh_call_ms` beside the
     dense eager call, peak memory;
 14. the C ABI's bridge (native_bridge.py) on cuda:0 at full width, every
     call with ctypes buffers as native/src/capi.cpp passes them: a
     full-width official-layout MobileSAM checkpoint
     (tests/_torch_official_sd.py) converted by `python -m
     dlimgedit_tpu_torch.convert.mobile_sam` and served by
     `create_environment(1, dir)` without random weights (the served
     weights equal to the .npz); MobileSAM `process` of a 1024x768 RGBA
     buffer and a 1500x1000 BGRA one with rows padded by 64 bytes, a
     point and a region mask, three masks, a batch of 16 mixed prompts,
     `generate_masks` (grid 32, 64 slots); ViT-B `process` and a mask;
     BiRefNet_lite `run_segment_objects`; a PNG saved and loaded. Every
     buffer byte for byte against the same call through the Python API,
     accuracies within 1e-6, each bridge call's launches exact (22 K1 and
     10 K2 a MobileSAM `process`, phase 4's ViT-B counts, one greedy_nms
     a `generate_masks`); the converter's seconds and the bridge's wall
     against the direct call's (medians of 20);
 15. the C hosts on cuda:0, through the port's own C library
     (dlimgedit_tpu_torch/native/, built by native_build.py with the C++
     compiler; it imports dlimgedit_tpu_torch.native_bridge itself) on
     phase 14's converted bundle and a seeded BiRefNet_lite `general`
     bundle, without random weights: the library loaded with ctypes into
     this interpreter (no jax, no JAX package before or after), every
     table entry through `dlimg_init()`'s table with backend 1 on phase
     14's two images (process, a point and a region mask, three masks, a
     batch of 16, `generate_masks` grid 32 with 64 slots,
     `segment_objects`, a PNG saved and loaded), every buffer byte for
     byte against the Python API on an Environment of the same options,
     accuracies within 1e-6, launches exact (22 K1 and 10 K2 a `process`,
     one greedy_nms a `generate_masks`), `process_ms` and `mask_ms`
     through the library against the direct call (medians of 20,
     interleaved); `dlimg-serve --backend gpu --threads 4
     --batch-window-ms 2` as a process of its own, its PID on the card:
     two sessions opened at once (first calls and captures in parallel),
     8 point and 4 box queries at concurrency 1 and 16 point queries at
     concurrency 4 (`batched_calls` above 0), `all=1`, `/auto-masks`,
     `/v1/segment`, `/v1/remove-bg`, every PNG decoded and held byte for
     byte against the direct call the daemon makes (at concurrency 4,
     where the batch a query rode in is not known, against the prompt's
     batch of 1 and `compute_mask`, and the prompt's batches of 1, 2, 4
     and 8 must all equal `compute_mask`: 16 of 16 prompts), each
     endpoint's median wall, `/v1/stats`, the
     sessions deleted and SIGTERM answered with exit 0; `dlimg segment`
     (its mask file equal to the direct call's), `test_cpp_api gpu` and
     `test_cpp_dynamic` exiting 0;
 16. the device-memory tool and the examples, in process, in a
     temporary directory: `tools/memory_footprint.py` at full width
     (MobileSAM at 1024 in bf16 on a 1024x1024 image, a click, AMG grid
     32, BiRefNet_lite `general` at 1024), each row printed with the
     card's name and power limit; it fails if a weights row's allocated
     delta is below its analytic bytes, a graph pool's bytes exceed
     `memory_reserved`, or the resident total is not
     `torch.cuda.memory_allocated()`; then examples 3-5 at full width
     on a seeded 1024x768 RGBA PNG with seeded random weights
     (interactive_segmentation, generate_masks at grid 32 with 32 masks,
     also with the IoU and stability filters off so that masks are
     written, foreground_extraction): every mask file byte for byte the
     same call's on a second Environment, the cutout's alpha
     `segment_objects`' mask, launches exact (22 K1 and 10 K2 a
     `process`, one greedy_nms a `generate_masks`; checked here, not
     added to the kernels' sums); then examples 6-10 on meshes of
     [cuda:0] * 2 at their own defaults (streaming_frames, latency_scaleout
     with ViT-B at 1024 and main_birefnet at 1024 in float32 on the float32
     kernels, distill_encoder, finetune_decoder twice, the second resuming
     from step 5, multihost_train in one process), each example's own
     assertions holding and its printed lines checked; each example's
     seconds;
 17. the Python-free serving route (DLIMG_PJRT_BUNDLE) on cuda:0: a
     MobileSAM 1024 bf16 bundle of seeded weights exported by `python -m
     dlimgedit_tpu_torch.tools.aot_export` (buckets 512 and 1024) and the
     serving library built (`native_build.build_serving()`, beside the
     export); in a fresh process with no PYTHONPATH of the repo and a
     sitecustomize that leaves a marker if an interpreter starts,
     `test_serving gpu` through the public C++ API: `process` of a
     1024x768 RGBA image and of a 500x375 RGB one (bucket 512), 8 point
     and 4 box `compute_mask`, `compute_masks` of a point,
     `compute_mask_batch` of the 12, two threads processing two 1024x768
     images at once for 8 rounds; every mask byte for byte and every
     accuracy bit for bit the Python API's on the exporter's Environment,
     22 K1 and 10 K2 launches counted by the serving library per
     `process` (also a replayed one), each CUDA graph's replay equal to
     its eager run, Py_IsInitialized false and no marker (checked here,
     not added to the kernels' sums); `test_serving_programs gpu` over
     the six programs (each output equal to the exporter's, the host's
     float32 flags put back after them, the weights held on the device
     printed) and `test_bundle_parse`; then `process_ms` and `mask_ms` through this
     route, the embedded-interpreter library and the direct call, in this
     interpreter, medians of 20 with the three interleaved, the serving
     library's K1 / K2 counts over its route's calls exact.

The line before the last is one JSON object with per-kernel numbers; the
last line is {"ok": true, "device": {...}}. Kernel and library times are
medians of 20 samples of 10 calls timed with CUDA events, a plain
version's of 3 samples of 2 calls (it is no yardstick); a kernel's `ms`,
`plain_ms`, `library_ms` and
`bound_ms` in the JSON are sums over the launches it made on the main
paths (its `launches`: both images' `process` calls of each path in round
2, all replays; at the batched shapes, phase 10's round-2 replay of
each B = 4 `encode_frames` key and phase 11's one teacher call; and
phase 12's counted sp runs and mesh `encode_frames` calls; and phase
13's bf16 MobileSAM `process` over 2 and over 4 bands; phase 14 runs
phase 4's shapes and holds its launches exact itself). For K7
and K8, which no main path launches, they are the numbers of one call at
their first shape (ViT-B's windows; the probe's row-replicated indices at
reps 8, bf16 table). greedy_nms's are sums over phase 7's round 2 (three
calls), each launch timed on the pool it had. P2's and P3's are sums over
phase 9's counted round (round 2, replays) of its w8a8 paths, one image
each; their library_ms is null (no one PyTorch call computes either; the
products beside P3 are printed in phase 2).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
PEAK_F32_FLOPS = 67e12           # float32 outside the tensor cores
PEAK_BF16_TC_FLOPS = 989e12      # bf16 tensor cores, dense

# Main-path shapes of one MobileSAM `process` call at image size 1024:
# (rows, C, eps, launches per process) for K1 ...
LN_SHAPES = [
    (17689, 128, 1e-5, 2), (16384, 128, 1e-5, 2),   # stage 1 attn / mlp
    (4900, 160, 1e-5, 6), (4096, 160, 1e-5, 6),     # stage 2
    (4900, 320, 1e-5, 2), (4096, 320, 1e-5, 2),     # stage 3
    (4096, 256, 1e-6, 2),                           # neck
]
# ... and (G, N, num_heads, launches per process) for K2 (head width 32).
ATTN_SHAPES = [(361, 49, 4, 2), (25, 196, 5, 6), (100, 49, 10, 2)]
LN_PER_PROCESS = sum(s[3] for s in LN_SHAPES)        # 22
ATTN_PER_PROCESS = sum(s[3] for s in ATTN_SHAPES)    # 10

# SAM ViT shapes at 1024 (grid 64; launches per image of the main paths:
# ViT-B runs twice, with its windows partitioned and with
# fused_window_blocks, and both launch K1, K3 and K4 alike; ViT-L and ViT-H
# run partitioned): K1 and K3 rows (rows, C, launches) ...
VIT_LN_SHAPES = [(4096, 768, 2 * 1), (4096, 1024, 1), (4096, 1280, 1)]
VIT_ADD_LN_SHAPES = [(4096, 768, 2 * 23), (4096, 1024, 47), (4096, 1280, 63)]
# ... K4 (heads, grid, head width, launches): one group per head ...
VIT_GLOBAL_SHAPES = [(12, 64, 64, 2 * 4), (16, 64, 64, 4), (16, 64, 80, 4),
                     (12, 32, 64, 0)]
# ... and K5 (windows, heads, window, head width, n_w, valid_rows,
# launches; the partitioned path only): the 64-grid pads to 70 = 5 x 14,
# the bottom row of 5 windows keeps 8 of its 14 rows.
VIT_WINDOW_SHAPES = [(25, 12, 14, 64, 5, 8, 8), (25, 16, 14, 64, 5, 8, 20),
                     (25, 16, 14, 80, 5, 8, 28)]


def vit_per_process(depth: int) -> dict:
    """Launches per `process` of a ViT of this depth with 4 global blocks,
    its windows partitioned."""
    return {"fused_layer_norm": 1, "fused_add_layer_norm": 2 * depth - 1,
            "relpos_attention_global": 4,
            "relpos_attention_windowed": depth - 4}


VIT_PER_PROCESS = vit_per_process(12)
# K6 on the fused_window_blocks path (batch, padded grid, heads, head width,
# window, launches per image): the strips of the padded 70 x 70 qkv
# output, ViT-B's 8 windowed blocks; ViT-H's shape held with 0 launches.
VIT_STRIP_SHAPES = [(1, 70, 12, 64, 14, 8), (1, 70, 16, 80, 14, 0)]
VIT_FUSED_PER_PROCESS = {"fused_layer_norm": 1, "fused_add_layer_norm": 23,
                         "relpos_attention_global": 4,
                         "windowed_attention_fused": 8}
# Phases 10 and 11, batched frames: `encode_frames` of FRAMES_B frames on
# MobileSAM and ViT-B (its counted run one replay each), `segment_frames`
# and the distillation teacher (ViT-H, one `teacher_embeddings` call, its
# warm-up) on TEACHER_B frames. Per counted call the launches of one
# `process`, at B times the rows and groups; K5 runs without the pad-query
# skip (a batch's bottom windows are not the tail of the window axis).
FRAMES_B, TEACHER_B = 4, 2
FRAMES_LN_SHAPES = [(FRAMES_B * r, C, eps, per) for r, C, eps, per in LN_SHAPES]
FRAMES_ATTN_SHAPES = [(FRAMES_B * G, N, nh, per) for G, N, nh, per in ATTN_SHAPES]
BATCHED_VIT_SHAPES = (  # K1, K3, K4 (groups = B x heads), K5 (B x 25 windows)
    (f"ViT-B B={FRAMES_B}", [(FRAMES_B * 4096, 768, 1)],
     [(FRAMES_B * 4096, 768, 23)], [(FRAMES_B * 12, 64, 64, 4)],
     [(FRAMES_B * 25, 12, 14, 64, None, None, 8)]),
    (f"ViT-H B={TEACHER_B} (teacher)", [(TEACHER_B * 4096, 1280, 1)],
     [(TEACHER_B * 4096, 1280, 63)], [(TEACHER_B * 16, 64, 80, 4)],
     [(TEACHER_B * 25, 16, 14, 80, None, None, 28)]),
)
# Phase 11: the BiRefNet_lite fine-tune's batches, largest first; the first
# whose steps fit in device memory is the one measured.
BIREFNET_TRAIN_BATCHES = (6, 5, 4, 2, 1)
# Phase 12, the multi-device schedules over meshes of cuda:0 repeated: the
# sequence-parallel ViTs (variant, C, heads, head width, depth) at 1024,
# B = 1, over SP_SIZES shards; encode_frames of MESH_B frames over (dp, tp)
# = MESH_LAYOUTS; segment_frames of TEACHER_B frames over dp 2; the dp
# train step of two ranks on one card (MobileSAM at 1024, MESH_B frames in
# all, one gloo group) and of one rank in an NCCL group.
SP_SIZES = (2, 4)
SP_VITS = (("vit_b", 768, 12, 64, 12), ("vit_h", 1280, 16, 80, 32))
MESH_B = 4
MESH_LAYOUTS = ((4, 1), (2, 2))


def sp_windows(sp: int) -> int:
    """Windows a shard holds: grid 64 pads to 70 = 5 x 14, 25 windows,
    and dummy windows until sp divides them (sp 4: 7 a shard, 3 dummy)."""
    return (25 + (-25) % sp) // sp


def sp_per_run(depth: int, sp: int) -> dict:
    """Launches of one sp encode (kernels on): every shard runs K1 twice in
    each windowed block and K5 once on its windows, and each of the 4
    global blocks whole (replicated form: K1, K3, K4)."""
    return {"fused_layer_norm": sp * (2 * (depth - 4) + 4),
            "fused_add_layer_norm": 4 * sp, "relpos_attention_global": 4 * sp,
            "relpos_attention_windowed": sp * (depth - 4)}


def phase12_shapes() -> dict:
    """The kernels' shapes and launches over phase 12's counted runs, by
    kind: "ln" K1 at MobileSAM's widths (rows, C, eps, launches), "attn"
    K2 (G, N, heads, launches), "vit_ln" K1 at the ViT widths and
    "add_ln" K3 (rows, C, launches), "global" K4 (heads, grid, head width,
    launches), "window" K5 (windows, heads, window, head width, n_w,
    valid_rows, launches). A dp row of one frame runs the single-image
    shapes (K5 with the pad-query skip), a row of two frames twice the
    rows and groups (K5 without it)."""
    out = {"ln": [], "attn": [], "vit_ln": [], "add_ln": [], "global": [],
           "window": []}
    for _, C, nh, hd, depth in SP_VITS:
        for sp in SP_SIZES:
            n = sp_windows(sp)
            out["vit_ln"] += [(n * 196, C, 2 * (depth - 4) * sp),
                              (4096, C, 4 * sp)]
            out["add_ln"].append((4096, C, 4 * sp))
            out["global"].append((nh, 64, hd, 4 * sp))
            out["window"].append((n, nh, 14, hd, None, None, (depth - 4) * sp))
    for dp, tp in MESH_LAYOUTS:
        b = MESH_B // dp  # frames a row
        out["ln"] += [(b * r, C, eps, per * dp) for r, C, eps, per in LN_SHAPES]
        out["attn"] += [(b * G, N, nh, per * dp) for G, N, nh, per in ATTN_SHAPES]
        out["vit_ln"].append((b * 4096, 768, dp))
        out["add_ln"].append((b * 4096, 768, 23 * dp))
        out["global"].append((b * 12, 64, 64, 4 * dp))
        out["window"].append((b * 25, 12, 14, 64, 5 if b == 1 else None,
                              8 if b == 1 else None, 8 * dp))
    return out
# Phase 13, canvas-row sharding over meshes of cuda:0 repeated: MobileSAM
# `process` at 1024 and BiRefNet_lite `segment_objects` (`general` over
# BAND_SIZES, `high_res` over 2) on row bands, the BiRefNet_lite train step
# over (dp, sp) = BAND_TRAIN at B = dp. TinyViT's window-attention stages
# at 1024 (rows = columns, window, C, heads, blocks).
BAND_SIZES = (2, 4)
BAND_TRAIN = ((1, 2), (2, 2))
TINYVIT_STAGES = ((128, 7, 128, 4, 2), (64, 14, 160, 5, 6), (64, 7, 320, 10, 2))


def band_windows(H: int, ws: int, sp: int) -> list:
    """(rows, window rows computed) of each band of H rows over sp bands
    (``parallel/spatial.py::split_rows``): every window that meets a band
    is computed whole, so a window straddling an edge counts in both."""
    c = -(-H // sp)
    out = []
    for i in range(sp):
        o0, o1 = min(i * c, H), min((i + 1) * c, H)
        out.append((o1 - o0, -(-o1 // ws) - o0 // ws if o1 > o0 else 0))
    return out


def band_shapes(sp: int):
    """K1 (rows, C, eps, launches) and K2 (G, N, heads, launches) of one
    MobileSAM `process` at 1024 over sp bands: per band and block the
    attention's LayerNorm on its windows' tokens, the MLP's on its rows,
    K2 on its windows; the neck's two on its rows of the 64-row grid (22
    K1 and 10 K2 a band, as the dense encoder)."""
    ln, attn = [], []
    for H, ws, C, nh, blocks in TINYVIT_STAGES:
        cols = -(-H // ws)
        for rows, wr in band_windows(H, ws, sp):
            ln += [(wr * cols * ws * ws, C, 1e-5, blocks),
                   (rows * H, C, 1e-5, blocks)]
            attn.append((wr * cols, ws * ws, nh, blocks))
    ln += [(rows * 64, 256, 1e-6, 2) for rows, _ in band_windows(64, 1, sp)]
    return ln, attn


# K7 (windows, heads, window, head width): ViT-B's and ViT-H's windows.
VIT_QKV_SHAPES = [(25, 12, 14, 64), (25, 16, 14, 80)]
# K8: the gather probe's (rows, lanes) and reps.
PROBE_SHAPE, PROBE_REPS = (4096, 128), (8, 16)

# Phase 7, automatic mask generation on MobileSAM at 1024 (and ViT-B once):
# grid 32 (1024 prompts, 3072 candidates, a pre-NMS pool of 2304), 64
# slots, the IoU and stability filters off; the configurations, each a
# `generate_masks` call per round (nms 1.0 keeps every valid candidate, so
# 64 winners; the small-region filter makes the program head, eager
# labelling, tail).
AMG_GRID, AMG_SLOTS = 32, 64
AMG_THRESH = dict(iou_thresh=0.0, stability_thresh=0.0)
AMG_CONFIGS = (("nms 0.7", dict(nms_thresh=0.7)),
               ("nms 1.0", dict(nms_thresh=1.0)),
               ("nms 1.0, min_mask_region_area 1000",
                dict(nms_thresh=1.0, min_mask_region_area=1000)))
# The greedy NMS kernel against its plain version (M: 256, the main path's
# 2304, grid 64's 9216, and 14400, a 26 MB scratch bitmask), and the
# float32 operations of one IoU test (max, min x4; sub, add, max x2 each
# side; mul; add, sub; max; div; compare).
NMS_SIZES = (256, 2304, 9216, 14400)
NMS_OPS_PER_TEST = 16

# Phase 9, quantised serving: the paths (variant, fused_window_blocks), each
# in bf16, w8 (int8 weights) and w8a8 (int8 weights and activations) on one
# 1024x768 image; the ViTs' (width, depth); the image sizes of the card
# against the CPU (every linear needs more than 16 tokens for cuBLASLt's
# int8 product); the pack's images (width, height, canvas bucket).
QUANT_PATHS = (("mobile_sam", False), ("vit_b", False), ("vit_b", True),
               ("vit_l", False), ("vit_h", False))
QUANT_MODES = ("bf16", "w8", "w8a8")
VIT_WIDTHS = {"vit_b": (768, 12), "vit_l": (1024, 24), "vit_h": (1280, 32)}
QUANT_CPU_SIZES = (("mobile_sam", 256), ("vit_b", 512))
PACK_IMAGES = ((1024, 768, 1024), (2000, 1500, 2048))
PEAK_INT8_TC_OPS = 1979e12       # int8 tensor cores, dense


def quant_linears(variant: str) -> list:
    """(M, K, N, launches per `process`) of each quantised linear of a
    variant at 1024: TinyViT's stages (width, tokens, tokens of the padded
    windows, blocks), whose qkv and proj run on the windows; a ViT's
    windowed blocks run qkv on the 70 x 70 padded grid (partitioned or
    fused), every other linear on the 64 x 64 tokens."""
    if variant == "mobile_sam":
        rows = []
        for C, tokens, windows, blocks in ((128, 16384, 17689, 2),
                                           (160, 4096, 4900, 6),
                                           (320, 4096, 4900, 2)):
            rows += [(windows, C, 3 * C, blocks), (windows, C, C, blocks),
                     (tokens, C, 4 * C, blocks), (tokens, 4 * C, C, blocks)]
        return rows
    C, depth = VIT_WIDTHS[variant]
    return [(4900, C, 3 * C, depth - 4), (4096, C, 3 * C, 4),
            (4096, C, C, depth), (4096, C, 4 * C, depth),
            (4096, 4 * C, C, depth)]


# The main path's images, (width, height, seed): canvas buckets 1024 and 2048.
IMAGES = ((1024, 768, 1), (1500, 1000, 2))
# Rounds of phase 4 over the images: warm-up and capture, then replays.
ROUNDS = 3

# Phase 8, BiRefNet `segment_objects` (bf16, full BiRefNet_lite width):
# (kind it must take, width, height, seed): resolution 1024 in buckets 1024
# and 2048, and an image above 1536 px that escalates to resolution 2048.
BIREFNET_IMAGES = (("general", 1024, 768, 4), ("general", 1500, 1000, 5),
                   ("high_res", 2000, 1500, 6))
# Float32 on the card against float32 on the CPU: the full width at this
# resolution (every Swin stage still pads, the shifted blocks included).
BIREFNET_F32_RESOLUTION = 256

# The shortest spin kernel run ahead of timed launches (about 10 ms at the
# H100's clocks, some 20x what the host takes to queue a sample of 10
# kernel launches; its device time is measured once, in `spin_ms`; longer
# for a callable that the host takes longer to queue), and how many times a
# sample may be taken again when the host took longer than 3/4 of the spin
# to queue its calls (the host is shared and stalls at times). Every
# sample waits out the spin, so its length is most of phase 2's time.
SPIN_CYCLES = 20_000_000
SAMPLE_RETRIES = 10
# A plain version's time is printed beside the kernel's (it is no
# yardstick: the kernel is held against the plain version for its values
# and against the library call for its time), from far fewer calls than
# the kernel's and the library's 20 samples of 10.
PLAIN_SAMPLES, PLAIN_PER_SAMPLE = 3, 2

# Phase 14, the C ABI's bridge: MobileSAM's images as a C caller hands
# them over, (width, height, channel code, bytes of padding a row, seed):
# RGBA packed, and BGRA with padded rows (canvas buckets 1024 and 2048).
BRIDGE_IMAGES = ((1024, 768, 4, 0, 41), (1500, 1000, 5, 64, 42))
BRIDGE_BATCH = 16
# generate_masks through the bridge: (IoU, stability, NMS thresholds,
# slots) as a C caller passes them (NMS 1.0 keeps every candidate, so all
# 64 slots fill); the grid from DLIMG_AMG_GRID.
BRIDGE_AMG = (0.0, 0.0, 1.0, 64)
BRIDGE_AMG_GRID = 32
# The environment variables the bridge reads (native_bridge.py); phase 14
# sets them and puts back what was there.
BRIDGE_VARS = ("DLIMG_ALLOW_RANDOM_WEIGHTS", "DLIMG_SAM_VARIANT",
               "DLIMG_SAM_IMAGE_SIZE", "DLIMG_COMPUTE_DTYPE",
               "DLIMG_COMPILATION_CACHE", "DLIMG_SCALEOUT_DEVICES",
               "DLIMG_AMG_GRID", "DLIMG_BIREFNET_TEST_SLIM",
               "DLIMG_BIREFNET_RESOLUTION")

# Phase 15, the C hosts: (points, boxes) at concurrency 1, then points at
# concurrency 4 on one session of dlimg-serve, and the daemon's batch
# window; `/v1/segment` and `/v1/remove-bg` are sent twice (the first call
# captures), `/auto-masks` once.
SERVE_C1 = (8, 4)
SERVE_C4 = 16
# The direct batches each concurrency-4 prompt is repeated in: every one
# must equal compute_mask (C5).
SERVE_BATCHES = (1, 2, 4, 8)
SERVE_WINDOW_MS = 2

# The tensor-core kernels, bf16 K4, K5, K7 and K6 (csrc/relpos_attention_tc.cu)
# and bf16 K2 (csrc/levit_attention_tc.cu): phase 1 fails if one is missing
# from nvcc's report or spills.
TC_SOURCES = {"relpos_attention_tc.cu", "levit_attention_tc.cu"}
TC_KERNELS = ("relpos_global_kernel_tc", "relpos_window_kernel_tc",
              "relpos_qkv_kernel_tc", "window_strip_kernel_tc",
              "levit_window_kernel_tc")

TOL = {("ln", "float32"): 1e-5, ("attn", "float32"): 2e-5,
       ("ln", "bfloat16"): 2e-2, ("attn", "bfloat16"): 2e-2}

KERNELS = (  # name, source, the TPU kernel it replaces (K1 ... K8)
    ("fused_layer_norm", "dlimgedit_tpu_torch/csrc/fused_layer_norm.cu",
     "dlimgedit_tpu/ops/fused_norm.py:64"),
    ("levit_window_attention", "dlimgedit_tpu_torch/csrc/levit_attention_tc.cu",
     "dlimgedit_tpu/ops/flash_attention.py:531"),
    ("fused_add_layer_norm", "dlimgedit_tpu_torch/csrc/fused_layer_norm.cu",
     "dlimgedit_tpu/ops/fused_norm.py:98"),
    ("relpos_attention_global",
     "dlimgedit_tpu_torch/csrc/relpos_attention_tc.cu",
     "dlimgedit_tpu/ops/flash_attention.py:139"),
    ("relpos_attention_windowed",
     "dlimgedit_tpu_torch/csrc/relpos_attention_tc.cu",
     "dlimgedit_tpu/ops/flash_attention.py:307"),
    ("windowed_attention_fused",
     "dlimgedit_tpu_torch/csrc/relpos_attention_tc.cu",
     "dlimgedit_tpu/ops/flash_attention.py:646"),
    ("relpos_attention_qkv",
     "dlimgedit_tpu_torch/csrc/relpos_attention_tc.cu",
     "dlimgedit_tpu/ops/flash_attention.py:382"),
    ("smem_gather", "dlimgedit_tpu_torch/csrc/gather_probe.cu",
     "tools/probe_vmem_gather.py:53"),
    # Not a TPU kernel: the lax.fori_loop of JAX's exact greedy NMS.
    ("greedy_nms", "dlimgedit_tpu_torch/csrc/greedy_nms.cu",
     "dlimgedit_tpu/ops/amg.py:175"),
    # Not TPU kernels: the passes over the activations of JAX's int8_linear
    # (its per-token quantisation and its epilogue), which XLA fuses.
    ("quantize_rows_int8", "dlimgedit_tpu_torch/csrc/quantize_rows.cu",
     "dlimgedit_tpu/ops/quant.py:57"),
    ("int8_epilogue", "dlimgedit_tpu_torch/csrc/quantize_rows.cu",
     "dlimgedit_tpu/ops/quant.py:75"),
)
QUANT_KERNELS = ("quantize_rows_int8", "int8_epilogue")


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


@contextlib.contextmanager
def tf32_off(torch):
    """The TF32 flags off for a phase's own float32 references (the plain
    kernel versions), and put back after: the port's entry points scope
    their own precision, and the rest of this script runs with PyTorch's
    default flags."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


_SPIN_MS = []


def spin_ms(torch) -> float:
    """Device time of one `torch.cuda._sleep(SPIN_CYCLES)`, measured once."""
    if not _SPIN_MS:
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(SPIN_CYCLES)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        _SPIN_MS.append(min(times))
    return _SPIN_MS[0]


def time_ms(torch, fn, samples: int = 20, per_sample: int = 10) -> float:
    """Device time of one call: median over `samples` of the mean of
    `per_sample` back-to-back calls between two CUDA events. A spin kernel
    runs first, so the host has queued every call before the first one
    starts and the events time the device, not the host's launch rate; the
    spin lasts at least 3x the host's time to queue `per_sample` calls (a
    plain version of many small launches needs longer than a kernel), and
    a sample whose calls the host queued too slowly for it is taken again."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(per_sample):
        fn()
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    stretch = max(1.0, 3 * queue_ms / spin_ms(torch))
    cycles = int(SPIN_CYCLES * stretch)
    host_limit_ms = 0.75 * spin_ms(torch) * stretch
    times, retries = [], 0
    while len(times) < samples:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(per_sample):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms > host_limit_ms:
            retries += 1
            if retries > SAMPLE_RETRIES:
                fail(f"host took {host_ms:.2f} ms to queue the timed calls, "
                     f"longer than the spin ahead of them "
                     f"({host_limit_ms:.2f} ms usable), {retries} times: the "
                     f"time would be the host's")
            continue
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)


def ln_label(rows, C):
    return f"K1 fused_layer_norm ({rows},{C})"


def add_ln_label(rows, C):
    return f"K3 fused_add_layer_norm ({rows},{C})"


def levit_label(G, N, nh, tensor_cores):
    return (f"K2 levit_window_attention ({G},{N},{nh * 3 * 32}) nh={nh} "
            f"({'tensor' if tensor_cores else 'CUDA'} cores)")


def global_label(nh, N, hd):
    return f"K4 relpos_attention_global ({nh},{N},{hd})"


def window_label(G, N, hd, n_w, valid_rows):
    return (f"K5 relpos_attention_windowed ({G},{N},{hd}) n_w={n_w} "
            f"valid_rows={valid_rows}")


class Entries:
    """Per-kernel sums over the main paths' launches (bf16 only), and the
    numbers of one call at each kernel's first shape (for a kernel that no
    main path launches). A kernel with no library yardstick records None."""

    TIMES = ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")

    def __init__(self):
        self.by_name = {}
        self.first = {}
        self.rows = []  # (label, kernel ms, bound ms) per shape
        self.per_shape = {}  # (name, label) -> the times of one launch

    def record(self, label, name, err, ms, plain_ms, lib_ms, bytes_ms, ops_ms,
               launches, images=len(IMAGES)):
        self.rows.append((label, ms, max(bytes_ms, ops_ms)))
        vals = dict(zip(self.TIMES, (ms, plain_ms, lib_ms, bytes_ms, ops_ms)))
        self.first.setdefault(name, vals)
        self.per_shape.setdefault((name, label), vals)
        e = self.by_name.setdefault(name, dict(
            max_abs_err=0.0, launches=0, **{k: 0.0 for k in self.TIMES}))
        e["max_abs_err"] = max(e["max_abs_err"], err)
        self._add(e, vals, launches * images)

    def add(self, label, name, launches) -> bool:
        """More main-path launches at a shape already timed (phase 12's);
        False when the shape has not been timed."""
        vals = self.per_shape.get((name, label))
        if vals is None:
            return False
        self._add(self.by_name[name], vals, launches)
        return True

    def _add(self, e, vals, launches):
        e["launches"] += launches
        for k, v in vals.items():
            e[k] = None if v is None or e[k] is None else e[k] + v * launches

    def numbers(self, name, launches):
        """The JSON numbers: sums over the main paths' launches, or one
        call at the first shape when no main path launched the kernel."""
        e = dict(self.by_name[name])
        if not launches:
            e.update(self.first[name])
        return e


def check_kernel(torch, label, name, dname, kernel, plain, library, tol,
                 nbytes, flops_mm, flops_f32, launches, entries, compare=None,
                 images=len(IMAGES)):
    """One kernel at one shape: max |kernel - plain| within `tol`; in bf16
    also the times of kernel, plain version and library call (None: there
    is no library yardstick), and the bound from the bytes moved and the
    operations done. Returns the library call's time (None in float32 or
    without a yardstick)."""
    t0 = time.perf_counter()
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = (compare or (lambda a, b: (a.float() - b.float()).abs().max().item())
           )(out, ref)
    del out, ref
    if not err <= tol:
        fail(f"{label} {dname}: max|diff| {err} > {tol}")
    if dname != "bfloat16":
        print(f"{label} {dname}: max|diff|={err:.3e} (atol {tol:g}) "
              f"[{time.perf_counter() - t0:.1f} s]", flush=True)
        return None
    ms = time_ms(torch, kernel)
    plain_ms = time_ms(torch, plain, PLAIN_SAMPLES, PLAIN_PER_SAMPLE)
    lib_ms = None if library is None else time_ms(torch, library)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (flops_mm / PEAK_BF16_TC_FLOPS + flops_f32 / PEAK_F32_FLOPS) * 1e3
    lib = ("none" if lib_ms is None
           else f"{lib_ms:.5f} (kernel/library {ms / lib_ms:.2f}x)")
    print(f"{label} {dname} x{launches}: max|diff|={err:.3e} (atol {tol:g}) "
          f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib} "
          f"bound_ms={max(bytes_ms, ops_ms):.5f} "
          f"({'bytes' if bytes_ms >= ops_ms else 'operations'}) "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    entries.record(label, name, err, ms, plain_ms, lib_ms, bytes_ms, ops_ms,
                   launches, images)
    return lib_ms


def nvcc_report(build_log: str):
    """nvcc's per-kernel lines, (source, kernel, template arguments,
    registers, spill store bytes), from the -Xptxas -v log of the build."""
    rows, source, kernel = [], None, None
    for line in build_log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = re.search(r"([a-z_]+_kernel(?:_tc)?)I(.*)EEv", m.group(1))
            if name:
                targs = name.group(2)
                dtype = ("bf16 " if "bfloat16" in targs
                         else "f32 " if targs.startswith("f") else "")
                kernel = (name.group(1), dtype + ",".join(
                    re.findall(r"L[ib](\d+)E", targs)))
            else:
                kernel = (m.group(1), "")
            spill = None
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and kernel:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            rows.append((source, kernel[0], kernel[1], int(m.group(1)), spill))
            kernel = None
    return rows


def check_kernels(torch, ops, entries, ln_shapes=LN_SHAPES,
                  attn_shapes=ATTN_SHAPES, images=len(IMAGES)):
    """Phase 2, MobileSAM's kernels K1 and K2 at their main-path shapes
    (``images``: the calls of the counted main-path run per shape's
    launches: phase 4's two images, or phase 10's one batch)."""
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        es = torch.empty((), dtype=dtype).element_size()
        mm_flops = 1.0 if dtype == torch.bfloat16 else 0.0
        for rows, C, eps, per in ln_shapes:
            x = torch.randn((rows, C), generator=gen, device=dev).to(dtype)
            scale = (0.25 + 0.5 * torch.rand((C,), generator=gen, device=dev)).to(dtype)
            bias = (0.5 * torch.rand((C,), generator=gen, device=dev) - 0.25).to(dtype)
            check_kernel(
                torch, ln_label(rows, C), "fused_layer_norm",
                dname, lambda: ops.fused_layer_norm(x, scale, bias, eps),
                lambda: ops.layer_norm_plain(x, scale, bias, eps),
                lambda: F.layer_norm(x, (C,), scale, bias, eps),
                TOL[("ln", dname)], (2 * rows * C + 2 * C) * es, 0,
                7 * rows * C, per, entries, images=images)
        for G, N, nh, per in attn_shapes:
            kd = 32
            qkv = torch.randn((G, N, nh * 3 * kd), generator=gen, device=dev).to(dtype)
            bias = (0.5 * torch.randn((nh, N, N), generator=gen, device=dev)).to(dtype)
            q5 = qkv.view(G, N, nh, 3, kd)
            q, k, v = (q5[:, :, :, i].transpose(1, 2) for i in range(3))
            mask = bias[None].expand(G, nh, N, N)
            mm = 4 * G * nh * N * N * kd
            check_kernel(
                torch, levit_label(G, N, nh, mm_flops),
                "levit_window_attention", dname,
                lambda: ops.levit_window_attention(qkv, bias, nh),
                lambda: ops.levit_window_attention_plain(qkv, bias, nh),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                TOL[("attn", dname)], (G * N * nh * 4 * kd + nh * N * N) * es,
                mm * mm_flops, 7 * G * nh * N * N + mm * (1 - mm_flops), per,
                entries, images=images)


def same_bits(a, b) -> float:
    """0.0 when the outputs (a tensor or a tuple of tensors) are equal bit
    for bit, else the largest difference."""
    a, b = (t if isinstance(t, tuple) else (t,) for t in (a, b))
    if all(x.dtype == y.dtype and x.equal(y) for x, y in zip(a, b)):
        return 0.0
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def check_quant_kernels(torch, ops, entries, gemm_ms):
    """Phase 2, P2 and P3 at every shape of the w8a8 main paths (phase 9:
    per linear, M tokens, K its input width, N its output width), bit for
    bit against their plain versions in bf16 and float32, bf16 timed; at
    each linear's shape also the two products P3's time is to be read
    beside: cuBLASLt's s8 x s8 (``torch._int_mm``, what the w8a8 path
    runs, with the weight column-major as ``QuantLinear`` stores it, and
    row-major for the record) and the bf16 ``x @ w`` it replaces. Adds the
    products' times over the main paths' launches to ``gemm_ms``."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    p2, p3 = {}, {}
    for variant, _ in QUANT_PATHS:
        for M, K, N, per in quant_linears(variant):
            p2[(M, K)] = p2.get((M, K), 0) + per
            p3[(M, K, N)] = p3.get((M, K, N), 0) + per
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        es = torch.empty((), dtype=dtype).element_size()
        for (M, C), per in sorted(p2.items()):
            x = torch.randn((M, C), generator=gen, device=dev)
            x = (x * torch.exp(torch.randn((M, 1), generator=gen, device=dev))
                 ).to(dtype)
            check_kernel(
                torch, f"P2 quantize_rows_int8 ({M},{C})", "quantize_rows_int8",
                dname, lambda: ops.quantize_rows_int8(x),
                lambda: ops.quantize_activations_int8(x), None, 0.0,
                M * C * (es + 1) + 4 * M, 0, 5 * M * C, per, entries,
                compare=same_bits, images=1)
        for (M, K, N), per in sorted(p3.items()):
            q = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                              dtype=torch.int8)
            w_q = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                                dtype=torch.int8)
            acc = torch._int_mm(q, w_q)
            xs = torch.rand((M, 1), generator=gen, device=dev) * 1e-2
            ws = torch.rand((N,), generator=gen, device=dev) * 1e-3
            b = torch.randn((N,), generator=gen, device=dev).to(dtype)
            check_kernel(
                torch, f"P3 int8_epilogue ({M},{N}) K={K}", "int8_epilogue",
                dname, lambda: ops.int8_epilogue(acc, xs, ws, b, dtype),
                lambda: ops.int8_epilogue_plain(acc, xs, ws, b, dtype), None,
                0.0, M * N * (4 + es) + 4 * M + N * (4 + es), 0, 4 * M * N, per,
                entries, compare=same_bits, images=1)
            if dtype == torch.bfloat16:
                xb = torch.randn((M, K), generator=gen, device=dev).to(dtype)
                wb = torch.randn((K, N), generator=gen, device=dev).to(dtype)
                w_col = w_q.t().contiguous().t()  # QuantLinear's layout
                int_ms = time_ms(torch, lambda: torch._int_mm(q, w_col))
                row_ms = time_ms(torch, lambda: torch._int_mm(q, w_q))
                mm_ms = time_ms(torch, lambda: xb @ wb)
                ops_n = 2 * M * K * N
                print(f"  beside P3 at ({M},{K},{N}) x{per}: torch._int_mm "
                      f"{int_ms:.5f} ms with the port's column-major weight "
                      f"({row_ms:.5f} row-major; bound "
                      f"{ops_n / PEAK_INT8_TC_OPS * 1e3:.5f}), bf16 x @ w "
                      f"{mm_ms:.5f} ms (bound "
                      f"{ops_n / PEAK_BF16_TC_FLOPS * 1e3:.5f})", flush=True)
                gemm_ms["int_mm"] += int_ms * per
                gemm_ms["int_mm_row_major"] += row_ms * per
                gemm_ms["bf16"] += mm_ms * per
                del xb, wb, w_col
            del q, w_q, acc


def relpos_mask(torch, bhw, grid_h, grid_w, folded, scale, dtype):
    """The materialised float bias of K4 / K5 for the SDPA yardstick."""
    n = grid_h * grid_w
    tok = torch.arange(n, device=bhw.device)
    b = bhw.float()
    bias = b[:, :, :grid_h][:, :, tok // grid_w] + b[:, :, grid_h:][:, :, tok % grid_w]
    return (bias * scale if folded else bias).to(dtype)


def check_vit_kernels(torch, ops, entries, ln_shapes=VIT_LN_SHAPES,
                      add_ln_shapes=VIT_ADD_LN_SHAPES,
                      global_shapes=VIT_GLOBAL_SHAPES,
                      window_shapes=VIT_WINDOW_SHAPES, images=len(IMAGES)):
    """Phase 2, the SAM ViT's kernels: K1 at the ViT widths, K3, K4, K5 at
    ViT-B's, ViT-L's and ViT-H's shapes at 1024, rel-pos tables nonzero
    (``images`` as in ``check_kernels``). A window shape with n_w None
    runs K5 without the pad-query skip (a batch of frames)."""
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        es = torch.empty((), dtype=dtype).element_size()
        bf16 = dtype == torch.bfloat16
        for (rows, C, per), (_, _, per3) in zip(ln_shapes, add_ln_shapes):
            x, d = (torch.randn((rows, C), generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            scale = (0.25 + 0.5 * torch.rand((C,), generator=gen, device=dev)).to(dtype)
            bias = (0.5 * torch.rand((C,), generator=gen, device=dev) - 0.25).to(dtype)
            if per is not None:  # None: only K3 at this shape
                check_kernel(
                    torch, ln_label(rows, C), "fused_layer_norm",
                    dname, lambda: ops.fused_layer_norm(x, scale, bias, 1e-6),
                    lambda: ops.layer_norm_plain(x, scale, bias, 1e-6),
                    lambda: F.layer_norm(x, (C,), scale, bias, 1e-6),
                    TOL[("ln", dname)], (2 * rows * C + 2 * C) * es, 0,
                    7 * rows * C, per, entries, images=images)
            if per3 is None:  # only K1 at this shape
                continue

            def add_err(a, b):  # s bit for bit, then y within the tolerance
                if not torch.equal(a[0], b[0]):
                    fail(f"K3 ({rows},{C}) {dname}: s differs from x + d")
                return (a[1].float() - b[1].float()).abs().max().item()

            check_kernel(
                torch, add_ln_label(rows, C),
                "fused_add_layer_norm", dname,
                lambda: ops.fused_add_layer_norm(x, d, scale, bias, 1e-6),
                lambda: ops.fused_add_layer_norm_plain(x, d, scale, bias, 1e-6),
                lambda: F.layer_norm(x + d, (C,), scale, bias, 1e-6),
                TOL[("ln", dname)], (4 * rows * C + 2 * C) * es, 0,
                8 * rows * C, per3, entries, compare=add_err,
                images=images)
        for nh, g, hd, per in global_shapes:
            N = g * g
            q, k, v = (torch.randn((nh, N, hd), generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            rh, rw = (0.3 * torch.randn((g, g, hd), generator=gen, device=dev)
                      for _ in range(2))
            bhw = ops.bias_halves(q, rh, rw, g, g)
            mask = relpos_mask(torch, bhw, g, g, False, 1.0, dtype)
            mm = 4 * nh * N * N * hd
            check_kernel(
                torch, global_label(nh, N, hd),
                "relpos_attention_global", dname,
                lambda: ops.relpos_attention_global(q, k, v, bhw, g, g),
                lambda: ops.attention_relpos_plain(q, k, v, bhw, g, g),
                lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], attn_mask=mask[None]),
                TOL[("attn", dname)], (4 * nh * N * hd + nh * N * 2 * g) * es,
                mm if bf16 else 0, 7 * nh * N * N + (0 if bf16 else mm), per,
                entries, images=images)
            del mask
        for W, nh, ws, hd, n_w, valid_rows, per in window_shapes:
            N, G = ws * ws, W * nh
            scale = hd ** -0.5
            q, k, v = (torch.randn((G, N, hd), generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            rh, rw = (0.3 * torch.randn((ws, ws, hd), generator=gen, device=dev)
                      for _ in range(2))
            bhw = ops.bias_halves(q, rh, rw, ws, ws, out_scale=1.0 / scale)
            mask = relpos_mask(torch, bhw, ws, ws, True, scale, dtype)
            skipped = n_w or 0
            rows = (W - skipped) * nh * N + skipped * nh * (valid_rows or 0) * ws
            mm = 4 * rows * N * hd

            def win_err(a, b):  # skipped pad-query rows must be zero
                if n_w and a[-n_w * nh:, valid_rows * ws:].any():
                    fail(f"K5 {dname}: skipped pad-query rows are not zero")
                return (a.float() - b.float()).abs().max().item()

            check_kernel(
                torch, window_label(G, N, hd, n_w, valid_rows),
                "relpos_attention_windowed", dname,
                lambda: ops.relpos_attention_windowed(q, k, v, bhw, ws, ws, nh,
                                                      True, n_w, valid_rows),
                lambda: ops.attention_relpos_plain(
                    q, k, v, bhw, ws, ws, folded=True, heads=nh, n_w=n_w,
                    valid_rows=valid_rows),
                lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], attn_mask=mask[None]),
                TOL[("attn", dname)],
                (2 * G * N * hd + rows * (hd + 2 * ws) + G * N * hd) * es,
                mm if bf16 else 0, 7 * rows * N + (0 if bf16 else mm), per,
                entries, compare=win_err, images=images)
            del mask


def check_window_kernels(torch, ops, entries):
    """Phase 2, the last three kernels: K6 at the fused-window path's
    shapes (ViT-B, and ViT-H's), K7 at ViT-B's and ViT-H's windows, K8 at
    the gather probe's shapes."""
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        es = torch.empty((), dtype=dtype).element_size()
        bf16 = dtype == torch.bfloat16
        for B, grid, nh, hd, ws, per in VIT_STRIP_SHAPES:
            C, n, nw = nh * hd, ws * ws, grid // ws
            G = B * nw * nw * nh
            qkv = torch.randn((B, grid, grid, 3 * C), generator=gen,
                              device=dev).to(dtype)
            q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
            # In the activation dtype, as the fused-window path passes them.
            rh, rw = ((0.3 * torch.randn((ws, ws, hd), generator=gen,
                                         device=dev)).to(dtype) for _ in range(2))

            def partition():  # what the SDPA yardstick needs, K6 does not
                t = qkv.view(B, nw, ws, nw, ws, 3, nh, hd)
                return t.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, G, n, hd)

            qw, kw, vw = partition()
            mask = relpos_mask(torch, ops.bias_halves(qw, rh, rw, ws, ws), ws,
                               ws, False, 1.0, dtype)
            mm = 4 * G * n * n * hd + 4 * G * n * ws * hd  # + bias halves
            label = f"K6 windowed_attention_fused ({B},{grid},{grid},{C})"
            lib_ms = check_kernel(
                torch, label, "windowed_attention_fused", dname,
                lambda: ops.windowed_attention_fused(q, k, v, rh, rw, ws=ws,
                                                     num_heads=nh),
                lambda: ops.windowed_attention_fused_plain(
                    q, k, v, rh, rw, ws=ws, num_heads=nh),
                lambda: F.scaled_dot_product_attention(
                    qw[None], kw[None], vw[None], attn_mask=mask[None]),
                TOL[("attn", dname)],
                (4 * B * grid * grid * C + 2 * ws * ws * hd) * es,
                mm if bf16 else 0, 7 * G * n * n + (0 if bf16 else mm), per,
                entries)
            if bf16:
                both_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    *(t[None] for t in partition()), attn_mask=mask[None]))
                print(f"{label} {dname}: SDPA yardstick without the partition "
                      f"{lib_ms:.5f} ms, with it {both_ms:.5f} ms; the "
                      f"partition of q, k, v into windows alone (copies K6 "
                      f"does not make) {time_ms(torch, partition):.5f} ms",
                      flush=True)
            del mask, qw, kw, vw
        for W, nh, ws, hd in VIT_QKV_SHAPES:
            n, G = ws * ws, W * nh
            qkv = torch.randn((W, 3, nh, n, hd), generator=gen,
                              device=dev).to(dtype)
            rh, rw = (0.3 * torch.randn((ws, ws, hd), generator=gen,
                                        device=dev) for _ in range(2))
            bhw = ops.bias_halves(qkv[:, 0].reshape(G, n, hd), rh, rw, ws, ws)
            mask = relpos_mask(torch, bhw, ws, ws, False, 1.0, dtype)
            mm = 4 * G * n * n * hd
            check_kernel(
                torch, f"K7 relpos_attention_qkv ({W},3,{nh},{n},{hd})",
                "relpos_attention_qkv", dname,
                lambda: ops.relpos_attention_qkv(qkv, bhw, ws, ws),
                lambda: ops.windowed_attention_qkv_plain(qkv, bhw, ws, ws),
                lambda: F.scaled_dot_product_attention(
                    qkv[:, 0], qkv[:, 1], qkv[:, 2],
                    attn_mask=mask.view(W, nh, n, n)),
                TOL[("attn", dname)], (4 * G * n * hd + G * n * 2 * ws) * es,
                mm if bf16 else 0, 7 * G * n * n + (0 if bf16 else mm), 0,
                entries)
            del mask
        table, layouts = ops.probe_inputs(dev, dtype)
        rows, lanes = PROBE_SHAPE
        for layout, idx in layouts.items():
            for reps in PROBE_REPS:
                check_kernel(
                    torch, f"K8 smem_gather ({rows},{lanes}) {layout} "
                    f"reps={reps}", "smem_gather", dname,
                    lambda: ops.smem_gather(table, idx, reps),
                    lambda: ops.smem_gather_plain(table, idx, reps), None,
                    0.0, rows * lanes * (es + 4 + 4), 0, reps * rows * lanes,
                    0, entries)


def np_greedy_nms(np, boxes, scores, thresh):
    """The exact greedy box NMS in numpy float32, each kept row vectorised
    over the later candidates still kept, with the plain version's ops in
    its order. -> (keep, the IoU tests these inputs need: each kept row
    against the later candidates still kept when it runs)."""
    f, one, zero = np.float32, np.float32(1), np.float32(0)
    x0, y0, x1, y1 = boxes.astype(f).T
    area = np.maximum(x1 - x0 + one, zero) * np.maximum(y1 - y0 + one, zero)
    keep = scores > 0
    tests = 0
    for i in range(len(keep)):
        if not keep[i]:
            continue
        live = np.flatnonzero(keep[i + 1:]) + i + 1
        tests += len(live)
        iw = np.maximum(np.minimum(x1[i], x1[live])
                        - np.maximum(x0[i], x0[live]) + one, zero)
        ih = np.maximum(np.minimum(y1[i], y1[live])
                        - np.maximum(y0[i], y0[live]) + one, zero)
        inter = iw * ih
        iou = inter / np.maximum(area[i] + area[live] - inter, one)
        keep[live[iou > f(thresh)]] = False
    return keep, tests


def nms_inputs(torch, M, seed):
    """Score-sorted overlapping boxes on the 256 low-res grid, a duplicate
    tail and invalid (-1) scores (as tests/test_torch_cuda.py makes them)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(seed)
    xy = torch.randint(0, 200, (M, 2), generator=gen)
    wh = torch.randint(1, 80, (M, 2), generator=gen)
    boxes = torch.cat([xy, xy + wh - 1], dim=1).float()
    boxes[M - M // 8:] = boxes[torch.randint(0, M, (M // 8,), generator=gen)]
    boxes = boxes[torch.randperm(M, generator=gen)]
    scores = torch.sort(torch.rand(M, generator=gen), descending=True).values
    scores[M - M // 10:] = -1.0
    return boxes.to(dev), scores.to(dev)


def graph_time_ms(torch, fn) -> float:
    """Device time of `fn` captured in a CUDA graph, one replay a sample:
    for a plain version of thousands of small launches, which the host
    cannot queue behind a spin (the launch queue fills and the host
    waits), and which inside a graphed program runs as such a graph."""
    caller = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        fn()
    caller.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    ms = time_ms(torch, graph.replay, samples=5, per_sample=1)
    del graph
    return ms


def nms_numbers(torch, np, ops, boxes, scores, thresh):
    """The NMS kernel and its plain version on one input: their keep flags
    must equal each other's and the numpy mirror's bit for bit. -> (kernel
    ms, plain ms, bytes ms, operations ms, kept, IoU tests)."""
    keep = ops.greedy_nms(boxes, scores, thresh)
    plain = ops.greedy_nms_plain(boxes, scores, thresh)
    mirror, tests = np_greedy_nms(np, boxes.cpu().numpy(), scores.cpu().numpy(),
                                  float(thresh.item()))
    if not torch.equal(keep, plain):
        fail(f"greedy_nms M={len(keep)}: {int((keep != plain).sum())} keep "
             f"flags differ from the plain version")
    if not np.array_equal(keep.cpu().numpy(), mirror):
        fail(f"greedy_nms M={len(keep)}: keep flags differ from numpy's")
    M = len(keep)
    ms = time_ms(torch, lambda: ops.greedy_nms(boxes, scores, thresh))
    plain_ms = graph_time_ms(
        torch, lambda: ops.greedy_nms_plain(boxes, scores, thresh))
    bytes_ms = (M * (16 + 4 + 1) + 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = tests * NMS_OPS_PER_TEST / PEAK_F32_FLOPS * 1e3
    return ms, plain_ms, bytes_ms, ops_ms, int(mirror.sum()), tests


def check_nms_kernel(torch, np, ops):
    """Phase 2, the greedy NMS kernel at NMS_SIZES on seeded boxes
    (threshold 0.7)."""
    thresh = torch.tensor([0.7], device="cuda")
    for M in NMS_SIZES:
        t0 = time.perf_counter()
        boxes, scores = nms_inputs(torch, M, M)
        ms, plain_ms, bytes_ms, ops_ms, kept, tests = nms_numbers(
            torch, np, ops, boxes, scores, thresh)
        print(f"greedy_nms M={M}: keep flags equal to the plain version's "
              f"and numpy's ({kept} kept, {tests} IoU tests) kernel_ms="
              f"{ms:.5f} (one call: the IoU bitmask, then the one-warp scan "
              f"over {-(-M // 64)} row blocks) plain_ms={plain_ms:.5f} (the "
              f"plain loop replayed as a CUDA graph) "
              f"bound_ms={max(bytes_ms, ops_ms):.5f} "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; the "
              f"scan is latency bound) "
              f"[{time.perf_counter() - t0:.1f} s]", flush=True)


def k1_launch_floor(torch, ops, entries, restore_counters):
    """K1 at each of MobileSAM's shapes (µs, bound), timed back to back as
    phase 2 times it and inside a CUDA graph of 100 launches (as the main
    path runs it since its executables are graphs), beside an empty kernel
    (`torch.cuda._sleep(0)`) timed both ways, and the in-graph sum over
    MobileSAM's main-path launches against the bound's."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    side = torch.cuda.Stream()
    rows = {label: (ms, bound) for label, ms, bound in entries.rows}
    graph_sum = bound_sum = 0.0
    for n, C, eps, per in LN_SHAPES:
        ms, bound = rows[ln_label(n, C)]
        x = torch.randn((n, C), generator=gen, device=dev).to(torch.bfloat16)
        scale = (0.25 + 0.5 * torch.rand((C,), generator=gen, device=dev)
                 ).to(torch.bfloat16)
        bias = (0.5 * torch.rand((C,), generator=gen, device=dev) - 0.25
                ).to(torch.bfloat16)
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream())
        with restore_counters():
            with torch.cuda.stream(side):
                ops.fused_layer_norm(x, scale, bias, eps)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(graph, stream=side):
                for _ in range(100):
                    ops.fused_layer_norm(x, scale, bias, eps)
        in_graph = time_ms(torch, graph.replay) * 1e3 / 100
        del graph
        graph_sum += in_graph * per * len(IMAGES) / 1e3
        bound_sum += bound * per * len(IMAGES)
        print(f"K1 at MobileSAM's ({n},{C}): {ms * 1e3:.2f} us back to back, "
              f"{in_graph:.2f} us in a CUDA graph of 100, bound "
              f"{bound * 1e3:.2f} us ({bound * 1e3 / in_graph:.0%} of the "
              f"in-graph time)")
    eager_us = time_ms(torch, lambda: torch.cuda._sleep(0)) * 1e3
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(100):
            torch.cuda._sleep(0)
    graph_us = time_ms(torch, graph.replay) * 1e3 / 100
    print(f"an empty kernel: {eager_us:.2f} us a launch back to back, "
          f"{graph_us:.2f} us a kernel in a CUDA graph of 100", flush=True)
    print(f"K1 over MobileSAM's {LN_PER_PROCESS * len(IMAGES)} main-path "
          f"launches, in CUDA graphs: {graph_sum:.5f} ms against a bound of "
          f"{bound_sum:.5f} ms ({bound_sum / graph_sum:.0%})", flush=True)


def rgba(np, h: int, w: int, seed: int):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)


def seed_vit_extras(torch, model, seed: int = 0) -> None:
    """Seeded nonzero rel-pos tables, pos_embed and qkv biases in the SAM
    ViT encoder (JAX's init zeroes them); the same values for every model
    of one config, cast to each model's dtype."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.encoder.named_parameters():
            if name == "pos_embed" or name.endswith(("rel_pos_h", "rel_pos_w",
                                                     "qkv.b")):
                std = 0.5 if name == "pos_embed" else 0.3
                p.copy_((std * torch.randn(p.shape, generator=gen)).to(p.dtype))


def rel_l2(torch, a, b) -> float:
    return (torch.linalg.vector_norm(a.float() - b.float())
            / torch.linalg.vector_norm(b.float())).item()


def use_fused_windows(bundle) -> None:
    """Set fused_window_blocks on a loaded ViT bundle's encoder config (as
    the tests inject bundles); before its first `process`, which builds the
    executables from the config."""
    bundle.cfg = dataclasses.replace(bundle.cfg, encoder_vit=dataclasses.replace(
        bundle.cfg.encoder_vit, fused_window_blocks=True))


def check_small_against_cpu(torch, np, dl, counters):
    """Phase 3: the port on the card against the port on the CPU (the plain
    path, which the CPU tests hold against the JAX package), float32:
    MobileSAM at 64, ViT-B at 512, ViT-B at 512 with fused_window_blocks."""
    for variant, size, emb_check, fused in (
            ("mobile_sam", 64, "abs", False), ("vit_b", 512, "rel", False),
            ("vit_b", 512, "rel", True)):
        t0 = time.perf_counter()
        opts = dict(allow_random_weights=True, compute_dtype="float32",
                    sam_image_size=size, largest_region_object=True,
                    sam_variant=variant)
        envs = [dl.Environment(dl.Options(backend=b, **opts))
                for b in (dl.Backend.cpu, dl.Backend.gpu)]
        if variant != "mobile_sam":
            for e in envs:
                seed_vit_extras(torch, e.sam_model(variant).model)
                if fused:
                    use_fused_windows(e.sam_model(variant))
        label = f"{variant}{' fused-window' if fused else ''}"
        w, h = size * 3 // 2, size
        img = dl.Image(dl.Extent(w, h), dl.Channels.rgba, rgba(np, h, w, 42))
        before = counters()
        segs = [dl.Segmentation.process(img, e) for e in envs]
        e_cpu, e_gpu = (s.embedding.float().cpu() for s in segs)
        err = (e_cpu - e_gpu).abs().max().item()
        rel = rel_l2(torch, e_gpu, e_cpu)
        launched = {k: v - before[k] for k, v in counters().items()}
        print(f"{label} at {size}, f32 embedding, card vs CPU: "
              f"max|diff|={err:.3e} relative L2 {rel:.3e} "
              f"({'atol 1e-4' if emb_check == 'abs' else 'limit 1e-5'}); "
              f"card launches {launched}")
        if emb_check == "abs" and not err <= 1e-4:
            fail(f"{label}: card embedding differs from the CPU port: {err}")
        if emb_check == "rel" and not rel <= 1e-5:
            fail(f"{label}: card embedding differs from the CPU port: "
                 f"relative L2 {rel}")
        if variant == "vit_b":
            per = VIT_FUSED_PER_PROCESS if fused else VIT_PER_PROCESS
            want = {k: per.get(k, 0) for k in launched}
            if launched != want:
                fail(f"{label} at 512 launched {launched}, want {want}")
        prompts = [dl.Point(w * 5 // 16, h * 5 // 16),
                   dl.Region(dl.Point(size // 8, size // 8),
                             dl.Point(w * 5 // 6, h * 7 // 8))]
        for p in prompts:
            a, b = (s.compute_mask(p).pixels for s in segs)
            flips = int((a != b).sum())
            print(f"{label} f32 mask {p}: {flips} of {a.size} pixels differ")
            limit = 0 if variant == "mobile_sam" else 1e-4 * a.size
            if flips > limit:
                fail(f"{label}: card mask differs from the CPU port for {p}")
        print(f"phase 3 {label}: {time.perf_counter() - t0:.1f} s", flush=True)


def amg_logits(torch, env, seg, grid, slots, thr, refine):
    """The upsampled logits (K, H, W) of the winners of the AMG program on
    `thr`, run eagerly from its own stages (for the near-zero flip rule)."""
    from dlimgedit_tpu_torch.ops.postprocess import upsample_mask_logits
    from dlimgedit_tpu_torch.ops.preprocess import pick_bucket
    from dlimgedit_tpu_torch.runtime import amg as ramg

    bundle = env.sam_model()
    cfg = bundle.cfg
    bucket = pick_bucket(seg.extent)
    head, between, _ = ramg._build_amg_fn(
        bundle, bucket, grid, slots, ramg._prenms_pool(grid * grid, slots), True)
    sizes = seg._sizes()
    with torch.inference_mode():
        out = head(seg.embedding, sizes, thr)
        m = between(*out)[0] if refine else out[0]
        logits = upsample_mask_logits(m[None], bucket, cfg.image_size, *sizes)
    h, w = seg.extent.height, seg.extent.width
    return logits[0, :, :h, :w].cpu().numpy()


def check_amg_small_against_cpu(torch, np, dl):
    """Phase 3, automatic mask generation at image size 64, float32: the
    card against the CPU (grid 4; the goldens' call, 8 winners at nms 1.0,
    and those through the small-region filter): the same count,
    accuracies within 2e-5, masks equal but where the CPU's logit is within
    1e-4 of zero."""
    t0 = time.perf_counter()
    opts = dict(allow_random_weights=True, compute_dtype="float32",
                sam_image_size=64)
    envs = [dl.Environment(dl.Options(backend=b, **opts))
            for b in (dl.Backend.cpu, dl.Backend.gpu)]
    img = dl.Image(dl.Extent(96, 64), dl.Channels.rgba, rgba(np, 64, 96, 42))
    segs = [dl.Segmentation.process(img, e) for e in envs]
    for kw in (dict(max_masks=4, nms_thresh=0.7),
               dict(max_masks=8, nms_thresh=1.0),
               dict(max_masks=8, nms_thresh=1.0, min_mask_region_area=400)):
        cpu, card = (s.generate_masks(grid=4, **AMG_THRESH, **kw) for s in segs)
        if len(cpu) != len(card) or not cpu:
            fail(f"AMG at 64 {kw}: {len(card)} masks on the card, {len(cpu)} "
                 f"on the CPU")
        err = max(abs(a.accuracy - b.accuracy) for a, b in zip(cpu, card))
        if not err <= 2e-5:
            fail(f"AMG at 64 {kw}: accuracies differ by {err}")
        seg = segs[0]
        lr = seg._scale * 16 / 64
        thr = envs[0].floats_on_device((0.0, 0.0, kw["nms_thresh"], 0.0, 1.0,
                                        kw.get("min_mask_region_area", 0) * lr * lr))
        logits = amg_logits(torch, envs[0], seg, 4, kw["max_masks"], thr,
                            "min_mask_region_area" in kw)
        flips = 0
        for i, (a, b) in enumerate(zip(cpu, card)):
            if not np.array_equal(np.where(logits[i] > 0, 255, 0),
                                  a.image.pixels[..., 0]):
                fail(f"AMG at 64 {kw}: the program's own logits do not give "
                     f"its mask {i}")
            flip = a.image.pixels[..., 0] != b.image.pixels[..., 0]
            if not (np.abs(logits[i][flip]) <= 1e-4).all():
                fail(f"AMG at 64 {kw}: mask {i} differs from the CPU's away "
                     f"from the threshold")
            flips += int(flip.sum())
        print(f"AMG at 64 {kw}, card vs CPU: {len(card)} masks each, "
              f"accuracies max|diff|={err:.2e} (limit 2e-5), {flips} pixels "
              f"flipped (allowed where the CPU's logit is within 1e-4 of 0)")
    print(f"phase 3 AMG: {time.perf_counter() - t0:.1f} s", flush=True)


def queries(dl, seg):
    ext = seg.extent
    cx, cy = ext.width // 2, ext.height // 2
    region = dl.Region(dl.Point(ext.width // 8, ext.height // 8),
                       dl.Point(ext.width * 7 // 8, ext.height * 7 // 8))
    out = [seg.compute_mask(dl.Point(cx, cy)), seg.compute_mask(region)]
    out += [m.image for m in seg.compute_masks(dl.Point(cx // 2, cy))]
    out += [m.image for m in seg.compute_mask_batch(
        [dl.Point(cx, cy), region, dl.Point(ext.width // 4, ext.height // 4),
         dl.Point(ext.width * 3 // 4, ext.height * 3 // 4)])]
    return out


def hold_replays_against_eager(torch, env, label) -> None:
    """Every CUDA graph of `env`, replayed on its last call's inputs, must
    equal its eager program on the same inputs bit for bit (the same
    kernels in the same order). The comparison's launches are not
    counted."""
    for key, exe in env.executables.items():
        if not exe.graphed:
            fail(f"{label}: executable {key} is not a CUDA graph")
        got, want = exe.replay_against_eager()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                err = (g.float() - w.float()).abs().max().item()
                fail(f"{label}: {key} replayed differs from eager, "
                     f"max|diff| {err}")


def check_no_aliasing(torch, np, dl, env, images, segs) -> None:
    """`process` B in the bucket of an earlier Segmentation A, then a click
    on A: A's embedding and mask are still A's (a replay overwrites the
    graph's static output; the embedding handed out is a clone)."""
    a = segs[0]
    w, h, _ = IMAGES[0]
    point = dl.Point(w // 2, h // 2)
    emb, mask = a.embedding.clone(), a.compute_mask(point).pixels
    b = dl.Segmentation.process(
        dl.Image(dl.Extent(w, h), dl.Channels.rgba, rgba(np, h, w, 3)), env)
    if torch.equal(b.embedding, emb):
        fail("aliasing check: images A and B embed alike")
    if not torch.equal(a.embedding, emb):
        fail("aliasing check: processing B changed A's embedding")
    if not np.array_equal(a.compute_mask(point).pixels, mask):
        fail("aliasing check: A's mask changed after processing B")
    print(f"aliasing check passed: process A, process B in A's bucket, "
          f"click on A", flush=True)


def check_batch_contract(torch, dl, probe_masks, env, images) -> None:
    """Phase 4 on MobileSAM, C5: JAX's contract (tests/test_segmentation.py::
    test_compute_mask_batch_matches_individual) at the main size. On image
    A, 16 seeded points and boxes, every batch size 1-8 with each prompt at
    every position: each `compute_mask_batch` mask byte-equal to
    `compute_mask` of its prompt, with largest_region_object on (the path's
    Environment) and off (a second one of the same seeded weights); then
    every graph of each Environment against its eager program."""
    t0 = time.perf_counter()
    for lcc in (True, False):
        e = env if lcc else dl.Environment(dl.Options(
            allow_random_weights=True, largest_region_object=False,
            sam_variant="mobile_sam"))
        seg = dl.Segmentation.process(images[0], e)
        report = probe_masks.hold_batches(
            dl, seg, probe_masks.batch_prompts(dl, seg.extent))
        line = probe_masks.describe(report)
        if report["differ"]:
            fail(f"phase 4 C5, largest_region_object={lcc}: {line}")
        hold_replays_against_eager(torch, e, f"C5 largest_region_object={lcc}")
        print(f"phase 4 C5 mobile_sam, largest_region_object={lcc}: {line} "
              f"(batch sizes 1-8, every position)", flush=True)
    print(f"phase 4 C5: {time.perf_counter() - t0:.1f} s", flush=True)


def lcc_options(torch, dl, run, host_ms) -> None:
    """A region click with largest_component on MobileSAM's first image,
    two ways of labelling in a graphed decode: (b) the eager early-exit
    labelling between two graphs (what the port runs), and (a) the fixed
    64 sweeps captured in the decode's graph, estimated as the graphed
    decode without labelling plus a graph of the 64 sweeps (and the
    selection of the largest component) on the same decoder masks."""
    from dlimgedit_tpu_torch.models import sam as sam_lib
    from dlimgedit_tpu_torch.ops import connected

    env, images, segs, _ = run
    seg, ext = segs[0], images[0].extent
    region = dl.Region(dl.Point(ext.width // 8, ext.height // 8),
                       dl.Point(ext.width * 7 // 8, ext.height * 7 // 8))
    b_ms = host_ms(lambda: seg.compute_mask(region, largest_component=True))
    plain_ms = host_ms(lambda: seg.compute_mask(region,
                                                largest_component=False))
    bundle = env.sam_model("mobile_sam")
    points, labels = seg._prompt_arrays(None, region)
    dev = env.device

    def fixed_sweeps(mask):  # option (a)'s labelling: no host read
        B, H, W = mask.shape
        ids = torch.arange(1, H * W + 1, device=dev).reshape(1, H, W)
        lab, fg = torch.where(mask, ids, 0), mask.reshape(B, H * W)
        for _ in range(64):
            lab = connected._sweep(lab, mask, fg)
        sizes = torch.zeros((B, H * W + 1), dtype=torch.int64, device=dev)
        sizes.scatter_add_(1, lab.reshape(B, H * W), fg.to(torch.int64))
        sizes[:, 0].fill_(0)  # a fill: a scalar store would copy from the host
        return (lab == torch.argmax(sizes, dim=1)[:, None, None]) & mask

    with torch.inference_mode():
        masks, _ = sam_lib.decode_masks(
            bundle.model, bundle.cfg, seg.embedding,
            torch.from_numpy(points).to(dev), torch.from_numpy(labels).to(dev),
            multimask=False)
        mask = masks[:, 0] > 0
        sweeps = [0]
        sweep = connected._sweep

        def counted(*args):
            sweeps[0] += 1
            return sweep(*args)

        connected._sweep = counted
        try:
            want = connected.largest_component_mask(mask)
        finally:
            connected._sweep = sweep
        label_ms = host_ms(lambda: connected.largest_component_mask(mask))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fixed_sweeps(mask)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            got = fixed_sweeps(mask)
        fixed_ms = host_ms(graph.replay)
        if not torch.equal(got, want):
            fail("the 64 fixed sweeps disagree with the early-exit labelling")
    print(f"largest_component on a MobileSAM region click ({ext.width}x"
          f"{ext.height}), mask_ms: (b) eager labelling between two graphs "
          f"(the port) {b_ms:.3f}; graphed decode without labelling "
          f"{plain_ms:.3f}; the eager early-exit labelling alone {label_ms:.3f} "
          f"({sweeps[0]} sweeps); a graph of the fixed 64 sweeps alone "
          f"{fixed_ms:.3f} (equal to the early exit); (a) estimated "
          f"{plain_ms + fixed_ms:.3f}", flush=True)


def drive_main_path(torch, np, dl, variant, counters, zero_counters, want,
                    fused=False):
    """Phase 4 for one variant (with ``fused``, its bundle's
    fused_window_blocks set): process + the four mask entry points on both
    images; launch counts checked; the embedding held against the plain
    path. Returns (env, images, segs, launches of round 2, (peak
    allocated, allocated, reserved) device bytes of the path's model and
    graphed rounds))."""
    t0 = time.perf_counter()
    label = f"{variant}{' fused-window' if fused else ''}"
    torch.cuda.empty_cache()  # reserved = allocated, before the path
    base_mem = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    env = dl.Environment(dl.Options(allow_random_weights=True,
                                    largest_region_object=True,
                                    sam_variant=variant))
    bundle = env.sam_model(variant)
    vit = bundle.cfg.encoder_vit is not None
    enc_cfg = bundle.cfg.encoder_vit if vit else bundle.cfg.encoder_tiny
    on = (enc_cfg.use_flash_attention if vit else
          enc_cfg.use_fused_norm and enc_cfg.use_flash_attention)
    if env.device.type != "cuda" or not on:
        fail(f"the default {variant} Environment is not on the card with its "
             f"kernels ({env.device}, {enc_cfg})")
    if vit:
        seed_vit_extras(torch, bundle.model)
    if fused:
        use_fused_windows(bundle)
    print(f"{label} model load (random weights, seed 0): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    images = [dl.Image(dl.Extent(w, h), dl.Channels.rgba, rgba(np, h, w, s))
              for (w, h, s) in IMAGES]

    # Three rounds over both images, each `process` and the four mask
    # queries: round 1 warms each key up (its eager launches count) and
    # captures its CUDA graph, rounds 2 and 3 replay. Each round's launches
    # are checked; the counted main-path run is round 2 (replays only).
    segs, first_masks, launches = [None] * len(images), [None] * len(images), None
    for rnd in range(ROUNDS):
        zero_counters()
        for i, img in enumerate(images):
            seg = dl.Segmentation.process(img, env)
            masks = queries(dl, seg)
            torch.cuda.synchronize()
            emb = seg.embedding
            if rnd == 0:
                segs[i], first_masks[i] = seg, masks
                if (tuple(emb.shape) != (1, 64, 64, 256)
                        or not bool(torch.isfinite(emb).all())):
                    fail(f"{label}: bad embedding {tuple(emb.shape)}")
                for m in masks:
                    px = m.pixels
                    if px.shape != (img.extent.height, img.extent.width, 1):
                        fail(f"mask shape {px.shape} != extent {img.extent}")
                    if not set(np.unique(px).tolist()) <= {0, 255}:
                        fail("mask is not binary {0, 255}")
                print(f"{label} image {img.extent.width}x{img.extent.height}: "
                      f"embedding {tuple(emb.shape)}, {len(masks)} masks, "
                      f"foreground shares "
                      f"{[round(float((m.pixels > 0).mean()), 3) for m in masks]}",
                      flush=True)
            else:
                if not torch.equal(emb, segs[i].embedding):
                    fail(f"{label} round {rnd + 1}: the replayed embedding "
                         f"differs from round 1's")
                if not all(np.array_equal(m.pixels, f.pixels)
                           for m, f in zip(masks, first_masks[i])):
                    fail(f"{label} round {rnd + 1}: a replayed mask differs "
                         f"from round 1's")
            hold_replays_against_eager(torch, env, f"{label} round {rnd + 1}")
        counts = counters()
        if rnd == 1:
            launches = counts
        print(f"{label} round {rnd + 1} ({'warm-up and capture' if rnd == 0 else 'replays'}) "
              f"launches over {len(images)} process calls: {counts}", flush=True)
        expect = {k: want.get(k, 0) * len(images) for k in counts}
        if counts != expect:
            fail(f"{label} round {rnd + 1}: kernel launches {counts} != {expect}")
    memory = (torch.cuda.max_memory_allocated() - base_mem,
              torch.cuda.memory_allocated() - base_mem,
              torch.cuda.memory_reserved() - base_reserved)
    captured = sum(e.captured for e in env.executables.values())
    print(f"{label}: {captured} executables captured, each replayed output "
          f"bit-equal to "
          f"its eager program; device memory of the path (above what the "
          f"earlier paths left): max_memory_allocated {memory[0] / 2**30:.3f} "
          f"GiB, allocated after {memory[1] / 2**30:.3f} GiB (weights, "
          f"static buffers, embeddings), reserved after "
          f"{memory[2] / 2**30:.3f} GiB (the graphs' memory pools too)",
          flush=True)

    # The same model with the kernels switched off (the plain PyTorch path on
    # the card: for the ViT the dense path, fused_window_blocks off too), and
    # both paths in float32. In bf16 the kernel and plain paths round
    # independently, so they are compared through their distance to the
    # float32 result; in float32 they are compared directly.
    def make_env(dtype, kernels):
        e = dl.Environment(dl.Options(allow_random_weights=True,
                                      compute_dtype=dtype, sam_variant=variant))
        b = e.sam_model(variant)
        if vit:
            seed_vit_extras(torch, b.model)
            b.cfg = dataclasses.replace(b.cfg, encoder_vit=dataclasses.replace(
                b.cfg.encoder_vit, use_flash_attention=kernels,
                fused_window_blocks=fused and kernels))
        else:
            b.cfg = dataclasses.replace(b.cfg, encoder_tiny=dataclasses.replace(
                b.cfg.encoder_tiny, use_fused_norm=kernels,
                use_flash_attention=kernels))
        for (k, v), (k2, v2) in zip(bundle.model.state_dict().items(),
                                    b.model.state_dict().items()):
            if k != k2 or not torch.equal(v, v2.to(v.dtype)):
                fail(f"the {dtype} {label} model differs from the main one "
                     f"at {k}")
        return e

    plain_env = make_env("bfloat16", False)
    f32_plain_env = make_env("float32", False)
    f32_kernel_env = make_env("float32", True)
    for img, seg in zip(images, segs):
        counts = counters()
        plain = dl.Segmentation.process(img, plain_env).embedding
        ref = dl.Segmentation.process(img, f32_plain_env).embedding
        if counters() != counts:
            fail(f"{label}: the plain path launched a kernel")
        f32_k = dl.Segmentation.process(img, f32_kernel_env).embedding
        f32_err = rel_l2(torch, f32_k, ref)
        k_err, p_err = rel_l2(torch, seg.embedding, ref), rel_l2(torch, plain, ref)
        print(f"{label} embedding {img.extent.width}x{img.extent.height}, "
              f"relative L2: float32 kernels vs float32 plain {f32_err:.3e} "
              f"(limit 1e-5); bf16 kernels vs float32 {k_err:.4e}, bf16 plain "
              f"vs float32 {p_err:.4e} (limit 1.1x); bf16 kernels vs bf16 "
              f"plain {rel_l2(torch, seg.embedding, plain):.4e}", flush=True)
        if not f32_err <= 1e-5:
            fail(f"{label}: float32 kernel path differs from the plain path: "
                 f"{f32_err}")
        if not k_err <= 1.1 * p_err:
            fail(f"{label}: bf16 kernel path is further from float32 "
                 f"({k_err}) than the bf16 plain path ({p_err})")
    del plain_env, f32_plain_env, f32_kernel_env
    torch.cuda.empty_cache()
    print(f"phase 4 {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return env, images, segs, launches, memory


def amg_thresholds(seg, bundle, kw):
    """generate_masks's threshold vector for the keywords `kw`."""
    lr = seg._scale * bundle.cfg.mask_input_size / bundle.cfg.image_size
    t = dict(AMG_THRESH, nms_thresh=0.7, min_area_frac=0.0, max_area_frac=1.0,
             min_mask_region_area=0)
    t.update(kw)
    return (t["iou_thresh"], t["stability_thresh"], t["nms_thresh"],
            t["min_area_frac"], t["max_area_frac"],
            t["min_mask_region_area"] * lr * lr)


def hold_amg_against_mirror(torch, np, env, seg, exe, thr):
    """The winners of the key's last call (replayed) against the numpy
    mirror of the selection (filter, stable sort, the pool, greedy NMS,
    top-K) fed with the card's own pass-A statistics (`amg_candidates`).
    -> the pool's (boxes, scores) on the card, the NMS kernel's input."""
    from dlimgedit_tpu_torch.runtime import amg as ramg

    bundle = env.sam_model(seg._variant)
    prenms = ramg._prenms_pool(AMG_GRID * AMG_GRID, AMG_SLOTS)
    with torch.inference_mode():
        cands = ramg.amg_candidates(bundle, seg.embedding, seg._sizes(), AMG_GRID)
        valid = ramg._grid_and_valid(bundle.cfg, seg._sizes(), AMG_GRID)[1]
        boxes_p, sc_p, idx_p = ramg.amg_pool(
            *cands, valid, env.floats_on_device(thr), prenms)
    iou, stab, area, boxes = (t.cpu().numpy() for t in cands)
    f = np.float32
    valid_area = f(valid.sum().item())
    ok = ((iou >= f(thr[0])) & (stab >= f(thr[1]))
          & (area >= max(f(thr[3]) * valid_area, f(1)))
          & (area <= f(thr[4]) * valid_area))
    score = np.where(ok, iou, f(-1))
    order = np.argsort(-score, kind="stable")[:prenms]
    if not np.array_equal(order, idx_p.cpu().numpy()):
        fail("AMG: the pre-NMS pool differs from numpy's stable sort")
    keep, _ = np_greedy_nms(np, boxes[order], score[order], thr[2])
    win = order[keep][:AMG_SLOTS]
    got, _ = exe.replay_against_eager()
    sc, st, ar = (t.cpu().numpy() for t in got[1:])
    n = int((sc > 0).sum())
    if n != len(win) or not (np.array_equal(sc[:n], iou[win])
                             and np.array_equal(st[:n], stab[win])
                             and np.array_equal(ar[:n], area[win])):
        fail(f"AMG thresholds {thr}: the program's {n} winners differ from "
             f"the numpy mirror's {len(win)}")
    return boxes_p, sc_p, n


def graph_nodes(torch, exe, restore_counters) -> str:
    """Nodes of the key's CUDA graphs (head, and tail), counted on a second
    capture kept as a cudaGraph_t (the driver's cuGraphGetNodes)."""
    import ctypes

    try:
        cuda = ctypes.CDLL("libcuda.so.1")
        counts = []
        for stage, g in zip(exe._stages[::2], exe._graphs):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with restore_counters(), torch.cuda.graph(graph, stream=side):
                stage(*g.static_inputs)
            n = ctypes.c_size_t(0)
            rc = cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                      None, ctypes.byref(n))
            if rc != 0:
                return f"not measured (cuGraphGetNodes returned {rc})"
            counts.append(n.value)
            del graph
        return " + ".join(str(c) for c in counts)
    except (OSError, TypeError, AttributeError, RuntimeError) as e:
        return f"not measured ({type(e).__name__}: {e})"


def drive_amg(torch, np, dl, ops, counters, zero_counters, restore_counters,
              host_ms, gpu_line):
    """Phase 7: automatic mask generation. MobileSAM (bf16 encoder, f32
    decoder) on 1024x768: per round `process` and the AMG_CONFIGS calls,
    three rounds (warm-up and capture, then replays); every replay
    bit-equal to its eager program, the winners equal to the numpy
    mirror's, the masks of rounds 2 and 3 equal to round 1's, exact launch
    counts per round (round 2 is the counted run). Then a threshold
    change (no new key, no new capture), times graphed and eager, ViT-B
    once on 1500x1000, and generate_masks_image with one crop layer.
    Returns greedy_nms's JSON numbers (sums over round 2's launches, each
    timed on the input that launch had)."""
    t0 = time.perf_counter()
    env = dl.Environment(dl.Options(allow_random_weights=True))
    bundle = env.sam_model()
    w, h, seed = IMAGES[0]
    img = dl.Image(dl.Extent(w, h), dl.Channels.rgba, rgba(np, h, w, seed))
    kwargs = [dict(grid=AMG_GRID, max_masks=AMG_SLOTS, **AMG_THRESH, **kw)
              for _, kw in AMG_CONFIGS]

    def amg_key(kw):
        refine = kw.get("min_mask_region_area", 0) > 0
        keys = [k for k in env.executables if k[0] == "amg" and k[6] == refine]
        if len(keys) != 1:
            fail(f"AMG: keys {keys} for refine={refine}")
        return keys[0]

    first, nms = {}, []
    per_process = {"fused_layer_norm": LN_PER_PROCESS,
                   "levit_window_attention": ATTN_PER_PROCESS,
                   "greedy_nms": len(AMG_CONFIGS)}
    launches = None
    for rnd in range(ROUNDS):
        zero_counters()
        seg = dl.Segmentation.process(img, env)
        for (label, kw), args in zip(AMG_CONFIGS, kwargs):
            before = counters()["greedy_nms"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t = time.perf_counter()
            masks = seg.generate_masks(**args)
            wall = (time.perf_counter() - t) * 1e3
            peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
            if counters()["greedy_nms"] != before + 1:
                fail(f"AMG {label}: greedy_nms launched "
                     f"{counters()['greedy_nms'] - before} times in one call")
            px = [m.image.pixels for m in masks]
            acc = [m.accuracy for m in masks]
            if not masks or (kw["nms_thresh"] >= 1.0 and len(masks) != AMG_SLOTS):
                fail(f"AMG {label}: {len(masks)} masks")
            if acc != sorted(acc, reverse=True) or any(
                    p.shape != (h, w, 1) or not set(np.unique(p).tolist()) <= {0, 255}
                    for p in px):
                fail(f"AMG {label}: masks not binary at the extent, or not "
                     f"sorted by accuracy")
            exe = env.executables[amg_key(kw)]
            if not exe.graphed or not exe.captured:
                fail(f"AMG {label}: {exe.key} is not a captured CUDA graph")
            hold_replays_against_eager(torch, env, f"AMG {label} round {rnd + 1}")
            boxes_p, sc_p, n = hold_amg_against_mirror(
                torch, np, env, seg, exe, amg_thresholds(seg, bundle, kw))
            if rnd == 0:
                first[label] = (px, acc)
            elif (acc != first[label][1]
                  or not all(np.array_equal(a, b) for a, b in zip(px, first[label][0]))):
                fail(f"AMG {label} round {rnd + 1}: masks differ from round 1's")
            if rnd == 1:
                nms.append((label, boxes_p, sc_p,
                            env.floats_on_device(amg_thresholds(seg, bundle, kw))[2:3]))
            if rnd < 2:
                print(f"AMG {label} round {rnd + 1} "
                      f"({'warm-up and capture' if rnd == 0 else 'replay'}): "
                      f"{len(masks)} masks (numpy mirror: {n} winners, equal), "
                      f"accuracies {acc[0]:.4f}..{acc[-1]:.4f}, {wall:.1f} ms, "
                      f"max_memory_allocated above resident {peak:.3f} GiB",
                      flush=True)
        counts = counters()
        expect = {k: per_process.get(k, 0) for k in counts}
        if counts != expect:
            fail(f"AMG round {rnd + 1}: launches {counts} != {expect}")
        if rnd == 1:
            launches = counts["greedy_nms"]
    print(f"AMG rounds: every replay bit-equal to its eager program; launches "
          f"per round {expect}", flush=True)

    # A threshold change: the same keys and graphs, the eager result.
    graphs = {k: [id(g.graph) for g in e._graphs] for k, e in env.executables.items()}
    new = dict(iou_thresh=0.02, stability_thresh=0.0, nms_thresh=0.95)
    seg.generate_masks(grid=AMG_GRID, max_masks=AMG_SLOTS, **new)
    if {k: [id(g.graph) for g in e._graphs]
            for k, e in env.executables.items()} != graphs:
        fail("AMG: a threshold change made a new key or a new capture")
    hold_replays_against_eager(torch, env, "AMG threshold change")
    _, _, n = hold_amg_against_mirror(torch, np, env, seg,
                                      env.executables[amg_key(new)],
                                      amg_thresholds(seg, bundle, new))
    print(f"AMG threshold change {new}: same keys and graphs, {n} winners "
          f"equal to the mirror's and to eager", flush=True)
    for label, kw in AMG_CONFIGS:
        exe = env.executables[amg_key(kw)]
        print(f"AMG {label}: graph nodes "
              f"{graph_nodes(torch, exe, restore_counters)}", flush=True)

    # The NMS kernel on round 2's inputs: the JSON row.
    row = dict(max_abs_err=0.0, launches=launches, ms=0.0, plain_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0, library_ms=None)
    for label, boxes_p, sc_p, thresh in nms:
        ms, plain_ms, bytes_ms, ops_ms, kept, tests = nms_numbers(
            torch, np, ops, boxes_p, sc_p, thresh)
        for k, v in zip(("ms", "plain_ms", "bytes_ms", "ops_ms"),
                        (ms, plain_ms, bytes_ms, ops_ms)):
            row[k] += v
        print(f"greedy_nms on AMG {label}'s pool (M={len(sc_p)}): {kept} kept, "
              f"{tests} IoU tests; kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"bound_ms={max(bytes_ms, ops_ms):.5f} (latency bound)",
              flush=True)

    # Wall time, graphed and eager (host clock, median of 5).
    for (label, kw), args in zip(AMG_CONFIGS, kwargs):
        exe = env.executables[amg_key(kw)]
        graphed = host_ms(lambda: seg.generate_masks(**args), n=5)
        exe.graphed = False
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        eager = host_ms(lambda: seg.generate_masks(**args), n=5)
        eager_peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        exe.graphed = True
        print(f"e2e AMG MobileSAM {w}x{h} grid {AMG_GRID} {label} on "
              f"{gpu_line}: amg_ms graphed={graphed:.3f} eager={eager:.3f} "
              f"(medians of 5); eager max_memory_allocated above resident "
              f"{eager_peak:.3f} GiB", flush=True)

    # generate_masks_image with one crop layer, once.
    t = time.perf_counter()
    crops = dl.generate_masks_image(img, env, grid=AMG_GRID, max_masks=AMG_SLOTS,
                                    crop_n_layers=1, **AMG_THRESH)
    torch.cuda.synchronize()
    crop_ms = (time.perf_counter() - t) * 1e3
    acc = [m.accuracy for m in crops]
    if (not crops or len(crops) > AMG_SLOTS or acc != sorted(acc, reverse=True)
            or any(m.image.extent != img.extent
                   or not set(np.unique(m.image.pixels).tolist()) <= {0, 255}
                   for m in crops)):
        fail("generate_masks_image: bad masks")
    print(f"generate_masks_image MobileSAM {w}x{h}, crop_n_layers=1 (5 crops): "
          f"{len(crops)} masks, {crop_ms:.1f} ms (first call of the crops' "
          f"buckets included; host clock)", flush=True)
    del env, seg
    torch.cuda.empty_cache()

    # ViT-B, windows partitioned, bf16: one call on 1500x1000 (bucket 2048).
    w, h, seed = IMAGES[1]
    env = dl.Environment(dl.Options(allow_random_weights=True,
                                    sam_variant="vit_b"))
    vb = env.sam_model("vit_b")
    seed_vit_extras(torch, vb.model)
    img = dl.Image(dl.Extent(w, h), dl.Channels.rgba, rgba(np, h, w, seed))
    args = dict(grid=AMG_GRID, max_masks=AMG_SLOTS, **AMG_THRESH, nms_thresh=1.0)
    zero_counters()
    seg = dl.Segmentation.process(img, env)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    masks = seg.generate_masks(**args)
    peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
    counts = counters()
    expect = {k: dict(VIT_PER_PROCESS, greedy_nms=1).get(k, 0) for k in counts}
    if counts != expect:
        fail(f"AMG ViT-B: launches {counts} != {expect}")
    if len(masks) != AMG_SLOTS or any(m.image.pixels.shape != (h, w, 1)
                                      for m in masks):
        fail(f"AMG ViT-B: {len(masks)} masks")
    hold_replays_against_eager(torch, env, "AMG ViT-B")
    exe = next(e for k, e in env.executables.items() if k[0] == "amg")
    graphed = host_ms(lambda: seg.generate_masks(**args), n=5)
    exe.graphed = False
    eager = host_ms(lambda: seg.generate_masks(**args), n=5)
    exe.graphed = True
    print(f"e2e AMG ViT-B {w}x{h} (bucket 2048) grid {AMG_GRID} nms 1.0 on "
          f"{gpu_line}: {len(masks)} masks; amg_ms graphed={graphed:.3f} "
          f"eager={eager:.3f} (medians of 5); first call (warm-up and "
          f"capture) max_memory_allocated above resident {peak:.3f} GiB; "
          f"launches {counts}", flush=True)
    del env, seg
    torch.cuda.empty_cache()
    print(f"phase 7: {time.perf_counter() - t0:.1f} s", flush=True)
    return row


def birefnet_models_equal(torch, a, b, label) -> None:
    for (k, v), (k2, v2) in zip(a.state_dict().items(), b.state_dict().items()):
        if k != k2 or not torch.equal(v.cpu(), v2.to(v.dtype).cpu()):
            fail(f"BiRefNet {label}: the models differ at {k}")


def check_birefnet_f32_against_cpu(torch, np, dl, seed_extras):
    """Phase 8: BiRefNet_lite at full width in float32 at resolution
    BIREFNET_F32_RESOLUTION, the card against the CPU, with PyTorch's
    default TF32 flags in force (cuDNN's allows TF32): the logits of one
    forward within relative L2 1e-4 (run in ``full_precision``, the scope
    every executable enters), the `segment_objects` masks within 1
    quantum. Also prints the card's logits of the same forward outside
    the scope (cuDNN in TF32, as the port ran before the repair)."""
    from dlimgedit_tpu_torch.models import birefnet as bn
    from dlimgedit_tpu_torch.models.common import full_precision

    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if flags != (True, False):
        fail(f"phase 8 float32: the TF32 flags are {flags}, not PyTorch's "
             f"defaults (cudnn True, matmul False)")
    os.environ["DLIMG_BIREFNET_RESOLUTION"] = str(BIREFNET_F32_RESOLUTION)
    try:
        envs = [dl.Environment(dl.Options(backend=b, allow_random_weights=True,
                                          compute_dtype="float32"))
                for b in (dl.Backend.cpu, dl.Backend.gpu)]
        bundles = [e.birefnet_model("general") for e in envs]
    finally:
        del os.environ["DLIMG_BIREFNET_RESOLUTION"]
    for b in bundles:
        seed_extras(b.model)
    birefnet_models_equal(torch, bundles[0].model, bundles[1].model, "float32")
    S = BIREFNET_F32_RESOLUTION
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, S, S, 3)).astype(np.float32))
    cfg = bundles[0].cfg
    with torch.inference_mode():
        want = bn.birefnet_apply(bundles[0].model, x, cfg)
        with full_precision():  # what the port's executables enter
            got = bn.birefnet_apply(bundles[1].model, x.cuda(), cfg).cpu()
        tf32 = bn.birefnet_apply(bundles[1].model, x.cuda(), cfg).cpu()
    rel, err = rel_l2(torch, got, want), (got - want).abs().max().item()
    rel_tf32 = rel_l2(torch, tf32, want)
    err_tf32 = (tf32 - want).abs().max().item()
    print(f"BiRefNet float32 at {S}, card vs CPU, default TF32 flags: logits "
          f"relative L2 {rel:.3e} (limit 1e-4), max|diff| {err:.3e}; outside "
          f"the port's scope (cuDNN in TF32, as before the repair): relative L2 "
          f"{rel_tf32:.3e}, max|diff| {err_tf32:.3e}; logits range "
          f"[{want.min().item():.3f}, {want.max().item():.3f}]", flush=True)
    if not rel <= 1e-4:
        fail(f"BiRefNet float32: the card's logits differ from the CPU's: "
             f"relative L2 {rel}")
    img = dl.Image(dl.Extent(320, 256), dl.Channels.rgba, rgba(np, 256, 320, 8))
    cpu, card = (dl.segment_objects(img, e).pixels.astype(np.int32)
                 for e in envs)
    diff = np.abs(cpu - card)
    print(f"BiRefNet float32 segment_objects 320x256, card vs CPU: mask "
          f"max quantum diff {diff.max()}, {int((diff > 0).sum())} of "
          f"{diff.size} pixels differ (limit 1 quantum)", flush=True)
    if diff.max() > 1:
        fail(f"BiRefNet float32: the card's mask differs from the CPU's by "
             f"{diff.max()} quanta")
    if (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) != flags:
        fail("BiRefNet float32: the port changed the caller's TF32 flags")
    print(f"phase 8 float32: {time.perf_counter() - t0:.1f} s", flush=True)


def check_birefnet_int8(torch, np, dl, env, seed_extras, first_mask, img):
    """Phase 8: `birefnet_int8_deform` at 1024. Every deform conv of one
    eager forward of the exact model is run both ways on its own inputs
    (the main path's shapes and data): the int8 corner stack within 2% of
    the output range (the JAX suite's bound). Then the int8 model's mask
    against the exact one's, printed."""
    from dlimgedit_tpu_torch.models import birefnet as bn
    from dlimgedit_tpu_torch.ops import deform

    t0 = time.perf_counter()
    exe = env.executables[("birefnet", "general", 1024)]
    devs = []

    def both(x, offset, mask, w, bias=None, padding=0, int8_gather=False,
             rows=None):
        exact = deform.deform_conv2d(x, offset, mask, w, bias, padding,
                                     rows=rows)
        q = deform.deform_conv2d(x, offset, mask, w, bias, padding,
                                 int8_gather=True, rows=rows)
        devs.append((tuple(x.shape), w.shape[-1], (
            (exact.float() - q.float()).abs().max()
            / exact.float().abs().max()).item()))
        return exact

    bn.deform_conv2d = both
    try:
        exe.eager(*exe.static_inputs)
    finally:
        bn.deform_conv2d = deform.deform_conv2d
    worst = max(devs, key=lambda d: d[2])
    print(f"BiRefNet int8 deform at 1024: {len(devs)} deform convs of one "
          f"forward, int8 against exact max|diff| / max|exact| up to "
          f"{worst[2]:.4f} (at input {worst[0]}, kernel {worst[1]}; limit "
          f"0.02); per conv "
          f"{[round(d[2], 4) for d in devs]}", flush=True)
    if not worst[2] < 0.02:
        fail(f"BiRefNet int8 deform deviates {worst[2]} of the output range")
    env8 = dl.Environment(dl.Options(allow_random_weights=True,
                                     birefnet_int8_deform=True))
    b8 = env8.birefnet_model("general")
    if not b8.cfg.deform_int8_gather:
        fail("birefnet_int8_deform did not reach the model config")
    seed_extras(b8.model)
    birefnet_models_equal(torch, env.birefnet_model("general").model,
                          b8.model, "int8")
    q = dl.segment_objects(img, env8).pixels.astype(np.int32)
    diff = np.abs(q - first_mask.astype(np.int32))
    print(f"BiRefNet int8 deform at 1024, segment_objects "
          f"{img.extent.width}x{img.extent.height} against the exact model: "
          f"mask max quantum diff {diff.max()}, mean {diff.mean():.3f}, "
          f"{(diff > 1).mean():.4f} of pixels differ by more than 1 "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    del env8
    torch.cuda.empty_cache()


def drive_birefnet(torch, np, dl, counters, zero_counters, restore_counters,
                   host_ms, gpu_line):
    """Phase 8: BiRefNet `segment_objects` at the full BiRefNet_lite width
    (swin_v1_tiny, mul_scl_ipt 'cat', cxt_num 3, decoder inter 64, ASPP 256
    wide with kernels 1/3/7, gdt 16) in bf16, seeded random weights with
    nonzero offset and modulator convs, biases, LayerNorms and rel-pos
    tables (models/birefnet.py::seed_nonzero_init); the
    BIREFNET_IMAGES in three rounds (warm-up and capture, then replays):
    every replay bit-equal to its key's eager program, rounds 2 and 3
    equal to round 1, masks uint8 at the extent and not constant, no
    launch of the port's kernels (BiRefNet reaches none). Then float32
    on the card against the CPU, the int8 deform option, and per image
    `birefnet_ms` graphed and eager (medians of 10) with the host's
    resize_mask back to the extent timed alone, the dense box-filter
    products once at the last image, the peak device memory of each key's
    first call and its graph's nodes."""
    from dlimgedit_tpu_torch.image import resize as host_resize
    from dlimgedit_tpu_torch.models.birefnet import seed_nonzero_init
    from dlimgedit_tpu_torch.ops.preprocess import pick_bucket

    t0 = time.perf_counter()
    for var in ("DLIMG_BIREFNET_TEST_SLIM", "DLIMG_BIREFNET_RESOLUTION"):
        os.environ.pop(var, None)
    torch.cuda.empty_cache()
    env = dl.Environment(dl.Options(allow_random_weights=True))
    for kind, res in (("general", 1024), ("high_res", 2048)):
        b = env.birefnet_model(kind)
        cfg, sw = b.cfg, b.cfg.swin
        got = (cfg.img_size, sw.embed_dim, sw.depths, sw.num_heads, sw.window,
               cfg.mul_scl_ipt, cfg.cxt_num, cfg.dec_inter_channels,
               cfg.aspp_channelster, cfg.aspp_kernel_sizes, cfg.gdt_channels,
               b.compute_dtype, next(b.model.parameters()).device.type)
        want = (res, 96, (2, 2, 6, 2), (3, 6, 12, 24), 7, "cat", 3, 64, 256,
                (1, 3, 7), 16, torch.bfloat16, "cuda")
        if got != want:
            fail(f"BiRefNet {kind}: configuration {got} != {want}")
        seed_nonzero_init(b.model)
    birefnet_models_equal(torch, env.birefnet_model("general").model,
                          env.birefnet_model("high_res").model, "kinds")
    n_params = sum(p.numel() for p in env.birefnet_model("general").model.parameters())
    print(f"BiRefNet_lite model load (random weights, seed 0, nonzero "
          f"offsets, modulators, biases; {n_params / 1e6:.2f} M parameters "
          f"each, bf16), both kinds: {time.perf_counter() - t0:.2f} s",
          flush=True)
    images = [(kind, dl.Image(dl.Extent(w, h), dl.Channels.rgba,
                              rgba(np, h, w, seed)))
              for kind, w, h, seed in BIREFNET_IMAGES]
    keys = [("birefnet", kind, pick_bucket(img.extent)) for kind, img in images]
    first, memory = [None] * len(images), {}
    for rnd in range(ROUNDS):
        zero_counters()
        for i, ((kind, img), key) in enumerate(zip(images, keys)):
            new = key not in env.executables
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            reserved = torch.cuda.memory_reserved()
            t = time.perf_counter()
            px = dl.segment_objects(img, env).pixels
            wall = (time.perf_counter() - t) * 1e3
            if new:
                memory[key] = (
                    (torch.cuda.max_memory_allocated() - resident) / 2**30,
                    (torch.cuda.memory_reserved() - reserved) / 2**30)
            if key not in env.executables:
                fail(f"BiRefNet {img.extent}: no executable {key} (kind "
                     f"escalation)")
            exe = env.executables[key]
            if not exe.graphed or not exe.captured:
                fail(f"BiRefNet: {key} is not a captured CUDA graph")
            got, want = exe.replay_against_eager()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"BiRefNet round {rnd + 1}: {key} replayed differs from "
                     f"its eager program")
            ext = img.extent
            if (px.shape != (ext.height, ext.width, 1) or px.dtype != np.uint8
                    or px.min() == px.max()):
                fail(f"BiRefNet {key}: mask {px.shape} {px.dtype} "
                     f"[{px.min()}, {px.max()}] at extent {ext}")
            if rnd == 0:
                first[i] = px
                print(f"BiRefNet {kind} {ext.width}x{ext.height} -> {key}: "
                      f"mask uint8 [{px.min()}, {px.max()}], mean "
                      f"{px.mean():.2f}; first call (warm-up and capture) "
                      f"{wall:.1f} ms, max_memory_allocated above resident "
                      f"{memory[key][0]:.3f} GiB, reserved grew "
                      f"{memory[key][1]:.3f} GiB (the graph's pool)",
                      flush=True)
            elif not np.array_equal(px, first[i]):
                fail(f"BiRefNet round {rnd + 1}: {key}'s mask differs from "
                     f"round 1's")
        counts = counters()
        if any(counts.values()):
            fail(f"BiRefNet round {rnd + 1} launched the port's kernels: "
                 f"{counts}")
    print(f"BiRefNet rounds: {len(env.executables)} keys "
          f"{sorted(env.executables)}, every replay bit-equal to its eager "
          f"program, rounds 2 and 3 equal to round 1; no launch of K1-K8 or "
          f"greedy_nms", flush=True)
    for key in sorted(env.executables):
        print(f"BiRefNet {key}: graph nodes "
              f"{graph_nodes(torch, env.executables[key], restore_counters)}",
              flush=True)
    for (kind, img), key in zip(images, keys):
        exe = env.executables[key]
        graphed = host_ms(lambda: dl.segment_objects(img, env), n=10)
        exe.graphed = False
        eager = host_ms(lambda: dl.segment_objects(img, env), n=10)
        exe.graphed = True
        S = env.birefnet_model(kind).resolution
        mask = np.random.default_rng(S).integers(0, 256, (S, S, 1),
                                                 dtype=np.uint8)
        resize_ms = host_ms(lambda: host_resize.resize_mask(
            dl.ImageView.from_array(mask, dl.Channels.mask), img.extent), n=5)
        print(f"e2e BiRefNet {kind} {img.extent.width}x{img.extent.height} "
              f"{key} on {gpu_line}: birefnet_ms graphed={graphed:.3f} "
              f"eager={eager:.3f} (medians of 10); of it the host's "
              f"resize_mask {S}x{S} -> extent alone {resize_ms:.3f} ms "
              f"(median of 5); first call max_memory_allocated above "
              f"resident {memory[key][0]:.3f} GiB", flush=True)
    t = time.perf_counter()
    host_resize._resample(mask / 255.0, img.extent, "box")
    print(f"BiRefNet host resize {S}x{S} -> {img.extent.width}x"
          f"{img.extent.height} as the dense box-filter products instead "
          f"(image/resize.py::_resample, once): "
          f"{(time.perf_counter() - t) * 1e3:.1f} ms", flush=True)
    check_birefnet_int8(torch, np, dl, env, seed_nonzero_init, first[0],
                        images[0][1])
    del env
    torch.cuda.empty_cache()
    check_birefnet_f32_against_cpu(torch, np, dl, seed_nonzero_init)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s", flush=True)


@contextlib.contextmanager
def quant_shapes(quant_mod):
    """Record (M, K, N) of each s8 x s8 linear that runs Python in the
    block (warm-ups and captures; a replay runs none)."""
    shapes, real = [], quant_mod.int8_mm

    def record(q, w):
        shapes.append((q.shape[0], q.shape[1], w.shape[1]))
        return real(q, w)

    quant_mod.int8_mm = record
    try:
        yield shapes
    finally:
        quant_mod.int8_mm = real


def follow_cpu_quanta(torch, np, real, recorded, dev):
    """A stand-in for P2's wrapper on the card that launches P2, counts the
    quanta that differ from the CPU's at the same linear (each must be a
    tie flip: |dq| = 1 where the CPU's x / scale lies within 1e-3 of a
    .5) and goes on with the CPU's quanta and scales, so a flip does not
    spread through the later layers. ``real`` is P2's wrapper. Returns
    (function, counts)."""
    counts = {"calls": 0, "flips": 0, "quanta": 0}

    def follow(x):  # a launch counts on the module's name: this stand-in
        q, s = real(x)
        cx, cq, cs = recorded[counts["calls"]]
        counts["calls"] += 1
        diff = q.cpu().numpy() != cq
        if diff.any():
            t = (cx / cs)[diff]
            dist = np.abs(np.abs(t - np.floor(t)) - 0.5).max()
            dq = np.abs(q.cpu().numpy()[diff].astype(int) - cq[diff]).max()
            if dist > 1e-3 or dq != 1:
                fail(f"an activation quantum differs from the CPU's away from "
                     f"a rounding tie (distance {dist}, |dq| {dq})")
        counts["flips"] += int(diff.sum())
        counts["quanta"] += diff.size
        return (torch.from_numpy(cq).to(dev),
                torch.from_numpy(cs).to(dev))

    follow.launches = 0
    return follow, counts


def check_quant_small_against_cpu(torch, np, dl, quant_mod):
    """Phase 9, the quantised encoders on the card against the same
    quantised models on the CPU (the plain path, which the CPU tests hold
    against the JAX package), float32: MobileSAM at 256 and ViT-B at 512,
    full width and depth, seeded nonzero rel-pos tables, pos_embed and qkv
    biases. w8: `process` on both, the embedding within phase 3's limits
    (atol 1e-4; relative L2 1e-5). w8a8: the encoder on one normalised
    input, the card's P2 counting its tie flips against the CPU's quanta
    and continuing from them (``follow_cpu_quanta``), the embedding within
    the same limits; the unaltered `process` embeddings' distance is
    printed."""
    from dlimgedit_tpu_torch.models import sam as sam_lib
    from dlimgedit_tpu_torch.models.common import full_precision

    dev = torch.device("cuda", 0)
    for variant, size in QUANT_CPU_SIZES:
        for mode in ("w8", "w8a8"):
            t0 = time.perf_counter()
            opts = dict(allow_random_weights=True, compute_dtype="float32",
                        sam_image_size=size, sam_variant=variant,
                        quantize_encoder=True,
                        quantize_activations=mode == "w8a8")
            envs = [dl.Environment(dl.Options(backend=b, **opts))
                    for b in (dl.Backend.cpu, dl.Backend.gpu)]
            if variant != "mobile_sam":
                for e in envs:
                    seed_vit_extras(torch, e.sam_model(variant).model)
            w, h = size * 3 // 2, size
            img = dl.Image(dl.Extent(w, h), dl.Channels.rgba, rgba(np, h, w, 43))
            e_cpu, e_gpu = (dl.Segmentation.process(img, e).embedding.float().cpu()
                            for e in envs)
            err = (e_cpu - e_gpu).abs().max().item()
            rel = rel_l2(torch, e_gpu, e_cpu)
            label = f"{variant} {mode} at {size}, f32 embedding, card vs CPU"
            print(f"{label} (process): max|diff|={err:.3e} relative L2 "
                  f"{rel:.3e}", flush=True)
            if mode == "w8a8":
                x = np.random.default_rng(44).standard_normal(
                    (1, size, size, 3)).astype(np.float32)
                b_cpu, b_gpu = (e.sam_model(variant) for e in envs)
                recorded, real = [], quant_mod.quantize_rows_int8

                def record(v):
                    q, sc = real(v)
                    recorded.append((v.reshape(-1, v.shape[-1]).numpy().copy(),
                                     q.numpy().copy(), sc.numpy().copy()))
                    return q, sc

                quant_mod.quantize_rows_int8 = record
                try:
                    with torch.inference_mode():
                        e_cpu = sam_lib.encode_image(b_cpu.model, b_cpu.cfg,
                                                     torch.from_numpy(x))
                    follow, counts = follow_cpu_quanta(
                        torch, np, real, recorded, dev)
                    quant_mod.quantize_rows_int8 = follow
                    with torch.inference_mode(), full_precision():
                        e_gpu = sam_lib.encode_image(
                            b_gpu.model, b_gpu.cfg,
                            torch.from_numpy(x).to(dev)).cpu()
                finally:
                    quant_mod.quantize_rows_int8 = real
                if counts["calls"] != len(recorded) or not recorded:
                    fail(f"{label}: {counts['calls']} quantised linears on the "
                         f"card, {len(recorded)} on the CPU")
                if counts["flips"] > 1e-3 * counts["quanta"]:
                    fail(f"{label}: {counts['flips']} tie flips of "
                         f"{counts['quanta']} quanta")
                err = (e_cpu - e_gpu).abs().max().item()
                rel = rel_l2(torch, e_gpu, e_cpu)
                print(f"{label} (encoder continuing from the CPU's quanta): "
                      f"max|diff|={err:.3e} relative L2 {rel:.3e}; "
                      f"{counts['flips']} tie flips of {counts['quanta']} "
                      f"quanta in {counts['calls']} linears", flush=True)
            if variant == "mobile_sam" and not err <= 1e-4:
                fail(f"{label}: max|diff| {err} > 1e-4")
            if variant != "mobile_sam" and not rel <= 1e-5:
                fail(f"{label}: relative L2 {rel} > 1e-5")
            print(f"phase 9 {variant} {mode} card vs CPU: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


def pack_times(torch, np, gpu_line) -> None:
    """Phase 9, the canvas pack before a `process`: the native loop
    (utils/hostops.py) against numpy's strided copies, RGBA into the
    pinned canvas, host clock, medians of 20."""
    from dlimgedit_tpu_torch.ops import preprocess
    from dlimgedit_tpu_torch.types import RGB_CHANNEL_MAP, Channels

    for w, h, bucket in PACK_IMAGES:
        px = rgba(np, h, w, 3)
        canvas = torch.empty((bucket, bucket, 3), dtype=torch.uint8,
                             pin_memory=True).numpy()
        ms = {}
        for name, pack in (("native", preprocess._pack_rows),
                           ("numpy", preprocess.pack_rows_plain)):
            times = []
            for _ in range(21):
                t = time.perf_counter()
                pack(px, RGB_CHANNEL_MAP[Channels.rgba], canvas, 0, h, w)
                times.append((time.perf_counter() - t) * 1e3)
            ms[name] = statistics.median(times[1:])
            if name == "native":
                got = canvas[:h, :w].copy()
            elif not np.array_equal(got, canvas[:h, :w]):
                fail(f"the native pack differs from numpy's at {w}x{h}")
        print(f"canvas pack {w}x{h} RGBA into the pinned {bucket}-bucket canvas "
              f"on the host of {gpu_line}: native {ms['native']:.3f} ms, numpy "
              f"{ms['numpy']:.3f} ms (medians of 20)", flush=True)


def check_w8a8_at_64(torch, np, dl, counters, zero_counters):
    """Phase 9: a w8a8 MobileSAM `process` and `compute_mask` at
    sam_image_size 64, where TinyViT's last stages see 16 tokens a linear
    (fewer than cuBLASLt's int8 product takes: ``int8_mm`` pads them to 17
    rows and slices back). The embedding finite and within relative L2
    0.5 of the bf16 float path's on the same image (as at 1024), P2 and P3
    one launch per quantised linear (40), the mask at the extent."""
    w, h = 96, 64
    img = dl.Image(dl.Extent(w, h), dl.Channels.rgba, rgba(np, h, w, 64))
    embs = {}
    for mode in ("bf16", "w8a8"):
        env = dl.Environment(dl.Options(
            allow_random_weights=True, sam_image_size=64,
            quantize_activations=mode == "w8a8"))
        zero_counters()
        seg = dl.Segmentation.process(img, env)
        mask = seg.compute_mask(dl.Point(w // 2, h // 2)).pixels
        torch.cuda.synchronize()
        counts = counters()
        embs[mode] = seg.embedding
        if (tuple(seg.embedding.shape) != (1, 4, 4, 256)
                or not bool(torch.isfinite(seg.embedding).all())
                or mask.shape != (h, w, 1)):
            fail(f"w8a8 at 64 ({mode}): bad embedding or mask")
        want = 40 if mode == "w8a8" else 0
        if any(counts[k] != want for k in QUANT_KERNELS):
            fail(f"w8a8 at 64 ({mode}): P2 / P3 launches {counts}, want {want}")
    rel = rel_l2(torch, embs["w8a8"], embs["bf16"])
    print(f"phase 9 w8a8 MobileSAM at sam_image_size 64 (16-token linears "
          f"padded to 17 rows): process and mask served, P2 / P3 "
          f"{counts['quantize_rows_int8']} / {counts['int8_epilogue']} "
          f"launches, embedding relative L2 to bf16 {rel:.3e} (limit 0.5)",
          flush=True)
    if not rel < 0.5:
        fail(f"w8a8 at 64: embedding relative L2 to bf16 {rel} >= 0.5")


def drive_quantized(torch, np, dl, quant_mod, counters, zero_counters,
                    host_ms, gpu_line):
    """Phase 9: quantised serving. The card against the CPU at small sizes
    (``check_quant_small_against_cpu``); then each of QUANT_PATHS at 1024
    in bf16, w8 and w8a8 (seeded random weights, the ViTs' rel-pos
    tables, pos_embed and qkv biases seeded nonzero): `process` and
    `compute_mask(Point)` on 1024x768 in three rounds (warm-up and
    capture, then replays), every replay bit-equal to its eager program,
    rounds 2 and 3 equal to round 1, exact launches per round (the float
    path's K1-K6, and under w8a8 P2 and P3 once per quantised linear, 4 a
    block), the shapes of the s8 x s8 linears those of phase 2, the int8
    embeddings' relative L2 to the bf16 one (below 0.5: int8 weights carry
    ~0.4% error each; a wrong scale gives ~1 or more); then
    `process_ms` and `mask_ms` graphed per mode, in turns, and the
    encoder's parameter bytes. Last the canvas pack's time. Returns the
    P2 and P3 launches of the counted rounds (round 2, w8a8)."""
    import collections

    from dlimgedit_tpu_torch.ops.quant import quantized_bytes

    t0 = time.perf_counter()
    check_quant_small_against_cpu(torch, np, dl, quant_mod)
    check_w8a8_at_64(torch, np, dl, counters, zero_counters)
    w, h, seed = IMAGES[0]
    img = dl.Image(dl.Extent(w, h), dl.Channels.rgba, rgba(np, h, w, seed))
    point = dl.Point(w // 2, h // 2)
    launches = {name: 0 for name in QUANT_KERNELS}
    for variant, fused in QUANT_PATHS:
        label = f"{variant}{' fused-window' if fused else ''}"
        vit = variant != "mobile_sam"
        if not vit:
            float_want = {"fused_layer_norm": LN_PER_PROCESS,
                          "levit_window_attention": ATTN_PER_PROCESS}
        elif fused:
            float_want = VIT_FUSED_PER_PROCESS
        else:
            float_want = vit_per_process(VIT_WIDTHS[variant][1])
        blocks = 10 if not vit else VIT_WIDTHS[variant][1]
        envs, embs, nbytes = {}, {}, {}
        for mode in QUANT_MODES:
            t1 = time.perf_counter()
            env = dl.Environment(dl.Options(
                allow_random_weights=True, sam_variant=variant,
                quantize_encoder=mode != "bf16",
                quantize_activations=mode == "w8a8"))
            bundle = env.sam_model(variant)
            want_quant = {"bf16": "none"}.get(mode, mode)
            scales = {str(p.dtype) for n, p in bundle.model.encoder.named_parameters()
                      if n.endswith("w_scale")}
            if bundle.quant != want_quant or (mode != "bf16"
                                              and scales != {"torch.float32"}):
                fail(f"{label} {mode}: bundle quant {bundle.quant}, w_scale "
                     f"dtypes {scales}")
            if vit:
                seed_vit_extras(torch, bundle.model)
            if fused:
                use_fused_windows(bundle)
            nbytes[mode] = quantized_bytes(bundle.model.encoder)
            want = dict(float_want)
            if mode == "w8a8":
                want.update({k: 4 * blocks for k in QUANT_KERNELS})
            first = None
            for rnd in range(ROUNDS):
                zero_counters()
                with quant_shapes(quant_mod) as shapes:
                    seg = dl.Segmentation.process(img, env)
                    mask = seg.compute_mask(point).pixels
                torch.cuda.synchronize()
                emb = seg.embedding
                if rnd == 0:
                    if (tuple(emb.shape) != (1, 64, 64, 256)
                            or not bool(torch.isfinite(emb).all())):
                        fail(f"{label} {mode}: bad embedding {tuple(emb.shape)}")
                    if mask.shape != (h, w, 1) or not set(
                            np.unique(mask).tolist()) <= {0, 255}:
                        fail(f"{label} {mode}: bad mask {mask.shape}")
                    first = (emb, mask)
                    # Each s8 x s8 linear ran Python twice: warm-up, capture.
                    want_shapes = collections.Counter(
                        {(M, K, N): 2 * n for M, K, N, n in quant_linears(variant)}
                        if mode == "w8a8" else {})
                    if collections.Counter(shapes) != want_shapes:
                        fail(f"{label} {mode}: s8 x s8 linears "
                             f"{sorted(collections.Counter(shapes).items())}, "
                             f"phase 2 checked {sorted(want_shapes.items())}")
                elif not (torch.equal(emb, first[0])
                          and np.array_equal(mask, first[1])):
                    fail(f"{label} {mode} round {rnd + 1}: a replay differs "
                         f"from round 1")
                hold_replays_against_eager(torch, env, f"{label} {mode} round "
                                                       f"{rnd + 1}")
                counts = counters()
                expect = {k: want.get(k, 0) for k in counts}
                if counts != expect:
                    fail(f"{label} {mode} round {rnd + 1}: launches {counts} "
                         f"!= {expect}")
                if rnd == 1:
                    for k in QUANT_KERNELS:
                        launches[k] += counts[k]
            envs[mode], embs[mode] = env, first[0]
            rel = {m: rel_l2(torch, embs[mode], embs[m]) for m in embs if m != mode}
            print(f"{label} {mode}: 3 rounds, replays bit-equal to eager, "
                  f"launches per round {counts}; embedding relative L2 to "
                  f"{rel}; encoder parameters {nbytes[mode]} bytes "
                  f"[{time.perf_counter() - t1:.1f} s]", flush=True)
            if mode != "bf16" and not rel_l2(torch, embs[mode], embs["bf16"]) < 0.5:
                fail(f"{label} {mode}: embedding relative L2 to bf16 "
                     f"{rel_l2(torch, embs[mode], embs['bf16'])} >= 0.5")
        ms = {}
        for mode, env in envs.items():
            seg = dl.Segmentation.process(img, env)
            ms[mode] = (host_ms(lambda: dl.Segmentation.process(img, env)),
                        host_ms(lambda: seg.compute_mask(point)))
        print(f"e2e quantised {label} {w}x{h} on {gpu_line}: process_ms "
              f"graphed " + ", ".join(f"{m}={ms[m][0]:.3f}" for m in ms)
              + "; mask_ms graphed " + ", ".join(f"{m}={ms[m][1]:.3f}" for m in ms)
              + " (medians of 20); encoder parameter bytes "
              + ", ".join(f"{m}={nbytes[m]}" for m in nbytes), flush=True)
        del envs, embs, env, seg
        torch.cuda.empty_cache()
    pack_times(torch, np, gpu_line)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def frames_executable(pbatch, model, program, shape):
    """The Executable of ``encode_frames`` / ``segment_frames`` for a model
    and a frames shape (parallel/batch.py's cache)."""
    hits = [exe for key, exe in pbatch._GRAPH_CACHE.items()
            if key[0] == program and key[1] is model and key[3] == shape]
    if len(hits) != 1:
        fail(f"{program}: {len(hits)} executables for shape {shape}")
    return hits[0]


def drive_frames(torch, np, dl, counters, zero_counters, restore_counters,
                 host_ms, gpu_line):
    """Phase 10: batched frames on the card. ``encode_frames`` at 1024 in
    bf16 with the serving flags (the Environment's bundle: kernels on) on
    MobileSAM and ViT-B (seeded nonzero rel-pos tables, pos_embed and qkv
    biases), B = 1 and B = FRAMES_B, each key in three rounds (warm-up and
    capture, then replays; round 2, the B = FRAMES_B replay, is the
    counted run): every round's launches those of one `process`, rounds 2
    and 3 equal to round 1, the replay bit-equal to the eager program,
    each frame of the batch within relative L2 2e-2 (phase 2's bf16
    tolerance) of the B = 1 call on it alone; frames/s and ms per call
    (host clock, medians of 20). Then ``segment_frames``: BiRefNet_lite
    (general, 1024, bf16, nonzero offsets) on TEACHER_B frames made by
    `segment_objects`' own input stage from two 1024x768 images: each
    frame's logits within relative L2 2e-2 of the B = 1 call, and its
    mask, resized to the extent as `segment_objects` resizes, within 1
    quantum of `segment_objects`' on all but 0.1% of the pixels; no
    kernel launched. Last `scaleout_devices=0`: one `process` and one
    mask equal to `scaleout_devices=1`'s bit for bit. Returns the
    launches of the counted runs."""
    from dlimgedit_tpu_torch.image.resize import resize_mask
    from dlimgedit_tpu_torch.models.birefnet import seed_nonzero_init
    from dlimgedit_tpu_torch.models.common import full_precision
    from dlimgedit_tpu_torch.ops.postprocess import sigmoid_to_u8
    from dlimgedit_tpu_torch.ops.preprocess import pack_and_put_canvas
    from dlimgedit_tpu_torch.parallel import batch as pbatch
    from dlimgedit_tpu_torch.runtime.birefnet import birefnet_input

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    launches = {}
    for variant, want in (("mobile_sam", {"fused_layer_norm": LN_PER_PROCESS,
                                          "levit_window_attention":
                                              ATTN_PER_PROCESS}),
                          ("vit_b", VIT_PER_PROCESS)):
        t1 = time.perf_counter()
        env = dl.Environment(dl.Options(allow_random_weights=True,
                                        sam_variant=variant))
        bundle = env.sam_model(variant)
        if variant != "mobile_sam":
            seed_vit_extras(torch, bundle.model)
        model, cfg = bundle.model, bundle.cfg
        gen = torch.Generator(device=dev).manual_seed(10)
        frames = torch.randn((FRAMES_B, 1024, 1024, 3), generator=gen,
                             device=dev).to(torch.bfloat16)
        outs, ms = {}, {}
        for B in (1, FRAMES_B):
            x = frames[:B]
            first = None
            for rnd in range(ROUNDS):
                zero_counters()
                out = pbatch.encode_frames(model, cfg, x)
                torch.cuda.synchronize()
                counts = counters()
                expect = {k: want.get(k, 0) for k in counts}
                if counts != expect:
                    fail(f"frames {variant} B={B} round {rnd + 1}: launches "
                         f"{counts} != {expect}")
                if rnd == 0:
                    if (tuple(out.shape) != (B, 64, 64, 256)
                            or not bool(torch.isfinite(out).all())):
                        fail(f"frames {variant} B={B}: bad embeddings "
                             f"{tuple(out.shape)}")
                    first = out
                elif not torch.equal(out, first):
                    fail(f"frames {variant} B={B} round {rnd + 1}: a replay "
                         f"differs from round 1")
                if rnd == 1 and B == FRAMES_B:
                    for k, v in counts.items():
                        launches[k] = launches.get(k, 0) + v
            exe = frames_executable(pbatch, model, "encode", tuple(x.shape))
            with restore_counters():
                got, ref = exe.replay_against_eager()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                fail(f"frames {variant} B={B}: the replay differs from the "
                     f"eager program")
            outs[B] = first
            ms[B] = host_ms(lambda: pbatch.encode_frames(model, cfg, x))
        ones = [outs[1]] + [pbatch.encode_frames(model, cfg, frames[i:i + 1])
                            for i in range(1, FRAMES_B)]
        rels = [rel_l2(torch, outs[FRAMES_B][i], ones[i][0])
                for i in range(FRAMES_B)]
        print(f"frames {variant} bf16 at 1024: launches per call {counts}; "
              f"replays bit-equal to eager; each frame of B={FRAMES_B} against "
              f"B=1, relative L2 {[f'{r:.3e}' for r in rels]} (limit 2e-2)",
              flush=True)
        if not max(rels) <= 2e-2:
            fail(f"frames {variant}: a frame of the batch is {max(rels)} "
                 f"from its B=1 call")
        print(f"e2e frames {variant} on {gpu_line}: encode_frames ms per "
              f"call B=1 {ms[1]:.3f} ({1e3 / ms[1]:.1f} frames/s), "
              f"B={FRAMES_B} {ms[FRAMES_B]:.3f} "
              f"({FRAMES_B * 1e3 / ms[FRAMES_B]:.1f} frames/s) (medians of 20) "
              f"[{time.perf_counter() - t1:.1f} s]", flush=True)
        del env, bundle, model, frames, outs, ones
        torch.cuda.empty_cache()

    # segment_frames: BiRefNet_lite on frames made by segment_objects' input
    # stage, against segment_objects.
    t1 = time.perf_counter()
    for var in ("DLIMG_BIREFNET_TEST_SLIM", "DLIMG_BIREFNET_RESOLUTION"):
        os.environ.pop(var, None)
    env = dl.Environment(dl.Options(allow_random_weights=True))
    bundle = env.birefnet_model("general")
    seed_nonzero_init(bundle.model)
    images = [dl.Image(dl.Extent(w, h), dl.Channels.rgba, rgba(np, h, w, seed))
              for w, h, seed in ((1024, 768, 21), (1024, 768, 22))]
    xs = []
    with torch.inference_mode(), full_precision():
        for img in images:
            canvas = pack_and_put_canvas(img.view(), 1024, dev)
            sizes = env.sizes_on_device((img.extent.height, img.extent.width))
            xs.append(birefnet_input(bundle, 1024, canvas, sizes))
    frames = torch.cat(xs)
    before = counters()
    logits = pbatch.segment_frames(bundle.model, bundle.cfg, frames)
    again = pbatch.segment_frames(bundle.model, bundle.cfg, frames)
    if not torch.equal(logits, again):
        fail("segment_frames: the replay differs from round 1")
    if tuple(logits.shape) != (TEACHER_B, 1024, 1024, 1) or not bool(
            torch.isfinite(logits).all()):
        fail(f"segment_frames: bad logits {tuple(logits.shape)}")
    for i, img in enumerate(images):
        one = pbatch.segment_frames(bundle.model, bundle.cfg, frames[i:i + 1])
        rel = rel_l2(torch, logits[i], one[0])
        u8 = sigmoid_to_u8(logits[i, :, :, 0]).cpu().numpy()
        mine = resize_mask(dl.ImageView.from_array(u8, dl.Channels.mask),
                           img.extent)
        theirs = dl.segment_objects(img, env).pixels
        d = np.abs(mine.astype(np.int32).reshape(theirs.shape)
                   - theirs.astype(np.int32))
        share = float((d > 1).mean())
        print(f"segment_frames frame {i}: logits relative L2 to B=1 "
              f"{rel:.3e} (limit 2e-2); mask vs segment_objects max diff "
              f"{int(d.max())}, share of pixels above 1 quantum {share:.2e} "
              f"(limit 1e-3)", flush=True)
        if not rel <= 2e-2 or not share <= 1e-3:
            fail(f"segment_frames frame {i} differs from segment_objects")
    if counters() != before:
        fail("segment_frames launched a kernel of the port")
    bms = host_ms(lambda: pbatch.segment_frames(bundle.model, bundle.cfg,
                                                frames), n=10)
    print(f"e2e segment_frames BiRefNet_lite B={TEACHER_B} at 1024 on "
          f"{gpu_line}: {bms:.3f} ms per call ({TEACHER_B * 1e3 / bms:.2f} "
          f"frames/s; median of 10) [{time.perf_counter() - t1:.1f} s]",
          flush=True)
    del env, bundle, frames, logits, again
    torch.cuda.empty_cache()

    # scaleout_devices=0 on the one card: the single-device path.
    w, h, seed = IMAGES[0]
    img = dl.Image(dl.Extent(w, h), dl.Channels.rgba, rgba(np, h, w, seed))
    segs = [dl.Segmentation.process(img, dl.Environment(dl.Options(
        allow_random_weights=True, scaleout_devices=n))) for n in (1, 0)]
    p = dl.Point(w // 2, h // 2)
    if not (torch.equal(segs[0].embedding, segs[1].embedding)
            and np.array_equal(segs[0].compute_mask(p).pixels,
                               segs[1].compute_mask(p).pixels)):
        fail("scaleout_devices=0 serves unlike scaleout_devices=1")
    print(f"scaleout_devices=0 on {torch.cuda.device_count()} device: process "
          f"and mask equal to scaleout_devices=1, bit for bit", flush=True)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def grads_close(torch, got, want, rel, floor=1e-4, zero=1e-6):
    """(largest relative L2, its leaf) between two gradient dicts, leaf by
    leaf; fails above ``rel``. An attention key bias (a leaf named
    ``k.b``) has an exact gradient of zero (the softmax cancels a shift of
    every key by one vector): both devices' gradients of it are rounding
    and must each stay below ``zero`` times the largest leaf's norm.
    Another leaf whose reference gradient is below ``floor`` times the
    largest leaf's norm is measured against that."""
    scale = max(float(g.norm()) for g in want.values())
    worst = (0.0, None)
    for k, w in want.items():
        if k.endswith(".k.b"):
            if not max(float(w.norm()), float(got[k].norm())) <= zero * scale:
                fail(f"gradient of {k}: not zero up to rounding on both "
                     f"devices ({float(w.norm())}, {float(got[k].norm())})")
            continue
        err = float((got[k].cpu() - w).norm())
        worst = max(worst, (err / max(float(w.norm()), floor * scale), k))
    if not worst[0] <= rel:
        fail(f"gradient of {worst[1]}: card vs CPU relative L2 {worst[0]} > "
             f"{rel}")
    return worst


def train_run(torch, counters, zero_counters, step, model, state, batches,
              label, gpu_line, warm=2, timed=5):
    """``warm`` + ``timed`` steps on device batches (``prefetch_to_device``
    of a fixed batch): ms per step (host clock around a step that ends in
    a synchronise; median of the timed steps), peak device memory, the
    timed steps' losses (the last must be below the first step's, the
    loss before any update: the SAM loss's IoU term jumps from step to
    step as the predicted masks' threshold moves), and no kernel launch
    of the port."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    zero_counters()
    losses, times = [], []
    for i, batch in enumerate(batches(warm + timed)):
        t = time.perf_counter()
        model, state, loss, _ = step(model, state, batch)
        torch.cuda.synchronize()
        if i >= warm:
            times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated() / 2**30
    net = peak - resident / 2**30
    launched = {k: v for k, v in counters().items() if v}
    if launched:
        fail(f"train {label}: a step launched the port's kernels {launched}")
    if not all(abs(x) < float("inf") for x in losses) or not losses[-1] < losses[0]:
        fail(f"train {label}: the loss did not fall: {losses}")
    print(f"train {label} on {gpu_line}: train_step_ms "
          f"{statistics.median(times):.3f} (median of {timed} after {warm} "
          f"warm-ups), train_peak_gib {peak:.3f} (max_memory_allocated; "
          f"{net:.3f} above the {resident / 2**30:.3f} GiB resident before "
          f"the first step, the model and its optimizer state included), "
          f"first loss "
          f"{losses[0]:.5f}, timed steps' losses "
          f"{[round(x, 5) for x in losses[warm:]]}, 0 kernel launches",
          flush=True)
    return model, state


def drive_training(torch, np, dl, counters, zero_counters, gpu_line):
    """Phase 11: the single-device train tier at full width on the card,
    float32 masters, the plain paths (no kernel has a backward).

      * SAM fine-tune: MobileSAM at 1024, B = 4, float32 and bf16 encoder,
        accum_steps 1 and 2, remat_encoder off and on (8 configs), each
        from the same seeded weights on the same batch, fed through
        ``prefetch_to_device`` (pinned copies on a copy stream);
      * distillation: the MobileSAM TinyViT student at 1024 (B =
        TEACHER_B) against ViT-H teacher embeddings from
        ``teacher_embeddings`` (the Environment's bf16 ViT-H with its
        kernels; launches counted: one `process`'s worth);
      * BiRefNet_lite fine-tune at 1024, float32, at the largest batch of
        BIREFNET_TRAIN_BATCHES whose step fits (an out-of-memory step
        tries the next);
    each with ``train_run``'s numbers. Then float32 card against CPU
    (MobileSAM at 256, B = 2; the slim BiRefNet at 256, B = 1, at its init
    and with nonzero offsets): loss within relative 1e-5 and every leaf's
    gradient within relative L2 1e-5 (1e-3 with nonzero offsets, or
    where a ReLU input at a tie changed sign between the devices;
    ``grads_close``), both under full precision; a checkpoint round
    trip on the card resumes to the same next-step loss; and
    ``export_serving_bundle`` writes a bundle that an Environment loads
    with its sha256 pin and serves (`process`, `compute_mask`). Returns
    the teacher's launches."""
    import copy
    import gc
    import hashlib
    import tempfile

    from dlimgedit_tpu_torch.models import birefnet as bn
    from dlimgedit_tpu_torch.models import sam
    from dlimgedit_tpu_torch.parallel import batch as pbatch
    from dlimgedit_tpu_torch.runtime.birefnet import slim_config
    from dlimgedit_tpu_torch.train import birefnet_step, checkpoint, distill
    from dlimgedit_tpu_torch.train import step as tstep
    from dlimgedit_tpu_torch.train.data import prefetch_to_device, sam_batch_iterator

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    gc.collect()  # what earlier phases left in reference cycles
    torch.cuda.empty_cache()

    def fixed(batch):
        return lambda n: prefetch_to_device(iter([batch] * n), depth=2)

    cfg = sam.make_config("mobile_sam", 1024)
    base = sam.init_sam(torch.Generator().manual_seed(0), cfg).to(dev)
    batch = next(sam_batch_iterator(np.random.default_rng(0), batch_size=4,
                                    image_size=1024,
                                    mask_size=cfg.mask_input_size))
    last = None
    for dtype in ("float32", "bfloat16"):
        for accum in (1, 2):
            for remat in (False, True):
                tcfg = tstep.TrainConfig(encoder_dtype=dtype,
                                         remat_encoder=remat)
                model = copy.deepcopy(base)
                state = tstep.init_train_state(model, tcfg)
                step = tstep.make_train_step(cfg, tcfg, accum_steps=accum)
                model, state = train_run(
                    torch, counters, zero_counters, step, model, state,
                    fixed(batch), f"MobileSAM 1024 B=4 {dtype} encoder, "
                    f"accum_steps {accum}, remat {'on' if remat else 'off'}",
                    gpu_line)
                if dtype == "float32" and accum == 1 and not remat:
                    last = (model, state, step)
                del model, state
    torch.cuda.empty_cache()

    # Checkpoint round trip on the card, then the serving export.
    model, state, step = last
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_train_state(d, 7, model, state)
        probe = next(fixed(batch)(1))
        fresh, opt, n = checkpoint.restore_train_state(
            d, like=sam.init_sam(torch.Generator().manual_seed(9), cfg).to(dev))
        _, _, want, _ = step(model, state, probe)
        _, _, got, _ = step(fresh, opt, probe)
        if n != 7 or float(got) != float(want):
            fail(f"checkpoint: resumed step {n} loss {float(got)} != "
                 f"{float(want)}")
        bundle = Path(d) / "models" / "segmentation" / "mobile_sam.npz"
        checkpoint.export_serving_bundle(fresh, bundle)
        digest = hashlib.sha256(bundle.read_bytes()).hexdigest()
        bundle.with_suffix(".npz.sha256").write_text(digest + "\n")
        env = dl.Environment(dl.Options(model_directory=str(Path(d) / "models")))
        served = env.sam_model("mobile_sam").model
        for k, v in tstep.leaves(fresh).items():
            if not torch.equal(served.state_dict()[k].float(),
                               v.to(served.state_dict()[k].dtype).float()):
                fail(f"export: the served leaf {k} is not the trained one")
        w, h, seed = IMAGES[0]
        img = dl.Image(dl.Extent(w, h), dl.Channels.rgba, rgba(np, h, w, seed))
        seg = dl.Segmentation.process(img, env)
        mask = seg.compute_mask(dl.Point(w // 2, h // 2)).pixels
        if mask.shape != (h, w, 1) or not bool(torch.isfinite(seg.embedding).all()):
            fail("export: the exported bundle does not serve")
        print(f"checkpoint: save / restore on the card resumes to the same "
              f"next-step loss ({float(got):.6f}); exported bundle (sha256 "
              f"{digest[:12]}...) loaded and served", flush=True)
        del env, served, seg
    del model, state, fresh, opt, last, base
    torch.cuda.empty_cache()

    # Distillation: TinyViT student against ViT-H teacher embeddings.
    env = dl.Environment(dl.Options(allow_random_weights=True,
                                    sam_variant="vit_h"))
    teacher = env.sam_model("vit_h")
    seed_vit_extras(torch, teacher.model)
    images = torch.randn((TEACHER_B, 1024, 1024, 3), generator=torch.Generator(
        device=dev).manual_seed(11), device=dev)
    zero_counters()
    emb = distill.teacher_embeddings(teacher.model, teacher.cfg, images)
    torch.cuda.synchronize()
    teacher_launches = counters()
    want = {k: vit_per_process(32).get(k, 0) for k in teacher_launches}
    if teacher_launches != want:
        fail(f"distill teacher: launches {teacher_launches} != {want}")
    if tuple(emb.shape) != (TEACHER_B, 64, 64, 256) or emb.dtype != torch.float32:
        fail(f"distill teacher: embeddings {tuple(emb.shape)} {emb.dtype}")
    print(f"distill teacher ViT-H bf16 B={TEACHER_B}: launches "
          f"{teacher_launches}", flush=True)
    del env, teacher
    pbatch._GRAPH_CACHE.clear()  # the teacher's graph holds the teacher
    torch.cuda.empty_cache()
    student = sam.init_sam(torch.Generator().manual_seed(1), cfg).to(dev)
    dcfg = distill.DistillConfig()
    train_run(torch, counters, zero_counters,
              distill.make_distill_step(cfg, dcfg), student.encoder,
              distill.init_distill_state(student.encoder, dcfg),
              fixed({"images": images, "teacher_emb": emb}),
              f"distill TinyViT student 1024 B={TEACHER_B} float32", gpu_line)
    del student, images, emb
    torch.cuda.empty_cache()

    # BiRefNet_lite at the largest batch that fits.
    bcfg = bn.BiRefNetConfig(img_size=1024)
    bt = birefnet_step.BiRefNetTrainConfig(learning_rate=1e-4)
    rng = np.random.default_rng(2)
    for B in BIREFNET_TRAIN_BATCHES:
        model = bn.init_birefnet(torch.Generator().manual_seed(0), bcfg)
        bn.seed_nonzero_init(model)
        model = model.to(dev)
        images = rng.standard_normal((B, 1024, 1024, 3)).astype(np.float32)
        # A target the model can learn (the first channel's sign), so the
        # loss falls from step to step rather than around pixel noise.
        bbatch = {"images": images,
                  "masks": (images[..., 0] > 0).astype(np.float32)}
        state = birefnet_step.init_birefnet_train_state(model, bt)
        step = birefnet_step.make_birefnet_train_step(bcfg, bt)
        try:
            train_run(torch, counters, zero_counters, step, model, state,
                      fixed(bbatch), f"BiRefNet_lite 1024 B={B} float32 "
                      f"(lr 1e-4)", gpu_line)
            break
        except torch.cuda.OutOfMemoryError:
            print(f"train BiRefNet_lite 1024 B={B}: out of device memory, "
                  f"trying a smaller batch", flush=True)
        finally:
            del model, state, step
            torch.cuda.empty_cache()
    else:
        fail("BiRefNet_lite: no batch fits")

    # Float32 card against CPU: loss and every leaf's gradient. A ReLU's
    # gradient jumps at 0, so where a pre-activation lies within rounding
    # distance of 0 the two devices may take different sides and every
    # leaf upstream of it moves (BiRefNet's decoder is ReLU; MobileSAM's
    # encoder is GELU). BiRefNet's ReLU inputs are recorded on both
    # devices: with no sign flip the limit is 1e-5; flips, each of a
    # pre-activation below 1e-5 in size (a tie, not a divergence), allow
    # 1e-3. BiRefNet runs twice: at its init (offset and modulator convs
    # zero, so every deformable sample lies on the pixel grid) and with
    # seeded nonzero offsets, where the offsets' gradient (the bilinear
    # sample's derivative in the position) also jumps at a pixel edge and
    # the devices' offsets differ by rounding: 1e-3.
    slim = slim_config(256, False)
    bir_batch = {"images": np.random.default_rng(5).standard_normal(
        (1, 256, 256, 3)).astype(np.float32),
        "masks": (np.random.default_rng(6).random((1, 256, 256)) > 0.5
                  ).astype(np.float32)}
    relu = bn.relu

    def relu_inputs(fn):
        """fn() with BiRefNet's ReLU inputs recorded: (result, inputs)."""
        seen = []

        def recorded(x):
            seen.append(x.detach().cpu())
            return relu(x)

        bn.relu = recorded
        try:
            return fn(), seen
        finally:
            bn.relu = relu

    for label, make, loss_fn, lcfg, b, smooth in (
            ("MobileSAM 256 B=2",
             lambda: sam.init_sam(torch.Generator().manual_seed(3),
                                  sam.make_config("mobile_sam", 256)),
             tstep.mask_loss, sam.make_config("mobile_sam", 256),
             next(sam_batch_iterator(np.random.default_rng(4), batch_size=2,
                                     image_size=256, mask_size=64)), True),
            ("slim BiRefNet 256 B=1, its init (offsets zero)",
             lambda: bn.init_birefnet(torch.Generator().manual_seed(0), slim),
             birefnet_step.birefnet_loss, slim, bir_batch, True),
            ("slim BiRefNet 256 B=1, seeded nonzero offsets",
             lambda: seeded_birefnet(bn, torch, slim),
             birefnet_step.birefnet_loss, slim, bir_batch, False)):
        t1 = time.perf_counter()
        cpu_model = make()
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        ((l_cpu, _), g_cpu), r_cpu = relu_inputs(
            lambda: tstep.loss_and_grads(loss_fn, cpu_model, lcfg, b))
        ((l_gpu, _), g_gpu), r_gpu = relu_inputs(
            lambda: tstep.loss_and_grads(loss_fn, gpu_model, lcfg, b))
        flips = [(a > 0) != (c > 0) for a, c in zip(r_cpu, r_gpu)]
        n_flips = sum(int(f.sum()) for f in flips)
        tie = max((float(a[f].abs().max()) for a, f in zip(r_cpu, flips)
                   if f.any()), default=0.0)
        if not tie <= 1e-5:
            fail(f"card vs CPU {label}: a ReLU input of {tie} changed sign")
        limit = 1e-5 if smooth and not n_flips else 1e-3
        rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
        if not rel <= 1e-5:
            fail(f"card vs CPU {label}: loss {float(l_gpu)} vs {float(l_cpu)}")
        err, leaf = grads_close(torch, g_gpu, g_cpu, limit)
        print(f"train card vs CPU float32 {label}: loss relative {rel:.3e} "
              f"(limit 1e-5), worst leaf gradient relative L2 {err:.3e} "
              f"({leaf}; limit {limit:g}, {len(g_cpu)} leaves); ReLU inputs "
              f"that changed sign {n_flips} (largest {tie:.2e}) "
              f"[{time.perf_counter() - t1:.1f} s]", flush=True)
        del cpu_model, gpu_model, g_cpu, g_gpu
    torch.cuda.empty_cache()
    print(f"phase 11: {time.perf_counter() - t0:.1f} s", flush=True)
    return teacher_launches


def check_phase12_shapes(torch, ops, entries):
    """Phase 2, the kernels at phase 12's shapes (``phase12_shapes``): a
    shape phase 2 has timed already takes phase 12's launches too; the
    others (the sp shards' windows, the rows of two frames) are held
    against their plain versions and timed here."""
    sh = phase12_shapes()

    def merge(rows, key):
        out = {}
        for r in rows:
            out[key(r)] = out.get(key(r), 0) + r[-1]
        return out

    ln = merge(sh["ln"], lambda r: r[:3])
    ln = [k + (n,) for k, n in ln.items()
          if not entries.add(ln_label(k[0], k[1]), "fused_layer_norm", n)]
    attn = merge(sh["attn"], lambda r: r[:3])
    attn = [k + (n,) for k, n in attn.items()
            if not entries.add(levit_label(*k, True), "levit_window_attention",
                               n)]
    check_kernels(torch, ops, entries, ln, attn, images=1)
    vit_ln = {k: n for k, n in merge(sh["vit_ln"], lambda r: r[:2]).items()
              if not entries.add(ln_label(*k), "fused_layer_norm", n)}
    add_ln = {k: n for k, n in merge(sh["add_ln"], lambda r: r[:2]).items()
              if not entries.add(add_ln_label(*k), "fused_add_layer_norm", n)}
    pairs = sorted(set(vit_ln) | set(add_ln))
    glob = [k + (n,) for k, n in merge(sh["global"], lambda r: r[:3]).items()
            if not entries.add(global_label(k[0], k[1] ** 2, k[2]),
                               "relpos_attention_global", n)]
    win = [k + (n,) for k, n in merge(sh["window"], lambda r: r[:6]).items()
           if not entries.add(window_label(k[0] * k[1], k[2] ** 2, k[3], k[4],
                                           k[5]),
                              "relpos_attention_windowed", n)]
    check_vit_kernels(torch, ops, entries,
                      [k + (vit_ln.get(k),) for k in pairs],
                      [k + (add_ln.get(k),) for k in pairs], glob, win,
                      images=1)


def check_phase13_shapes(torch, ops, entries):
    """Phase 2, K1 and K2 at the band shapes of phase 13's counted runs
    (``band_shapes`` over BAND_SIZES, one bf16 `process` each): a shape
    timed already takes the launches; the others are held against their
    plain versions and timed here."""
    ln, attn = {}, {}
    for sp in BAND_SIZES:
        l, a = band_shapes(sp)
        for r in l:
            ln[r[:3]] = ln.get(r[:3], 0) + r[3]
        for r in a:
            attn[r[:3]] = attn.get(r[:3], 0) + r[3]
    ln = [k + (n,) for k, n in ln.items()
          if not entries.add(ln_label(k[0], k[1]), "fused_layer_norm", n)]
    attn = [k + (n,) for k, n in attn.items()
            if not entries.add(levit_label(*k, True), "levit_window_attention",
                               n)]
    check_kernels(torch, ops, entries, ln, attn, images=1)


def sam_train_batch(np, B: int, seed: int = 7) -> dict:
    """A seeded MobileSAM train batch at 1024 (train/step.py's schema)."""
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((B, 1024, 1024, 3)).astype(np.float32),
            "point_coords": rng.uniform(0, 1024, (B, 2, 2)).astype(np.float32),
            "point_labels": np.tile(np.array([[1.0, -1.0]], np.float32), (B, 1)),
            "masks": (rng.random((B, 256, 256)) > 0.5).astype(np.float32)}


def params_close(torch, got, want, g_got, g_want, lr):
    """Parameters after one AdamW step from equal parameters on gradients
    ``g_got`` and ``g_want`` (tests/test_torch_train_step.py's rule): where
    either gradient element is below 1e-6 in size (Adam moves it by about
    +-lr on its sign, which a rounding may flip), within 1e-6 + 2 lr; every
    other element of a leaf within relative L2 1e-5 of the leaf, plus 1e-4
    lr per element. Returns the largest relative L2 seen."""
    worst = 0.0
    for k, w in want.items():
        d = (got[k] - w).abs()
        small = (g_got[k].abs() < 1e-6) | (g_want[k].abs() < 1e-6)
        if small.any() and not float(d[small].max()) <= 1e-6 + 2 * lr:
            fail(f"parameter {k}: a small-gradient element moved "
                 f"{float(d[small].max())} apart")
        rest = ~small
        err, ref = float(d[rest].norm()), float(w[rest].norm())
        if not err <= 1e-5 * ref + 1e-4 * lr * float(rest.sum()) ** 0.5:
            fail(f"parameter {k}: relative L2 {err / max(ref, 1e-30)} > 1e-5")
        worst = max(worst, err / max(ref, 1e-30))
    return worst


def dp_worker(rank: int, port: int) -> int:
    """One of phase 12's two ranks on one card (``chip_smoke.py
    --dp-worker RANK PORT``): a gloo group of 2 through torch.distributed
    itself, a global mesh of one device a process (cuda:0 in both), the
    MobileSAM dp train step at 1024 on MESH_B frames, MESH_B // 2 a rank.
    Rank 1 starts from other weights, which ``replicate_params`` replaces
    by rank 0's. Prints one "DP-WORKER" JSON line: the loss, a digest of
    the parameters after the step, the gradients against a one-process
    run on the whole batch, and the step's ms."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from dlimgedit_tpu_torch.models import sam
    from dlimgedit_tpu_torch.parallel import multihost
    from dlimgedit_tpu_torch.train import step as pstep

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    cfg = sam.make_config("mobile_sam", 1024)
    tcfg = pstep.TrainConfig()
    mesh = multihost.global_mesh(dp=2, devices=[dev])
    model = multihost.replicate_params(
        mesh, sam.init_sam(torch.Generator().manual_seed(rank), cfg))
    ref = sam.init_sam(torch.Generator().manual_seed(0), cfg).to(dev)
    for (k, a), b in zip(model.state_dict().items(), ref.state_dict().values()):
        if not torch.equal(a, b):
            fail(f"rank {rank}: {k} differs from rank 0's after the broadcast")
    batch = sam_train_batch(np, MESH_B)
    (l1, _), g1 = pstep.loss_and_grads(pstep.mask_loss, ref, cfg, batch, tcfg)
    m, o, placed = pstep.place_train_state(
        model, pstep.init_train_state(model), batch, mesh)
    (l2, _), g2 = pstep.mesh_loss_and_grads(pstep.mask_loss, m, cfg, placed,
                                            tcfg, 1, tp=True)
    g_worst, g_leaf = grads_close(torch, g2, {k: v.cpu() for k, v in g1.items()},
                                  1e-5)
    step = pstep.make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    m, o, loss, _ = step(m, o, placed)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    _, _, one_loss, _ = step(ref, pstep.init_train_state(ref), batch)
    p_worst = params_close(torch, dict(m.state_dict()), dict(ref.state_dict()),
                           g2, g1, tcfg.learning_rate)
    digest = hashlib.sha256(b"".join(
        t.detach().cpu().numpy().tobytes()
        for t in m.state_dict().values())).hexdigest()
    print("DP-WORKER " + json.dumps({
        "rank": rank, "loss": float(loss), "one_process_loss": float(one_loss),
        "mesh_loss_before_step": float(l2), "one_process_loss_before": float(l1),
        "grad_rel_l2": g_worst, "grad_leaf": g_leaf, "param_rel_l2": p_worst,
        "params": digest, "step_ms": step_ms}), flush=True)
    dist.destroy_process_group()
    return 0


def check_nccl_group_of_one(torch, np, gpu_line):
    """The NCCL route (multihost.initialize on a CUDA process) in a group
    of one: the dp step's gradient all-reduce runs on NCCL, and its loss
    and gradients equal the step without a mesh."""
    import socket

    import torch.distributed as dist

    from dlimgedit_tpu_torch.models import sam
    from dlimgedit_tpu_torch.parallel import multihost
    from dlimgedit_tpu_torch.train import step as pstep

    dev = torch.device("cuda", 0)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"localhost:{port}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            fail(f"initialize on a CUDA process chose {dist.get_backend()}")
        cfg = sam.make_config("mobile_sam", 1024)
        tcfg = pstep.TrainConfig()
        model = sam.init_sam(torch.Generator().manual_seed(0), cfg).to(dev)
        batch = sam_train_batch(np, 2)
        (l1, _), g1 = pstep.loss_and_grads(pstep.mask_loss, model, cfg, batch,
                                           tcfg)
        mesh = multihost.global_mesh(dp=1, devices=[dev])
        m, o, placed = pstep.place_train_state(
            model, pstep.init_train_state(model), batch, mesh)
        t = time.perf_counter()
        (l2, _), g2 = pstep.mesh_loss_and_grads(pstep.mask_loss, m, cfg,
                                                placed, tcfg, 1, tp=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        worst, leaf = grads_close(torch, g2, {k: v.cpu() for k, v in g1.items()},
                                  1e-5)
        if abs(float(l2) - float(l1)) > 1e-6 * abs(float(l1)):
            fail(f"NCCL group of one: loss {float(l2)} != {float(l1)}")
        print(f"multi-process, NCCL group of one on {gpu_line}: the dp "
              f"step's all-reduce ran on NCCL; loss {float(l2):.6f} against "
              f"{float(l1):.6f} without a mesh, gradients within relative "
              f"L2 {worst:.3e} ({leaf}); loss and gradients in {ms:.1f} ms",
              flush=True)
    finally:
        dist.destroy_process_group()


def run_two_ranks(torch, gpu_line):
    """Phase 12's two ranks on cuda:0 (``dp_worker``), spawned and waited
    for; every process stopped before this returns."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dp-worker", str(r),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rows = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        line = next((ln for ln in out.splitlines()
                     if ln.startswith("DP-WORKER ")), None)
        if p.returncode != 0 or line is None:
            fail(f"dp worker {r} exited {p.returncode}:\n{out[-3000:]}")
        rows.append(json.loads(line[len("DP-WORKER "):]))
    if rows[0]["loss"] != rows[1]["loss"]:
        fail(f"the two ranks' losses differ: {rows[0]['loss']} "
             f"{rows[1]['loss']}")
    if rows[0]["params"] != rows[1]["params"]:
        fail("the two ranks' parameters after the step differ")
    r0 = rows[0]
    if not abs(r0["loss"] - r0["one_process_loss"]) <= 1e-5 * abs(
            r0["one_process_loss"]):
        fail(f"two ranks' loss {r0['loss']} against one process "
             f"{r0['one_process_loss']}")
    print(f"multi-process, two ranks on one card (gloo) on {gpu_line}: the "
          f"same loss {r0['loss']!r} on both (one process on the whole "
          f"batch: {r0['one_process_loss']!r}), parameters after the step "
          f"bit-equal across the ranks (sha256 {r0['params'][:16]}), within "
          f"relative L2 {r0['param_rel_l2']:.3e} of the one-process step's; "
          f"gradients within {r0['grad_rel_l2']:.3e} ({r0['grad_leaf']}); "
          f"step ms rank 0 {r0['step_ms']:.1f}, rank 1 "
          f"{rows[1]['step_ms']:.1f} (one step, both ranks sharing the card "
          f"and gloo's host copies) [{time.perf_counter() - t0:.1f} s]",
          flush=True)


def drive_multi_device(torch, np, dl, counters, zero_counters, host_ms,
                       gpu_line):
    """Phase 12: the multi-device tier's explicit schedules over meshes
    whose devices are all cuda:0 (the card holds every schedule for
    exactness and runs its kernels; a virtual mesh does the dense work
    plus the gathers, so its times are no speed-ups).

      * sp: ViT-B and ViT-H at 1024, bf16, B = 1, kernels on, over SP_SIZES
        shards: launches per run exactly ``sp_per_run`` (the counted run),
        the embedding's relative L2 to the float32 plain path at most 1.1x
        the dense bf16 path's (phase 4's rule); ViT-B in float32, kernels
        off (the row-sharded global blocks at full precision) within atol
        1e-5, rtol 1e-5 of the dense float32 path (JAX's tests/test_sp.py);
      * ``encode_frames`` of MESH_B frames, MobileSAM and ViT-B, bf16, the
        serving flags: over (dp 4, tp 1) every frame bit for bit its B = 1
        call, over (dp 2, tp 2) finite (its relative L2 to the dense call
        printed: bf16 rounds each row-parallel part, so no bf16 limit
        tells a sound split from a faulty one); exact launches of the
        counted calls; then MobileSAM and ViT-B in float32 over (dp 2, tp
        2), 2 frames, within the CPU test's atol 2e-4, rtol 1e-3 of the
        dense call (the tp reassociation tolerance);
      * ``segment_frames``, BiRefNet_lite at 1024, bf16, TEACHER_B frames
        over dp 2: each frame bit for bit its B = 1 call, no launch;
      * the NCCL group of one and the two gloo ranks on one card.
    Times (host clock, medians) with the card's name and power limit.
    Returns the counted runs' launches."""
    import copy
    import types

    from dlimgedit_tpu_torch.models import sam as sam_lib
    from dlimgedit_tpu_torch.models.birefnet import seed_nonzero_init
    from dlimgedit_tpu_torch.models.common import cast_tree, full_precision
    from dlimgedit_tpu_torch.models.vit_sam import SamViT, sam_vit_apply
    from dlimgedit_tpu_torch.parallel import batch as pbatch
    from dlimgedit_tpu_torch.parallel import mesh as pmesh
    from dlimgedit_tpu_torch.parallel import sp as psp

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    launches = {}

    def count(label, expect, run):
        zero_counters()
        out = run()
        torch.cuda.synchronize()
        counts = counters()
        want = {k: expect.get(k, 0) for k in counts}
        if counts != want:
            fail(f"{label}: launches {counts} != {want}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return out, counts

    # -- sp ------------------------------------------------------------------
    for variant, C, nh, hd, depth in SP_VITS:
        t1 = time.perf_counter()
        vcfg = sam_lib.make_config(variant, 1024).encoder_vit
        kcfg = dataclasses.replace(vcfg, use_flash_attention=True)
        enc32 = SamViT(vcfg, torch.Generator().manual_seed(0)).to(dev)
        seed_vit_extras(torch, types.SimpleNamespace(encoder=enc32))
        enc16 = cast_tree(copy.deepcopy(enc32), torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(12)
        x32 = torch.randn((1, 1024, 1024, 3), generator=gen, device=dev)
        x16 = x32.to(torch.bfloat16)

        def dense(enc, x, cfg):
            with torch.inference_mode(), full_precision():
                return sam_vit_apply(enc, x, cfg)

        def sharded(enc, x, cfg, mesh):
            with torch.inference_mode():
                return psp.sam_vit_apply_sp(enc, x, cfg, mesh)

        ref32 = dense(enc32, x32, vcfg)
        dense16 = dense(enc16, x16, kcfg)
        r_dense = rel_l2(torch, dense16, ref32)
        ms_dense = host_ms(lambda: dense(enc16, x16, kcfg), n=5)
        for sp in SP_SIZES:
            mesh = psp.make_sp_mesh(sp, devices=[dev] * sp)
            out, counts = count(f"sp {variant} sp={sp}", sp_per_run(depth, sp),
                                lambda: sharded(enc16, x16, kcfg, mesh))
            r_sp, r_vs = rel_l2(torch, out, ref32), rel_l2(torch, out, dense16)
            if tuple(out.shape) != (1, 64, 64, 256) or not r_sp <= 1.1 * r_dense:
                fail(f"sp {variant} sp={sp} bf16: relative L2 to float32 "
                     f"{r_sp} > 1.1 x the dense path's {r_dense}")
            ms = host_ms(lambda: sharded(enc16, x16, kcfg, mesh), n=5)
            per_shard = {k: v // sp for k, v in counts.items() if v}
            print(f"sp {variant} bf16 over [cuda:0] x {sp} ({sp_windows(sp)} "
                  f"windows a shard, {sp * sp_windows(sp) - 25} dummy): "
                  f"launches {sum(counts.values())} ({per_shard} a shard); "
                  f"relative L2 to float32 {r_sp:.3e} (dense bf16 "
                  f"{r_dense:.3e}; limit 1.1x), to dense bf16 {r_vs:.3e}; on "
                  f"{gpu_line}: sp call {ms:.3f} ms, dense eager call "
                  f"{ms_dense:.3f} ms (medians of 5; one card, so no "
                  f"speed-up)", flush=True)
            if variant == "vit_b":
                got = sharded(enc32, x32, vcfg, mesh)
                err = float((got - ref32).abs().max())
                if not torch.allclose(got, ref32, atol=1e-5, rtol=1e-5):
                    fail(f"sp vit_b sp={sp} float32: max|diff| {err} to the "
                         f"dense path (atol 1e-5, rtol 1e-5)")
                print(f"sp vit_b float32 (row-sharded global blocks) over "
                      f"sp={sp}: max|diff| to the dense float32 path "
                      f"{err:.3e} (atol 1e-5, rtol 1e-5)", flush=True)
        print(f"phase 12, sp {variant}: {time.perf_counter() - t1:.1f} s",
              flush=True)
        del enc32, enc16, ref32, dense16, out
        pmesh.clear_replicas()
        torch.cuda.empty_cache()

    # -- encode_frames over (dp, tp) -----------------------------------------
    for variant, per_call in (("mobile_sam", {"fused_layer_norm":
                                              LN_PER_PROCESS,
                                              "levit_window_attention":
                                              ATTN_PER_PROCESS}),
                              ("vit_b", VIT_PER_PROCESS)):
        t1 = time.perf_counter()
        env = dl.Environment(dl.Options(allow_random_weights=True,
                                        sam_variant=variant))
        bundle = env.sam_model(variant)
        if variant != "mobile_sam":
            seed_vit_extras(torch, bundle.model)
        model, cfg = bundle.model, bundle.cfg
        gen = torch.Generator(device=dev).manual_seed(13)
        frames = torch.randn((MESH_B, 1024, 1024, 3), generator=gen,
                             device=dev).to(torch.bfloat16)
        whole = pbatch.encode_frames(model, cfg, frames)
        ones = [pbatch.encode_frames(model, cfg, frames[i:i + 1])
                for i in range(MESH_B)]
        ms_whole = host_ms(lambda: pbatch.encode_frames(model, cfg, frames),
                           n=10)
        for dp, tp in MESH_LAYOUTS:
            mesh = pmesh.make_mesh(dp * tp, dp=dp, tp=tp, devices=[dev] * 4)
            pbatch.encode_frames(model, cfg, frames, mesh=mesh)  # warm-up
            out, _ = count(f"encode_frames {variant} dp={dp} tp={tp}",
                           {k: v * dp for k, v in per_call.items()},
                           lambda: pbatch.encode_frames(model, cfg, frames,
                                                        mesh=mesh))
            if tp == 1:
                if not all(torch.equal(out[i], ones[i][0])
                           for i in range(MESH_B)):
                    fail(f"encode_frames {variant} dp={dp}: a frame differs "
                         f"from its B=1 call")
                note = "every frame bit-equal to its B=1 call"
            else:
                if (out.shape != whole.shape
                        or not bool(torch.isfinite(out).all())):
                    fail(f"encode_frames {variant} dp={dp} tp={tp}: shape "
                         f"{tuple(out.shape)} or a value not finite")
                note = (f"finite; relative L2 to the dense B={MESH_B} call "
                        f"{rel_l2(torch, out, whole):.3e} (bf16, no limit: "
                        f"held in float32 below)")
            ms = host_ms(lambda: pbatch.encode_frames(model, cfg, frames,
                                                      mesh=mesh), n=10)
            print(f"encode_frames {variant} bf16 over (dp {dp}, tp {tp}) on "
                  f"[cuda:0] x 4: {note}; on {gpu_line}: {ms:.3f} ms a call "
                  f"({'graphs per row' if tp == 1 else 'eager'}), dense "
                  f"B={MESH_B} graph {ms_whole:.3f} ms (medians of 10)",
                  flush=True)
        del env, bundle, model, frames, whole, ones, out
        pbatch._GRAPH_CACHE.clear()
        pmesh.clear_replicas()
        torch.cuda.empty_cache()
        print(f"phase 12, frames {variant}: {time.perf_counter() - t1:.1f} s",
              flush=True)
    # float32: the tp split (ViT-B's qkv, proj, lin1 and lin2; TinyViT's
    # qkv, proj, fc1 and fc2) against the dense call at the CPU test's
    # reassociation tolerance.
    mesh = pmesh.make_mesh(4, dp=2, tp=2, devices=[dev] * 4)
    x = torch.randn((2, 1024, 1024, 3), generator=gen, device=dev)
    for variant in ("mobile_sam", "vit_b"):
        env = dl.Environment(dl.Options(allow_random_weights=True,
                                        compute_dtype="float32",
                                        sam_variant=variant))
        bundle = env.sam_model(variant)
        if variant != "mobile_sam":
            seed_vit_extras(torch, bundle.model)
        want = pbatch.encode_frames(bundle.model, bundle.cfg, x)
        got = pbatch.encode_frames(bundle.model, bundle.cfg, x, mesh=mesh)
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=2e-4, rtol=1e-3):
            fail(f"encode_frames {variant} float32 over (dp 2, tp 2): "
                 f"max|diff| {err} to the dense call (atol 2e-4, rtol 1e-3)")
        print(f"encode_frames {variant} float32 B=2 over (dp 2, tp 2): "
              f"max|diff| to the dense call {err:.3e} (atol 2e-4, rtol 1e-3)",
              flush=True)
        del env, bundle, got, want
        pbatch._GRAPH_CACHE.clear()
        pmesh.clear_replicas()
    del x
    torch.cuda.empty_cache()

    # -- segment_frames over dp ----------------------------------------------
    t1 = time.perf_counter()
    for var in ("DLIMG_BIREFNET_TEST_SLIM", "DLIMG_BIREFNET_RESOLUTION"):
        os.environ.pop(var, None)
    env = dl.Environment(dl.Options(allow_random_weights=True))
    bundle = env.birefnet_model("general")
    seed_nonzero_init(bundle.model)
    frames = torch.randn((TEACHER_B, 1024, 1024, 3), generator=gen,
                         device=dev).to(torch.bfloat16)
    mesh = pmesh.make_mesh(TEACHER_B, dp=TEACHER_B, devices=[dev] * TEACHER_B)
    ones = [pbatch.segment_frames(bundle.model, bundle.cfg, frames[i:i + 1])
            for i in range(TEACHER_B)]
    logits, _ = count("segment_frames over dp", {},
                      lambda: pbatch.segment_frames(bundle.model, bundle.cfg,
                                                    frames, mesh=mesh))
    if not all(torch.equal(logits[i], ones[i][0]) for i in range(TEACHER_B)):
        fail("segment_frames over dp: a frame differs from its B=1 call")
    ms = host_ms(lambda: pbatch.segment_frames(bundle.model, bundle.cfg,
                                               frames, mesh=mesh), n=5)
    print(f"segment_frames BiRefNet_lite bf16 B={TEACHER_B} over dp "
          f"{TEACHER_B} on [cuda:0] x {TEACHER_B}: every frame bit-equal to "
          f"its B=1 call, no kernel launched; on {gpu_line}: {ms:.3f} ms a "
          f"call (median of 5) [{time.perf_counter() - t1:.1f} s]", flush=True)
    del env, bundle, frames, logits, ones
    pbatch._GRAPH_CACHE.clear()
    pmesh.clear_replicas()
    torch.cuda.empty_cache()

    # -- the multi-process tier -----------------------------------------------
    check_nccl_group_of_one(torch, np, gpu_line)
    torch.cuda.empty_cache()
    run_two_ranks(torch, gpu_line)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def drive_canvas_rows(torch, np, dl, counters, zero_counters, host_ms,
                      gpu_line):
    """Phase 13: canvas-row sharding (parallel/spatial.py) through the
    public entry points, every mesh cuda:0 repeated
    (``runtime.environment.backend_devices`` patched to [cuda:0] x k, the
    CPU tests' seam; one card, so no time is a speed-up):

      * MobileSAM `Segmentation.process` at 1024 on 1024x768 over
        BAND_SIZES bands, float32 then bf16 (kernels on): the embedding
        in float32 within atol 2e-4, rtol 1e-4 of the dense call, in bf16
        its relative L2 to the float32 dense embedding at most 1.1x the
        dense bf16 one's (phase 4's rule); masks of 3 clicks flipped on
        under 5e-3 of the pixels; K1 and K2 launches per band exactly the
        geometry's (``band_shapes``; the bf16 runs are counted); the
        executable not graphed;
      * BiRefNet_lite `segment_objects` (seeded nonzero offsets):
        `general` on 1024x768 over BAND_SIZES bands and `high_res` on
        2000x1500 over 2, no kernel launched; in float32 the uint8 mask at
        most 1 quantum off the dense call's, on under 5e-3 of the pixels;
        in bf16 (the served dtype, timed) the masks' distance to the
        float32 mask printed beside the dense bf16 call's, and the logits
        held instead: `birefnet_apply_spatial` at 1024 over 2 bands within
        relative L2 1e-5 of `birefnet_apply` in float32, and in bf16 at
        most 1.1x the dense bf16 path's relative L2 to float32 (phase 4's
        rule: two bf16 programs round apart);
      * the BiRefNet_lite train step at 1024 in float32 over (dp, sp) =
        BAND_TRAIN, B = dp, learning rate 1e-3, against the dense step on
        the same model and batch: loss relative 1e-5; parameters within
        atol 5e-5, rtol 1e-4 (tests/test_torch_parallel.py's limits) where
        both gradients exceed 1e-6 in size, within 1e-6 + 2 lr elsewhere
        (Adam's first step moves those by +-lr on a sign a rounding may
        flip); the gradients' largest relative L2 printed (a deform
        offset's gradient jumps where a sample crosses a pixel edge);
        the step's time and peak device memory beside the dense step's.
    `mesh_call_ms`: each band call beside the dense eager call (host
    clock, medians). Returns the counted runs' launches."""
    import copy

    from dlimgedit_tpu_torch.models import birefnet as bn
    from dlimgedit_tpu_torch.models.common import cast_tree, full_precision
    from dlimgedit_tpu_torch.parallel import mesh as pmesh
    from dlimgedit_tpu_torch.parallel import spatial
    from dlimgedit_tpu_torch.runtime import environment as renv
    from dlimgedit_tpu_torch.train import birefnet_step as bstep
    from dlimgedit_tpu_torch.train import step as pstep

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    seam = renv.backend_devices
    launches = {}

    def env_over(k, **kw):
        renv.backend_devices = lambda device: [dev] * k
        try:
            return dl.Environment(dl.Options(allow_random_weights=True,
                                             scaleout_devices=k, **kw))
        finally:
            renv.backend_devices = seam

    def eager_ms(env, fn, n):
        """The call with every executable of ``env`` eager."""
        for exe in env.executables.values():
            exe.graphed = False
        return host_ms(fn, n=n)

    # -- MobileSAM ---------------------------------------------------------
    img = dl.Image(dl.Extent(1024, 768), dl.Channels.rgba,
                   rgba(np, 768, 1024, 31))
    clicks = [dl.Point(300, 200), dl.Point(512, 384), dl.Point(800, 600)]
    ref32 = None
    for dtype in ("float32", "bfloat16"):
        t1 = time.perf_counter()
        dense = env_over(1, compute_dtype=dtype)
        seg1 = dl.Segmentation.process(img, dense)
        masks1 = [seg1.compute_mask(c).pixels for c in clicks]
        emb1 = seg1.embedding.clone()
        if ref32 is None:
            ref32 = emb1
        r_dense = rel_l2(torch, emb1, ref32)
        ms_dense = eager_ms(dense, lambda: dl.Segmentation.process(img, dense),
                            5)
        for sp in BAND_SIZES:
            env = env_over(sp, compute_dtype=dtype)
            if env.mesh.shape != {"sp": sp}:
                fail(f"scaleout_devices={sp}: mesh {env.mesh}")
            zero_counters()
            seg = dl.Segmentation.process(img, env)
            torch.cuda.synchronize()
            counts = counters()
            want = {k: 0 for k in counts}
            want.update(fused_layer_norm=22 * sp, levit_window_attention=10 * sp)
            if counts != want:
                fail(f"MobileSAM {dtype} over {sp} bands: launches {counts} != "
                     f"{want}")
            if dtype == "bfloat16":
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
            exe = next(e for k, e in env.executables.items() if k[0] == "embed")
            if exe.graphed:
                fail("the band-sharded embed executable is graphed")
            emb = seg.embedding
            err = float((emb - emb1).abs().max())
            if dtype == "float32":
                if not torch.allclose(emb, emb1, atol=2e-4, rtol=1e-4):
                    fail(f"MobileSAM float32 over {sp} bands: max|diff| {err} "
                         f"to the dense embedding (atol 2e-4, rtol 1e-4)")
                note = f"max|diff| to the dense embedding {err:.3e}"
            else:
                r_sp = rel_l2(torch, emb, ref32)
                if not r_sp <= 1.1 * r_dense:
                    fail(f"MobileSAM bf16 over {sp} bands: relative L2 to "
                         f"float32 {r_sp} > 1.1 x the dense bf16 {r_dense}")
                note = (f"relative L2 to the float32 embedding {r_sp:.3e} "
                        f"(dense bf16 {r_dense:.3e}; limit 1.1x), max|diff| "
                        f"to the dense bf16 embedding {err:.3e}")
            flips = [float(np.mean(seg.compute_mask(c).pixels != m))
                     for c, m in zip(clicks, masks1)]
            if not max(flips) < 5e-3:
                fail(f"MobileSAM {dtype} over {sp} bands: mask pixels "
                     f"flipped {flips} (limit 5e-3)")
            ms = host_ms(lambda: dl.Segmentation.process(img, env), n=5)
            windows = {f"{H}/{ws}": [w for _, w in band_windows(H, ws, sp)]
                       for H, ws, *_ in TINYVIT_STAGES}
            print(f"MobileSAM {dtype} process over {sp} bands on [cuda:0] x "
                  f"{sp}: launches {sum(counts.values())} (22 K1 and 10 K2 a "
                  f"band); window rows a band (stage rows/window: band by "
                  f"band, 19/5/10 columns) {windows}; {note}; mask flips "
                  f"{[f'{f:.2e}' for f in flips]} (limit 5e-3); eager; on "
                  f"{gpu_line}: mesh_call_ms {ms:.3f}, dense eager call "
                  f"{ms_dense:.3f} (medians of 5; one card, so the "
                  f"schedule's overhead, no speed-up)", flush=True)
            del env, seg
            pmesh.clear_replicas()
        del dense, seg1
        print(f"phase 13, MobileSAM {dtype}: {time.perf_counter() - t1:.1f} s",
              flush=True)
    torch.cuda.empty_cache()

    # -- BiRefNet segment_objects ---------------------------------------------
    t1 = time.perf_counter()
    for var in ("DLIMG_BIREFNET_TEST_SLIM", "DLIMG_BIREFNET_RESOLUTION"):
        os.environ.pop(var, None)

    def birefnet_env(k, dtype):
        env = env_over(k, compute_dtype=dtype)
        for kind in ("general", "high_res"):
            bn.seed_nonzero_init(env.birefnet_model(kind).model)
        return env

    images = [(kind, dl.Image(dl.Extent(w, h), dl.Channels.rgba,
                              rgba(np, h, w, 32)), sizes)
              for kind, w, h, sizes in (("general", 1024, 768, BAND_SIZES),
                                        ("high_res", 2000, 1500, (2,)))]
    masks32 = {}
    for dtype in ("float32", "bfloat16"):
        dense = birefnet_env(1, dtype)
        for kind, img, sizes in images:
            m1 = dl.segment_objects(img, dense).pixels
            ref = masks32.setdefault(kind, m1).astype(np.int32)
            off_dense = np.abs(m1.astype(np.int32) - ref)
            if dtype == "bfloat16":
                ms_dense = eager_ms(dense, lambda: dl.segment_objects(img,
                                                                      dense), 3)
            for sp in sizes:
                env = birefnet_env(sp, dtype)
                zero_counters()
                m = dl.segment_objects(img, env).pixels
                torch.cuda.synchronize()
                launched = {k: v for k, v in counters().items() if v}
                if launched:
                    fail(f"BiRefNet {kind} over {sp} bands launched {launched}")
                d = np.abs(m.astype(np.int32) - m1.astype(np.int32))
                label = (f"BiRefNet_lite {kind} {dtype} segment_objects "
                         f"{img.extent.width}x{img.extent.height} over {sp} "
                         f"bands on [cuda:0] x {sp}: mask at most {d.max()} "
                         f"quanta off the dense call's, on "
                         f"{np.mean(d > 0):.2e} of the pixels")
                if dtype == "float32":
                    if not (m.shape == m1.shape and d.max() <= 1
                            and np.mean(d > 0) < 5e-3):
                        fail(f"{label} (limit 1 quantum on 5e-3)")
                    print(f"{label} (limit 1 quantum on 5e-3); no kernel "
                          f"launched", flush=True)
                else:
                    off = np.abs(m.astype(np.int32) - ref)
                    ms = host_ms(lambda: dl.segment_objects(img, env), n=3)
                    print(f"{label} (bf16 rounding: held on the logits "
                          f"below); mean |mask - float32 mask| {off.mean():.4f} "
                          f"quanta (dense bf16 {off_dense.mean():.4f}); no "
                          f"kernel launched; eager; on {gpu_line}: "
                          f"mesh_call_ms {ms:.3f}, dense eager call "
                          f"{ms_dense:.3f} (medians of 3; one card: the "
                          f"schedule's overhead, no speed-up)", flush=True)
                del env
                pmesh.clear_replicas()
                torch.cuda.empty_cache()
        del dense
        torch.cuda.empty_cache()
    cfg = bn.BiRefNetConfig(img_size=1024)
    model = bn.init_birefnet(torch.Generator().manual_seed(0), cfg)
    bn.seed_nonzero_init(model)
    model = model.to(dev).eval()
    m16 = cast_tree(copy.deepcopy(model), torch.bfloat16)
    x = torch.randn((1, 1024, 1024, 3),
                    generator=torch.Generator(device=dev).manual_seed(33),
                    device=dev)
    mesh = spatial.make_spatial_mesh(2, devices=[dev] * 2)
    with torch.inference_mode():
        with full_precision():
            want = bn.birefnet_apply(model, x, cfg)
            dense16 = bn.birefnet_apply(m16, x.to(torch.bfloat16), cfg)
        got = spatial.birefnet_apply_spatial(model, x, cfg, mesh)
        got16 = spatial.birefnet_apply_spatial(m16, x.to(torch.bfloat16), cfg,
                                               mesh)
    r, err = rel_l2(torch, got, want), float((got - want).abs().max())
    if not (got.shape == want.shape and r <= 1e-5):
        fail(f"birefnet_apply_spatial float32 over 2 bands: relative L2 {r} "
             f"(max|diff| {err}) to birefnet_apply (limit 1e-5)")
    r16, r_dense = rel_l2(torch, got16, want), rel_l2(torch, dense16, want)
    if not r16 <= 1.1 * r_dense:
        fail(f"birefnet_apply_spatial bf16 over 2 bands: relative L2 to "
             f"float32 {r16} > 1.1 x the dense bf16 {r_dense}")
    print(f"birefnet_apply_spatial at 1024 over 2 bands: float32 relative L2 "
          f"{r:.3e}, max|diff| {err:.3e} to birefnet_apply (limit 1e-5); "
          f"bf16 relative L2 to the float32 logits {r16:.3e} (dense bf16 "
          f"{r_dense:.3e}; limit 1.1x) [BiRefNet: "
          f"{time.perf_counter() - t1:.1f} s]", flush=True)
    del got, want, x, m16, got16, dense16
    pmesh.clear_replicas()

    # -- the (dp, sp) train step ----------------------------------------------
    t1 = time.perf_counter()
    lr = 1e-3
    tcfg = bstep.BiRefNetTrainConfig(learning_rate=lr)
    step = bstep.make_birefnet_train_step(cfg, tcfg)
    for dp, sp in BAND_TRAIN:
        rng = np.random.default_rng(40 + dp)
        batch = {"images": rng.standard_normal((dp, 1024, 1024, 3)
                                               ).astype(np.float32),
                 "masks": (rng.random((dp, 1024, 1024)) > 0.5
                           ).astype(np.float32)}
        md, mb = copy.deepcopy(model), copy.deepcopy(model)
        (_, _), g1 = pstep.loss_and_grads(bstep.birefnet_loss, md, cfg, batch,
                                          tcfg)
        od = bstep.init_birefnet_train_state(md, tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        _, _, l1, _ = step(md, od, batch)
        torch.cuda.synchronize()
        ms_dense = (time.perf_counter() - t) * 1e3
        peak_dense = torch.cuda.max_memory_allocated() / 2**30
        mesh = pmesh.Mesh(np.asarray([[dev] * sp] * dp, dtype=object),
                          ("dp", "sp"))
        mb, ob, placed = bstep.place_birefnet_train_state(
            mb, bstep.init_birefnet_train_state(mb, tcfg), batch, mesh)
        (_, _), g2 = pstep.mesh_loss_and_grads(bstep.birefnet_loss, mb, cfg,
                                               placed, tcfg, 1, tp=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        zero_counters()
        t = time.perf_counter()
        _, _, l2, _ = step(mb, ob, placed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        launched = {k: v for k, v in counters().items() if v}
        if launched:
            fail(f"train over (dp {dp}, sp {sp}) launched {launched}")
        if not abs(float(l2) - float(l1)) <= 1e-5 * abs(float(l1)):
            fail(f"train over (dp {dp}, sp {sp}): loss {float(l2)} != the "
                 f"dense step's {float(l1)} (relative 1e-5)")
        # Printed, not held: a deform offset's gradient jumps where a
        # sample crosses a pixel edge, which a rounding moves.
        worst, leaf = grads_close(torch, g2, {k: v.cpu() for k, v in g1.items()},
                                  float("inf"))
        pb, pd = pstep.leaves(mb), pstep.leaves(md)
        flipped = 0
        for k, w in pd.items():
            small = (g1[k].abs() < 1e-6) | (g2[k].abs() < 1e-6)
            d = (pb[k] - w).abs()
            if small.any() and not float(d[small].max()) <= 1e-6 + 2 * lr:
                fail(f"train over (dp {dp}, sp {sp}): parameter {k} moved "
                     f"{float(d[small].max())} apart at a small gradient")
            flipped += int((d[small] > 1e-6 + lr).sum())
            ok = d[~small] <= 5e-5 + 1e-4 * w[~small].abs()
            if not bool(ok.all()):
                fail(f"train over (dp {dp}, sp {sp}): parameter {k} off the "
                     f"dense step's by {float(d[~small].max())} (atol 5e-5, "
                     f"rtol 1e-4)")
        print(f"BiRefNet_lite train step float32 B={dp} over (dp {dp}, sp "
              f"{sp}) on [cuda:0] x {dp * sp}: loss {float(l2):.6f} against "
              f"the dense step's {float(l1):.6f}; parameters within atol "
              f"5e-5, rtol 1e-4 ({flipped} small-gradient elements moved "
              f"apart by Adam's sign); gradients' largest relative L2 "
              f"{worst:.3e} ({leaf}); no kernel launched; on {gpu_line}: "
              f"mesh_call_ms {ms:.1f} (one step; the dense step {ms_dense:.1f}"
              f"), train_peak_gib {peak:.3f} ({resident / 2**30:.3f} "
              f"resident before; the dense step {peak_dense:.3f})",
              flush=True)
        del md, mb, od, ob, placed, g1, g2
        pmesh.clear_replicas()
        torch.cuda.empty_cache()
    print(f"phase 13, train: {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def memoize_seeded_init(torch, sam_module) -> None:
    """Seeded random SAM weights made once per (config, seed) in this
    process: the first ``sam_module.init_sam`` call with a fresh generator
    draws them on the host (seconds for ViT-H), later calls of the same
    config and seed get a copy (the generator is then left undrawn; a
    generator already drawn from always takes the real init). The phases
    build the same seeded models many times (every random-weights
    Environment, phase 4's plain and float32 twins, phase 9's quantised
    ones): a copy holds the same numbers, so no check changes."""
    import copy

    real, cache = sam_module.init_sam, {}

    def init_sam(gen, cfg):
        seed = gen.initial_seed()
        if not torch.equal(gen.get_state(),
                           torch.Generator().manual_seed(seed).get_state()):
            return real(gen, cfg)
        if (cfg, seed) not in cache:
            cache[cfg, seed] = real(gen, cfg)
        return copy.deepcopy(cache[cfg, seed])

    sam_module.init_sam = init_sam


def c_pixels(ctypes, np, arr, pad: int):
    """A C caller's pixel buffer holding `arr` (h, w, c) in rows of
    w * c + pad bytes (the padding a pattern no pixel copy may read) ->
    (the ctypes array, the stride argument: 0 for packed rows)."""
    h, w, c = arr.shape
    stride = w * c + pad
    buf = (ctypes.c_uint8 * (stride * h))()
    rows = np.frombuffer(buf, np.uint8).reshape(h, stride)
    rows[:] = 77
    rows[:, :w * c] = arr.reshape(h, w * c)
    return buf, (stride if pad else 0)


def c_masks(ctypes, n: int, size: int):
    """n caller-owned mask buffers of `size` bytes and their addresses."""
    bufs = [(ctypes.c_uint8 * size)() for _ in range(n)]
    return bufs, [ctypes.addressof(b) for b in bufs]


def same_bytes(np, buf, image, label, phase: int = 14) -> None:
    want = np.ascontiguousarray(image.pixels).tobytes()
    if bytes(buf) != want:
        got = np.frombuffer(buf, np.uint8)
        fail(f"phase {phase} {label}: the caller's buffer differs from the "
             f"direct call's mask in "
             f"{int((got != np.frombuffer(want, np.uint8)).sum())} of "
             f"{len(want)} bytes")


def same_accuracies(acc, masks, label, phase: int = 14) -> None:
    err = max(abs(acc[i] - m.accuracy) for i, m in enumerate(masks))
    if not err <= 1e-6:
        fail(f"phase {phase} {label}: accuracies differ from the direct call's "
             f"by {err} (limit 1e-6)")


def counted(torch, counters, zero_counters, fn):
    """fn() with the launch counters zeroed just before and read just
    after: -> (fn's result, the launches)."""
    zero_counters()
    out = fn()
    torch.cuda.synchronize()
    return out, counters()


def expect_launches(counts, want, label, phase: int = 14) -> None:
    expect = {k: want.get(k, 0) for k in counts}
    if counts != expect:
        fail(f"phase {phase} {label}: kernel launches {counts} != {expect}")
    print(f"phase {phase} {label}: launches "
          f"{({k: v for k, v in counts.items() if v})} exactly", flush=True)


def paired_ms(torch, fa, fb, n: int = 20):
    """Medians of n host-clock walls of fa and of fb, their calls
    interleaved, each ending in a device synchronise."""
    fa(), fb()
    torch.cuda.synchronize()
    ta, tb = [], []
    for _ in range(n):
        for f, ts in ((fa, ta), (fb, tb)):
            t = time.perf_counter()
            f()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ta), statistics.median(tb)


def bridge_queries(np, rng, w: int, h: int):
    """Phase 14's prompts on a w x h image: a point, a region, the point of
    the three masks, and BRIDGE_BATCH mixed prompts as the C ABI passes
    them (a flat int tuple of 4 a prompt, is_region flags)."""
    point, point3 = (w // 2, h // 2), (w // 4, h // 2)
    region = (w // 8, h // 8, w * 7 // 8, h * 7 // 8)
    flat, is_region = [], []
    for i in range(BRIDGE_BATCH):
        x0, x1 = sorted(int(v) for v in rng.integers(0, w, 2))
        y0, y1 = sorted(int(v) for v in rng.integers(0, h, 2))
        is_region.append(i % 2)
        flat += [x0, y0, x1 + 1, y1 + 1] if i % 2 else [x0, y0, 0, 0]
    return point, region, point3, tuple(flat), tuple(is_region)


def bridge_process_and_masks(ctypes, nb, env, buf, stride, w, h, code, q):
    """`process` of a caller's buffer and the mask entry points on it, all
    through the bridge, the masks into caller buffers: -> (the
    Segmentation, (the point and region masks, the three masks, their
    accuracies, the batch's masks, its accuracies))."""
    point, region, point3, flat, is_region = q
    n = w * h
    seg = nb.process(env, ctypes.addressof(buf), w, h, code, stride)
    one, one_p = c_masks(ctypes, 2, n)
    nb.compute_mask(seg, point, None, [one_p[0], 0, 0], 0)
    nb.compute_mask(seg, None, region, [one_p[1], 0, 0], 0)
    three, three_p = c_masks(ctypes, 3, n)
    acc3 = (ctypes.c_float * 3)()
    nb.compute_mask(seg, point3, None, three_p, ctypes.addressof(acc3))
    batch, batch_p = c_masks(ctypes, BRIDGE_BATCH, n)
    accb = (ctypes.c_float * BRIDGE_BATCH)()
    nb.compute_mask_batch(seg, flat, is_region, BRIDGE_BATCH, batch_p,
                          ctypes.addressof(accb))
    return seg, (one, three, acc3, batch, accb)


def hold_masks_against_direct(np, dl, direct, q, outs, label,
                              phase: int = 14) -> None:
    """The mask buffers and accuracies the bridge (phase 14) or the C
    library (phase 15) filled (``outs`` as ``bridge_process_and_masks``
    returns them) against the same queries through the Python API on
    `direct`: bytes equal, accuracies within 1e-6."""
    point, region, point3, flat, is_region = q
    one, three, acc3, batch, accb = outs
    same_bytes(np, one[0], direct.compute_mask(dl.Point(*point)),
               f"{label} point", phase)
    same_bytes(np, one[1], direct.compute_mask(dl.Region(
        dl.Point(*region[:2]), dl.Point(*region[2:]))), f"{label} region",
        phase)
    masks = direct.compute_masks(dl.Point(*point3))
    for i, m in enumerate(masks):
        same_bytes(np, three[i], m.image, f"{label} mask {i} of three", phase)
    same_accuracies(acc3, masks, f"{label} three masks", phase)
    prompts = [dl.Region(dl.Point(*flat[4 * i:4 * i + 2]),
                         dl.Point(*flat[4 * i + 2:4 * i + 4]))
               if is_region[i] else dl.Point(*flat[4 * i:4 * i + 2])
               for i in range(BRIDGE_BATCH)]
    masks = direct.compute_mask_batch(prompts)
    for i, m in enumerate(masks):
        same_bytes(np, batch[i], m.image, f"{label} batch mask {i}", phase)
    same_accuracies(accb, masks, f"{label} batch", phase)
    shares = [round(float(np.frombuffer(b, np.uint8).mean() / 255), 3)
              for b in one + three]
    print(f"phase {phase} {label}: 2 + 3 + {BRIDGE_BATCH} masks and "
          f"accuracies equal to the direct calls' (foreground shares "
          f"{shares})", flush=True)


def drive_bridge(torch, np, dl, counters, zero_counters, gpu_line, root,
                 model_dir):
    """Phase 14, the C ABI's bridge (native_bridge.py) on cuda:0 at full
    width, every call with ctypes buffers exactly as native/src/capi.cpp
    passes them: a full-width official-layout MobileSAM checkpoint
    (tests/_torch_official_sd.py, from the port's seeded tree) saved with
    torch.save and converted by ``python -m
    dlimgedit_tpu_torch.convert.mobile_sam`` into `model_dir` (phase 15
    serves it again);
    ``create_environment(1, dir)`` with DLIMG_ALLOW_RANDOM_WEIGHTS=0 must
    serve exactly what the converter wrote. MobileSAM at 1024:
    `process` of BRIDGE_IMAGES, a point and a region mask, the three
    masks with their accuracies, a batch of 16 mixed prompts, and on the
    first image `generate_masks` (grid 32, 64 slots); ViT-B (seeded random
    weights, rel-pos tables, pos_embed and qkv biases as phase 4)
    `process` and a point mask; BiRefNet_lite `general` (offsets seeded
    nonzero as phase 8) through `run_segment_objects`; a PNG saved and
    loaded. Every buffer byte for byte against the same call through the
    port's Python API (its Image a contiguous copy in the declared channel
    order), accuracies within 1e-6; the launches of each bridge call
    exact (22 K1 and 10 K2 a MobileSAM `process`, phase 4's ViT-B counts,
    one greedy_nms a `generate_masks`, none for BiRefNet). Prints the
    converter's seconds and the bridge's wall against the direct call's."""
    import ctypes

    from dlimgedit_tpu_torch import native_bridge as nb
    from dlimgedit_tpu_torch.convert import mobile_sam as conv
    from dlimgedit_tpu_torch.convert.from_numpy import (
        numpy_from_params,
        params_from_numpy,
    )
    from dlimgedit_tpu_torch.models import sam as sam_lib
    from dlimgedit_tpu_torch.models.birefnet import seed_nonzero_init
    from dlimgedit_tpu_torch.utils.pytree_io import flatten_tree, load_pytree

    sys.path.insert(0, str(root / "tests"))
    from _torch_official_sd import as_tensors, official_sam_state_dict

    t0 = time.perf_counter()
    saved = {k: os.environ.get(k) for k in BRIDGE_VARS}
    try:
        (model_dir / "segmentation").mkdir(parents=True)
        # -- the converted bundle ------------------------------------------
        tree = numpy_from_params(sam_lib.init_sam(
            torch.Generator().manual_seed(0), sam_lib.make_config("mobile_sam")))
        # The init's conv + BN affines are (1, 0): seeded ones instead, so
        # the converter's fold of the BatchNorm statistics does arithmetic.
        bn_rng = np.random.default_rng(140)
        for leaf in flatten_tree(tree):
            node = tree
            for part in leaf.split("/")[:-1]:
                node = node[int(part)] if isinstance(node, list) else node[part]
            if "scale" in node and np.ndim(node.get("w")) == 4:
                n = node["scale"].shape
                node["scale"] = bn_rng.uniform(0.5, 1.5, n).astype(np.float32)
                node["bias"] = (0.1 * bn_rng.standard_normal(n)).astype(np.float32)
        src = model_dir / "mobile_sam.pt"
        torch.save(as_tensors(official_sam_state_dict(tree, "mobile_sam", 14)),
                   src)
        dst = model_dir / "segmentation" / "mobile_sam.npz"
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "dlimgedit_tpu_torch.convert.mobile_sam",
             str(src), str(dst)], cwd=root, capture_output=True, text=True,
            timeout=600)
        cli_s = time.perf_counter() - t
        if r.returncode != 0:
            fail(f"phase 14: the converter failed: {r.stderr[-2000:]}")
        t = time.perf_counter()
        again = flatten_tree(conv.convert_checkpoint(conv.load_state_dict(str(src))))
        conv_s = time.perf_counter() - t
        written, seeded = flatten_tree(load_pytree(dst)), flatten_tree(tree)
        if set(written) != set(seeded) or any(
                not np.array_equal(written[k], again[k]) for k in written):
            fail("phase 14: the converter's .npz is not the converted tree")
        fold = max(float(np.abs(written[k] - seeded[k]).max()
                         / max(float(np.abs(seeded[k]).max()), 1e-30))
                   for k in seeded)
        if not fold <= 1e-6:
            fail(f"phase 14: the converted tree is {fold} (relative) off the "
                 f"seeded tree")
        n_params = sum(v.size for v in seeded.values())
        print(f"phase 14 converter mobile_sam at full width on the host of "
              f"{gpu_line} ({n_params} "
              f"parameters, {len(seeded)} leaves, official layout with "
              f"BatchNorm statistics): the CLI {cli_s:.2f} s (a fresh "
              f"interpreter: imports, torch.load, conversion, .npz), the "
              f"load and conversion alone {conv_s:.2f} s; the folds within "
              f"{fold:.2e} (relative) of the seeded tree", flush=True)

        os.environ.update({"DLIMG_ALLOW_RANDOM_WEIGHTS": "0",
                           "DLIMG_SAM_IMAGE_SIZE": "1024",
                           "DLIMG_COMPUTE_DTYPE": "bfloat16",
                           "DLIMG_AMG_GRID": str(BRIDGE_AMG_GRID)})
        for k in ("DLIMG_SAM_VARIANT", "DLIMG_COMPILATION_CACHE",
                  "DLIMG_SCALEOUT_DEVICES", "DLIMG_BIREFNET_TEST_SLIM",
                  "DLIMG_BIREFNET_RESOLUTION"):
            os.environ.pop(k, None)
        if not (nb.backend_supported(0) and nb.backend_supported(1)):
            fail("phase 14: backend_supported(1) is False on the card")
        env = nb.create_environment(1, str(model_dir))
        if env.device != torch.device("cuda", 0) or env.options.allow_random_weights:
            fail(f"phase 14: create_environment(1, ...) gave {env.device}, "
                 f"random weights {env.options.allow_random_weights}")
        served = env.sam_model().model.state_dict()
        want = params_from_numpy(load_pytree(dst))
        if set(served) != set(want) or any(
                not torch.equal(v.cpu(), want[k].to(v.dtype))
                for k, v in served.items()):
            fail("phase 14: the card does not serve the converted bundle")
        print(f"phase 14: create_environment(1, dir) on {env.device} serves "
              f"the converted bundle ({len(served)} leaves, encoder "
              f"{env.compute_dtype}, equal to the .npz cast)", flush=True)

        # -- MobileSAM through the bridge, then the direct calls ------------
        codes = {1: dl.Channels.mask, 3: dl.Channels.rgb, 4: dl.Channels.rgba,
                 5: dl.Channels.bgra, 6: dl.Channels.argb}
        rng = np.random.default_rng(14)
        runs = []
        for w, h, code, pad, seed in BRIDGE_IMAGES:
            nch = 4 if code in (5, 6) else code
            arr = rgba(np, h, w, seed)[:, :, :nch]
            buf, stride = c_pixels(ctypes, np, arr, pad)
            q = bridge_queries(np, rng, w, h)
            (seg, outs), counts = counted(
                torch, counters, zero_counters,
                lambda: bridge_process_and_masks(ctypes, nb, env, buf, stride,
                                                 w, h, code, q))
            label = f"MobileSAM {w}x{h} code {code} stride {stride}"
            expect_launches(counts, {"fused_layer_norm": LN_PER_PROCESS,
                                     "levit_window_attention": ATTN_PER_PROCESS},
                            f"{label}: process, 2 + 3 + {BRIDGE_BATCH} masks")
            if nb.segmentation_extent(seg) != (w, h):
                fail(f"phase 14 {label}: extent {nb.segmentation_extent(seg)}")
            img = dl.Image(dl.Extent(w, h), codes[code], np.ascontiguousarray(arr))
            direct = dl.Segmentation.process(img, env)
            if not torch.equal(seg.embedding, direct.embedding):
                fail(f"phase 14 {label}: the bridge's embedding differs from "
                     f"the direct call's")
            hold_masks_against_direct(np, dl, direct, q, outs, label)
            point = q[0]
            runs.append((w, h, code, buf, stride, img, seg, direct, point))

        w, h, code, buf, stride, img, seg, direct, point = runs[0]
        iou, stab, nms, slots = BRIDGE_AMG
        gen, gen_p = c_masks(ctypes, slots, w * h)
        accg = (ctypes.c_float * slots)()
        count, counts = counted(torch, counters, zero_counters,
                                lambda: nb.generate_masks(seg, iou, stab, nms,
                                                          slots, gen_p,
                                                          ctypes.addressof(accg)))
        expect_launches(counts, {"greedy_nms": 1},
                        f"generate_masks grid {BRIDGE_AMG_GRID}")
        masks = direct.generate_masks(grid=BRIDGE_AMG_GRID, max_masks=slots,
                                      iou_thresh=iou, stability_thresh=stab,
                                      nms_thresh=nms)
        if count != len(masks) or count < 1:
            fail(f"phase 14 generate_masks: {count} masks through the bridge, "
                 f"{len(masks)} direct")
        for i, m in enumerate(masks):
            same_bytes(np, gen[i], m.image, f"generated mask {i}")
        same_accuracies(accg, masks, "generate_masks")
        print(f"phase 14 generate_masks MobileSAM {w}x{h}: {count} masks and "
              f"accuracies equal to the direct call's", flush=True)

        pacc = (ctypes.c_float * 3)()
        mbuf, mptr = c_masks(ctypes, 1, w * h)
        process_ms = paired_ms(
            torch, lambda: nb.process(env, ctypes.addressof(buf), w, h, code,
                                      stride),
            lambda: dl.Segmentation.process(img, env))
        mask_ms = paired_ms(
            torch, lambda: nb.compute_mask(seg, point, None, [mptr[0], 0, 0],
                                           ctypes.addressof(pacc)),
            lambda: direct.compute_mask(dl.Point(*point)))
        print(f"e2e bridge MobileSAM {w}x{h} on {gpu_line}: process_ms "
              f"bridge={process_ms[0]:.3f} direct={process_ms[1]:.3f}; "
              f"mask_ms bridge={mask_ms[0]:.3f} direct={mask_ms[1]:.3f} "
              f"(medians of 20, the two calls interleaved; the bridge wraps "
              f"the caller's pointer and copies the mask into its buffer)",
              flush=True)
        del runs, seg, direct, env, served
        torch.cuda.empty_cache()

        # -- ViT-B and BiRefNet on seeded random weights ---------------------
        os.environ.update({"DLIMG_SAM_VARIANT": "vit_b",
                           "DLIMG_ALLOW_RANDOM_WEIGHTS": "1"})
        env_b = nb.create_environment(1, str(model_dir))
        seed_vit_extras(torch, env_b.sam_model("vit_b").model)
        w, h, code, pad, seed = BRIDGE_IMAGES[0]
        arr = rgba(np, h, w, seed)
        buf, stride = c_pixels(ctypes, np, arr, pad)
        vmask, vptr = c_masks(ctypes, 1, w * h)

        def vit_calls():
            s = nb.process(env_b, ctypes.addressof(buf), w, h, code, stride)
            nb.compute_mask(s, (w // 2, h // 2), None, [vptr[0], 0, 0], 0)
            return s

        vseg, counts = counted(torch, counters, zero_counters, vit_calls)
        expect_launches(counts, VIT_PER_PROCESS, f"ViT-B {w}x{h}: process, a mask")
        img = dl.Image(dl.Extent(w, h), dl.Channels.rgba, arr)
        vdirect = dl.Segmentation.process(img, env_b)
        if not torch.equal(vseg.embedding, vdirect.embedding):
            fail("phase 14 ViT-B: the bridge's embedding differs from the "
                 "direct call's")
        same_bytes(np, vmask[0], vdirect.compute_mask(dl.Point(w // 2, h // 2)),
                   "ViT-B point")
        print(f"phase 14 ViT-B {w}x{h}: embedding and mask equal to the direct "
              f"calls'", flush=True)
        del vseg, vdirect

        b = env_b.birefnet_model("general")
        if (b.cfg.img_size, b.cfg.swin.embed_dim, b.compute_dtype) != (
                1024, 96, torch.bfloat16):
            fail(f"phase 14 BiRefNet: not BiRefNet_lite general in bf16 "
                 f"({b.cfg.img_size}, {b.cfg.swin.embed_dim}, {b.compute_dtype})")
        seed_nonzero_init(b.model)
        out, optr = c_masks(ctypes, 1, w * h)
        _, counts = counted(torch, counters, zero_counters,
                            lambda: nb.run_segment_objects(
                                env_b, ctypes.addressof(buf), w, h, code,
                                stride, optr[0]))
        expect_launches(counts, {}, f"run_segment_objects {w}x{h}")
        mask = dl.segment_objects(img, env_b)
        same_bytes(np, out[0], mask, "run_segment_objects")
        px = np.frombuffer(out[0], np.uint8)
        if px.min() == px.max():
            fail("phase 14 run_segment_objects: a constant mask")
        print(f"phase 14 run_segment_objects BiRefNet_lite general {w}x{h}: "
              f"mask equal to segment_objects' (uint8 {px.min()}..{px.max()}, "
              f"mean {px.mean():.2f})", flush=True)
        del env_b, b
        torch.cuda.empty_cache()

        # -- image files ------------------------------------------------------
        for code, pad in ((3, 40), (1, 7)):
            arr = rgba(np, 120, 160, 5)[:, :, :code]
            buf, stride = c_pixels(ctypes, np, arr, pad)
            mine, theirs = model_dir / "bridge.png", model_dir / "direct.png"
            nb.save_image(ctypes.addressof(buf), 160, 120, code, stride,
                          str(mine))
            dl.Image(dl.Extent(160, 120), codes[code], arr).save(str(theirs))
            if mine.read_bytes() != theirs.read_bytes():
                fail(f"phase 14 save_image code {code}: the file differs from "
                     f"Image.save's")
            if nb.load_image(str(mine)) != (160, 120, code, arr.tobytes()):
                fail(f"phase 14 load_image code {code}: not the saved pixels")
        print("phase 14 save_image / load_image: PNG bytes equal to "
              "Image.save's, pixels read back", flush=True)
    finally:
        restore_vars(saved)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)


def restore_vars(saved) -> None:
    """Put the environment variables back as `saved` holds them."""
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def foreign_modules() -> list:
    """jax and the JAX package, where this process imported them."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "dlimgedit_tpu"))


def compute_apps() -> list:
    """The PIDs nvidia-smi lists as compute processes on the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()


class Daemon:
    """The port's dlimg-serve as a process of its own, its output drained
    by a thread (a full pipe would block the embedded interpreter while it
    holds the GIL) and kept for a failure's message."""

    def __init__(self, exe, args, apps_before):
        """Start it; `apps_before` are the card's compute processes before
        it (``compute_apps``)."""
        self.apps_before = apps_before
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([str(exe), "--port", "0", *args],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lines = []

    def wait_listening(self) -> None:
        """Read its output up to the line with the port it listens on."""
        while True:
            line = self.proc.stdout.readline()
            if not line:
                fail(f"phase 15: dlimg-serve exited before it listened "
                     f"(exit {self.proc.wait()}): {''.join(self.lines)[-3000:]}")
            self.lines.append(line)
            if "listening on" in line:
                break
            if time.perf_counter() - self.t0 > 300:
                self.stop()
                fail("phase 15: dlimg-serve did not listen within 300 s")
        self.start_s = time.perf_counter() - self.t0
        self.port = int(line.split(":")[-1].split()[0])
        import threading

        self.drain = threading.Thread(target=self._drain, daemon=True)
        self.drain.start()

    def _drain(self):
        for line in self.proc.stdout:
            self.lines.append(line)

    def request(self, method, path, data=None):
        """-> (status, body, wall ms)."""
        import urllib.error
        import urllib.request

        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}",
                                     data=data, method=method)
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                status, body = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read()
        return status, body, (time.perf_counter() - t) * 1e3

    def ok(self, method, path, data=None):
        status, body, ms = self.request(method, path, data)
        if status not in (200, 204):
            self.stop()
            fail(f"phase 15: {method} {path}: HTTP {status} {body[:500]!r}; "
                 f"dlimg-serve said: {''.join(self.lines)[-2000:]}")
        return body, ms

    def stop(self) -> int:
        """SIGTERM, then the exit code (killed after 60 s)."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
                return -9
        return self.proc.returncode


def timed_ms(fn) -> float:
    t = time.perf_counter()
    fn()
    return (time.perf_counter() - t) * 1e3


def png_bytes(arr) -> bytes:
    from PIL import Image as PILImage

    buf = io.BytesIO()
    PILImage.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def png_pixels(np, data: bytes):
    from PIL import Image as PILImage

    return np.asarray(PILImage.open(io.BytesIO(data)))


def served_equal(np, data: bytes, image, label) -> None:
    """A PNG the daemon served, decoded, against a direct call's mask."""
    got = png_pixels(np, data)
    want = np.ascontiguousarray(image.pixels).reshape(got.shape)
    if not np.array_equal(got, want):
        fail(f"phase 15 {label}: the served mask differs from the direct "
             f"call's in {int((got != want).sum())} of {got.size} pixels")


def library_calls(ctypes, np, api, handle, buf, stride, w, h, code, q):
    """`process` of a caller's buffer and the mask entries on it, all
    through the C library's table: -> (the segmentation handle, outputs
    as ``bridge_process_and_masks`` returns them)."""
    from dlimgedit_tpu_torch.native_build import DlimgImageView

    u8p = ctypes.POINTER(ctypes.c_uint8)
    point, region, point3, flat, is_region = q
    n = w * h

    def ok(rc, what):
        if rc != 0:
            fail(f"phase 15 {what}: rc {rc}: {api.last_error().decode()}")

    def ptrs(bufs, slots=None):
        p = [ctypes.cast(b, u8p) for b in bufs]
        return (u8p * (slots or len(p)))(*p)

    view = DlimgImageView(width=w, height=h, channels=code, stride=stride,
                          pixels=ctypes.cast(buf, u8p))
    seg = ctypes.c_void_p()
    ok(api.process_image_for_segmentation(ctypes.byref(seg),
                                          ctypes.byref(view), handle),
       "process")
    one, _ = c_masks(ctypes, 2, n)
    ok(api.get_segmentation_mask(seg, (ctypes.c_int * 2)(*point), None,
                                 ptrs(one[:1], 3), None), "point mask")
    ok(api.get_segmentation_mask(seg, None, (ctypes.c_int * 4)(*region),
                                 ptrs(one[1:], 3), None), "region mask")
    three, _ = c_masks(ctypes, 3, n)
    acc3 = (ctypes.c_float * 3)()
    ok(api.get_segmentation_mask(seg, (ctypes.c_int * 2)(*point3), None,
                                 ptrs(three), acc3), "three masks")
    batch, _ = c_masks(ctypes, BRIDGE_BATCH, n)
    accb = (ctypes.c_float * BRIDGE_BATCH)()
    ok(api.compute_mask_batch(seg, (ctypes.c_int * len(flat))(*flat),
                              (ctypes.c_int * BRIDGE_BATCH)(*is_region),
                              BRIDGE_BATCH, ptrs(batch), accb), "batch")
    return seg, (one, three, acc3, batch, accb)


class Host:
    """A C host as a process of its own, started from the directory that
    holds `model_dir` (test_cpp_api's ./models); a thread waits for it,
    so its seconds are its own."""

    def __init__(self, cmd, model_dir):
        import threading

        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=model_dir.parent,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     env={**os.environ,
                                          "TMPDIR": str(model_dir)})
        self.out = None
        self.waiter = threading.Thread(target=self._wait, daemon=True)
        self.waiter.start()

    def _wait(self):
        self.out = self.proc.communicate()
        self.seconds = time.perf_counter() - self.t0

    def result(self):
        """-> (exit code, stdout, stderr, seconds), once it has ended."""
        self.waiter.join(timeout=600)
        if self.out is None:
            self.proc.kill()
            fail(f"phase 15: {self.proc.args[0]} ran over 600 s")
        return self.proc.returncode, *self.out, self.seconds

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()


def drive_c_hosts(torch, np, dl, counters, zero_counters, gpu_line,
                  model_dir):
    """Phase 15, the C hosts through the port's own C library on cuda:0
    (the module docstring's item 15)."""
    import ctypes

    from dlimgedit_tpu_torch import native_bridge as nb
    from dlimgedit_tpu_torch import native_build
    from dlimgedit_tpu_torch.convert.from_numpy import numpy_from_params
    from dlimgedit_tpu_torch.models import birefnet as bn
    from dlimgedit_tpu_torch.utils.pytree_io import save_pytree

    t0 = time.perf_counter()
    saved = {k: os.environ.get(k) for k in BRIDGE_VARS}
    running, daemon = {}, None
    try:
        # -- 1. the build ------------------------------------------------------
        t = time.perf_counter()
        build = native_build.build()
        print(f"phase 15 native build: {time.perf_counter() - t:.2f} s "
              f"({'built' if build.seconds is not None else 'found built'}), "
              f"compiler {build.compiler}, codecs "
              f"{list(build.codecs) or 'none: PNG through the bridge (Pillow)'}"
              f" -> {build.directory}", flush=True)
        # BiRefNet_lite general, seeded nonzero offsets, as a bundle file.
        t = time.perf_counter()
        save_pytree(model_dir / "segmentation" / "birefnet_general.npz",
                    numpy_from_params(seeded_birefnet(
                        bn, torch, bn.BiRefNetConfig(img_size=1024))))
        print(f"phase 15: BiRefNet_lite general bundle written in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        os.environ.update({"DLIMG_ALLOW_RANDOM_WEIGHTS": "0",
                           "DLIMG_SAM_IMAGE_SIZE": "1024",
                           "DLIMG_COMPUTE_DTYPE": "bfloat16",
                           "DLIMG_AMG_GRID": str(BRIDGE_AMG_GRID)})
        for k in ("DLIMG_SAM_VARIANT", "DLIMG_COMPILATION_CACHE",
                  "DLIMG_SCALEOUT_DEVICES", "DLIMG_BIREFNET_TEST_SLIM",
                  "DLIMG_BIREFNET_RESOLUTION"):
            os.environ.pop(k, None)

        # The C hosts that are processes of their own start now, each a fresh
        # interpreter importing torch (~8 s): dlimg segment, the C++ tests
        # and the daemon run alongside the in-process checks below, and
        # are done or idle before anything is timed.
        apps_before = compute_apps()
        w, h, _, _, seed = BRIDGE_IMAGES[0]
        cli_in = rgba(np, h, w, seed)
        (model_dir / "cli.png").write_bytes(png_bytes(cli_in))
        cli_point = (w // 3, h // 2)
        hosts = {
            "dlimg segment --backend gpu": [
                str(build.executable("dlimg")), "segment",
                str(model_dir / "cli.png"), "--backend", "gpu", "--models",
                str(model_dir), "--point", f"{cli_point[0]},{cli_point[1]}",
                "-o", str(model_dir / "cli_mask.png"), "--time"],
            "test_cpp_api gpu": [str(build.executable("test_cpp_api")), "gpu"],
            "test_cpp_dynamic": [str(build.executable("test_cpp_dynamic")),
                                 str(build.library)]}
        running = {name: Host(cmd, model_dir) for name, cmd in hosts.items()}
        daemon = Daemon(build.executable("dlimg-serve"), [
            "--backend", "gpu", "--models", str(model_dir), "--threads", "4",
            "--batch-window-ms", str(SERVE_WINDOW_MS)], apps_before)

        # -- 2. the library in this interpreter --------------------------------
        if foreign_modules():
            fail(f"phase 15: imported before the library: {foreign_modules()}")
        api = native_build.load_api(build.library)
        if api.is_backend_supported(1) != 1:
            fail(f"phase 15: the library reports no backend 1: "
                 f"{api.last_error().decode()}")
        handle = ctypes.c_void_p()
        opts = native_build.DlimgOptions(backend=1,
                                         model_directory=str(model_dir).encode())
        if api.create_environment(ctypes.byref(handle), ctypes.byref(opts)):
            fail(f"phase 15 create_environment: {api.last_error().decode()}")
        denv = nb.create_environment(1, str(model_dir))  # the direct calls'
        rng = np.random.default_rng(15)
        runs = []
        for w, h, code, pad, seed in BRIDGE_IMAGES:
            nch = 4 if code in (5, 6) else code
            arr = rgba(np, h, w, seed)[:, :, :nch]
            buf, stride = c_pixels(ctypes, np, arr, pad)
            q = bridge_queries(np, rng, w, h)
            label = f"library MobileSAM {w}x{h} code {code} stride {stride}"
            (seg, outs), counts = counted(
                torch, counters, zero_counters,
                lambda: library_calls(ctypes, np, api, handle, buf, stride, w,
                                      h, code, q))
            expect_launches(counts, {"fused_layer_norm": LN_PER_PROCESS,
                                     "levit_window_attention": ATTN_PER_PROCESS},
                            f"{label}: process, 2 + 3 + {BRIDGE_BATCH} masks",
                            15)
            extent = (ctypes.c_int * 2)()
            api.get_segmentation_extent(seg, extent)
            if (extent[0], extent[1]) != (w, h):
                fail(f"phase 15 {label}: extent {tuple(extent)}")
            img = dl.Image(dl.Extent(w, h), {4: dl.Channels.rgba,
                                             5: dl.Channels.bgra}[code],
                           np.ascontiguousarray(arr))
            direct = dl.Segmentation.process(img, denv)
            hold_masks_against_direct(np, dl, direct, q, outs, label, 15)
            runs.append((w, h, code, buf, stride, img, seg, direct, q[0]))

        w, h, code, buf, stride, img, seg, direct, point = runs[0]
        iou, stab, nms, slots = BRIDGE_AMG
        gen, _ = c_masks(ctypes, slots, w * h)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        accg = (ctypes.c_float * slots)()
        count = ctypes.c_int(-1)

        def generate():
            if api.generate_masks(seg, (ctypes.c_float * 3)(iou, stab, nms),
                                  slots, (u8p * slots)(*[
                                      ctypes.cast(b, u8p) for b in gen]),
                                  accg, ctypes.byref(count)):
                fail(f"phase 15 generate_masks: {api.last_error().decode()}")

        _, counts = counted(torch, counters, zero_counters, generate)
        expect_launches(counts, {"greedy_nms": 1},
                        f"library generate_masks grid {BRIDGE_AMG_GRID}", 15)
        masks = direct.generate_masks(grid=BRIDGE_AMG_GRID, max_masks=slots,
                                      iou_thresh=iou, stability_thresh=stab,
                                      nms_thresh=nms)
        if count.value != len(masks) or count.value < 1:
            fail(f"phase 15 generate_masks: {count.value} masks through the "
                 f"library, {len(masks)} direct")
        for i, m in enumerate(masks):
            same_bytes(np, gen[i], m.image, f"generated mask {i}", 15)
        same_accuracies(accg, masks, "generate_masks", 15)

        view = native_build.DlimgImageView(width=w, height=h, channels=code,
                                           stride=stride,
                                           pixels=ctypes.cast(buf, u8p))
        obj, _ = c_masks(ctypes, 1, w * h)

        def segment_objects():
            if api.segment_objects(ctypes.byref(view),
                                   ctypes.cast(obj[0], u8p), handle):
                fail(f"phase 15 segment_objects: {api.last_error().decode()}")

        _, counts = counted(torch, counters, zero_counters, segment_objects)
        expect_launches(counts, {}, f"library segment_objects {w}x{h}", 15)
        same_bytes(np, obj[0], dl.segment_objects(img, denv),
                   "segment_objects", 15)
        print(f"phase 15 library: generate_masks ({count.value} masks) and "
              f"segment_objects (BiRefNet_lite general) equal to the direct "
              f"calls'", flush=True)

        png_route = ("native libpng" if "libpng" in build.codecs
                     else "the bridge (Pillow)")
        arr = rgba(np, 120, 160, 5)[:, :, :3]
        pbuf, pstride = c_pixels(ctypes, np, arr, 40)
        mine, theirs = model_dir / "library.png", model_dir / "direct.png"
        pview = native_build.DlimgImageView(width=160, height=120, channels=3,
                                            stride=pstride,
                                            pixels=ctypes.cast(pbuf, u8p))
        if api.save_image(ctypes.byref(pview), str(mine).encode()):
            fail(f"phase 15 save_image: {api.last_error().decode()}")
        dl.Image(dl.Extent(160, 120), dl.Channels.rgb, arr).save(str(theirs))
        if "libpng" not in build.codecs and (
                mine.read_bytes() != theirs.read_bytes()):
            fail("phase 15 save_image: the file differs from Image.save's")
        ext, ch, px = (ctypes.c_int * 2)(), ctypes.c_int(), u8p()
        if api.load_image(str(mine).encode(), ext, ctypes.byref(ch),
                          ctypes.byref(px)):
            fail(f"phase 15 load_image: {api.last_error().decode()}")
        got = ctypes.string_at(px, 160 * 120 * 3)
        api.destroy_image(px)
        if (ext[0], ext[1], ch.value) != (160, 120, 3) or got != arr.tobytes():
            fail("phase 15 load_image: not the saved pixels")
        print(f"phase 15 library save_image / load_image of a PNG through "
              f"{png_route}: pixels read back"
              f"{'' if 'libpng' in build.codecs else ', bytes equal to Image.save'}",
              flush=True)

        # -- 4. dlimg segment, test_cpp_api, test_cpp_dynamic, finished ----------
        for name, host in running.items():
            rc, out, err, took = host.result()
            if rc != 0:
                fail(f"phase 15 {name}: exit {rc}: {out[-1000:]} {err[-2000:]}")
            phases = " ".join(line.strip() for line in err.splitlines()
                              if line.startswith("[dlimg]"))
            print(f"phase 15 {name}: exit 0 in {took:.1f} s, alongside the "
                  f"library's checks ({out.strip()}"
                  f"{'; ' + phases if phases else ''})", flush=True)
        cli_seg = dl.Segmentation.process(dl.Image(
            dl.Extent(cli_in.shape[1], cli_in.shape[0]), dl.Channels.rgba,
            cli_in), denv)
        served_equal(np, (model_dir / "cli_mask.png").read_bytes(),
                     cli_seg.compute_mask(dl.Point(*cli_point)),
                     "dlimg segment")
        print("phase 15 dlimg segment: its mask file equal to the direct "
              "call's", flush=True)
        daemon.wait_listening()

        pacc = (ctypes.c_float * 3)()
        one, _ = c_masks(ctypes, 1, w * h)
        slot = (u8p * 3)(ctypes.cast(one[0], u8p), None, None)
        pview = native_build.DlimgImageView(width=w, height=h, channels=code,
                                            stride=stride,
                                            pixels=ctypes.cast(buf, u8p))

        def library_process():
            s = ctypes.c_void_p()
            if api.process_image_for_segmentation(ctypes.byref(s),
                                                  ctypes.byref(pview), handle):
                fail(f"phase 15 process: {api.last_error().decode()}")
            api.destroy_segmentation(s)

        process_ms = paired_ms(torch, library_process,
                               lambda: dl.Segmentation.process(img, denv))
        mask_ms = paired_ms(
            torch, lambda: api.get_segmentation_mask(
                seg, (ctypes.c_int * 2)(*point), None, slot, pacc),
            lambda: direct.compute_mask(dl.Point(*point)))
        print(f"e2e C library MobileSAM {w}x{h} on {gpu_line}: process_ms "
              f"library={process_ms[0]:.3f} direct={process_ms[1]:.3f}; "
              f"mask_ms library={mask_ms[0]:.3f} direct={mask_ms[1]:.3f} "
              f"(medians of 20, the two calls interleaved; the library wraps "
              f"the caller's pointer into the bridge and copies the mask into "
              f"its buffer)", flush=True)
        for r in runs:
            api.destroy_segmentation(r[6])
        api.destroy_environment(handle)
        if foreign_modules():
            fail(f"phase 15: imported after the library: {foreign_modules()}")
        del runs, seg, direct
        torch.cuda.empty_cache()

        # -- 3. dlimg-serve -----------------------------------------------------
        try:
            drive_daemon(np, dl, denv, daemon, gpu_line)
        finally:
            code_ = daemon.stop()
        if code_ != 0:
            fail(f"phase 15: dlimg-serve answered SIGTERM with exit {code_}: "
                 f"{''.join(daemon.lines)[-2000:]}")
        print(f"phase 15 dlimg-serve: sessions deleted, SIGTERM answered with "
              f"exit 0; compute processes on the card after it: "
              f"{compute_apps()}", flush=True)

        del denv
        torch.cuda.empty_cache()
    finally:
        for host in running.values():
            host.kill()
        if daemon is not None:
            daemon.stop()
        restore_vars(saved)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)


def drive_daemon(np, dl, denv, daemon, gpu_line):
    """Phase 15's dlimg-serve on cuda:0 against the direct calls on
    `denv` (an Environment of the daemon's options)."""
    import base64
    from concurrent.futures import ThreadPoolExecutor

    print(f"phase 15 dlimg-serve: listening {daemon.start_s:.1f} s after its "
          f"start (interpreter, torch, the Environment; it started alongside "
          f"the library's checks), PID {daemon.proc.pid}", flush=True)
    info = json.loads(daemon.ok("GET", "/v1/info")[0])
    if (info.get("backend"), info.get("mode")) != ("gpu",
                                                   "embedded-python-pytorch"):
        fail(f"phase 15 /v1/info: {info}")
    images, directs = [], []
    for w, h, code, _, seed in BRIDGE_IMAGES:
        arr = rgba(np, h, w, seed)  # RGBA; phase 14's BGRA buffer holds these
        images.append((w, h, arr, png_bytes(arr)))
        directs.append(dl.Segmentation.process(
            dl.Image(dl.Extent(w, h), dl.Channels.rgba, arr), denv))
    # The first two requests open both sessions at once: the daemon's first
    # process calls, with their warm-ups and captures, run in parallel.
    with ThreadPoolExecutor(2) as pool:
        opened = list(pool.map(lambda im: daemon.ok("POST", "/v1/sessions",
                                                     im[3]), images))
    sids = []
    for (w, h, _, _), (body, ms) in zip(images, opened):
        meta = json.loads(body)
        if (meta["width"], meta["height"]) != (w, h):
            fail(f"phase 15 /v1/sessions: {meta}")
        sids.append(meta["id"])
    times = {"sessions (first, 2 at once)": [ms for _, ms in opened]}
    apps = compute_apps()
    if str(daemon.proc.pid) in apps:
        print(f"phase 15 dlimg-serve: PID {daemon.proc.pid} among the card's "
              f"compute processes {apps}", flush=True)
    elif len(apps) == len(daemon.apps_before) + 1:
        # nvidia-smi reports PIDs of another PID namespace (a container):
        # the daemon shows as one more compute process on the card.
        print(f"phase 15 dlimg-serve: one more compute process on the card "
              f"while it serves ({daemon.apps_before} -> {apps}; nvidia-smi "
              f"reports PIDs outside this PID namespace)", flush=True)
    else:
        fail(f"phase 15: dlimg-serve (PID {daemon.proc.pid}) is not on the "
             f"card: compute processes {daemon.apps_before} before it "
             f"started, {apps} while it serves")
    for im in images:  # a session once the embeddings' graphs exist
        body, ms = daemon.ok("POST", "/v1/sessions", im[3])
        sids.append(json.loads(body)["id"])
        times.setdefault("sessions (again)", []).append(ms)

    (w, h, _, png), direct = images[0], directs[0]
    rng = np.random.default_rng(151)

    def point():
        return int(rng.integers(0, w)), int(rng.integers(0, h))

    def box():
        x0, x1 = sorted(int(v) for v in rng.integers(0, w, 2))
        y0, y1 = sorted(int(v) for v in rng.integers(0, h, 2))
        return x0, y0, x1 + 1, y1 + 1

    def query(v):
        q = (f"box={v[0]},{v[1]},{v[2]},{v[3]}" if len(v) == 4
             else f"point={v[0]},{v[1]}")
        return daemon.ok("POST", f"/v1/sessions/{sids[0]}/mask?{q}")

    def prompt(v):
        return (dl.Region(dl.Point(*v[:2]), dl.Point(*v[2:])) if len(v) == 4
                else dl.Point(*v))

    def batched(v, n):
        return direct.compute_mask_batch([prompt(v)] * n)[0].image

    n_points, n_boxes = SERVE_C1
    c1 = [point() for _ in range(n_points)] + [box() for _ in range(n_boxes)]
    c1_ms = {"point": [], "box": []}
    for v in c1:  # the batch window's single prompts: batches of 1
        body, ms = query(v)
        served_equal(np, body, batched(v, 1), f"concurrency 1 {v}")
        c1_ms["box" if len(v) == 4 else "point"].append(ms)
    times["mask point, concurrency 1"] = c1_ms["point"]
    times["mask box, concurrency 1"] = c1_ms["box"]
    stats0 = json.loads(daemon.ok("GET", "/v1/stats")[0])
    c4 = [point() for _ in range(SERVE_C4)]
    with ThreadPoolExecutor(4) as pool:
        served = list(pool.map(query, c4))
    same_across = 0
    for v, (body, _) in zip(c4, served):
        # The batch a query rode in is not known; every batch of the prompt
        # must give compute_mask's bytes (C5), so the served mask must too.
        got = png_pixels(np, body)
        single = np.ascontiguousarray(
            direct.compute_mask(prompt(v)).pixels).reshape(got.shape)
        refs = {n: np.ascontiguousarray(batched(v, n).pixels).reshape(got.shape)
                for n in SERVE_BATCHES}
        if not (np.array_equal(got, refs[1]) and np.array_equal(got, single)):
            fail(f"phase 15 concurrency 4 {v}: the served mask differs from "
                 f"the prompt's batch of 1 or its compute_mask")
        same_across += all(np.array_equal(single, r) for r in refs.values())
    if same_across != SERVE_C4:
        fail(f"phase 15 concurrency 4: the batches of {SERVE_BATCHES} equal "
             f"compute_mask for only {same_across} of {SERVE_C4} prompts")
    times["mask point, concurrency 4"] = [ms for _, ms in served]
    stats = json.loads(daemon.ok("GET", "/v1/stats")[0])
    calls = stats["batched_calls"] - stats0["batched_calls"]
    if not calls > 0 or stats["batched_prompts"] - stats0["batched_prompts"] \
            != SERVE_C4:
        fail(f"phase 15 concurrency 4: batched_calls {calls}, stats {stats}")
    print(f"phase 15 dlimg-serve: {n_points} point and {n_boxes} box masks at "
          f"concurrency 1 equal to the direct batch of 1; {SERVE_C4} at "
          f"concurrency 4 in {calls} batched calls (largest batch so far "
          f"{stats['largest_batch']}), each equal to the prompt's direct "
          f"batch of 1 and compute_mask; the batches of "
          f"{', '.join(map(str, SERVE_BATCHES))} equal compute_mask bit for "
          f"bit for {same_across} of {SERVE_C4} prompts", flush=True)

    (wb, hb, _, png_b), direct_b = images[1], directs[1]
    pb = (wb // 3, hb // 3)
    body, ms = daemon.ok("POST", f"/v1/sessions/{sids[1]}/mask?point="
                                 f"{pb[0]},{pb[1]}&all=1")
    times["mask all=1"] = [ms]
    served3 = json.loads(body)["masks"]
    want = direct_b.compute_masks(dl.Point(*pb))
    for i, (s, m) in enumerate(zip(served3, want)):
        served_equal(np, base64.b64decode(s["png_base64"]), m.image,
                     f"all=1 mask {i}")
        if not abs(s["accuracy"] - m.accuracy) <= 5e-5:  # printed as %.4f
            fail(f"phase 15 all=1: accuracy {s['accuracy']} != {m.accuracy}")
    if len(served3) != 3:
        fail(f"phase 15 all=1: {len(served3)} masks")
    iou, stab, nms, slots = BRIDGE_AMG
    want = direct.generate_masks(grid=BRIDGE_AMG_GRID, max_masks=slots,
                                 iou_thresh=iou, stability_thresh=stab,
                                 nms_thresh=nms)
    times["auto-masks"], times["segment"], times["remove-bg"] = [], [], []
    seg_point = (w // 2, h // 3)
    want_seg = direct.compute_mask(dl.Point(*seg_point))
    want_obj = dl.segment_objects(
        dl.Image(dl.Extent(w, h), dl.Channels.rgba, images[0][2]), denv)
    body, ms = daemon.ok("POST", f"/v1/sessions/{sids[0]}/auto-masks?"
                                 f"iou={iou}&stability={stab}&nms={nms}"
                                 f"&max={slots}")
    times["auto-masks"].append(ms)
    auto = json.loads(body)["masks"]
    if len(auto) != len(want):
        fail(f"phase 15 /auto-masks: {len(auto)} masks, {len(want)} direct")
    for i, (s, m) in enumerate(zip(auto, want)):
        served_equal(np, base64.b64decode(s["png_base64"]), m.image,
                     f"/auto-masks mask {i}")
    for _ in range(2):
        body, ms = daemon.ok("POST", f"/v1/segment?point={seg_point[0]},"
                                     f"{seg_point[1]}", png)
        times["segment"].append(ms)
        served_equal(np, body, want_seg, "/v1/segment")
        body, ms = daemon.ok("POST", "/v1/remove-bg", png)
        times["remove-bg"].append(ms)
        served_equal(np, body, want_obj, "/v1/remove-bg")
    print(f"phase 15 dlimg-serve: all=1 (3 masks), /auto-masks ({len(want)} "
          f"masks, grid {BRIDGE_AMG_GRID}), /v1/segment and /v1/remove-bg "
          f"(BiRefNet_lite general, twice each) equal to the direct calls'",
          flush=True)
    # The host's share: Pillow's PNG codec in this process on this host
    # (the card's machine has no libpng, so the daemon's PNGs go through
    # Pillow too), on a served mask and on the session image.
    from PIL import Image as PILImage

    mask_px = np.ascontiguousarray(want_seg.pixels).reshape(h, w)
    encode = statistics.median(timed_ms(lambda: PILImage.fromarray(
        mask_px, mode="L").save(io.BytesIO(), format="PNG")) for _ in range(5))
    decode = statistics.median(timed_ms(lambda: png_pixels(np, png))
                               for _ in range(5))
    print(f"phase 15 host PNG codec (Pillow, this process, medians of 5): "
          f"encode of the /v1/segment mask {encode:.1f} ms "
          f"({len(png_bytes(mask_px))} bytes), decode of the session image "
          f"{decode:.1f} ms ({len(png)} bytes)", flush=True)
    summary = "; ".join(
        f"{k} " + (" and ".join(f"{ms:.1f}" for ms in v) + " ms" if len(v) <= 2
                   else f"first {v[0]:.1f} ms, then median "
                        f"{statistics.median(v[1:]):.1f} of {len(v) - 1}")
        for k, v in times.items())
    print(f"e2e dlimg-serve MobileSAM {w}x{h} (masks) on {gpu_line}, HTTP "
          f"walls seen from this process (image bytes in, PNG out, "
          f"--batch-window-ms {SERVE_WINDOW_MS}): {summary}", flush=True)
    print(f"phase 15 /v1/stats: {daemon.ok('GET', '/v1/stats')[0].decode()}",
          flush=True)
    for sid in sids:
        daemon.ok("DELETE", f"/v1/sessions/{sid}")
        if daemon.request("POST", f"/v1/sessions/{sid}/mask?point=1,1")[0] \
                != 404:
            fail(f"phase 15: session {sid} still answers after DELETE")


def tee(fn, *args, **kw):
    """fn's result and what it printed (echoed as it is)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    sys.stdout.write(buf.getvalue())
    sys.stdout.flush()
    return out, buf.getvalue()


def check_memory_tool(torch, gpu_line) -> None:
    """Phase 16's first part: the device-memory tool at full width, its
    rows printed with the card, and the checks that catch a meter that
    reads nothing."""
    from dlimgedit_tpu_torch.tools import memory_footprint as mf

    for var in ("DLIMG_BIREFNET_RESOLUTION", "DLIMG_BIREFNET_TEST_SLIM"):
        if var in os.environ:
            fail(f"phase 16: {var} is set; the memory tool runs at full width")
    t = time.perf_counter()
    # No collection of earlier phases' garbage between the tool's last
    # reading and this one.
    gc.collect()
    gc.disable()
    try:
        fp = mf.main(["--variant", "mobile_sam", "--size", "1024"])
        allocated = torch.cuda.memory_allocated()
    finally:
        gc.enable()
    for r in fp.rows:
        row = dict(phase=r.name, allocated_delta=r.allocated,
                   reserved_delta=r.reserved, driver_delta=r.driver,
                   peak_delta=r.peak, analytic=r.analytic,
                   keys=["/".join(map(str, k)) for k in r.keys])
        print(f"phase 16 memory on {gpu_line}: {json.dumps(row)}")
        if r.name.endswith("weights") and not r.allocated >= r.analytic:
            fail(f"phase 16 memory: {r.name}: allocated delta {r.allocated} "
                 f"below the analytic {r.analytic} bytes")
    for key, (n, nbytes) in fp.pools.items():
        print(f"phase 16 memory on {gpu_line}: pool {'/'.join(map(str, key))}: "
              f"{n} graphs, {nbytes} bytes")
        if nbytes is not None and nbytes > fp.final.reserved:
            fail(f"phase 16 memory: pool of {key} {nbytes} bytes above "
                 f"memory_reserved {fp.final.reserved}")
    print(f"phase 16 memory: the graphs' pool ids "
          f"{'all' if fp.pools_matched else 'NOT all'} found in the snapshot",
          flush=True)
    if fp.final.allocated != allocated:
        fail(f"phase 16 memory: resident {fp.final.allocated} bytes, "
             f"torch.cuda.memory_allocated() {allocated}")
    print(f"phase 16 memory on {gpu_line}: resident {fp.final.allocated}, "
          f"peak {fp.peak}, reserved {fp.final.reserved}, driver used "
          f"{fp.final.driver}, before the environment {fp.baseline}; "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    del fp
    torch.cuda.empty_cache()


def drive_examples(torch, np, dl, counters, zero_counters, gpu_line,
                   tmp: Path) -> None:
    """Phase 16 (see the module docstring): the memory tool, then the eight
    examples of dlimgedit_tpu_torch/examples/ on the card."""
    import importlib

    from dlimgedit_tpu_torch.parallel import batch as pbatch
    from dlimgedit_tpu_torch.parallel.mesh import clear_replicas

    t0 = time.perf_counter()
    check_memory_tool(torch, gpu_line)

    def example(name):
        return importlib.import_module(f"dlimgedit_tpu_torch.examples.{name}")

    def timed(label, fn, *args, **kw):
        t = time.perf_counter()
        out, text = tee(fn, *args, **kw)
        torch.cuda.synchronize()
        print(f"phase 16 {label}: {time.perf_counter() - t:.1f} s", flush=True)
        return out, text

    def same_file(got: Path, image, label) -> None:
        want = tmp / "direct.png"
        dl.Image.save(image, want)
        if got.read_bytes() != want.read_bytes():
            fail(f"phase 16 {label}: {got.name} differs from the direct "
                 f"call's mask")

    # -- examples 3-5 at full width ----------------------------------------
    w, h = 1024, 768
    png = tmp / "photo.png"
    dl.Image.save(dl.Image(dl.Extent(w, h), dl.Channels.rgba,
                           rgba(np, h, w, 16)), png)
    options = dl.Options(backend=dl.Backend.gpu, allow_random_weights=True,
                         model_directory=str(tmp))
    direct = dl.Environment(options)
    img = dl.Image.load(png)
    seg = dl.Segmentation.process(img, direct)
    per_process = {"fused_layer_norm": LN_PER_PROCESS,
                   "levit_window_attention": ATTN_PER_PROCESS}

    x, y = w // 2, h // 3
    zero_counters()
    _, text = timed("interactive_segmentation",
                    example("interactive_segmentation").main,
                    argv=[str(png), str(x), str(y), str(tmp / "mask.png")],
                    options=options)
    expect_launches(counters(), per_process, "interactive_segmentation", 16)
    same_file(tmp / "mask.png", seg.compute_mask(dl.Point(x, y)).view(),
              "interactive_segmentation")
    got = [float(v) for v in re.findall(r"predicted IoU (\S+)", text)]
    want = [round(m.accuracy, 3) for m in seg.compute_masks(dl.Point(x, y))]
    if got != want or "batched 3 prompts" not in text:
        fail(f"phase 16 interactive_segmentation: printed {got}, the direct "
             f"call's accuracies {want}")

    for filters in ("script", "off"):
        out_dir = tmp / f"masks_{filters}"
        real = dl.Segmentation.generate_masks
        if filters == "off":  # random weights pass neither filter
            dl.Segmentation.generate_masks = lambda self, **kw: real(
                self, **kw, iou_thresh=0.0, stability_thresh=0.0)
        try:
            zero_counters()
            _, text = timed(f"generate_masks ({filters} filters)",
                            example("generate_masks").main,
                            argv=[str(png), str(out_dir)], options=options)
            expect_launches(counters(), dict(per_process, greedy_nms=1),
                            f"generate_masks ({filters} filters)", 16)
            masks = seg.generate_masks(grid=32, max_masks=32)
        finally:
            dl.Segmentation.generate_masks = real
        files = sorted(out_dir.glob("mask_*.png")) if out_dir.exists() else []
        if len(files) != len(masks) or (filters == "off" and not masks):
            fail(f"phase 16 generate_masks: {len(files)} files, the direct "
                 f"call {len(masks)} masks")
        for f, m in zip(files, masks):
            same_file(f, m.image.view(), f"generate_masks {f.name}")
        print(f"phase 16 generate_masks ({filters} filters): {len(files)} "
              f"mask files, each the direct call's", flush=True)

    zero_counters()
    timed("foreground_extraction", example("foreground_extraction").main,
          argv=[str(png), str(tmp / "cutout.png")], options=options)
    expect_launches(counters(), {}, "foreground_extraction", 16)
    cut = dl.Image.load(tmp / "cutout.png").pixels
    mask = dl.segment_objects(img, direct).pixels
    if not (np.array_equal(cut[..., 3], mask[..., 0])
            and np.array_equal(cut[..., :3], img.pixels[..., :3])):
        fail("phase 16 foreground_extraction: the cutout is not the image "
             "with segment_objects' mask as alpha")
    del direct, seg
    torch.cuda.empty_cache()

    # -- examples 6-10 on meshes of the one card ----------------------------
    dev = torch.device("cuda", 0)
    devices = [dev] * 2
    zero_counters()
    _, text = timed("streaming_frames", example("streaming_frames").main,
                    devices=devices)
    # 3 chunks x 2 dp rows, each row's encode one `process`'s launches.
    expect_launches(counters(), {k: 6 * v for k, v in per_process.items()},
                    "streaming_frames", 16)
    for want in ("embeddings: (4, 16, 16, 256)", "masks: (6, 1, 64, 64)"):
        if want not in text:
            fail(f"phase 16 streaming_frames: no {want!r} in its output")
    pbatch._GRAPH_CACHE.clear()
    clear_replicas()

    scaleout = example("latency_scaleout")
    zero_counters()
    emb, _ = timed("latency_scaleout (ViT-B 1024, float32)", scaleout.main,
                   devices=devices)
    want = sp_per_run(12, 2)
    want = {k: want.get(k, 0) + VIT_PER_PROCESS.get(k, 0)
            for k in set(want) | set(VIT_PER_PROCESS)}
    expect_launches(counters(), want, "latency_scaleout (sp 2 + single)", 16)
    logits, _ = timed("latency_scaleout main_birefnet (1024, float32)",
                      scaleout.main_birefnet, devices=devices)
    if tuple(emb.shape) != (1, 64, 64, 256) or tuple(logits.shape) != (
            1, 1024, 1024, 1):
        fail(f"phase 16 latency_scaleout: shapes {tuple(emb.shape)}, "
             f"{tuple(logits.shape)}")
    del emb, logits
    clear_replicas()

    _, text = timed("distill_encoder", example("distill_encoder").main,
                    devices=devices)
    if "step 3: mse" not in text or "grafted student serves" not in text:
        fail("phase 16 distill_encoder: its steps or the graft not printed")
    pbatch._GRAPH_CACHE.clear()
    clear_replicas()

    finetune = example("finetune_decoder")
    bundle = tmp / "models" / "segmentation" / "mobile_sam.npz"
    for run in (1, 2):
        _, text = timed(f"finetune_decoder run {run}", finetune.main,
                        argv=[str(tmp / "ckpts")], bundle_out=str(bundle),
                        devices=devices)
        if "exported serving bundle" not in text or (
                run == 2 and "resumed from step 5" not in text):
            fail(f"phase 16 finetune_decoder run {run}: not resumed or not "
                 f"exported")
    clear_replicas()

    _, text = timed("multihost_train", example("multihost_train").main,
                    argv=[str(tmp / "mh_ckpts")], devices=devices)
    if ("collective checkpoint at step 3" not in text
            or not (tmp / "mh_ckpts" / "step_3").exists()):
        fail("phase 16 multihost_train: no checkpoint at step 3")
    clear_replicas()
    torch.cuda.empty_cache()
    print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)


# Phase 17, the Python-free serving route: prompts on the 1024x768 image.
SERVING_POINTS, SERVING_BOXES = 8, 4


def interleaved_ms(torch, fns, n: int = 20):
    """Medians of n host-clock walls of each callable, their calls
    interleaved, each ending in a device synchronise."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    ts = [[] for _ in fns]
    for _ in range(n):
        for f, t_ in zip(fns, ts):
            t = time.perf_counter()
            f()
            torch.cuda.synchronize()
            t_.append((time.perf_counter() - t) * 1e3)
    return [statistics.median(t_) for t_ in ts]


def drive_python_free(torch, np, dl, gpu_line) -> None:
    """Phase 17, the Python-free serving route on cuda:0 (the module
    docstring's item 17)."""
    import ctypes
    import re
    import threading

    from dlimgedit_tpu_torch import native_build
    from dlimgedit_tpu_torch.tools import aot_export, serving_check

    t0 = time.perf_counter()
    built = {}

    def build():
        try:
            built["build"] = native_build.build_serving()
        except Exception as e:  # reported below, after the export
            built["error"] = e

    builder = threading.Thread(target=build)
    builder.start()
    saved = {k: os.environ.get(k) for k in (*BRIDGE_VARS, "DLIMG_PJRT_BUNDLE")}
    handles, api = [], None
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        bundle, check = work / "bundle", work / "check"
        try:
            t = time.perf_counter()
            env = aot_export.export_serving(
                serving_check.bundle_args(bundle, 1024, "gpu"))
            goldens = serving_check.write_goldens(env, check, 1024,
                                                  SERVING_POINTS, SERVING_BOXES)
            print(f"phase 17: bundle exported and the Python API's results "
                  f"written in {time.perf_counter() - t:.1f} s", flush=True)
            builder.join()
            if "error" in built:
                fail(f"phase 17: the serving build failed: {built['error']}")
            b = built["build"]
            print(f"phase 17 serving build: {b.seconds or 0.0:.2f} s -> "
                  f"{b.serving_library}", flush=True)
            try:
                r = serving_check.run_test_serving(b, bundle, check, work,
                                                   "gpu", time_n=20)
                p = serving_check.run_test_programs(b, bundle, work, "gpu")
            except RuntimeError as e:
                fail(f"phase 17: {e}")
            counts = re.findall(r"launches per process (\S+(?: \(replay\))?): "
                                r"K1 (\d+) K2 (\d+)", r.stdout)
            if len(counts) != 3 or any(
                    (int(k1), int(k2)) != (LN_PER_PROCESS, ATTN_PER_PROCESS)
                    for _, k1, k2 in counts):
                fail(f"phase 17: test_serving's launches per process "
                     f"{counts}, want {LN_PER_PROCESS} K1 and "
                     f"{ATTN_PER_PROCESS} K2 each")
            held = re.search(r"replays equal eager: (\d+) graphs", r.stdout)
            if not held or int(held.group(1)) < 5:
                fail(f"phase 17: graphs held against their eager runs: "
                     f"{held and held.group(1)}")
            for line in r.stdout.splitlines():
                if not line.startswith(("point mask", "box mask")):
                    print(f"phase 17 test_serving: {line}", flush=True)
            if not re.search(r"concurrent process of 2 images x \d+ rounds "
                             r"vs the Python API: 0/\d+ pixels differ",
                             r.stdout):
                fail("phase 17: test_serving's concurrent leg did not hold")
            n_pass = p.stdout.count(": PASS")
            if n_pass != 6:
                fail(f"phase 17: test_serving_programs passed {n_pass} of 6")
            if "the host's float32 flags after the programs: put back" \
                    not in p.stdout:
                fail("phase 17: the serving library left the host's float32 "
                     "flags changed")
            held_w = re.search(r"weights held on the device: .*", p.stdout)
            print(f"phase 17 test_serving_programs gpu: "
                  f"{held_w and held_w.group(0)} on {gpu_line}", flush=True)
            print(f"phase 17 test_serving_programs gpu: 6 of 6 programs "
                  f"byte-equal to the exporter's outputs; "
                  f"{p.stdout.strip().splitlines()[-1]}", flush=True)

            # The three routes in this interpreter, interleaved.
            lib = ctypes.CDLL(str(b.serving_library))
            api = native_build.load_api(b.library)
            opts = native_build.DlimgOptions(backend=1, model_directory=b".")
            os.environ["DLIMG_PJRT_BUNDLE"] = str(bundle)
            served = ctypes.c_void_p()
            if api.create_environment(ctypes.byref(served),
                                      ctypes.byref(opts)):
                fail(f"phase 17 create_environment (serving): "
                     f"{api.last_error().decode()}")
            handles.append(served)
            for k in (*BRIDGE_VARS, "DLIMG_PJRT_BUNDLE"):
                os.environ.pop(k, None)
            os.environ.update({"DLIMG_ALLOW_RANDOM_WEIGHTS": "1",
                               "DLIMG_SAM_IMAGE_SIZE": "1024",
                               "DLIMG_COMPUTE_DTYPE": "bfloat16"})
            embedded = ctypes.c_void_p()
            if api.create_environment(ctypes.byref(embedded),
                                      ctypes.byref(opts)):
                fail(f"phase 17 create_environment (embedded): "
                     f"{api.last_error().decode()}")
            handles.append(embedded)
            (w, h), _ = serving_check.image_sizes(1024)
            arr = np.frombuffer((check / "image.raw").read_bytes(),
                                np.uint8).reshape(h, w, 4)
            buf, stride = c_pixels(ctypes, np, arr, 0)
            view = native_build.DlimgImageView(
                width=w, height=h, channels=4, stride=stride,
                pixels=ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)))
            img = dl.Image(dl.Extent(w, h), dl.Channels.rgba, arr.copy())
            point = goldens["prompts"][0]
            c_point = (ctypes.c_int * 2)(point.x, point.y)
            out_mask, addrs = c_masks(ctypes, 1, w * h)
            slot = (ctypes.POINTER(ctypes.c_uint8) * 3)(
                ctypes.cast(addrs[0], ctypes.POINTER(ctypes.c_uint8)),
                None, None)

            def c_process(handle):
                s_ = ctypes.c_void_p()
                if api.process_image_for_segmentation(
                        ctypes.byref(s_), ctypes.byref(view), handle):
                    fail(f"phase 17 process: {api.last_error().decode()}")
                return s_

            segs = {name: c_process(hd) for name, hd in
                    (("serving", served), ("embedded", embedded))}
            direct = dl.Segmentation.process(img, env)

            def c_mask(name):
                if api.get_segmentation_mask(segs[name], c_point, None, slot,
                                             None):
                    fail(f"phase 17 compute_mask: {api.last_error().decode()}")

            c_mask("serving")
            if bytes(out_mask[0]) != goldens["masks"][0].tobytes():
                fail("phase 17: the served mask in this interpreter differs "
                     "from the Python API's")
            lib.dlimg_serving_reset_launches()
            process_ms = interleaved_ms(torch, [
                lambda: api.destroy_segmentation(c_process(served)),
                lambda: api.destroy_segmentation(c_process(embedded)),
                lambda: dl.Segmentation.process(img, env)])
            k1, k2 = ctypes.c_int64(), ctypes.c_int64()
            lib.dlimg_serving_launches(ctypes.byref(k1), ctypes.byref(k2))
            if (k1.value, k2.value) != (21 * LN_PER_PROCESS,
                                        21 * ATTN_PER_PROCESS):
                fail(f"phase 17: the serving library counted K1 {k1.value}, "
                     f"K2 {k2.value} over its route's 21 process calls")
            mask_ms = interleaved_ms(torch, [
                lambda: c_mask("serving"), lambda: c_mask("embedded"),
                lambda: direct.compute_mask(dl.Point(point.x, point.y))])
            print(f"e2e Python-free serving MobileSAM {w}x{h} on {gpu_line}: "
                  f"process_ms serving={process_ms[0]:.3f} embedded="
                  f"{process_ms[1]:.3f} direct={process_ms[2]:.3f}; mask_ms "
                  f"serving={mask_ms[0]:.3f} embedded={mask_ms[1]:.3f} direct="
                  f"{mask_ms[2]:.3f} (medians of 20, the three routes "
                  f"interleaved in this interpreter; the serving library "
                  f"launched K1 {k1.value} and K2 {k2.value} times over its "
                  f"21 process calls, 22 and 10 a call)", flush=True)
            for s_ in segs.values():
                api.destroy_segmentation(s_)
            del direct, goldens, env
        finally:
            for hd in handles:
                api.destroy_environment(hd)
            restore_vars(saved)
            builder.join()
    torch.cuda.empty_cache()
    print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)


def seeded_birefnet(bn, torch, cfg):
    model = bn.init_birefnet(torch.Generator().manual_seed(0), cfg)
    bn.seed_nonzero_init(model)
    return model


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "dlimgedit_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no dlimgedit_tpu_torch package beside "
              f"{Path(__file__).name}: run it from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    if sys.argv[1:2] == ["--dp-worker"]:  # one of phase 12's two ranks
        return dp_worker(int(sys.argv[2]), int(sys.argv[3]))
    import types

    import numpy as np

    import dlimgedit_tpu_torch as dl
    from dlimgedit_tpu_torch.models import sam as sam_module
    from dlimgedit_tpu_torch.ops import amg
    from dlimgedit_tpu_torch.ops import flash_attention as fa
    from dlimgedit_tpu_torch.ops import fused_norm as fn
    from dlimgedit_tpu_torch.ops import quant
    from dlimgedit_tpu_torch.ops.cuda_build import LIBRARY
    from dlimgedit_tpu_torch.parallel import batch as pbatch
    from dlimgedit_tpu_torch.tools import probe_batch_masks as probe_masks
    from dlimgedit_tpu_torch.tools import probe_smem_gather as probe

    ops = types.SimpleNamespace(
        fused_layer_norm=fn.fused_layer_norm,
        layer_norm_plain=fn.layer_norm_plain,
        fused_add_layer_norm=fn.fused_add_layer_norm,
        fused_add_layer_norm_plain=fn.fused_add_layer_norm_plain,
        levit_window_attention=fa.levit_window_attention,
        levit_window_attention_plain=fa.levit_window_attention_plain,
        relpos_attention_global=fa.relpos_attention_global,
        relpos_attention_windowed=fa.relpos_attention_windowed,
        attention_relpos_plain=fa.attention_relpos_plain,
        bias_halves=fa._bias_halves,
        windowed_attention_fused=fa.windowed_attention_fused,
        windowed_attention_fused_plain=fa.windowed_attention_fused_plain,
        relpos_attention_qkv=fa.relpos_attention_qkv,
        windowed_attention_qkv_plain=fa.windowed_attention_qkv_plain,
        smem_gather=probe.smem_gather,
        smem_gather_plain=probe.smem_gather_plain,
        probe_inputs=probe.probe_inputs,
        greedy_nms=amg.greedy_nms,
        greedy_nms_plain=amg.greedy_nms_plain,
        quantize_rows_int8=quant.quantize_rows_int8,
        quantize_activations_int8=quant.quantize_activations_int8,
        int8_epilogue=quant.int8_epilogue,
        int8_epilogue_plain=quant.int8_epilogue_plain)
    wrappers = {name: getattr(ops, name) for name, _, _ in KERNELS}
    memoize_seeded_init(torch, sam_module)

    def counters():
        return {name: w.launches for name, w in wrappers.items()}

    def zero_counters():
        for w in wrappers.values():
            w.launches = 0

    @contextlib.contextmanager
    def restore_counters():
        """Leave the counters as they were (around a capture that is not a
        launch of the main path)."""
        saved = counters()
        try:
            yield
        finally:
            for name, w in wrappers.items():
                w.launches = saved[name]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    gpu_line = smi.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}; "
          f"device count {torch.cuda.device_count()}; TF32 flags (PyTorch's "
          f"defaults, in force outside phase 2): cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    LIBRARY.get()
    print(f"phase 1, kernel build: {time.perf_counter() - t0:.2f} s -> "
          f"{LIBRARY.path}")
    report = nvcc_report(LIBRARY.build_log)
    if LIBRARY.build_log and not report:
        fail("no register report in nvcc's output")
    for source, kernel, targs, regs, spill in report:
        print(f"  nvcc: {source} {kernel}<{targs}>: {regs} registers, "
              f"{spill} bytes spill stores")
        if source in TC_SOURCES and spill != 0:
            fail(f"{kernel}<{targs}> spills ({spill} bytes of spill stores)")
    reported = {kernel for source, kernel, *_ in report if source in TC_SOURCES}
    if LIBRARY.build_log and not set(TC_KERNELS) <= reported:
        fail(f"tensor-core kernels missing from nvcc's report: "
             f"{sorted(set(TC_KERNELS) - reported)}")
    sys.stdout.flush()

    def host_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    # -- 2. kernels against their plain versions -------------------------
    t0 = time.perf_counter()
    entries = Entries()
    with tf32_off(torch):  # the plain versions are float32 references
        check_kernels(torch, ops, entries)
        check_vit_kernels(torch, ops, entries)
        check_kernels(torch, ops, entries, FRAMES_LN_SHAPES,
                      FRAMES_ATTN_SHAPES, images=1)
        for label, ln, add_ln, glob, win in BATCHED_VIT_SHAPES:
            print(f"phase 2, batched: {label}", flush=True)
            check_vit_kernels(torch, ops, entries, ln, add_ln, glob, win,
                              images=1)
        print("phase 2, phase 12's shapes", flush=True)
        check_phase12_shapes(torch, ops, entries)
        print("phase 2, phase 13's band shapes", flush=True)
        check_phase13_shapes(torch, ops, entries)
        check_window_kernels(torch, ops, entries)
        check_nms_kernel(torch, np, ops)
        k1_launch_floor(torch, ops, entries, restore_counters)
        gemm_ms = {"int_mm": 0.0, "int_mm_row_major": 0.0, "bf16": 0.0}
        check_quant_kernels(torch, ops, entries, gemm_ms)
    print(f"phase 2, the products beside P3, summed over phase 9's w8a8 "
          f"launches: torch._int_mm {gemm_ms['int_mm']:.5f} ms (row-major "
          f"weights {gemm_ms['int_mm_row_major']:.5f}), bf16 x @ w "
          f"{gemm_ms['bf16']:.5f} ms", flush=True)
    torch.cuda.empty_cache()
    print(f"phase 2: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 3. small size: the card against the CPU -------------------------
    check_small_against_cpu(torch, np, dl, counters)
    check_amg_small_against_cpu(torch, np, dl)

    # -- 4. main paths at full width -------------------------------------
    launches = {name: 0 for name in wrappers}
    runs = {}
    for variant, want, fused in (
            ("mobile_sam", {"fused_layer_norm": LN_PER_PROCESS,
                            "levit_window_attention": ATTN_PER_PROCESS}, False),
            ("vit_b", VIT_PER_PROCESS, False),
            ("vit_b", VIT_FUSED_PER_PROCESS, True),
            ("vit_l", vit_per_process(24), False),
            ("vit_h", vit_per_process(32), False)):
        env, images, segs, counts, memory = drive_main_path(
            torch, np, dl, variant, counters, zero_counters, want, fused)
        if variant == "mobile_sam":
            check_no_aliasing(torch, np, dl, env, images, segs)
            check_batch_contract(torch, dl, probe_masks, env, images)
        runs[f"{variant}{' fused-window' if fused else ''}"] = (
            env, images, segs, memory)
        for name, n in counts.items():
            launches[name] += n

    # -- 5. the gather probe, briefly ------------------------------------
    t0 = time.perf_counter()
    probe.main(["--reps", "2", "4"])  # raises (a non-zero exit) on any fault
    print(f"phase 5: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 6. end-to-end times ---------------------------------------------
    t0 = time.perf_counter()

    def set_graphed(env, on: bool) -> None:
        """Run the path's executables as CUDA graphs, or their eager
        programs through the same entry points."""
        for exe in env.executables.values():
            exe.graphed = on

    for variant, (env, images, segs, memory) in runs.items():
        for img, seg in zip(images, segs):
            c = dl.Point(img.extent.width // 2, img.extent.height // 2)
            ms = {}
            for mode in ("graphed", "eager"):
                set_graphed(env, mode == "graphed")
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                ms[mode] = (host_ms(lambda: dl.Segmentation.process(img, env)),
                            host_ms(lambda: seg.compute_mask(c)),
                            (torch.cuda.max_memory_allocated() - resident) / 2**20)
            set_graphed(env, True)
            (gp, gm, gpk), (ep, em, epk) = ms["graphed"], ms["eager"]
            print(f"e2e {variant} {img.extent.width}x{img.extent.height} on "
                  f"{gpu_line}: process_ms graphed={gp:.3f} eager={ep:.3f}; "
                  f"mask_ms graphed={gm:.3f} eager={em:.3f} (medians of 20); "
                  f"transient device memory while timed: graphed {gpk:.1f} "
                  f"MiB, eager {epk:.1f} MiB; the path's max_memory_allocated "
                  f"in phase 4 {memory[0] / 2**30:.3f} GiB, "
                  f"{memory[2] / 2**30:.3f} GiB left reserved", flush=True)
    lcc_options(torch, dl, runs["mobile_sam"], host_ms)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s", flush=True)
    del runs
    torch.cuda.empty_cache()

    # -- 7. automatic mask generation ------------------------------------
    nms_row = drive_amg(torch, np, dl, ops, counters, zero_counters,
                        restore_counters, host_ms, gpu_line)
    launches["greedy_nms"] = nms_row["launches"]

    # -- 8. BiRefNet segment_objects -------------------------------------
    drive_birefnet(torch, np, dl, counters, zero_counters, restore_counters,
                   host_ms, gpu_line)

    # -- 9. quantised serving --------------------------------------------
    launches.update(drive_quantized(torch, np, dl, quant, counters,
                                    zero_counters, host_ms, gpu_line))

    # -- 10. batched frames ------------------------------------------------
    for name, n in drive_frames(torch, np, dl, counters, zero_counters,
                                restore_counters, host_ms, gpu_line).items():
        launches[name] += n
    pbatch._GRAPH_CACHE.clear()  # the frames' graphs hold their models
    torch.cuda.empty_cache()

    # -- 11. the single-device train tier --------------------------------
    for name, n in drive_training(torch, np, dl, counters, zero_counters,
                                  gpu_line).items():
        launches[name] += n
    pbatch._GRAPH_CACHE.clear()
    torch.cuda.empty_cache()

    # -- 12. the multi-device schedules over meshes of the one card -------
    for name, n in drive_multi_device(torch, np, dl, counters, zero_counters,
                                      host_ms, gpu_line).items():
        launches[name] += n

    # -- 13. canvas-row sharding over meshes of the one card --------------
    for name, n in drive_canvas_rows(torch, np, dl, counters, zero_counters,
                                     host_ms, gpu_line).items():
        launches[name] += n

    # -- 14. the C ABI's bridge and a converted bundle --------------------
    # -- 15. the C hosts: the port's library, dlimg-serve, dlimg ----------
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = Path(tmp) / "models"
        drive_bridge(torch, np, dl, counters, zero_counters, gpu_line, root,
                     model_dir)
        drive_c_hosts(torch, np, dl, counters, zero_counters, gpu_line,
                      model_dir)

    # -- 16. the device-memory tool and the examples ----------------------
    with tempfile.TemporaryDirectory() as tmp:
        drive_examples(torch, np, dl, counters, zero_counters, gpu_line,
                       Path(tmp))

    # -- 17. the Python-free serving route ---------------------------------
    drive_python_free(torch, np, dl, gpu_line)

    kernels = []
    for name, source, replaces in KERNELS:
        e = (nms_row if name == "greedy_nms"
             else entries.numbers(name, launches[name]))
        if e["launches"] != launches[name]:
            fail(f"{name}: phase 2 timed {e['launches']} main-path launches, "
                 f"the main paths made {launches[name]}")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"],
            "bound_ms": max(e["bytes_ms"], e["ops_ms"]),
            "bound_by": "bytes" if e["bytes_ms"] >= e["ops_ms"] else "operations",
            "library_ms": e["library_ms"]})
    print(gpu_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
