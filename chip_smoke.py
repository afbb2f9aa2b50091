#!/usr/bin/env python3
"""
Smoke run of the gance_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a GPU

It builds the port's CUDA kernels from `gance_tpu_torch/ops/cuda/csrc/` and then,
in order (any failure exits non-zero; no phase's failure is caught):

1. prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, the TF32 flags, the kernel build time and the native AVI
   muxer's build time (g++);
2. holds each kernel against its plain PyTorch twin on the card, at the shapes
   the 1024px config-f path gives it at batch 8, in fp32 and bf16, and times
   the kernel, the twin, one PyTorch library call that computes the same
   function where there is one, and the least time the card could take
   (bound). A and B must equal their twins bit for bit; C rounds like its
   twin: fp32 max abs error at most 1e-5 of the output's scale, bf16 at most
   2 bf16 ulps. A is also held with
   per-sample noise at training's (4, 64, 1024, 1024), and A and B with x
   one element past a 16-byte boundary (their scalar paths). E takes the nine taps of
   its folded Conv1 weight (576 conv terms per output) and 256 ToRGB terms,
   its twin the dense fold (1024 terms), summed in another order: fp32 at
   most 1e-4 of the output's scale, bf16 at most 1e-2 (z and the output
   round to bf16). B is also checked at the non-symmetric FIR (1, 2, 3, 4).
   E's bound counts the products its folded weights need (36 of the 64
   blocks of the dense folded contraction are non-zero); the dense bound is
   printed beside it.
   D is held at the training path's shapes at batch 4 (every blur of one
   discriminator forward, C's input gradient at the top block, the FIR
   (1, 2, 3, 4)) with A-C's limits; its library call is a depthwise conv2d;
3. drives the main path: a random config-f 1024px network (seeded, with
   non-zero noise strengths, biases and dlatent_avg) is written with
   `save_generator_pickle`, loaded with `SynthesisNetwork.from_pkl`, and serves
   `images_from_vectors` (batch 8), `images_from_matrices` (batch 8) and a
   2-network `MultiNetwork.synthesize_stream` of 40 frames with alternating
   indices on the standard path; then the same vectors, matrices and 16 frames
   of the stream on the polyphase top-block path (GANCE_TPU_PHASE1024=on,
   kernel E), and one `output_side_length=512` request on each path. The
   launch counts of each request are checked (A / B / C / E per forward:
   17 / 8 / 8 / 0 standard, 15 / 7 / 7 / 1 phase, 15 / 8 / 7 / 1 phase with a
   resize); the frames are checked for shape, stream order and content, the
   phase path's frames against the standard path's (within 1 uint8 step on at
   least 99.9% of pixels), and the resized frames against the float render
   resized in float64 on the host with Keys cubic weights written out in this
   script (the port's weights are held against jax.image.resize by
   tests/test_torch_phase_block.py);
4. renders one frame on the card and on the port's CPU path (the plain twins)
   and bounds the difference; prints the bf16 render's PSNR against fp32, on
   both paths;
5. prints fp32 and bf16 frames/s at batch 8 with the phase path off and on,
   timed with CUDA events;
6. holds the gradients of kernels A-E (their autograd Functions) on the card
   against the same gradients through the twins on the CPU, first and second
   order, within 1e-4 of each gradient's scale (a cut gradient gives zeros);
   E at (2, 256, 64, 64), through w4 = fold_conv1_weights(v), with every
   pre-activation held 0.05 from the lrelu's kink so that both devices take
   the same slope;
7. drives training (gance_tpu_torch/parallel/training.py): (a) one step's
   losses and gradients with R1 and path length, at a 32px config with
   config-f's widths, on the card and on the port's CPU path with the same
   draws: losses within 1e-3 relative; gradients norm-wise within 2e-2 for
   each network and 1e-1 for each leaf (a cut or wrong gradient is off by
   about 1). Max-abs limits per leaf are below fp32 noise here: one lrelu
   input within rounding of the kink takes the other slope and moves every
   upstream gradient (the port's CPU fp32 against float64 differs by 0.4%
   norm-wise on D and 3.4% of the leaf's max on 4x4/Conv/weight,
   tools/gradient_conditioning.py); (b) config-f 1024px at full width and
   depth, random seeded weights and seeded images in [-1, 1], through
   `run_training`: 5 fp32 steps at batch 4 (step 0 with R1 and PL, step 4
   with PL only), then 2 bf16 steps resumed from the checkpoint, each with
   finite losses, its A/B/C/D launches checked against counts derived from
   the architecture, seconds per step by CUDA events and peak memory; G, D
   and EMA must have moved; after the fp32 steps, one G step's gradients
   with PL on the standard path and on the phase path
   (GANCE_TPU_PHASE1024=on: E forward, E's backward and PL's second order
   through it), losses within 1e-3 relative, launches (E's included)
   checked; the split of a step between G, D, R1 and PL by
   CUDA events; (c) the checkpoint written after step 3, loaded, runs step 4
   again and matches the unbroken run (the D step's losses within 1e-5
   relative, the G step's within 1e-3, since cuDNN's weight gradients are
   not deterministic and Adam's first steps amplify that; params within 2.5
   lr everywhere and 5% of lr on average over every leaf, where a cut
   gradient would give about lr); (d) the EMA generator, exported with
   `save_generator_pickle`, is loaded with `SynthesisNetwork.from_pkl` and
   serves one batch that matches the EMA params rendered directly;
8. drives the noise-blend pipeline, WAV in and video out
   (gance_tpu_torch/pipelines/noise_blend.py): (a) a 4 s percussive WAV
   (44.1 kHz int16, `fabricate_percussive_wav`) turned into the pipeline's
   inputs at vector length 512 and 30 fps, alpha 0.25, amplitude range
   (-1, 1), FFT roll off and on, on the card and on the port's CPU path:
   spectrogram, noise and combined vectors within 1e-4 with non-finite
   entries in the same places, network indices equal, and no scaled RMS on
   the CPU side within 1e-4 of a half-integer (else the check cannot be
   exact, and it says so); (b) `noise_blend_api` with phase 3's two config-f
   1024px networks, side 1024, 30 fps, fp32, standard path, with
   GANCE_TPU_EGRESS=raw-spill (the lossless egress: one uncompressed AVI with
   the audio interleaved, whatever encoders the host has): the AVI is parsed
   by a RIFF reader written here; its frames number the index stream and lie within 1
   uint8 step on at least 99.9% of pixels of `vector_synthesis` run directly
   on the same inputs, its audio chunks concatenate to the WAV's samples,
   both networks are used, and A / B / C launch 17 / 8 / 8 times per forward,
   forwards counted from the indices with `synthesize_stream`'s windows and
   buckets; (c) the same in bf16 with GANCE_TPU_PHASE1024=on at side 512:
   the frame count and 15 / 8 / 7 / 1 launches per forward (E included);
   (d) (b) again with the default egress (GANCE_TPU_EGRESS=auto: ffmpeg, else
   cv2 mp4v then the native MJPEG mux, else the raw AVI): the frame count
   and the audio are checked, and its time shows what the host's encoder
   costs.
   Each run prints its wall seconds split into loading, audio features and
   synthesis plus write, the frames/s end to end, the AVI's bytes and MB/s,
   the synthesis stream's own seconds and, for the raw AVI, the time to
   write the same frames and audio again through the same writer alone;
9. drives the flagship, projection-file blend
   (gance_tpu_torch/pipelines/projection_file_blend.py), with phase 3's
   networks and phase 8's WAV. It prints whether h5py, cv2 and cv2.data
   import and where OpenCV's Haar cascade XMLs are. (a) A projection file
   as the projector writes one: 60 frames at 15 fps, seeded smooth 1024px
   targets, rows-identical w+ from seeded z through network 0's mapping.
   With h5py it is written by the port's `ProjectionFileWriter` (timed),
   read back bit for bit and verified; without h5py the renders read an
   in-memory reader of the same frames through the pipeline's
   `_blend_from_reader`, and the script says so. (b) The pHash of 256 seeded
   crops of 8-120 px on the card against the port's CPU path: bits equal,
   except on crops where a low-frequency coefficient lies within 1e-5 of
   max|coefficient| of the median on the CPU side (counted and printed).
   (c) fp32, side 1024, 30 fps (120 frames), blend depth 10, alpha 0.25,
   standard path, no overlay, GANCE_TPU_EGRESS=raw-spill: the AVI has 120
   frames within 1 uint8 step on at least 99.9% of pixels of
   `vector_synthesis` run directly on the same `alpha_blend_projection_file`
   inputs and scaled the same way, the WAV's samples as its audio, and A /
   B / C launch 17 / 8 / 8 times per forward, forwards counted from the
   indices (both networks used). (d) bf16, GANCE_TPU_PHASE1024=on, side 512
   (scaled on the host, as JAX does), with the README's overlay gates (pHash
   30, bbox 50, track length 5) when the cascades are there: the frame
   count, the audio and 15 / 7 / 7 / 1 launches per forward (no resize on
   the device, so the top block's last skip upsample is the fused uint8
   path's, not B); it prints the frames with a face found on each stream
   and the frames composited. Each render prints its wall seconds split
   into loading, audio features and render, frames/s, each stage's busy
   seconds and the AVI's bytes;
10. drives the projector (gance_tpu_torch/projection/projector.py) at
   config-f 1024px with phase 3's network 0 and the random-VGG metric at
   256px. (a) One fp32 step at batch 1 on the card and on the port's CPU
   path with the same seeded w, planes, jitter and target: distance and loss
   within 1e-4 relative; the gradient of the step's synthesis term (the
   regulariser's weight at 0, since at 1e5 its gradient hides the noise
   gradients that come through A and E) with respect to w, and to the 17
   planes taken together, norm-wise within 2e-2, each plane within 1e-1
   (phase 7a's bounds and reason). (b) `project_batch` of 100 steps from
   the dlatent average with seeded planes, targets the network's own frames
   from seeded rows-identical w: fp32 at batch 4, then bf16 at batch 8, on
   the standard path; the clean distance (`evaluate_distance`) must fall for
   every frame, every output be finite, and the launches equal the count
   derived from the architecture (`projection_launches`: per step a forward
   and one D per C in the backward, then the final render); it prints ms
   per step (CUDA events), frame-steps/s, frames per hour at 1000 steps and
   peak memory. (c) bf16 at batch 8 for 20 steps on the phase path (E
   forward and E's backward), its ms per step beside (b)'s; then one fp32
   step at batch 2 on each path with the same inputs, the synthesis term's
   gradients within 2e-2 norm-wise. (d) `_projection_write_loop` over 8
   seeded 1024px frames at batch 4, 20 steps in segments of 8, latents
   histories on, into an in-memory writer (the card machine has no h5py):
   rows identical, histories of 20 steps, noise shapes in JAX's (1, h, w, 1)
   layout, launches derived; then the flagship's `_blend_from_reader` over
   the result (`MemoryProjectionReader`, 16 frames at 30 fps, side 512, phase
   8's WAV cut to the clip) with the frame count, the audio and the launches
   per forward checked.
11. drives the rest of the render surface with phase 3's networks and phase
   8's WAV, GANCE_TPU_EGRESS=raw-spill wherever frames are compared, each
   step's launches counted from 0 and checked. (a) Still images
   (gance_tpu_torch/pipelines/synthesis_file.py): `images_from_network_api`,
   16 face-free images per network from seed 1234 in fp32 (random weights
   give no faces): each PNG's md5 in its sidecar, each vector a z drawn in
   order; then `synthesis_file_into_networks_api` replays all 32 sidecars
   through both networks, and a network's replay of its own vectors lies
   within 1 uint8 step on at least 99.9% of pixels of its first image (the
   batches differ). (b) `check_move_networks_api` over the two networks, a
   copy of one, a truncated pickle and a submit_config.pkl copies exactly
   the two, with gance_tpu's names; a wrapper of kernel A that raises must
   leave `validate_network` (not reject the network). (c) Resumable
   noise-blend, fp32, side 1024, 120 frames, chunks of 32 (a multiple of the
   stream's 16-frame window), raw parts: an unbroken resumable render, then
   one in a child process (GANCE_TPU_RESUME_CHUNK_DELAY) killed with SIGKILL
   once a chunk is durable, resumed here: the manifest and parts are gone,
   the audio is the WAV's, the frames equal the unbroken render's bit for
   bit and lie within 1 step on 99.9% of `vector_synthesis` run directly,
   and the resumed run launches only the forwards of the frames after the
   durable count. (d) The resumable flagship, bf16, side 512, the phase
   path, the README's gates, on the in-memory reader: unbroken, then killed
   in a child during detection (GANCE_TPU_RESUME_DECISION_DELAY) once the
   decision sidecar holds a decision, and resumed: bit for bit, the sidecar,
   manifest and parts gone, 15 / 7 / 7 / 1 launches per forward. (e)
   `frames_in_spill` over (c)'s AVI equals the RIFF reader's frames,
   `spill_segment_paths` orders a three-segment spill and raises on a hole,
   `reencode_spill` writes the 120 frames as mp4v. (c) and (d) print the
   wall split into loading, audio features, chunks and finalize, frames/s
   beside 8b's and 9d's, and the parts' bytes at the peak.
12. serves (gance_tpu_torch/serving/) with phase 3's networks and phase 8's
   WAV, each served request's launches counted from 0 and checked against
   the batches the daemon dispatched (17 / 8 / 8 per forward; 15 / 7 / 7 / 1
   on the phase path). (a) A `SynthesisDaemon` over both networks on port 0,
   max batch 48, linger 20 ms, every bucket (8, 16, 32, 48) of both lanes
   warmed with the serve CLI's `warm_networks`; through `ServingClient`:
   /healthz lists both;
   /synthesize from seeds, from dlatents and on network 1 by name, each
   within 1 uint8 step on at least 99.9% of pixels of
   `images_from_vectors` / `_matrices` run directly on the same rows (fp32
   cuDNN does not repeat itself bit for bit); 8 concurrent clients of 3-5
   rows: fewer batches than requests, each client's rows back in order; a
   png, a png-zip and (GANCE_TPU_EGRESS=raw-spill) an avi request decoded
   back within the same bound; /metrics parses. (b) /synthesize_audio over
   the 4 s WAV with both networks: the plan's indices equal the offline
   planning's on the card and its rows lie within 1e-4 of the card's
   inputs; the npy frames within the 1-step bound of `MultiNetwork`'s
   render of the same plan; a plan-cache hit within 1 step of the miss;
   latents registered by POST (phase 9's 60 frames x 18 x 512) and the
   flagship blend at blend depth 10 against `synthesis/inputs.py`'s blend
   rendered directly; it prints the planning seconds of the clip on the
   CPU. (c) /admin/load of a third network from a pickle and /admin/unload:
   `torch.cuda.memory_allocated` rises and falls by at least 90% of its
   parameter bytes; the serve CLI's `run_server` in a child process,
   SIGTERM while a 96-frame request is in flight: the request completes, a
   new one gets 503, the child exits 0. (d) Peak memory per warm bucket in
   fp32 and bf16; then 6 concurrent clients of 8 frames for 10 s against a
   daemon over network 0 in fp32, in bf16, and in bf16 on the phase path
   (E): frames/s, requests/s, client latency p50 and p99, batches, mean
   batch and occupancy (`serving_load`, which tools/time_torch_serving.py
   also runs).

The line before the last is the kernels' JSON record (A-E; D's time is per
discriminator forward at batch 4, its launches are the training run's and
phase 10's; E's launches include the phase-path G step's; A, B, C and E's
include phases 8-12's); the last line is {"ok": true, "device":
{...}}. Without a CUDA device it exits 1 and prints no result.
"""

import base64
import collections
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SEED = 20261016
BATCH = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 rate outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor-core rate, dense
TAPS = (0.25, 0.75, 0.75, 0.25)  # [1,3,3,1] binomial, gain 2 per axis
TAPS_1234 = (0.2, 0.4, 0.6, 0.8)  # root of the non-symmetric FIR (1, 2, 3, 4)
FIR_1234 = np.outer((1, 2, 3, 4), (1, 2, 3, 4)) / 100.0  # a 4x4 FIR that is not symmetric
TRAIN_BATCH = 4  # NVlabs config-f's per-GPU minibatch
RESIZE_SIDE = 512
PHASE_ENV = "GANCE_TPU_PHASE1024"
PIPELINE_SECONDS = 4.0  # the phase-8 WAV
PIPELINE_FPS = 30.0
PIPELINE_VECTOR = 512  # config-f's latent length, the pipeline's vector length
PIPELINE_ALPHA = 0.25
FLAGSHIP_PROJECTION_FRAMES = 60  # the phase-9 projection file: 4 s at 15 fps
FLAGSHIP_PROJECTION_FPS = 15.0
FLAGSHIP_FPS = 30.0  # a frame multiplier of 2
FLAGSHIP_BLEND_DEPTH = 10
FLAGSHIP_OVERLAY = (30, 50.0, 5)  # the README's phash, bbox and track-length gates
PROJECTION_STEPS = 100  # 10b: num_steps, so the whole LR and jitter schedule runs
PROJECTION_RUNS = (("float32", 4), ("bfloat16", 8))  # 10b: (compute dtype, batch)
PROJECTION_PHASE_STEPS = 20  # 10c: bf16 at batch 8 on the phase path
PROJECTION_WRITE_FRAMES = 8  # 10d: the writer loop's source frames
PROJECTION_WRITE_BATCH = 4
PROJECTION_WRITE_STEPS = 20
PROJECTION_WRITE_SEGMENT = 8  # segments of 8, 8 and 4 steps
PROJECTION_WRITE_FPS = 15.0  # divides the flagship's 30 fps
STILL_IMAGES = 16  # 11a: face-free images per network
STILL_SEED = 1234  # the images-from-network default
RESUME_FRAMES = 120  # 11c: the phase-8 WAV at 30 fps
RESUME_CHUNK = 32  # a multiple of the stream window (batch 8 x lookahead 2)
RESUME_CHUNK_DELAY = 5.0  # 11c: seconds between durable chunks in the child
RESUME_DECISION_DELAY = 0.2  # 11d: seconds per overlay decision in the child
SPILL_SEGMENT_FRAMES = 2  # 11e: frames per segment of the segmented spill
SERVE_MAX_BATCH = 48  # 12: the daemon's batch ceiling (buckets 8, 16, 32, 48)
SERVE_LOAD = (6, 8, 10.0)  # 12d: concurrent clients, frames per request, timed seconds
SERVE_SETTLE_S = 2.0  # 12d: traffic before the timed window
RATES: Dict[str, dict] = {}  # 8b-8d and 9d's results, printed beside phase 11's

REPLACES = {
    "fused_bias_noise_lrelu": "gance_tpu/ops/pallas/fused_ops.py:52",
    "upsample2x_blur": "gance_tpu/ops/pallas/fused_ops.py:137",
    "blur4_separable_pad11": "gance_tpu/ops/pallas/fused_ops.py:304",
    "phase_conv1_torgb": "gance_tpu/ops/pallas/phase_fused.py:125",
    "stencil_blur4_valid": "gance_tpu/ops/pallas/fused_ops.py:412",
}
SOURCES = {
    "fused_bias_noise_lrelu": "gance_tpu_torch/ops/cuda/csrc/fused_bias_noise_lrelu.cu",
    "upsample2x_blur": "gance_tpu_torch/ops/cuda/csrc/upsample2x_blur.cu",
    "blur4_separable_pad11": "gance_tpu_torch/ops/cuda/csrc/blur4_separable.cu",
    "phase_conv1_torgb": "gance_tpu_torch/ops/cuda/csrc/phase_conv1_torgb.cu",
    "stencil_blur4_valid": "gance_tpu_torch/ops/cuda/csrc/stencil_blur4_valid.cu",
}


def fail(message: str) -> None:
    print(f"chip_smoke FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(condition: bool, message: str) -> None:
    if not condition:
        fail(message)


def time_ms(fn: Callable[[], object], min_total_ms: float = 50.0) -> float:
    """Mean milliseconds per call on the current stream, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(3, min(200, int(min_total_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved: float, flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S) -> Tuple[float, str]:
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                fp32_rel: float = 1e-5, bf16_rel: Optional[float] = None) -> float:
    """fp32: max abs <= fp32_rel * max|want|; bf16: <= bf16_rel * max|want| where
    given, else <= 2 ulps of bf16 at each value."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    require(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    err = (g - w).abs()
    rel = fp32_rel if got.dtype == torch.float32 else bf16_rel
    if rel is not None:
        limit = rel * max(float(w.abs().max()), 1e-30)
        require(float(err.max()) <= limit, f"{name}: max abs {float(err.max()):.3g} > {limit:.3g}")
    else:
        mag = torch.maximum(g.abs(), w.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
        ulp = torch.exp2(torch.floor(torch.log2(mag))) * torch.finfo(torch.bfloat16).eps
        worst = float((err / ulp).max())
        require(worst <= 2.0, f"{name}: {worst:.2f} bf16 ulps > 2")
    return float(err.max())


def print_sums(name: str, unit: str, sums: Dict[str, Dict[str, float]]) -> None:
    """One line per kernel: its ms, twin's ms, library call's ms and bound
    summed over the path's shapes, in fp32 and in bf16."""
    parts = [f"{dtype} ms {t['ms']:.4f} plain_ms {t['plain_ms']:.4f} library_ms "
             f"{t['library_ms'] or None} bound_ms {t['bound_ms']:.4f}" for dtype, t in sums.items()]
    print(f"kernel {name} per {unit}: " + "; ".join(parts), flush=True)


def path_shapes(config) -> Dict[str, List[Tuple[tuple, int]]]:
    """Each kernel's input shapes on the synthesis path at BATCH, with launches
    per forward: A, B and C on the standard path, E on the phase path (the
    phase planes of the top block's input, 4 * C channels at half resolution)."""
    top = config.resolution_log2
    shapes: Dict[str, List[Tuple[tuple, int]]] = {
        "fused_bias_noise_lrelu": [((BATCH, config.nf(1), 4, 4), 1)],
        "upsample2x_blur": [],
        "blur4_separable_pad11": [],
        "phase_conv1_torgb": [((BATCH, 4 * config.nf(top - 1), 2 ** (top - 1), 2 ** (top - 1)), 1)],
    }
    for res in range(3, top + 1):
        size, cout = 2**res, config.nf(res - 1)
        shapes["fused_bias_noise_lrelu"].append(((BATCH, cout, size, size), 2))
        shapes["upsample2x_blur"].append(((BATCH, config.num_channels, size // 2, size // 2), 1))
        shapes["blur4_separable_pad11"].append(((BATCH, cout, size + 1, size + 1), 1))
    return shapes


def discriminator_shapes(config) -> List[Tuple[tuple, int, tuple]]:
    """Kernel D's (input shape, launches per discriminator forward, pads) at
    TRAIN_BATCH: each D block blurs its input with pads (2, 2) before the 3x3
    Conv1_down and (1, 1) before the 1x1 Skip."""
    return [((TRAIN_BATCH, config.nf(res - 1), 2**res, 2**res), 1, pads)
            for res in range(config.resolution_log2, 2, -1) for pads in ((2, 2), (1, 1))]


def kernel_phase(config, gen: torch.Generator) -> List[dict]:
    from gance_tpu_torch.ops.cuda import fused_ops as K
    from gance_tpu_torch.ops.phase_block import fold_conv1_weights

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    k2d = torch.tensor(np.outer(TAPS, TAPS), dtype=torch.float32, device="cuda")
    records = []
    for name, shapes in path_shapes(config).items():
        # (shape, launches per forward, option, offset): option is C's w_logical,
        # B's taps or A's noise batch; offset puts x's base that many elements
        # past a 16-byte boundary (a contiguous view with a storage offset)
        cases = [(s, n, TAPS if name == "upsample2x_blur" else None, 0) for s, n in shapes]
        if name == "fused_bias_noise_lrelu":
            top = shapes[-1][0]
            cases.append(((TRAIN_BATCH,) + top[1:], 0, TRAIN_BATCH, 0))  # per-sample noise
            cases.append((top, 0, None, 1))  # a misaligned base: A's scalar path
        if name == "blur4_separable_pad11":
            # junk columns past an odd w_logical, filled with NaN: never read
            b, c, h, _ = shapes[-1][0]
            cases.append(((b, c, h, h + 15), 0, h, 0))
        if name == "upsample2x_blur":
            cases.append((shapes[-1][0], 0, TAPS_1234, 0))  # a FIR that is not symmetric
            cases.append((shapes[-1][0], 0, TAPS, 1))  # a misaligned base: B's scalar path
        sums = {d: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
                for d in ("float32", "bfloat16")}
        totals = sums["float32"]
        max_err, bound_by = 0.0, "bytes"
        for shape, per_forward, option, offset in cases:
            for dtype in (torch.float32, torch.bfloat16):
                if offset:
                    count = math.prod(shape)
                    x = randn((count + 16,), dtype)[offset:offset + count].view(shape)
                else:
                    x = randn(shape, dtype)
                b, c, h, w = shape
                size = x.element_size()
                library: Optional[Callable[[], torch.Tensor]] = None
                note = ""
                tolerance: Dict[str, float] = {}
                flops_per_s = FP32_FLOPS_PER_S
                if name == "fused_bias_noise_lrelu":
                    noise = randn((option or 1, 1, h, w), torch.float32)
                    bias = randn((c,), torch.float32)
                    strength = torch.tensor(0.37, device="cuda")
                    run = lambda: K.fused_bias_noise_lrelu(x, noise, bias, strength)  # noqa: E731
                    plain = lambda: K.fused_bias_noise_lrelu_plain(x, noise, bias, strength)  # noqa: E731
                    moved, flops = 2 * x.numel() * size + noise.numel() * 4, 5 * x.numel()
                elif name == "upsample2x_blur":
                    taps = option
                    run = lambda: K.upsample2x_blur(x, taps)  # noqa: E731
                    plain = lambda: K.upsample2x_blur_plain(x, taps)  # noqa: E731
                    # the transpose conv flips its kernel: the same polyphase taps
                    kt = torch.tensor(np.outer(taps, taps)[::-1, ::-1].copy(), device="cuda")
                    kt = kt.to(dtype).expand(c, 1, 4, 4)
                    library = lambda: F.conv_transpose2d(x, kt, stride=2, padding=1, groups=c)  # noqa: E731
                    moved, flops = 5 * x.numel() * size, 16 * x.numel()
                elif name == "phase_conv1_torgb":
                    x.mul_(0.5)
                    # the folded Conv1 of a random 3x3 weight, as on the main path:
                    # 28 of its 64 (tap, in-phase, out-phase) blocks are zero
                    w4 = fold_conv1_weights(randn((c // 4, c // 4, 3, 3), torch.float32)
                                            * (9 * c // 4) ** -0.5)
                    demod = randn((b, c), torch.float32).abs() + 0.5
                    nb = randn((1, c, h + 1, w + 1), torch.float32) * 0.1
                    wrgb = randn((b, c, 16), torch.float32) * c ** -0.5
                    wrgb[:, :, 12:] = 0.0
                    run = lambda: K.phase_conv1_torgb(x, w4, demod, nb, wrgb)  # noqa: E731
                    plain = lambda: K.phase_conv1_torgb_plain(x, w4, demod, nb, wrgb)  # noqa: E731
                    w4d, demodd, nbd, wrgbd = (t.to(dtype) for t in (w4, demod, nb, wrgb))

                    def library() -> torch.Tensor:
                        # no single call computes E: the composition it replaces
                        z = F.conv2d(x, w4d, padding=1) * demodd[:, :, None, None] + nbd
                        z = torch.maximum(z, z * 0.2)
                        return torch.einsum("bchw,bck->bkhw", z, wrgbd)

                    outs = b * (h + 1) * (w + 1)
                    moved = (x.numel() + w4.numel() + nb.numel() + wrgb.numel() + 16 * outs) * size
                    moved += demod.numel() * 4
                    # the products this run's weights need: the non-zero entries of
                    # w4 (36 of its 64 blocks) and of wrgb (12 of its 16 columns)
                    nonzero = b * int(torch.count_nonzero(w4)) + int(torch.count_nonzero(wrgb))
                    flops = 2 * (h + 1) * (w + 1) * nonzero
                    if dtype == torch.bfloat16:
                        flops_per_s = BF16_FLOPS_PER_S
                    dense = 2 * outs * c * (4 * c + 16)
                    note = (f" (dense folded contraction: bound_ms "
                            f"{bound_ms(moved, dense, flops_per_s)[0]:.4f}, information only)")
                    tolerance = dict(fp32_rel=1e-4, bf16_rel=1e-2)
                else:
                    w_logical = option
                    wl = w if w_logical is None else w_logical
                    if w_logical is not None:
                        x[..., wl:] = float("nan")
                    run = lambda: K.blur4_separable_pad11(x, TAPS, w_logical)  # noqa: E731
                    plain = lambda: K.blur4_separable_pad11_plain(x, TAPS, w_logical)  # noqa: E731
                    kc = k2d.to(dtype).expand(c, 1, 4, 4)
                    library = lambda: F.conv2d(x[..., :wl], kc, padding=1, groups=c)  # noqa: E731
                    outs = b * c * (h - 1) * (wl - 1)
                    moved, flops = (b * c * h * wl + outs) * size, 16 * outs
                label = f"{name} {tuple(shape)} {str(dtype)[6:]}"
                if name == "fused_bias_noise_lrelu" and option:
                    label += f" noise {tuple(noise.shape)}"
                elif option is not None and name == "blur4_separable_pad11":
                    label += f" w_logical={option}"
                elif name == "upsample2x_blur" and option != TAPS:
                    label += f" taps={option}"
                if offset:
                    label += f" x at {offset} element past a 16-byte boundary"
                got, want = run(), plain()
                torch.cuda.synchronize()
                if name in ("fused_bias_noise_lrelu", "upsample2x_blur"):  # bit for bit
                    err = check_close(label, got, want, fp32_rel=0.0, bf16_rel=0.0)
                else:
                    err = check_close(label, got, want, **tolerance)
                lib_ms = None
                if library is not None:
                    if dtype == torch.float32:  # the yardstick computes the same function
                        check_close(label + " (library call)", library(), want, **tolerance)
                    lib_ms = time_ms(library)
                ms, plain_ms = time_ms(run), time_ms(plain)
                bms, by = bound_ms(moved, flops, flops_per_s)
                print(f"kernel {label}: max_abs_err {err:.3g} ms {ms:.4f} plain_ms "
                      f"{plain_ms:.4f} library_ms {lib_ms if lib_ms is None else round(lib_ms, 4)} "
                      f"bound_ms {bms:.4f} ({by}){note}", flush=True)
                if per_forward:
                    t = sums[str(dtype)[6:]]
                    t["ms"] += per_forward * ms
                    t["plain_ms"] += per_forward * plain_ms
                    t["bound_ms"] += per_forward * bms
                    t["library_ms"] += per_forward * (lib_ms or 0.0)
                if dtype == torch.float32 and per_forward:
                    bound_by = by
                    max_err = max(max_err, err)
                del x, got, want
        print_sums(name, "synthesis forward at batch 8", sums)
        records.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": 0,
            "max_abs_err": max_err,
            "ms": totals["ms"],
            "plain_ms": totals["plain_ms"],
            "bound_ms": totals["bound_ms"],
            "bound_by": bound_by,
            "library_ms": None if name == "fused_bias_noise_lrelu" else totals["library_ms"],
        })
    records.append(stencil_phase(config, randn))
    torch.cuda.empty_cache()
    return records


def stencil_phase(config, randn: Callable) -> dict:
    """Kernel D at the training path's shapes (batch 4), in fp32 and bf16:
    every blur of one discriminator forward, C's input gradient at the top
    block ((4, 64, 1024, 1024) padded (2, 2) -> (4, 64, 1025, 1025), taps the
    flipped outer product of C's) and the FIR (1, 2, 3, 4), which is not
    symmetric. D and its twin sum alike: fp32 within 1e-5 of the output's
    scale, bf16 within 2 ulps. The library call is a depthwise `conv2d`."""
    from gance_tpu_torch.ops.cuda import fused_ops as K

    binomial = np.outer(TAPS, TAPS) / 4.0
    top = (TRAIN_BATCH, config.nf(config.resolution_log2 - 1), config.resolution, config.resolution)
    cases = [(shape, n, pads, binomial, "") for shape, n, pads in discriminator_shapes(config)]
    cases += [(top, 0, (2, 2), np.outer(TAPS, TAPS)[::-1, ::-1], " (C's input gradient)"),
              (top, 0, (2, 2), FIR_1234, " FIR (1,2,3,4)")]
    sums = {d: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
            for d in ("float32", "bfloat16")}
    max_err = 0.0
    for shape, per_forward, pads, fir, note in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(shape, dtype)
            b, c, h, w = shape
            p0, p1 = pads
            kt = torch.tensor(np.ascontiguousarray(fir), dtype=dtype, device="cuda").expand(c, 1, 4, 4)
            run = lambda: K.stencil_blur4_valid(x, fir, pads)  # noqa: E731
            plain = lambda: K.stencil_blur4_valid_plain(x, fir, pads)  # noqa: E731
            library = lambda: F.conv2d(x, kt, padding=p0, groups=c)  # noqa: E731
            outs = b * c * (h + p0 + p1 - 3) * (w + p0 + p1 - 3)
            moved, flops = (x.numel() + outs) * x.element_size(), 32 * outs
            label = f"stencil_blur4_valid {shape} pads {pads} {str(dtype)[6:]}{note}"
            with torch.no_grad():
                got, want = run(), plain()
                torch.cuda.synchronize()
                err = check_close(label, got, want)
                if dtype == torch.float32:
                    check_close(label + " (library call)", library(), want)
                lib_ms, ms, plain_ms = time_ms(library), time_ms(run), time_ms(plain)
            bms, by = bound_ms(moved, flops)
            print(f"kernel {label}: max_abs_err {err:.3g} ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms {lib_ms:.4f} bound_ms {bms:.4f} ({by})", flush=True)
            if per_forward:
                for key, value in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bms),
                                   ("library_ms", lib_ms)):
                    sums[str(dtype)[6:]][key] += per_forward * value
            if dtype == torch.float32 and per_forward:
                max_err = max(max_err, err)
            del x, got, want
    print_sums("stencil_blur4_valid", "discriminator forward at batch 4", sums)
    return {"name": "stencil_blur4_valid", "route": "cuda",
            "source": SOURCES["stencil_blur4_valid"], "replaces": REPLACES["stencil_blur4_valid"],
            "launches": 0, "max_abs_err": max_err, "bound_by": "bytes", **sums["float32"]}


def smoke_params(seed: int, config) -> dict:
    """Random config-f params with every epilogue term non-zero."""
    from gance_tpu_torch.models.stylegan2 import init_generator_params

    params = init_generator_params(seed, config)
    rng = np.random.RandomState(seed + 1)
    for name, block in params["synthesis"].items():
        if name == "noise":
            continue
        for layer_name, layer in block.items():
            if "bias" in layer:
                layer["bias"] = (0.1 * rng.standard_normal(layer["bias"].shape)).astype(np.float32)
            if "noise_strength" in layer:
                layer["noise_strength"] = np.float32(rng.uniform(0.05, 0.3))
            if layer_name == "ToRGB":
                # keep the summed RGB skip chain inside [-1, 1] for most pixels
                layer["weight"] = (layer["weight"] * 0.15).astype(np.float32)
    params["dlatent_avg"] = (0.5 * rng.standard_normal(config.dlatent_size)).astype(np.float32)
    return params


def keys_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float64 weights of a Keys cubic (a = -0.5) resize along one
    axis, antialiased on downscale, written out here apart from the port's
    `cubic_resize_matrix`: half-pixel sample centres, the kernel widened by
    n_in / n_out when shrinking, each column normalised to sum 1."""
    scale = n_in / n_out
    centres = (np.arange(n_out) + 0.5) * scale - 0.5
    d = np.abs(np.arange(n_in)[:, None] - centres[None, :]) / max(scale, 1.0)
    k = np.where(d < 1, 1.5 * d**3 - 2.5 * d**2 + 1,
                 np.where(d < 2, -0.5 * d**3 + 2.5 * d**2 - 4 * d + 2, 0.0))
    return k / k.sum(axis=0, keepdims=True)


def check_frames(label: str, images: np.ndarray, count: int, resolution: int) -> None:
    require(images.dtype == np.uint8 and images.shape == (count, resolution, resolution, 3),
            f"{label}: got {images.dtype} {images.shape}")
    for i, image in enumerate(images):
        saturated = float(np.mean((image == 0) | (image == 255)))
        require(float(image.std()) > 10.0, f"{label}[{i}]: near-constant image")
        require(saturated < 0.5, f"{label}[{i}]: {saturated:.2f} of pixels saturated")


def forward_launches(config, phase: bool = False, resize: bool = False) -> Dict[str, int]:
    """Kernel launches of one synthesis forward. On the phase path the top
    block's two conv layers take their epilogue in phase space (not A), its
    blur is folded into the conv (not C), and its Conv1 + ToRGB run as E; the
    last skip upsample is B's interleave on the float path (a resize, or a
    float output as the projector asks for) and the plain phase planes on the
    fused uint8 path."""
    blocks = config.resolution_log2 - 2
    return {
        "fused_bias_noise_lrelu": 1 + 2 * blocks - 2 * phase,
        "upsample2x_blur": blocks - (phase and not resize),
        "blur4_separable_pad11": blocks - phase,
        "phase_conv1_torgb": int(phase),
        "stencil_blur4_valid": 0,
    }


def launches_per_forward(label: str, forwards: int, config, phase: bool = False,
                         resize: bool = False) -> Dict[str, int]:
    """Check the launches of the request just served against
    `forward_launches` times the forwards."""
    from gance_tpu_torch.ops.cuda.fused_ops import LAUNCHES

    counts = dict(LAUNCHES)
    want = {k: v * forwards for k, v in forward_launches(config, phase, resize).items()}
    print(f"launches {label} ({forwards} forwards): {counts}", flush=True)
    require(counts == want, f"{label}: launches {counts} != {want}")
    return counts


def projection_launches(config, steps: int, phase: bool) -> Dict[str, int]:
    """Kernel launches of a `project_batch` of `steps` steps: each step one
    synthesis forward with a float output and its backward to w and the noise
    planes, in which each C's input gradient launches one D (A's, B's and E's
    backward passes are plain PyTorch); then one forward for the final render."""
    forward = forward_launches(config, phase, resize=True)
    step = dict(forward, stencil_blur4_valid=forward["blur4_separable_pad11"])
    return {k: steps * step[k] + forward[k] for k in forward}


def share_within_one_step(a: np.ndarray, b: np.ndarray) -> Tuple[int, float]:
    """(max step difference, share of values within 1 step) of two uint8 arrays."""
    steps = np.abs(a.astype(int) - b.astype(int))
    return int(steps.max()), float(np.mean(steps <= 1))


def require_close_frames(label: str, got: np.ndarray, want: np.ndarray) -> None:
    """uint8 frames within 1 step on at least 99.9% of values."""
    worst, share = share_within_one_step(got, want)
    print(f"{label}: max {worst} steps, {share:.6f} within 1 step", flush=True)
    require(share >= 0.999, f"{label}: {share:.5f} of values within 1 step")


def set_phase(mode: str) -> None:
    os.environ[PHASE_ENV] = mode


def main_path_phase(config, workdir: Path) -> Tuple[Dict[str, int], object, np.ndarray]:
    from gance_tpu_torch.models.pickle_loader import save_generator_pickle
    from gance_tpu_torch.models.stylegan2 import generator_apply
    from gance_tpu_torch.ops.cuda.fused_ops import reset_launch_counts
    from gance_tpu_torch.synthesis.runtime import MultiNetwork, SynthesisNetwork

    paths = []
    for i in range(2):
        path = workdir / f"{i}_net.pkl"
        start = time.perf_counter()
        save_generator_pickle(smoke_params(SEED + 10 * i, config), path)
        print(f"wrote {path.name}: {path.stat().st_size / 2**20:.1f} MiB in "
              f"{time.perf_counter() - start:.1f} s", flush=True)
        paths.append(path)
    rng = np.random.RandomState(SEED)
    net = SynthesisNetwork.from_pkl(paths[0])
    require(net.device.type == "cuda", f"from_pkl placed the net on {net.device}")
    res = config.resolution
    totals: Dict[str, int] = {}

    def serve(label: str, request: Callable[[], np.ndarray], forwards: int, count: int,
              side: int = res, phase: bool = False) -> np.ndarray:
        """One request with the counts set to 0 just before it and read just after."""
        set_phase("on" if phase else "off")
        reset_launch_counts()
        images = request()
        for k, v in launches_per_forward(label, forwards, config, phase=phase,
                                         resize=side != res).items():
            totals[k] = totals.get(k, 0) + v
        check_frames(label, images, count, side)
        return images

    z = rng.standard_normal((BATCH, config.latent_size)).astype(np.float32)
    w_plus = rng.standard_normal(
        (BATCH, config.num_style_rows, config.dlatent_size)).astype(np.float32)
    vectors = serve("images_from_vectors", lambda: net.images_from_vectors(z), 1, BATCH)
    matrices = serve("images_from_matrices", lambda: net.images_from_matrices(w_plus), 1, BATCH)

    frames = rng.standard_normal((40, config.latent_size)).astype(np.float32)
    indices = np.arange(40) % 2
    with MultiNetwork(paths) as multi:
        # windows of 16, 16, 8 frames: 8 + 8, 8 + 8, 4 + 4 per network
        stream = serve("synthesize_stream", lambda: np.stack(list(multi.synthesize_stream(
            frames, indices, batch_size=BATCH, lookahead=2))), 6, 40)
        set_phase("off")
        for start, end in ((0, 16), (16, 32), (32, 40)):
            for index in (0, 1):
                rows = np.arange(start, end)[indices[start:end] == index]
                want = multi.network(index).images_from_vectors(frames[rows])
                diff = np.abs(stream[rows].astype(int) - want.astype(int))
                require(int(diff.max()) <= 1, f"stream frames {rows.tolist()} out of order "
                        f"or wrong network (max diff {int(diff.max())})")
        other = multi.network(1).images_from_vectors(frames[:1])
        require(float(np.abs(other.astype(int) - stream[:1].astype(int)).mean()) > 5.0,
                "networks 0 and 1 render the same frame")
        # the polyphase top block with kernel E: one window of 8 + 8 frames
        phase_stream = serve("synthesize_stream phase", lambda: np.stack(list(
            multi.synthesize_stream(frames[:16], indices[:16], batch_size=BATCH, lookahead=2))),
            2, 16, phase=True)
        require_close_frames("phase vs standard stream", phase_stream, stream[:16])
    print("main path: vectors, matrices and a 40-frame 2-network stream served; "
          "stream order checked", flush=True)

    phase_vectors = serve("images_from_vectors phase", lambda: net.images_from_vectors(z), 1,
                          BATCH, phase=True)
    require_close_frames("phase vs standard vectors", phase_vectors, vectors)
    phase_matrices = serve("images_from_matrices phase",
                           lambda: net.images_from_matrices(w_plus), 1, BATCH, phase=True)
    require_close_frames("phase vs standard matrices", phase_matrices, matrices)

    small = SynthesisNetwork.from_staged((net.params, net.config), net.path,
                                         output_side_length=RESIZE_SIDE)
    resized = serve(f"images_from_vectors side {RESIZE_SIDE}",
                    lambda: small.images_from_vectors(z), 1, BATCH, side=RESIZE_SIDE)
    phase_resized = serve(f"images_from_vectors side {RESIZE_SIDE} phase",
                          lambda: small.images_from_vectors(z), 1, BATCH, side=RESIZE_SIDE,
                          phase=True)
    require_close_frames("phase vs standard resized", phase_resized, resized)
    # the resize against the card's float render, resized in float64 on the host
    # with this script's own weights
    set_phase("off")
    with torch.inference_mode():
        fine = generator_apply(net.params, torch.from_numpy(z[:2]).cuda(), config).cpu().numpy()
    weights = keys_resize_weights(res, RESIZE_SIDE)
    host = np.einsum("bhwc,hy->bywc", fine.astype(np.float64), weights, optimize=True)
    host = np.einsum("bywc,wx->byxc", host, weights, optimize=True)
    host = np.clip(np.floor(host * 127.5 + 128.0), 0, 255).astype(np.uint8)
    require_close_frames("resized vs host float64 resize", resized[:2], host)
    print(f"phase path: vectors, matrices, a 16-frame stream and a side-{RESIZE_SIDE} request "
          "on both paths served and checked", flush=True)
    return totals, net, z


def parity_phase(net, z: np.ndarray) -> None:
    from gance_tpu_torch.models.stylegan2 import generator_apply, images_to_uint8
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    set_phase("off")
    cpu_net = SynthesisNetwork.from_staged((net.params, net.config), net.path, device="cpu")
    z1 = torch.from_numpy(z[:1])
    with torch.inference_mode():
        start = time.perf_counter()
        cpu = generator_apply(cpu_net.params, z1, cpu_net.config)
        cpu_s = time.perf_counter() - start
        gpu = generator_apply(net.params, z1.cuda(), net.config).cpu()
    diff = float((gpu - cpu).abs().max())
    u_gpu, u_cpu = images_to_uint8(gpu).numpy(), images_to_uint8(cpu).numpy()
    steps = np.abs(u_gpu.astype(int) - u_cpu.astype(int))
    print(f"parity card vs CPU (1 frame, fp32, CPU {cpu_s:.1f} s): float max abs {diff:.3g}; "
          f"uint8 max {int(steps.max())} steps, {float(np.mean(steps == 0)):.6f} identical",
          flush=True)
    require(diff <= 1e-3, f"card vs CPU float max abs {diff:.3g} > 1e-3")
    within = float(np.mean(steps <= 1))
    require(within >= 0.999, f"card vs CPU uint8: {within:.5f} of pixels within 1 step")

    bf16_net = SynthesisNetwork.from_staged(
        (net.params, net.config), net.path, compute_dtype=torch.bfloat16)
    u_f32 = net.images_from_vectors(z).astype(np.float64)
    for mode in ("off", "on"):
        set_phase(mode)
        u_bf16 = bf16_net.images_from_vectors(z).astype(np.float64)
        mse = float(np.mean((u_bf16 - u_f32) ** 2))
        psnr = 10 * math.log10(255.0**2 / mse) if mse else float("inf")
        print(f"bf16 (phase path {mode}) vs fp32 render (batch {BATCH}): PSNR {psnr:.2f} dB, "
              f"mean abs {float(np.mean(np.abs(u_bf16 - u_f32))):.3f} steps", flush=True)
        require(psnr >= 35.0, f"bf16 PSNR (phase path {mode}) {psnr:.2f} dB < 35")
    set_phase("off")


def fps_phase(net, z: np.ndarray, card: str) -> None:
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    for dtype in (torch.float32, torch.bfloat16):
        run_net = net if dtype == torch.float32 else SynthesisNetwork.from_staged(
            (net.params, net.config), net.path, compute_dtype=dtype)
        for mode in ("off", "on"):
            set_phase(mode)
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: run_net.device_images_from_vectors(z), min_total_ms=2000.0)
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"fps {str(dtype)[6:]} batch {BATCH} at {net.resolution}px phase {mode}: "
                  f"{BATCH / ms * 1e3:.2f} frames/s ({ms:.2f} ms per batch, peak "
                  f"{peak:.2f} GiB) on {card}", flush=True)
    set_phase("off")


def phase_conv1_inputs() -> List[np.ndarray]:
    """Kernel E's operands (x, v, demod, noise_bias, wrgb) at (2, 256, 64, 64),
    w4 being fold_conv1_weights(v). The per-sample noise_bias puts every
    pre-activation at least 0.05 from the lrelu's kink (the conv sums are
    taken on the host first), so the card and the CPU, whose fp32 sums differ
    in order, take the same slope everywhere."""
    from gance_tpu_torch.ops.cuda import fused_ops as K
    from gance_tpu_torch.ops.precision import exact_fp32

    rng = np.random.RandomState(5)
    b, c4, h = 2, 256, 64
    c = c4 // 4
    x = (rng.randn(b, c4, h, h) * 0.5).astype(np.float32)
    v = (rng.randn(c, c, 3, 3) * (9 * c) ** -0.5).astype(np.float32)
    demod = (rng.rand(b, c4) + 0.5).astype(np.float32)
    wrgb = (rng.randn(b, c4, 16) * c4 ** -0.5).astype(np.float32)
    wrgb[:, :, 12:] = 0.0
    with exact_fp32():
        acc = F.conv2d(torch.from_numpy(x), K.fold_conv1_weights(torch.from_numpy(v)),
                       padding=1).numpy()
    s = rng.randn(b, c4, h + 1, h + 1) * 0.3
    pre = np.sign(s) * (0.05 + np.abs(s))
    noise_bias = (pre - acc * demod[:, :, None, None]).astype(np.float32)
    return [x, v, demod, noise_bias, wrgb]


def gradient_phase() -> None:
    """First- and second-order gradients through the Functions of A-E on the
    card against the same gradients through the twins on the CPU (the
    wrappers take the twins for CPU tensors): A-D at (4, 64, 128, 128), E at
    (2, 256, 64, 64) with w4 = fold_conv1_weights(v) and v differentiated."""
    from gance_tpu_torch.ops.cuda import fused_ops as K

    e_inputs = phase_conv1_inputs()

    def case(name: str, device: str):
        rng = np.random.RandomState(3)

        def t(*shape: int) -> torch.Tensor:
            return torch.tensor(np.asarray(rng.randn(*shape), np.float32), device=device)

        if name == "phase_conv1_torgb":
            def e_fn(x, v, demod, noise_bias, wrgb):
                return K.phase_conv1_torgb(x, K.fold_conv1_weights(v), demod, noise_bias, wrgb)
            return e_fn, [torch.tensor(a, device=device) for a in e_inputs]
        shape = (TRAIN_BATCH, 64, 128, 128)
        if name == "fused_bias_noise_lrelu":
            return K.fused_bias_noise_lrelu, [t(*shape), t(shape[0], 1, 128, 128), t(64), t()]
        if name == "upsample2x_blur":
            return (lambda x: K.upsample2x_blur(x, TAPS_1234)), [t(*shape)]
        if name == "blur4_separable_pad11":
            return (lambda x: K.blur4_separable_pad11(x, TAPS_1234, 121)), [t(*shape)]
        return (lambda x: K.stencil_blur4_valid(x, FIR_1234, (2, 1))), [t(*shape)]

    def gradients(name: str, device: str):
        fn, inputs = case(name, device)
        inputs = [v.requires_grad_(True) for v in inputs]
        y = fn(*inputs)
        gen = torch.Generator().manual_seed(4)
        w = torch.randn(y.shape, generator=gen).to(device)
        first = torch.autograd.grad((y.square() * w).sum(), inputs, create_graph=True)
        u = [torch.randn(v.shape, generator=gen).to(device) for v in inputs]
        second = torch.autograd.grad(sum((g * v).sum() for g, v in zip(first, u)), inputs,
                                     allow_unused=True)
        second = [torch.zeros_like(v) if g is None else g for v, g in zip(inputs, second)]
        return [g.detach().cpu() for g in first], [g.detach().cpu() for g in second]

    for name in ("fused_bias_noise_lrelu", "upsample2x_blur", "blur4_separable_pad11",
                 "stencil_blur4_valid", "phase_conv1_torgb"):
        got, want = gradients(name, "cuda"), gradients(name, "cpu")
        worst = 0.0
        for order, label in ((0, "first"), (1, "second")):
            for i, (g, r) in enumerate(zip(got[order], want[order])):
                scale = float(r.abs().max())
                err = float((g - r).abs().max())
                require(scale > 0 and err <= 1e-4 * scale,
                        f"{name} {label}-order gradient of input {i}: max abs {err:.3g}, scale {scale:.3g}")
                worst = max(worst, err / scale)
        print(f"gradients {name}: first and second order on the card vs the CPU twin, "
              f"worst {worst:.3g} of scale (limit 1e-4)", flush=True)


def train_launches(config, apply_r1: bool, apply_pl: bool) -> Dict[str, int]:
    """Kernel launches of one train step, derived from the architecture. A G
    forward runs A 1 + 2 * blocks times and B and C once per block; a D
    forward runs D twice per block. Backward: A's and B's are plain PyTorch;
    C's input gradient is one D, D's is one D. The D step makes fakes without
    a graph, runs D on fakes and reals, back-propagates both (one D each per
    D launch) and with R1 also takes the reals' gradient (one D each) and
    differentiates that again (one D each). The G step runs G and D forward
    and back (one D per C and per D); path length adds a G forward on half
    the batch, its input gradient (one D per C) and the second order through
    both (one D per C, twice)."""
    blocks = config.resolution_log2 - 2
    a, bc, d_fwd = 1 + 2 * blocks, blocks, 2 * blocks
    forwards = 2 + apply_pl
    d_launches = 4 * d_fwd + 2 * d_fwd * apply_r1  # D step
    d_launches += 2 * d_fwd + bc + 3 * bc * apply_pl  # G step
    return {"fused_bias_noise_lrelu": a * forwards, "upsample2x_blur": bc * forwards,
            "blur4_separable_pad11": bc * forwards, "stencil_blur4_valid": d_launches,
            "phase_conv1_torgb": 0}


def g_step_launches(config, apply_pl: bool, phase: bool) -> Dict[str, int]:
    """Kernel launches of one G step's gradients (`g_step_gradients`): G and,
    with path length, G on half the batch, forward; D forward and back; C's
    input gradients (one D each) and path length's second order (one D per
    C, twice). On the phase path the top block runs E and not C or its two
    A epilogues; E's backward is plain PyTorch."""
    blocks = config.resolution_log2 - 2
    forwards = 1 + apply_pl
    c = blocks - phase
    return {"fused_bias_noise_lrelu": (1 + 2 * blocks - 2 * phase) * forwards,
            "upsample2x_blur": blocks * forwards, "blur4_separable_pad11": c * forwards,
            "stencil_blur4_valid": 4 * blocks + c + 3 * c * apply_pl,
            "phase_conv1_torgb": int(phase) * forwards}


def phase_g_step_phase(state, config, train_config, card: str) -> Dict[str, int]:
    """One fp32 G step with path length at 1024px (its gradients and losses,
    `g_step_gradients`), standard path and then phase path
    (GANCE_TPU_PHASE1024=on: kernel E forward, E's Function backward, PL's
    second order through it) with the same state and draws: losses within
    1e-3 relative, launches as derived. Returns the phase path's launches."""
    from gance_tpu_torch.ops.cuda.fused_ops import LAUNCHES, reset_launch_counts
    from gance_tpu_torch.parallel import training as T

    draws = T.draw_step(SEED, 5, TRAIN_BATCH, config, train_config, "cuda")
    results = {}
    for mode in ("off", "on"):
        set_phase(mode)
        reset_launch_counts()
        start = time.perf_counter()
        grads, metrics = T.g_step_gradients(state.g_params, state.d_params, draws, state.pl_mean,
                                            True, config, train_config)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts = dict(LAUNCHES)
        values = {k: float(v) for k, v in metrics.items()}
        norm = float(torch.sqrt(sum(g.float().square().sum() for g in grads)))
        del grads
        want = g_step_launches(config, True, mode == "on")
        print(f"G step with PL, fp32 batch {TRAIN_BATCH}, phase {mode}: {seconds:.3f} s, losses "
              f"{values}, gradient norm {norm:.6g}, launches {counts} on {card}", flush=True)
        require(counts == want, f"G step phase {mode}: launches {counts} != {want}")
        require(all(math.isfinite(v) for v in values.values()) and math.isfinite(norm),
                f"G step phase {mode}: {values}, norm {norm}")
        results[mode] = values, counts
    set_phase("off")
    (off, _), (on, counts) = results["off"], results["on"]
    for name in ("g_loss", "pl", "pl_length"):
        err = abs(on[name] - off[name]) / max(abs(off[name]), 1e-30)
        require(off[name] != 0 and err <= 1e-3, f"G step {name}: phase path {on[name]} vs "
                f"standard {off[name]}")
    print("G step with PL: the phase path's losses within 1e-3 of the standard path's", flush=True)
    return counts


class SeededImages:
    """Seeded images in [-1, 1] in host memory, with the dataset interface
    `run_training` reads: step s's batch is a function of (seed, s)."""

    def __init__(self, seed: int, count: int, resolution: int) -> None:
        rng = np.random.RandomState(seed)
        side = resolution // 16  # smooth content: 16x16 blocks of noise, blurred by upsampling
        coarse = rng.uniform(-1, 1, (count, 3, side, side)).astype(np.float32)
        fine = F.interpolate(torch.from_numpy(coarse), size=(resolution, resolution),
                             mode="bilinear", align_corners=False)
        self.images = fine.permute(0, 2, 3, 1).contiguous().numpy()
        self.seed = seed

    def batches(self, start: int, total: int, batch: int):
        for step in range(start, total):
            idx = np.random.RandomState(self.seed + step).randint(0, len(self.images), batch)
            yield step, self.images[idx]


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float().cpu() - want.float().cpu()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def train_parity_phase() -> None:
    """One step's losses and gradients, R1 and PL on, at 32px with config-f's
    widths (512 channels everywhere), on the card and on the CPU path."""
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.parallel import training as T

    config = GeneratorConfig(resolution=32)
    tc = T.TrainingConfig()
    draws = T.draw_step(SEED, 0, TRAIN_BATCH, config, tc, "cpu")
    reals = torch.from_numpy(SeededImages(SEED, 8, config.resolution).images[:TRAIN_BATCH])
    results = {}
    for device in ("cuda", "cpu"):
        start = time.perf_counter()
        state = T.init_training_state(SEED, config, tc, device=device)
        d_grads, d_m = T.d_step_gradients(state.g_params, state.d_params, reals.to(device),
                                          draws.to(device), True, config, tc)
        g_grads, g_m = T.g_step_gradients(state.g_params, state.d_params, draws.to(device),
                                          state.pl_mean, True, config, tc)
        results[device] = ([g.detach().cpu() for g in d_grads],
                           [g.detach().cpu() for g in g_grads], {**d_m, **g_m})
        print(f"train parity: one step's gradients on {device} in "
              f"{time.perf_counter() - start:.1f} s", flush=True)
    (dc, gc, mc), (dp, gp, mp) = results["cuda"], results["cpu"]
    for name in ("d_loss", "r1", "g_loss", "pl"):
        err = abs(float(mc[name]) - float(mp[name])) / abs(float(mp[name]))
        require(float(mp[name]) != 0 and err <= 1e-3, f"train parity {name}: {float(mc[name])} "
                f"on the card vs {float(mp[name])} on the CPU")
    state = T.init_training_state(SEED, config, tc, device="cpu")
    for net, got, want, params in (("D", dc, dp, state.d_params), ("G", gc, gp, state.g_params)):
        leaves, worst_leaf, worst_max = [], (0.0, ""), (0.0, "")
        for (path, _), g, r in zip(T.tree_leaves(params), got, want):
            if float(r.norm()) == 0.0:  # noise buffers and dlatent_avg get none
                require(float(g.abs().max()) == 0.0, f"train parity {net} {path}: not zero")
                continue
            err = float((g - r).norm() / r.norm())
            require(err <= 1e-1, f"train parity {net} gradient {path}: {err:.3g} of its norm")
            worst_leaf = max(worst_leaf, (err, path))
            worst_max = max(worst_max, (max_rel(g, r), path))
            leaves.append((g.reshape(-1), r.reshape(-1)))
        whole_got = torch.cat([g for g, _ in leaves])
        whole_want = torch.cat([r for _, r in leaves])
        whole = float((whole_got - whole_want).norm() / whole_want.norm())
        print(f"train parity {net} gradients, card vs CPU: whole net {whole:.3g} of its norm "
              f"(limit 2e-2); worst leaf {worst_leaf[0]:.3g} of its norm, {worst_leaf[1]} (limit "
              f"1e-1); worst max-abs over the leaf's max {worst_max[0]:.3g}, {worst_max[1]} "
              f"(information)", flush=True)
        require(whole <= 2e-2, f"train parity {net}: whole-net gradient {whole:.3g} of its norm")
    print(f"train parity (32px, 512 channels, batch {TRAIN_BATCH}, R1 and PL): losses "
          f"{ {k: round(float(v), 6) for k, v in mc.items()} } within 1e-3 of the CPU's", flush=True)


def training_phase(workdir: Path, card: str) -> Dict[str, int]:
    """Config-f 1024px training through run_training: 5 fp32 steps and 2 bf16
    steps at batch 4, the resume check and export-then-serve. Returns the
    launches of the training run."""
    from gance_tpu_torch.models.stylegan2 import (
        GeneratorConfig, generator_apply, images_to_uint8, init_discriminator_params,
        init_generator_params)
    from gance_tpu_torch.ops.cuda.fused_ops import LAUNCHES, reset_launch_counts
    from gance_tpu_torch.parallel import training as T
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    config = GeneratorConfig()
    set_phase("off")
    torch.cuda.empty_cache()
    data = SeededImages(SEED, 8, config.resolution)
    ckpt, ckpt_after_3 = workdir / "train.ckpt", workdir / "train_step4.ckpt"
    out_net = workdir / "trained.pkl"
    totals: Dict[str, int] = {}
    seen: Dict[int, dict] = {}
    events: Dict[str, torch.cuda.Event] = {}

    def before(step: int) -> None:
        if step == 4 and state_config[0].compute_dtype == "float32":
            shutil.copyfile(ckpt, ckpt_after_3)  # written after step 3: the resume check's start
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events["start"] = torch.cuda.Event(enable_timing=True)
        events["start"].record()

    def after(step: int, state, metrics: Dict[str, torch.Tensor]) -> None:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        seconds = events["start"].elapsed_time(end) / 1e3
        counts = dict(LAUNCHES)
        tc = state_config[0]
        apply_r1, apply_pl = step % tc.r1_interval == 0, step % tc.pl_interval == 0
        want = train_launches(config, apply_r1, apply_pl)
        values = {k: float(v) for k, v in metrics.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"train step {step} {tc.compute_dtype} (R1 {apply_r1}, PL {apply_pl}): "
              f"{seconds:.3f} s, peak {peak:.2f} GiB, losses {values}, launches {counts}",
              flush=True)
        require(counts == want, f"train step {step}: launches {counts} != {want}")
        require(all(math.isfinite(v) for v in values.values()), f"train step {step}: {values}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        seen[step] = {"seconds": seconds, "peak": peak, "metrics": values}

    fp32 = T.TrainingConfig()
    state_config = [fp32]
    state = T.run_training(data, config, fp32, ckpt, 5, TRAIN_BATCH, checkpoint_every=4,
                           seed=SEED, device="cuda", before_step=before, after_step=after)
    for k, v in phase_g_step_phase(state, config, fp32, card).items():
        totals[k] = totals.get(k, 0) + v
    g0, d0 = init_generator_params(SEED, config), init_discriminator_params(SEED + 1, config)
    top = f"{config.resolution}x{config.resolution}"

    def change(tensor: torch.Tensor, initial: np.ndarray) -> float:
        return float((tensor.detach().cpu() - torch.from_numpy(initial)).abs().max())

    moved = {
        "G": change(state.g_params["synthesis"][top]["Conv1"]["weight"],
                    g0["synthesis"][top]["Conv1"]["weight"]),
        "EMA": change(state.ema_params["synthesis"][top]["Conv1"]["weight"],
                      g0["synthesis"][top]["Conv1"]["weight"]),
        "D": change(state.d_params[top]["FromRGB"]["weight"], d0[top]["FromRGB"]["weight"]),
    }
    print(f"after 5 fp32 steps, max change of the top block's Conv1 weight (G, EMA) and "
          f"of D's FromRGB weight: {moved}", flush=True)
    require(all(v > 0 for v in moved.values()), f"params did not move: {moved}")

    # (c) resume: step 4 again from the checkpoint written after step 3
    unbroken = {path: leaf.detach().clone() for path, leaf in
                T.tree_leaves(state.g_params) + [("D/" + p, v) for p, v in T.tree_leaves(state.d_params)]}
    del state
    torch.cuda.empty_cache()
    resumed = T.load_checkpoint(ckpt_after_3, fp32, "cuda")
    require(resumed.step == 4, f"checkpoint after step 3 holds step {resumed.step}")
    reals = torch.from_numpy(next(data.batches(4, 5, TRAIN_BATCH))[1]).cuda()
    draws = T.draw_step(SEED, 4, TRAIN_BATCH, config, fp32, "cuda")
    resumed, metrics = T.make_train_step(config, fp32)(resumed, reals, draws)
    again = {k: float(v) for k, v in metrics.items()}
    first = seen[4]["metrics"]
    for name, limit in (("d_loss", 1e-5), ("r1", 1e-5), ("g_loss", 1e-3), ("pl", 1e-3)):
        err = abs(again[name] - first[name]) / max(abs(first[name]), 1e-30)
        require(err <= limit, f"resume: {name} {again[name]} vs unbroken {first[name]}")
    lr = fp32.learning_rate
    worst_max, worst_mean = 0.0, 0.0
    for path, leaf in T.tree_leaves(resumed.g_params) + [
            ("D/" + p, v) for p, v in T.tree_leaves(resumed.d_params)]:
        diff = (leaf.detach() - unbroken[path]).abs()
        worst_max, worst_mean = max(worst_max, float(diff.max())), max(worst_mean, float(diff.mean()))
    print(f"resume from the checkpoint after step 3: step 4 losses {again} vs unbroken {first}; "
          f"params max abs diff {worst_max:.3g} (limit {2.5 * lr}), worst leaf mean "
          f"{worst_mean:.3g} (limit {0.05 * lr})", flush=True)
    require(worst_max <= 2.5 * lr and worst_mean <= 0.05 * lr, "resume: params differ")
    del resumed, unbroken
    torch.cuda.empty_cache()

    # bf16: 2 more steps, resumed from the checkpoint at step 5; export the EMA
    bf16 = T.TrainingConfig(compute_dtype="bfloat16")
    state_config[0] = bf16
    state = T.run_training(data, config, bf16, ckpt, 7, TRAIN_BATCH, checkpoint_every=100,
                           output_network=out_net, seed=SEED, device="cuda",
                           before_step=before, after_step=after)
    require(state.step == 7 and sorted(seen) == list(range(7)), f"steps run: {sorted(seen)}")

    # split of a step between D, R1, G and PL, by CUDA events (fp32, batch 4)
    reals = torch.from_numpy(next(data.batches(0, 1, TRAIN_BATCH))[1]).cuda()
    draws = T.draw_step(SEED, 0, TRAIN_BATCH, config, fp32, "cuda")
    split = {}
    for label, fn in (
        ("D", lambda: T.d_step_gradients(state.g_params, state.d_params, reals, draws, False,
                                         config, fp32)),
        ("D+R1", lambda: T.d_step_gradients(state.g_params, state.d_params, reals, draws, True,
                                            config, fp32)),
        ("G", lambda: T.g_step_gradients(state.g_params, state.d_params, draws, state.pl_mean,
                                         False, config, fp32)),
        ("G+PL", lambda: T.g_step_gradients(state.g_params, state.d_params, draws, state.pl_mean,
                                            True, config, fp32)),
    ):
        split[label] = time_ms(fn, min_total_ms=1.0)
    print(f"step split fp32 batch {TRAIN_BATCH} (ms, CUDA events): {split}; R1 adds "
          f"{split['D+R1'] - split['D']:.1f}, PL adds {split['G+PL'] - split['G']:.1f} on {card}",
          flush=True)
    fp32_steps = [seen[s]["seconds"] for s in (1, 2, 3)]
    print(f"train s/step at 1024px batch {TRAIN_BATCH} on {card}: fp32 step 0 (R1+PL) "
          f"{seen[0]['seconds']:.3f}, steps 1-3 {fp32_steps}, step 4 (PL) {seen[4]['seconds']:.3f}; "
          f"bf16 steps 5-6 {[round(seen[s]['seconds'], 3) for s in (5, 6)]}; peak "
          f"{max(v['peak'] for v in seen.values()):.2f} GiB", flush=True)

    # (d) export, load, serve
    net = SynthesisNetwork.from_pkl(out_net)
    z = np.random.RandomState(SEED).standard_normal((TRAIN_BATCH, config.latent_size)).astype(np.float32)
    served = net.images_from_vectors(z)
    res = config.resolution
    require(served.shape == (TRAIN_BATCH, res, res, 3) and served.dtype == np.uint8,
            f"served {served.shape} {served.dtype}")
    with torch.inference_mode():
        direct = images_to_uint8(generator_apply(
            state.ema_params, torch.from_numpy(z).cuda(), config)).cpu().numpy()
    require_close_frames("served EMA generator vs its params rendered directly", served, direct)
    require(float(served.std()) > 1.0, "served frames are constant")
    print("export: the EMA generator written by run_training loads with "
          "SynthesisNetwork.from_pkl and serves a batch", flush=True)
    del state, net
    torch.cuda.empty_cache()
    return totals


def read_avi(path: Path) -> Tuple[List[np.ndarray], int, np.ndarray]:
    """(uncompressed frames as (H, W, 3) RGB views, the count of compressed
    frames, the concatenated PCM16 samples) of an AVI, by walking its RIFF
    chunks: 'avih' gives the size, '00db' an uncompressed frame (BI_RGB,
    top-down BGR rows padded to 4 bytes), '00dc' a compressed one, '01wb'
    audio."""
    data = memoryview(path.read_bytes())
    require(bytes(data[:4]) == b"RIFF" and bytes(data[8:12]) == b"AVI ", f"{path}: not an AVI")
    frames: List[np.ndarray] = []
    audio: List[np.ndarray] = []
    size = {"compressed": 0}

    def walk(offset: int, end: int) -> None:
        while offset + 8 <= end:
            cid = bytes(data[offset:offset + 4])
            length = int.from_bytes(data[offset + 4:offset + 8], "little")
            body = offset + 8
            if cid == b"LIST":
                walk(body + 4, body + length)
            elif cid == b"avih":
                size["w"] = int.from_bytes(data[body + 32:body + 36], "little")
                size["h"] = int.from_bytes(data[body + 36:body + 40], "little")
            elif cid == b"00db":
                w, h = size["w"], size["h"]
                rows = np.frombuffer(data, np.uint8, length, body).reshape(h, (w * 3 + 3) & ~3)
                frames.append(rows[:, :w * 3].reshape(h, w, 3)[..., ::-1])
            elif cid == b"00dc":
                size["compressed"] += 1
            elif cid == b"01wb":
                audio.append(np.frombuffer(data, "<i2", length // 2, body))
            offset = body + length + (length & 1)

    walk(12, len(data))
    return frames, size["compressed"], (np.concatenate(audio) if audio else np.zeros(0, np.int16))


def stream_batches(indices: np.ndarray) -> List[int]:
    """The batch size of each generator forward of
    `MultiNetwork.synthesize_stream` at its default batch and lookahead: per
    window of batch * lookahead frames, each network index present takes
    full batches, then its remainder padded to the next power of two."""
    from gance_tpu_torch.synthesis.runtime import DEFAULT_BATCH_SIZE, DEFAULT_STREAM_LOOKAHEAD

    window = DEFAULT_BATCH_SIZE * max(DEFAULT_STREAM_LOOKAHEAD, 1)
    sizes = []
    for s in range(0, len(indices), window):
        for i in np.unique(indices[s:s + window]):
            frames = int(np.sum(indices[s:s + window] == i))
            sizes += [DEFAULT_BATCH_SIZE] * (frames // DEFAULT_BATCH_SIZE)
            if frames % DEFAULT_BATCH_SIZE:
                sizes.append(min(2 ** math.ceil(math.log2(frames % DEFAULT_BATCH_SIZE)),
                                 DEFAULT_BATCH_SIZE))
    return sizes


def features_phase(wav: Path) -> None:
    """8a: the noise-blend inputs on the card against the port's CPU path."""
    from gance_tpu_torch.audio.dsp import remap_values_into_range
    from gance_tpu_torch.audio.io import read_wavs_scale_for_video
    from gance_tpu_torch.audio.reduction import reduce_vector_rms_rolling_average
    from gance_tpu_torch.synthesis.inputs import alpha_blend_vectors_max_rms_power_audio

    audio = read_wavs_scale_for_video([wav], PIPELINE_VECTOR, frames_per_second=PIPELINE_FPS).wav_data
    rms = reduce_vector_rms_rolling_average(audio, PIPELINE_VECTOR, device="cpu").result.data
    for count in (2, 3):  # the two networks' indices, and the FFT roll's 0..2
        scaled = remap_values_into_range(rms, (float(rms.min()), float(rms.max())),
                                         (0.0, float(count - 1)), device="cpu").numpy()
        margin = float(np.min(np.abs(scaled - np.floor(scaled) - 0.5)))
        require(margin > 1e-4, f"a frame's scaled RMS (over {count} indices) lies {margin:.2g} "
                "from a half-integer on the CPU side: card and CPU indices cannot be held equal")
    def features(roll: bool, device: str):
        start = time.perf_counter()
        result = alpha_blend_vectors_max_rms_power_audio(
            PIPELINE_ALPHA, roll, (-1.0, 1.0), audio, PIPELINE_VECTOR, [0, 1], device=device)
        return result, time.perf_counter() - start

    for roll in (False, True):
        (card, card_s), (cpu, cpu_s) = features(roll, "cuda"), features(roll, "cpu")
        worst = {}
        for field in ("a_vectors", "b_vectors", "combined"):
            got, want = getattr(card, field).data, getattr(cpu, field).data
            finite = np.isfinite(want)
            require(got.shape == want.shape and bool(np.array_equal(np.isfinite(got), finite))
                    and bool(np.array_equal(np.isnan(got), np.isnan(want))),
                    f"features roll {roll} {field}: shapes or non-finite entries differ")
            worst[field] = float(np.abs(got[finite] - want[finite]).max()) if finite.any() else 0.0
            require(worst[field] <= 1e-4, f"features roll {roll} {field}: card vs CPU max abs "
                    f"{worst[field]:.3g} > 1e-4")
        indices = card.network_indices.result.data
        require(bool(np.array_equal(indices, cpu.network_indices.result.data)),
                f"features roll {roll}: network indices differ between the card and the CPU")
        print(f"pipeline features (4 s WAV, {len(indices)} frames, roll {roll}): card vs CPU max abs "
              f"{worst}, indices equal ({np.bincount(indices).tolist()}); card {card_s:.3f} s, "
              f"CPU {cpu_s:.3f} s", flush=True)


def run_render(wav: Path, paths: List[Path], out: Path, side: int, dtype: str, phase: bool,
               egress: str, trace_dir: Optional[Path] = None) -> dict:
    """One `noise_blend_api` render of `wav` into `out` (vector length 512,
    30 fps, alpha 0.25, no FFT roll) with GANCE_TPU_EGRESS=`egress` and the
    phase path on or off. Returns its wall seconds and its stage stats:
    `features` (audio features), `render` (synthesis and write), `stream`
    (the synthesis stream's share of the render: the time spent waiting in
    its next()), `loading` (the rest of the wall: network loading) and
    `frames`. tools/time_torch_pipeline.py times its renders with this."""
    from gance_tpu_torch.pipelines.noise_blend import noise_blend_api

    stages = out.with_suffix(".stages.jsonl")
    stages.unlink(missing_ok=True)
    os.environ.update(GANCE_TPU_STAGE_STATS=str(stages), GANCE_TPU_EGRESS=egress)
    set_phase("on" if phase else "off")
    torch.cuda.synchronize()
    start = time.perf_counter()
    noise_blend_api([wav], out, paths, None, PIPELINE_FPS, side, None, None, None, PIPELINE_ALPHA,
                    False, (-1.0, 1.0), compute_dtype=dtype, trace_dir=trace_dir, device="cuda")
    wall = time.perf_counter() - start
    del os.environ["GANCE_TPU_STAGE_STATS"], os.environ["GANCE_TPU_EGRESS"]
    stats = {json.loads(line)["stage"]: json.loads(line) for line in stages.read_text().splitlines()}
    stages.unlink()
    features, render = stats["audio_features"]["busy_sec"], stats["render"]["busy_sec"]
    return {"wall": wall, "loading": wall - features - render, "features": features,
            "render": render, "stream": stats["synthesis"]["busy_sec"],
            "frames": stats["render"]["count"]}


def describe_render(r: dict) -> str:
    """A render's wall split and its frames/s, from `run_render`'s result."""
    return (f"wall {r['wall']:.3f} s = network loading {r['loading']:.3f} + audio features "
            f"{r['features']:.3f} + synthesis and write {r['render']:.3f}; end to end "
            f"{r['frames'] / r['wall']:.2f} frames/s, synthesis and write "
            f"{r['frames'] / r['render']:.2f} frames/s; inside the render, the synthesis stream "
            f"{r['stream']:.3f} s ({r['frames'] / r['stream']:.2f} frames/s)")


def render_phase(label: str, wav: Path, paths: List[Path], workdir: Path, config, side: int,
                 dtype: str, phase: bool, egress_mode: str, card: str,
                 check_frames_against_direct: bool) -> Dict[str, int]:
    """8b-8d: one `noise_blend_api` render with GANCE_TPU_EGRESS=`egress_mode` and
    the counts set to 0 just before it and read just after; returns its
    launches."""
    from scipy.io import wavfile

    from gance_tpu_torch.audio.io import read_wavs_scale_for_video
    from gance_tpu_torch.ops.cuda.fused_ops import LAUNCHES, reset_launch_counts
    from gance_tpu_torch.synthesis.inputs import alpha_blend_vectors_max_rms_power_audio
    from gance_tpu_torch.synthesis.orchestration import vector_synthesis
    from gance_tpu_torch.synthesis.runtime import MultiNetwork

    out = workdir / f"{label}.avi"
    reset_launch_counts()
    r = RATES[label] = run_render(wav, paths, out, side, dtype, phase, egress_mode)
    counts = dict(LAUNCHES)

    audio = read_wavs_scale_for_video([wav], PIPELINE_VECTOR, frames_per_second=PIPELINE_FPS).wav_data
    inputs = alpha_blend_vectors_max_rms_power_audio(
        PIPELINE_ALPHA, False, (-1.0, 1.0), audio, PIPELINE_VECTOR, [0, 1], device="cuda")
    indices = inputs.network_indices.result.data
    batches = stream_batches(indices)
    forwards = len(batches)
    # the phase-path render resizes on the device: its last skip upsample is B
    want = {k: v * forwards for k, v in forward_launches(config, phase, resize=True).items()}
    print(f"launches pipeline {label} ({forwards} forwards from the indices, batches "
          f"{dict(sorted(collections.Counter(batches).items()))}, {sum(batches)} padded frames "
          f"for {len(indices)}): {counts}", flush=True)
    require(counts == want, f"pipeline {label}: launches {counts} != {want}")
    require(set(indices.tolist()) == {0, 1}, f"pipeline {label}: indices use {set(indices.tolist())}")

    frames, compressed, pcm = read_avi(out)
    count = len(frames) + compressed
    require(count == len(indices) == r["frames"],
            f"pipeline {label}: {count} frames, {len(indices)} indices, {r['frames']} rendered")
    if egress_mode == "raw-spill":
        require(not compressed and all(f.shape == (side, side, 3) for f in frames),
                f"pipeline {label}: {compressed} compressed frames or a wrong frame shape")
        require(float(frames[0].std()) > 10.0, f"pipeline {label}: near-constant first frame")
    require(bool(np.array_equal(pcm, wavfile.read(str(wav))[1])),
            f"pipeline {label}: the AVI's audio is not the WAV's samples")
    if check_frames_against_direct:
        with MultiNetwork(paths, output_side_length=side, compute_dtype=getattr(torch, dtype),
                          device="cuda") as networks:
            within, worst = 0, 0
            direct = vector_synthesis(networks, inputs).synthesized_images
            for compared, (got, ref) in enumerate(zip(frames, direct), start=1):
                steps = np.abs(got.astype(np.int16) - ref.astype(np.int16))
                within += int(np.count_nonzero(steps <= 1))
                worst = max(worst, int(steps.max()))
        require(compared == count, f"pipeline {label}: direct synthesis gave {compared} frames")
        share = within / (count * side * side * 3)
        print(f"pipeline {label} vs vector_synthesis run directly: max {worst} steps, {share:.6f} "
              "within 1 step", flush=True)
        require(share >= 0.999, f"pipeline {label}: {share:.5f} of values within 1 step")
    bytes_written = out.stat().st_size
    # the raw egress alone: the same frames and audio written again through
    # the pipeline's writer
    egress_note = ""
    if egress_mode == "raw-spill":
        from gance_tpu_torch.media.native import RawAviWriter, concatenated_pcm16

        rate, samples = concatenated_pcm16([wav])
        rgb = [np.ascontiguousarray(f) for f in frames]
        start = time.perf_counter()
        writer = RawAviWriter(workdir / f"{label}.again.avi", side, side, PIPELINE_FPS,
                              pcm=samples, audio_rate=rate)
        for frame in rgb:
            writer.write_frame_rgb(frame)
        writer.finalize()
        write_s = time.perf_counter() - start
        (workdir / f"{label}.again.avi").unlink()
        del rgb
        egress_note = (f"; the raw write alone {write_s:.3f} s ({count / write_s:.2f} "
                       f"frames/s, {bytes_written / write_s / 1e6:.1f} MB/s)")
    print(f"pipeline {label} ({count} frames of {side}px, {dtype}, phase path "
          f"{'on' if phase else 'off'}, egress {egress_mode}, {compressed} compressed): "
          f"{describe_render(r)}; AVI {bytes_written} bytes, "
          f"{bytes_written / r['render'] / 1e6:.1f} MB/s{egress_note}; on {card}", flush=True)
    out.unlink()
    return counts


def pipeline_phase(config, workdir: Path, card: str) -> Dict[str, int]:
    """Phase 8, with phase 3's two networks in `workdir`; returns its launches."""
    from gance_tpu_torch.audio.io import fabricate_percussive_wav

    paths = [workdir / f"{i}_net.pkl" for i in range(2)]
    wav = fabricate_percussive_wav(workdir / "song.wav", seconds=PIPELINE_SECONDS)
    torch.cuda.empty_cache()
    have = {name: importlib.util.find_spec(name) is not None for name in ("cv2", "PIL", "click")}
    print(f"host egress: ffmpeg {shutil.which('ffmpeg')}, importable {have}", flush=True)
    features_phase(wav)
    totals: Dict[str, int] = {}
    for label, side, dtype, phase, egress, direct in (
            ("fp32-1024", config.resolution, "float32", False, "raw-spill", True),
            ("bf16-512-phase", RESIZE_SIDE, "bfloat16", True, "raw-spill", False),
            ("fp32-1024-default-egress", config.resolution, "float32", False, "auto", False)):
        for k, v in render_phase(label, wav, paths, workdir, config, side, dtype, phase, egress,
                                 card, direct).items():
            totals[k] = totals.get(k, 0) + v
    set_phase("off")
    return totals


class MemoryProjectionReader:
    """The members of a ProjectionFileReader that the flagship reads
    (`projection_attributes`, and fresh lazy iterators of `final_latents`,
    `target_images` and `final_images` on every access), over arrays in
    memory: the flagship's input on a host without h5py."""

    def __init__(self, attributes, targets: np.ndarray, latents: np.ndarray) -> None:
        self.projection_attributes = attributes
        self._targets, self._latents = targets, latents

    @property
    def final_latents(self):
        return (matrix[0] for matrix in self._latents)  # (1, R, V) -> (R, V)

    @property
    def target_images(self):
        return iter(self._targets)

    @property
    def final_images(self):
        return iter(self._targets)


def host_findings() -> Tuple[bool, bool]:
    """9: print what the host offers the flagship (h5py for the projection
    file, cv2 and OpenCV's Haar cascade XMLs for the overlay); returns
    (h5py importable, both cascades found)."""
    from gance_tpu_torch.overlay.faces import cascade_dirs

    def spec(name: str) -> bool:
        try:
            return importlib.util.find_spec(name) is not None
        except ImportError:
            return False

    found = {name: spec(name) for name in ("h5py", "cv2", "cv2.data")}
    dirs = cascade_dirs()
    cascades = {f"{d}/{xml}": (d / xml).exists() for d in dirs
                for xml in ("haarcascade_frontalface_default.xml", "haarcascade_eye.xml")}
    have_cascades = all(any((d / xml).exists() for d in dirs)
                        for xml in ("haarcascade_frontalface_default.xml", "haarcascade_eye.xml"))
    print(f"flagship host: importable {found}; cascade XMLs {cascades}", flush=True)
    return found["h5py"], have_cascades


def smooth_frames(count: int, res: int, gen: torch.Generator) -> np.ndarray:
    """`count` seeded smooth uint8 (res, res, 3) frames: 8x8 uniform noise,
    bicubic-upsampled on the card."""
    coarse = torch.rand((count, 3, 8, 8), generator=gen, device="cuda") * 255.0
    frames = F.interpolate(coarse, size=(res, res), mode="bicubic", align_corners=False)
    frames = frames.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    return frames.cpu().numpy()


def projection_source(config, workdir: Path, have_h5py: bool):
    """9a: the flagship's projection file, as the projector writes one:
    FLAGSHIP_PROJECTION_FRAMES seeded smooth targets at the network's size and
    rows-identical w+ from seeded z through network 0's mapping. With h5py it
    is written by the port's ProjectionFileWriter, timed, read back bit for bit
    and verified; returns its path. Without h5py, an in-memory reader of the
    same frames."""
    from gance_tpu_torch.models.stylegan2 import broadcast_dlatents, mapping_apply
    from gance_tpu_torch.projection import LATEST_VERSION, ProjectionAttributes
    from gance_tpu_torch.synthesis.runtime import params_to_device

    count, res = FLAGSHIP_PROJECTION_FRAMES, config.resolution
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    targets = smooth_frames(count, res, gen)
    mapping = params_to_device({"mapping": smoke_params(SEED, config)["mapping"]},
                               torch.device("cuda"))
    z = torch.randn((count, config.latent_size), generator=gen, device="cuda")
    with torch.inference_mode():
        latents = broadcast_dlatents(mapping_apply(mapping, z, config), config)[:, None]
    latents = latents.cpu().numpy()  # (count, 1, R, 512), rows identical
    attributes = ProjectionAttributes(
        version_number=LATEST_VERSION, complete=True, original_target_path="targets.mp4",
        original_width_height=(res, res), projection_width_height=(res, res),
        target_md5_hash="0" * 32, original_network_path="0_net.pkl",
        network_md5_hash="0" * 32, steps_in_projection=1, noises_shapes=np.nan,
        latents_histories_enabled=False, noises_histories_enabled=False,
        images_histories_enabled=False, original_fps=FLAGSHIP_PROJECTION_FPS,
        projection_fps=FLAGSHIP_PROJECTION_FPS, original_frame_count=count,
        projection_frame_count=count)
    if not have_h5py:
        print(f"flagship 9a: h5py is not importable here, so the projection file is not written; "
              f"the render reads an in-memory reader of the same {count} frames "
              f"(the HDF5 route is held by the CPU tests)", flush=True)
        return MemoryProjectionReader(attributes, targets, latents)

    from gance_tpu_torch.projection import (ProjectionFileWriter, load_projection_file,
                                            verify_projection_file_assumptions)

    path = workdir / "projection.hdf5"
    start = time.perf_counter()
    with ProjectionFileWriter(path, attributes) as writer:
        for target, matrix in zip(targets, latents):
            with writer.frame_writer() as frame:
                frame.finish(target, matrix, target)
    write_s = time.perf_counter() - start
    with load_projection_file(path) as reader:
        got = reader.projection_attributes
        require(np.isnan(got.noises_shapes) and got == dataclasses.replace(
            attributes, noises_shapes=got.noises_shapes),
            f"flagship 9a: attributes {got} != {attributes}")
        require(all(np.array_equal(a, b) for a, b in zip(reader.final_latents, latents[:, 0]))
                and all(np.array_equal(a, b) for a, b in zip(reader.target_images, targets)),
                "flagship 9a: the file's latents or targets differ from what was written")
    verify_projection_file_assumptions(path)
    print(f"flagship 9a: wrote {count} frames of {res}px to {path.name} "
          f"({path.stat().st_size} bytes, gzip 9) in {write_s:.3f} s; read back bit for bit, "
          "rows identical", flush=True)
    return path


def phash_phase() -> None:
    """9b: the pHash on the card against the port's CPU path, 256 seeded crops
    of 8-120 px. A crop whose low-frequency coefficient lies within 1e-5 of
    max|coefficient| of the median on the CPU side cannot be decided."""
    from gance_tpu_torch.overlay.phash import _prepare_crop, low_frequencies, phash_batch

    rng = np.random.RandomState(SEED + 9)
    crops = [(rng.rand(*rng.randint(8, 121, size=2), 3) * 255).astype(np.uint8)
             for _ in range(256)]
    card = phash_batch(crops, device="cuda")
    start = time.perf_counter()
    card = phash_batch(crops, device="cuda")
    card_s = time.perf_counter() - start
    cpu = phash_batch(crops, device="cpu")
    low = low_frequencies(torch.from_numpy(np.stack([_prepare_crop(c) for c in crops]))).numpy()
    ordered = np.sort(low, axis=1)
    median = (ordered[:, 31] + ordered[:, 32]) * np.float32(0.5)
    undecided = (np.abs(low - median[:, None]).min(axis=1)
                 <= 1e-5 * np.abs(low).max(axis=1))
    differ = (card != cpu).any(axis=1)
    print(f"flagship 9b: pHash of 256 crops, card vs CPU: {int(differ.sum())} differ, "
          f"{int(undecided.sum())} undecidable (a coefficient within 1e-5 of max|coefficient| "
          f"of the median), of which {int((differ & undecided).sum())} differ; card "
          f"{card_s * 1e3:.3f} ms for the batch (host prep included)", flush=True)
    require(not (differ & ~undecided).any(),
            f"flagship 9b: pHash bits differ on decidable crops {np.nonzero(differ & ~undecided)[0]}")


def read_stage_stats(path: Path) -> Dict[str, dict]:
    stats = {json.loads(line)["stage"]: json.loads(line) for line in path.read_text().splitlines()}
    path.unlink()
    return stats


def flagship_render(source, wav: Path, paths: List[Path], out: Path, side: int, dtype: str,
                    overlay: Optional[Tuple[int, float, int]],
                    trace_dir: Optional[Path] = None) -> dict:
    """One flagship render of `wav` over `source` (a projection file's path, or
    an in-memory reader) into `out` with GANCE_TPU_EGRESS=raw-spill, traced
    into `trace_dir` when given; returns its wall seconds and stage stats.
    tools/time_torch_pipeline.py --flagship times its renders with this."""
    from gance_tpu_torch.pipelines import projection_file_blend as pfb
    from gance_tpu_torch.utils.profiling import trace

    stages = out.with_suffix(".stages.jsonl")
    stages.unlink(missing_ok=True)
    os.environ.update(GANCE_TPU_STAGE_STATS=str(stages), GANCE_TPU_EGRESS="raw-spill")
    args = dict(wav=[wav], output_path=out, network_paths=paths, frames_to_visualize=None,
                output_fps=FLAGSHIP_FPS, output_side_length=side, alpha=PIPELINE_ALPHA,
                fft_roll_enabled=False, fft_amplitude_range=(-1.0, 1.0),
                blend_depth=FLAGSHIP_BLEND_DEPTH, compute_dtype=dtype)
    gates = dict(zip(("phash_distance", "bbox_distance", "track_length"), overlay or ()))
    torch.cuda.synchronize()
    start = time.perf_counter()
    with trace(trace_dir):
        if isinstance(source, Path):
            pfb.projection_file_blend_api(projection_file_path=source, debug_path=None,
                                          debug_window=None, debug_side_length=None,
                                          device="cuda", **gates, **args)
        else:
            pfb._blend_from_reader(reader=source, complexity_change_rolling_sum_window=None,
                                   complexity_change_threshold=None, overlay_gates=overlay,
                                   overlay_detection_side=None, overlay_smoothing=0,
                                   device="cuda", **args)
    wall = time.perf_counter() - start
    del os.environ["GANCE_TPU_STAGE_STATS"], os.environ["GANCE_TPU_EGRESS"]
    stats = read_stage_stats(stages)
    busy = {name: s.get("busy_sec", 0.0) for name, s in stats.items()}
    features, render = busy["audio_features"], busy["render"]
    return {"wall": wall, "loading": wall - features - render, "features": features,
            "render": render, "frames": stats["render"]["count"], "busy": busy}


def describe_flagship(r: dict) -> str:
    stages = ", ".join(f"{k} {v:.3f}" for k, v in r["busy"].items()
                       if k not in ("audio_features", "render"))
    return (f"wall {r['wall']:.3f} s = loading {r['loading']:.3f} + audio features "
            f"{r['features']:.3f} + render {r['render']:.3f}; end to end "
            f"{r['frames'] / r['wall']:.2f} frames/s, render {r['frames'] / r['render']:.2f} "
            f"frames/s; stage busy seconds (each stage's next() includes what feeds it): {stages}")


def flagship_phase(config, workdir: Path, card: str) -> Dict[str, int]:
    """Phase 9, with phase 3's two networks and phase 8's WAV in `workdir`;
    returns its launches."""
    from scipy.io import wavfile

    from gance_tpu_torch.audio.io import read_wavs_scale_for_video
    from gance_tpu_torch.media.video import scale_square_source_duplicate
    from gance_tpu_torch.ops.cuda.fused_ops import reset_launch_counts
    from gance_tpu_torch.overlay import faces
    from gance_tpu_torch.pipelines import projection_file_blend as pfb
    from gance_tpu_torch.projection import final_latents_matrices_label, load_projection_file
    from gance_tpu_torch.synthesis.inputs import alpha_blend_projection_file
    from gance_tpu_torch.synthesis.orchestration import vector_synthesis
    from gance_tpu_torch.synthesis.runtime import MultiNetwork

    paths = [workdir / f"{i}_net.pkl" for i in range(2)]
    wav = workdir / "song.wav"
    torch.cuda.empty_cache()
    have_h5py, have_cascades = host_findings()
    source = projection_source(config, workdir, have_h5py)
    phash_phase()

    @contextlib.contextmanager
    def opened():
        if isinstance(source, Path):
            with load_projection_file(source) as reader:
                yield reader
        else:
            yield source

    count = int(FLAGSHIP_FPS // FLAGSHIP_PROJECTION_FPS) * FLAGSHIP_PROJECTION_FRAMES
    audio = read_wavs_scale_for_video([wav], PIPELINE_VECTOR, target_num_vectors=count).wav_data
    with opened() as reader:
        latents = final_latents_matrices_label(reader)
    inputs = alpha_blend_projection_file(latents, PIPELINE_ALPHA, False, (-1.0, 1.0),
                                         FLAGSHIP_BLEND_DEPTH, audio, PIPELINE_VECTOR, [0, 1],
                                         device="cuda")
    indices = inputs.network_indices.result.data
    batches = stream_batches(indices)
    require(set(indices.tolist()) == {0, 1}, f"flagship: indices use {set(indices.tolist())}")
    samples = wavfile.read(str(wav))[1]
    totals: Dict[str, int] = {}

    # (c) fp32, 1024px, standard path, no overlay
    out = workdir / "flagship-fp32-1024.avi"
    set_phase("off")
    reset_launch_counts()
    r = flagship_render(source, wav, paths, out, config.resolution, "float32", None)
    counts = launches_per_forward(f"flagship fp32-1024 (batches "
                                  f"{dict(sorted(collections.Counter(batches).items()))})",
                                  len(batches), config)
    frames, compressed, pcm = read_avi(out)
    require(len(frames) == count == r["frames"] and not compressed,
            f"flagship fp32-1024: {len(frames)} frames ({compressed} compressed), "
            f"{r['frames']} rendered, {count} expected")
    require(bool(np.array_equal(pcm, samples)), "flagship fp32-1024: audio is not the WAV's")
    require(float(frames[0].std()) > 10.0, "flagship fp32-1024: near-constant first frame")
    with MultiNetwork(paths, compute_dtype=torch.float32, device="cuda") as networks:
        direct = scale_square_source_duplicate(
            vector_synthesis(networks, inputs).synthesized_images, config.resolution)
        within, worst, compared = 0, 0, 0
        for got, ref in zip(frames, direct):
            steps = np.abs(got.astype(np.int16) - ref.astype(np.int16))
            within += int(np.count_nonzero(steps <= 1))
            worst = max(worst, int(steps.max()))
            compared += 1
    require(compared == count, f"flagship fp32-1024: direct synthesis gave {compared} frames")
    share = within / (count * config.resolution ** 2 * 3)
    print(f"flagship fp32-1024 vs vector_synthesis run directly: max {worst} steps, "
          f"{share:.6f} within 1 step", flush=True)
    require(share >= 0.999, f"flagship fp32-1024: {share:.5f} of values within 1 step")
    size = out.stat().st_size
    print(f"flagship fp32-1024 ({count} frames, {len(batches)} forwards, egress raw-spill): "
          f"{describe_flagship(r)}; AVI {size} bytes; on {card}", flush=True)
    out.unlink()
    del frames
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v

    # (d) bf16, the phase path, side 512, with the README's overlay gates
    overlay = FLAGSHIP_OVERLAY if have_cascades else None
    if overlay is None:
        print("flagship bf16-512-phase: no Haar cascade XMLs on this host, so eye detection is "
              "not run; the render runs without the overlay", flush=True)
    with opened() as reader:
        keys = {t.tobytes() for t in scale_square_source_duplicate(reader.target_images,
                                                                   RESIZE_SIDE)}
    detected = collections.Counter()
    composited = [0]
    landmarks, compose = faces.FaceFinderProxy.face_landmarks, pfb.write_boxes_onto_image

    def counting_landmarks(self, face_image):
        found = landmarks(self, face_image)
        stream = ("target" if np.ascontiguousarray(face_image).tobytes() in keys
                  else "synthesized")
        detected[stream, bool(found)] += 1
        return found

    def counting_compose(**kwargs):
        composited[0] += 1
        return compose(**kwargs)

    out = workdir / "flagship-bf16-512-phase.avi"
    set_phase("on")
    reset_launch_counts()
    faces.FaceFinderProxy.face_landmarks = counting_landmarks
    pfb.write_boxes_onto_image = counting_compose
    try:
        r = RATES["flagship-bf16-512-phase"] = flagship_render(source, wav, paths, out,
                                                               RESIZE_SIDE, "bfloat16", overlay)
    finally:
        faces.FaceFinderProxy.face_landmarks = landmarks
        pfb.write_boxes_onto_image = compose
        set_phase("off")
    # no resize on the device (frames leave at 1024px), so the top block's
    # last skip upsample is the fused uint8 path's, not B
    counts = launches_per_forward("flagship bf16-512-phase", len(batches), config, phase=True)
    frames, compressed, pcm = read_avi(out)
    require(len(frames) == count == r["frames"] and not compressed
            and all(f.shape == (RESIZE_SIDE, RESIZE_SIDE, 3) for f in frames),
            f"flagship bf16-512-phase: {len(frames)} frames, {r['frames']} rendered")
    require(bool(np.array_equal(pcm, samples)), "flagship bf16-512-phase: audio is not the WAV's")
    if overlay is not None:
        calls = sum(detected.values())
        require(calls == 2 * count, f"flagship bf16-512-phase: {calls} detections for "
                f"{count} frame pairs")
        print(f"flagship bf16-512-phase overlay (phash {overlay[0]}, bbox {overlay[1]}, track "
              f"{overlay[2]}): frames with a face found, target {detected['target', True]} and "
              f"synthesized {detected['synthesized', True]} of {count} each; composited "
              f"{composited[0]}", flush=True)
    size = out.stat().st_size
    print(f"flagship bf16-512-phase ({count} frames, overlay {'on' if overlay else 'off'}, "
          f"egress raw-spill): {describe_flagship(r)}; AVI {size} bytes; on {card}", flush=True)
    out.unlink()
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    return totals


class MemoryProjectionWriter:
    """The ProjectionFileWriter surface that `_projection_write_loop` uses, in
    memory (the card machine has no h5py): per frame the steps and latents of
    its history, its final latents and target, the noise shapes recorded, and
    `complete` set on a clean exit."""

    class Frame:
        def __init__(self) -> None:
            self.steps: List[int] = []
            self.latents: List[np.ndarray] = []
            self.noise_shapes: List[tuple] = []
            self.final_latents: Optional[np.ndarray] = None
            self.target: Optional[np.ndarray] = None

        def record_step(self, step, latents, noises, image) -> None:
            self.steps.append(step)
            self.latents.append(np.array(latents))
            self.noise_shapes = [tuple(np.asarray(n).shape) for n in noises]

        def finish(self, target_image, final_latents, final_image) -> None:
            self.final_latents, self.target = np.array(final_latents), target_image

    def __init__(self, path: Path, attributes) -> None:
        self.attributes = attributes
        self.frames: List["MemoryProjectionWriter.Frame"] = []
        self.noises_shapes: Optional[list] = None

    def __enter__(self) -> "MemoryProjectionWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.attributes.complete = exc_type is None
        self.attributes.projection_frame_count = len(self.frames)
        self.attributes.noises_shapes = self.noises_shapes

    @property
    def frame_index(self) -> int:
        return len(self.frames)

    @contextlib.contextmanager
    def batch_frame_writers(self, count: int):
        writers = [self.Frame() for _ in range(count)]
        yield writers
        require(all(w.final_latents is not None for w in writers), "a frame was not finished")
        self.frames.extend(writers)

    def record_noises_shapes(self, shapes) -> None:
        self.noises_shapes = list(shapes)


def own_frames(params, config, count: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The network's own uint8 frames from seeded z through its mapping, w
    broadcast to every row (rows identical), const noise; returns (frames, w)."""
    from gance_tpu_torch.models.stylegan2 import broadcast_dlatents, mapping_apply, synthesis_apply

    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((count, config.latent_size), generator=gen, device="cuda")
    with torch.inference_mode():
        w = mapping_apply(params, z, config)
        frames = synthesis_apply(params, broadcast_dlatents(w, config), config, uint8_output=True)
    return frames.cpu().numpy(), w.cpu().numpy()


def seeded_planes(projector, batch: int, seed: int) -> List[np.ndarray]:
    """Seeded N(0, 1) noise planes in JAX's layout, (batch, h, w, 1) each."""
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((batch, h, w, 1)).astype(np.float32)
            for h, w in projector.noise_spatial_shapes]


def gradient_error(got: List[torch.Tensor], want: List[torch.Tensor]) -> float:
    """Norm-wise relative error of a list of gradients taken together."""
    g = torch.cat([t.float().cpu().reshape(-1) for t in got])
    w = torch.cat([t.float().cpu().reshape(-1) for t in want])
    return float((g - w).norm() / w.norm())


def synthesis_term(projector, w: torch.Tensor, planes: List[torch.Tensor],
                   target_proc: torch.Tensor, jitter: torch.Tensor):
    """`_loss_and_gradients` with the regulariser's weight at 0: the per-frame
    distances and the gradients of their sum with respect to w and the planes.
    At the projector's weight (1e5) the regulariser's gradient outweighs the
    synthesis term of the planes' gradient by about 1e5 on seeded N(0, 1)
    planes, so a comparison of the whole gradient could not see the noise
    gradients that come through A and E."""
    weight = projector.settings.regularize_noise_weight
    projector.settings.regularize_noise_weight = 0.0
    try:
        _, dist, _, grads = projector._loss_and_gradients(w, planes, target_proc, jitter)
    finally:
        projector.settings.regularize_noise_weight = weight
    return dist, grads


def projector_parity_phase(params, config) -> None:
    """10a: one fp32 step at batch 1, 1024px, on the card and on the port's
    CPU path with the same seeded w, planes, jitter and target: the distance
    and the loss (distance + 1e5 * the noise regulariser) within 1e-4
    relative; the gradient of the synthesis term (`synthesis_term`) with
    respect to w and to the 17 planes taken together norm-wise within 2e-2,
    each plane's within 1e-1 (phase 7a's bounds, for its reason: one lrelu
    input at the fp32 kink)."""
    from gance_tpu_torch.projection.projector import Projector, _noise_regularization

    set_phase("off")
    rng = np.random.RandomState(SEED + 10)
    w = (0.5 * rng.standard_normal((1, config.dlatent_size))).astype(np.float32)
    jitter = (0.05 * rng.standard_normal((1, config.dlatent_size))).astype(np.float32)
    target = smooth_frames(1, config.resolution, torch.Generator(device="cuda").manual_seed(SEED + 11))
    results = {}
    for device in ("cuda", "cpu"):
        projector = Projector(params, config, device=device)
        planes = [torch.from_numpy(np.ascontiguousarray(p.transpose(0, 3, 1, 2))).to(device)
                  for p in seeded_planes(projector, 1, SEED + 12)]
        start = time.perf_counter()
        dist, grads = synthesis_term(projector, torch.from_numpy(w).to(device), planes,
                                     projector._target_proc(target),
                                     torch.from_numpy(jitter).to(device))
        loss = float(dist.sum()) + projector.settings.regularize_noise_weight * float(
            _noise_regularization(planes).sum())
        results[device] = loss, float(dist[0]), [g.cpu() for g in grads], time.perf_counter() - start
        del projector, planes, grads
    (gl, gd, gg, gs), (cl, cd, cg, cs) = results["cuda"], results["cpu"]
    worst_plane = max((gradient_error([g], [c]), i) for i, (g, c) in enumerate(zip(gg[1:], cg[1:])))
    errors = {"loss": abs(gl - cl) / abs(cl), "distance": abs(gd - cd) / abs(cd),
              "w": gradient_error(gg[:1], cg[:1]), "planes": gradient_error(gg[1:], cg[1:])}
    print(f"projector 10a, one fp32 step at batch 1, {config.resolution}px, card vs CPU (card "
          f"{gs:.2f} s with first launches, CPU {cs:.2f} s): loss {gl:.6g} vs {cl:.6g}, distance "
          f"{gd:.6g} vs {cd:.6g}; relative errors {errors} (limits 1e-4, 1e-4, 2e-2, 2e-2); worst "
          f"plane noise{worst_plane[1]} {worst_plane[0]:.3g} of its norm (limit 1e-1)", flush=True)
    require(errors["loss"] <= 1e-4 and errors["distance"] <= 1e-4, f"10a: {errors}")
    require(errors["w"] <= 2e-2 and errors["planes"] <= 2e-2, f"10a: {errors}")
    require(worst_plane[0] <= 1e-1, f"10a: noise{worst_plane[1]} gradient {worst_plane[0]:.3g}")
    require(all(float(g.abs().max()) > 0 for g in gg), "10a: a zero gradient on the card")


def projection_run(projector, config, label: str, targets: np.ndarray, steps: int, phase: bool,
                   card: str) -> Tuple[dict, Dict[str, int]]:
    """One `project_batch` from the dlatent average with seeded planes, the
    counts set to 0 just before it and read just after: the launches against
    `projection_launches`, finite outputs, the clean distance (evaluate_distance)
    below the start's for every frame; ms per step by CUDA events between the
    ends of step 0 and of the last step; peak memory."""
    from gance_tpu_torch.ops.cuda.fused_ops import LAUNCHES, reset_launch_counts

    set_phase("on" if phase else "off")
    batch = len(targets)
    projector.settings.num_steps = steps
    w0 = np.tile(projector.dlatent_avg.cpu().numpy(), (batch, 1))
    planes = seeded_planes(projector, batch, SEED + 13)
    before = projector.evaluate_distance(w0, planes, targets)
    events: List[torch.cuda.Event] = []
    step_distances: List[torch.Tensor] = []
    original = projector._step

    def timed_step(*args, **kwargs):
        out = original(*args, **kwargs)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        step_distances.append(out[0])
        return out

    projector._step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    start = time.perf_counter()
    try:
        results = projector.project_batch(targets, want_step_images=False, initial_latents=w0,
                                          initial_noises=planes)
    finally:
        del projector._step
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = projection_launches(config, steps, phase)
    require(counts == want, f"projection {label}: launches {counts} != {want}")
    latents = np.stack([r.final_latents[0] for r in results])
    noises = [np.concatenate(n) for n in zip(*[r.noises for r in results])]
    require(all(np.isfinite(a).all() for a in [latents] + noises)
            and all(math.isfinite(r.final_distance) for r in results),
            f"projection {label}: non-finite output")
    require(all(np.all(r.final_latents == r.final_latents[:, :1]) for r in results),
            f"projection {label}: rows of the final latents differ")
    after = projector.evaluate_distance(latents, noises, targets)
    ms = events[0].elapsed_time(events[-1]) / (len(events) - 1)
    rate = batch / ms * 1e3
    print(f"projection {label} ({config.resolution}px, batch {batch}, {steps} steps, phase path "
          f"{'on' if phase else 'off'}): {ms:.3f} ms per step (CUDA events, steps 1-{steps - 1}), "
          f"{rate:.3f} frame-steps/s, {rate * 3.6:.1f} frames per hour at 1000 steps; wall "
          f"{wall:.3f} s; peak {peak:.2f} GiB; mean step distance first "
          f"{float(step_distances[0].mean()):.4f}, last {float(step_distances[-1].mean()):.4f}; "
          f"clean distance (evaluate_distance) start {np.round(before, 4).tolist()} -> end "
          f"{np.round(after, 4).tolist()}; launches {counts} on {card}", flush=True)
    require(bool(np.all(after < before)), f"projection {label}: distance did not fall: {before} -> "
            f"{after}")
    return {"ms": ms, "peak": peak, "before": before, "after": after}, counts


def write_loop_phase(projector, config, workdir: Path, card: str) -> Dict[str, int]:
    """10d: `_projection_write_loop` over PROJECTION_WRITE_FRAMES seeded
    source frames with an in-memory writer, latents histories on (so the
    segmented loop runs), then the flagship's `_blend_from_reader` over the
    result with phase 8's WAV cut to the clip's length."""
    from scipy.io import wavfile

    from gance_tpu_torch.audio.io import read_wavs_scale_for_video
    from gance_tpu_torch.ops.cuda.fused_ops import LAUNCHES, reset_launch_counts
    from gance_tpu_torch.projection import (LATEST_VERSION, ProjectionAttributes,
                                            final_latents_matrices_label)
    from gance_tpu_torch.projection.file_writer import _projection_write_loop
    from gance_tpu_torch.synthesis.inputs import alpha_blend_projection_file

    count, res, steps = PROJECTION_WRITE_FRAMES, config.resolution, PROJECTION_WRITE_STEPS
    set_phase("off")
    frames = smooth_frames(count, res, torch.Generator(device="cuda").manual_seed(SEED + 14))
    projector.settings.compute_dtype = "float32"
    projector.settings.scan_segment = PROJECTION_WRITE_SEGMENT
    projector.settings.num_steps = steps
    attributes = ProjectionAttributes(
        version_number=LATEST_VERSION, complete=False, original_target_path="source.mp4",
        original_width_height=(res, res), projection_width_height=(res, res),
        target_md5_hash="0" * 32, original_network_path="0_net.pkl", network_md5_hash="0" * 32,
        steps_in_projection=steps, noises_shapes=np.nan, latents_histories_enabled=True,
        noises_histories_enabled=False, images_histories_enabled=False,
        original_fps=PROJECTION_WRITE_FPS, projection_fps=PROJECTION_WRITE_FPS,
        original_frame_count=count, projection_frame_count=count)
    writers: List[MemoryProjectionWriter] = []

    def factory(path: Path, attrs) -> MemoryProjectionWriter:
        writers.append(MemoryProjectionWriter(path, attrs))
        return writers[-1]

    torch.cuda.synchronize()
    reset_launch_counts()
    start = time.perf_counter()
    _projection_write_loop(factory, workdir / "projection.hdf5", attributes, iter(frames),
                           PROJECTION_WRITE_BATCH, projector, None, count, True, False, False,
                           False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = dict(LAUNCHES)
    batches = -(-count // PROJECTION_WRITE_BATCH)
    want = {k: v * batches for k, v in projection_launches(config, steps, False).items()}
    require(counts == want, f"10d: launches {counts} != {want}")
    (writer,) = writers
    sizes = [(1, h, w, 1) for h, w in projector.noise_spatial_shapes]
    require(writer.attributes.complete and writer.attributes.projection_frame_count == count
            and len(writer.frames) == count, f"10d: {len(writer.frames)} frames written")
    require(writer.noises_shapes == sizes, f"10d: noises shapes {writer.noises_shapes} are not "
            f"JAX's layout {sizes}")
    for i, frame in enumerate(writer.frames):
        require(frame.steps == list(range(steps)) and len(frame.latents) == steps,
                f"10d frame {i}: history steps {frame.steps}")
        require(frame.noise_shapes == sizes, f"10d frame {i}: noise shapes {frame.noise_shapes}")
        require(frame.final_latents.shape == (1, config.num_style_rows, config.dlatent_size)
                and bool(np.all(frame.final_latents == frame.final_latents[:, :1]))
                and bool(np.isfinite(frame.final_latents).all()),
                f"10d frame {i}: final latents {frame.final_latents.shape}, rows not identical "
                "or not finite")
        require(np.array_equal(frame.latents[-1], frame.final_latents),
                f"10d frame {i}: the last history step is not the final latents")
        require(np.array_equal(frame.target, frames[i]), f"10d frame {i}: target out of order")
    print(f"projection 10d, the writer loop ({count} frames of {res}px, batch "
          f"{PROJECTION_WRITE_BATCH}, {steps} steps in segments of {PROJECTION_WRITE_SEGMENT}, "
          f"fp32, latents histories): {wall:.3f} s; histories of {steps} steps each, rows "
          f"identical, noise shapes in JAX's layout; launches {counts} on {card}", flush=True)

    # the projection into the flagship, with the WAV cut to the clip's length
    rate, samples = wavfile.read(str(workdir / "song.wav"))
    clip = workdir / "clip.wav"
    wavfile.write(str(clip), rate, samples[: int(round(rate * count / PROJECTION_WRITE_FPS))])
    reader = MemoryProjectionReader(writer.attributes, frames,
                                    np.stack([f.final_latents for f in writer.frames]))
    paths = [workdir / f"{i}_net.pkl" for i in range(2)]
    out = workdir / "projected-flagship.avi"
    output_frames = int(FLAGSHIP_FPS // PROJECTION_WRITE_FPS) * count
    audio = read_wavs_scale_for_video([clip], PIPELINE_VECTOR,
                                      target_num_vectors=output_frames).wav_data
    inputs = alpha_blend_projection_file(
        final_latents_matrices_label(reader), PIPELINE_ALPHA, False, (-1.0, 1.0),
        FLAGSHIP_BLEND_DEPTH, audio, PIPELINE_VECTOR, [0, 1], device="cuda")
    batches_of_render = stream_batches(inputs.network_indices.result.data)
    reset_launch_counts()
    r = flagship_render(reader, clip, paths, out, RESIZE_SIDE, "float32", None)
    render_counts = launches_per_forward("flagship over the projection", len(batches_of_render),
                                         config)
    got, compressed, pcm = read_avi(out)
    require(len(got) == output_frames == r["frames"] and not compressed
            and all(f.shape == (RESIZE_SIDE, RESIZE_SIDE, 3) for f in got),
            f"10d flagship: {len(got)} frames, {r['frames']} rendered, {output_frames} expected")
    require(bool(np.array_equal(pcm, wavfile.read(str(clip))[1])), "10d flagship: audio is not "
            "the clip's")
    require(float(got[0].std()) > 1.0, "10d flagship: constant first frame")
    print(f"projection 10d into the flagship ({output_frames} frames of {RESIZE_SIDE}px from "
          f"{count} projected frames, fp32, no overlay, egress raw-spill): "
          f"{describe_flagship(r)}; on {card}", flush=True)
    out.unlink()
    for k, v in render_counts.items():
        counts[k] += v
    return counts


def projector_phase(config, workdir: Path, card: str) -> Dict[str, int]:
    """Phase 10, with phase 3's network 0 (smoke_params) and phase 8's WAV in
    `workdir`; returns the launches of 10b-10d's main-path runs."""
    from gance_tpu_torch.projection.projector import Projector

    torch.cuda.empty_cache()
    params = smoke_params(SEED, config)
    projector_parity_phase(params, config)
    torch.cuda.empty_cache()
    projector = Projector(params, config, device="cuda")
    totals: Dict[str, int] = {}

    def add(counts: Dict[str, int]) -> None:
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    # 10b: fp32 at batch 4 and bf16 at batch 8, the standard path
    targets, _ = own_frames(projector.params, config, max(b for _, b in PROJECTION_RUNS),
                            SEED + 15)
    runs = {}
    for dtype, batch in PROJECTION_RUNS:
        projector.settings.compute_dtype = dtype
        runs[dtype], counts = projection_run(projector, config, f"10b {dtype}", targets[:batch],
                                             PROJECTION_STEPS, False, card)
        add(counts)
        torch.cuda.empty_cache()

    # 10c: the phase path, bf16 at batch 8 (E forward and E's backward)
    phase, counts = projection_run(projector, config, "10c bfloat16", targets,
                                   PROJECTION_PHASE_STEPS, True, card)
    add(counts)
    print(f"projection 10c: bf16 batch {len(targets)} ms per step, phase path on "
          f"{phase['ms']:.3f} vs standard path {runs['bfloat16']['ms']:.3f} on {card}", flush=True)
    # one fp32 step at batch 2 on each path, the same inputs
    projector.settings.compute_dtype = "float32"
    rng = np.random.RandomState(SEED + 16)
    w = torch.from_numpy((0.5 * rng.standard_normal((2, config.dlatent_size))).astype(np.float32))
    planes = [torch.from_numpy(np.ascontiguousarray(p.transpose(0, 3, 1, 2))).cuda()
              for p in seeded_planes(projector, 2, SEED + 17)]
    target_proc = projector._target_proc(targets[:2])
    grads = {}
    for mode in ("off", "on"):
        set_phase(mode)
        _, grads[mode] = synthesis_term(projector, w.cuda(), planes, target_proc,
                                        torch.zeros_like(w).cuda())
    set_phase("off")
    errors = {"w": gradient_error(grads["on"][:1], grads["off"][:1]),
              "planes": gradient_error(grads["on"][1:], grads["off"][1:]),
              "top Conv1 plane": gradient_error(grads["on"][-1:], grads["off"][-1:])}
    print(f"projection 10c: one fp32 step at batch 2, phase path vs standard path, gradients of "
          f"the synthesis term, norm-wise: {errors} (limit 2e-2 for w and the planes together; "
          "the top Conv1 plane's comes through E's noise_bias gradient)", flush=True)
    require(errors["w"] <= 2e-2 and errors["planes"] <= 2e-2, f"10c: {errors}")
    del grads, planes, target_proc
    torch.cuda.empty_cache()

    add(write_loop_phase(projector, config, workdir, card))
    del projector
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# Phase 11: resumable renders, the spill tools, still images, network checks
# ---------------------------------------------------------------------------


def still_images_phase(config, workdir: Path, card: str) -> Dict[str, int]:
    """11a: `images_from_network_api` over phase 3's two networks (no face
    wanted, STILL_IMAGES each), then `synthesis_file_into_networks_api` of
    every sidecar through both; returns the launches."""
    from gance_tpu_torch.media.images import read_image
    from gance_tpu_torch.ops.cuda.fused_ops import reset_launch_counts
    from gance_tpu_torch.pipelines.synthesis_file import (
        FILTER_BATCH, images_from_network_api, read_synthesis_file,
        synthesis_file_into_networks_api)
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork
    from gance_tpu_torch.utils.hashing import hash_file

    nets = workdir / "still_nets"
    nets.mkdir()
    for i in range(2):
        (nets / f"{i}_net.pkl").symlink_to(workdir / f"{i}_net.pkl")
    batches: List[int] = []
    images_from_vectors = SynthesisNetwork.images_from_vectors

    def counting(self, z_batch):
        batches.append(len(z_batch))
        return images_from_vectors(self, z_batch)

    out, replayed = workdir / "still_images", workdir / "still_replayed"
    SynthesisNetwork.images_from_vectors = counting
    try:
        reset_launch_counts()
        start = time.perf_counter()
        sidecars = images_from_network_api(nets, out, num_faces=0, no_faces=STILL_IMAGES,
                                           random_seed=STILL_SEED, compute_dtype="float32",
                                           device="cuda")
        made_s, made_batches = time.perf_counter() - start, list(batches)
        start = time.perf_counter()
        synthesis_file_into_networks_api(sorted(sidecars), [nets / "0_net.pkl",
                                                            nets / "1_net.pkl"],
                                         replayed, compute_dtype="float32", device="cuda")
        replay_s = time.perf_counter() - start
    finally:
        SynthesisNetwork.images_from_vectors = images_from_vectors
    counts = launches_per_forward(f"11a still images (batches {batches})", len(batches), config)
    require(all(b == FILTER_BATCH for b in batches), f"11a: batches {batches}")
    worst, share_min = 0, 1.0
    for i in range(2):
        mine = sorted(s for s in sidecars if s.name.startswith(f"{i}_net_"))
        require(len(mine) == STILL_IMAGES and all("_no_face_" in s.name for s in mine),
                f"11a network {i}: {[s.name for s in mine]}")
        # the z each network drew, STILL_SEED anew per network, FILTER_BATCH a
        # round; no network drew more rounds than both did
        rng = np.random.RandomState(STILL_SEED)
        draws = [rng.standard_normal((FILTER_BATCH, PIPELINE_VECTOR)).astype(np.float32)
                 for _ in made_batches]
        draws = list(np.concatenate(draws))
        for sidecar in sorted(mine, key=lambda s: int(s.stem.rsplit("_", 1)[1])):
            record = read_synthesis_file(sidecar)
            image = Path(record.image_path)
            require(image == sidecar.with_suffix(".png") and hash_file(image) == record.image_hash,
                    f"11a {sidecar.name}: the sidecar's md5 is not its PNG's")
            vector = np.asarray(record.vector, np.float32)
            while draws and not np.array_equal(draws[0], vector):
                draws.pop(0)  # a draw the face filter rejected
            require(bool(draws), f"11a {sidecar.name}: its vector is not a drawn z, in order")
            draws.pop(0)
            again = read_image(replayed / f"{i}_net_{sidecar.stem}.png")
            top, share = share_within_one_step(again, read_image(image))
            worst, share_min = max(worst, top), min(share_min, share)
    print(f"11a still images: {2 * STILL_IMAGES} PNG + JSON pairs from {len(made_batches)} "
          f"forwards in {made_s:.3f} s (face detection and PNG writes included), each vector a "
          f"drawn z and each md5 its PNG's; {len(sidecars)} sidecars replayed through both "
          f"networks in {replay_s:.3f} s; a network's replay of its own vectors: max {worst} "
          f"steps, at least {share_min:.6f} within 1 step; on {card}", flush=True)
    require(share_min >= 0.999, f"11a: replayed images {share_min:.5f} within 1 step")
    for directory in (out, replayed, nets):
        shutil.rmtree(directory)
    return counts


def network_checks_phase(config, workdir: Path) -> Dict[str, int]:
    """11b: `check_move_networks_api` over phase 3's networks, a copy of one,
    a truncated pickle and a submit_config.pkl; then a wrapper of A that
    raises must leave `validate_network`. Returns the launches."""
    from gance_tpu_torch.ops.cuda import fused_ops
    from gance_tpu_torch.pipelines.check_move_networks import (check_move_networks_api,
                                                               validate_network)

    candidates, production = workdir / "check_nets", workdir / "production"
    candidates.mkdir()
    for i in range(2):
        shutil.copy2(workdir / f"{i}_net.pkl", candidates / f"{i}_net.pkl")
    shutil.copy2(workdir / "0_net.pkl", candidates / "2_copy.pkl")
    data = (workdir / "1_net.pkl").read_bytes()
    (candidates / "3_truncated.pkl").write_bytes(data[: len(data) // 2])
    (candidates / "submit_config.pkl").write_bytes(b"not a network")
    fused_ops.reset_launch_counts()
    start = time.perf_counter()
    copied = check_move_networks_api([candidates], production, device="cuda")
    wall = time.perf_counter() - start
    counts = launches_per_forward("11b network checks", 2, config)  # one vector per network
    names = [p.name for p in copied]
    require(names == sorted(p.name for p in production.iterdir())
            == ["0_check_nets_0_net.pkl", "1_check_nets_1_net.pkl"], f"11b: copied {names}")
    reason = validate_network(candidates / "3_truncated.pkl", "cuda")
    require(reason is not None, "11b: the truncated pickle was not rejected")

    def failing(*args, **kwargs):
        raise RuntimeError("11b: a kernel failure injected into A's wrapper")

    run = fused_ops._fused_bias_noise_lrelu_run
    fused_ops._fused_bias_noise_lrelu_run = failing
    try:
        validate_network(candidates / "0_net.pkl", "cuda")
        fail("11b: a kernel failure did not leave validate_network")
    except RuntimeError as e:
        require("injected" in str(e), f"11b: {e}")
    finally:
        fused_ops._fused_bias_noise_lrelu_run = run
    print(f"11b network checks: copied {names} in {wall:.3f} s; the duplicate skipped by md5, "
          f"submit_config.pkl by name, the truncated pickle rejected ({reason}); a failing "
          "kernel wrapper raised out of validate_network", flush=True)
    shutil.rmtree(candidates)
    shutil.rmtree(production)
    return counts


@contextlib.contextmanager
def peak_part_bytes(peak: Dict[str, int]):
    """Record in peak["bytes"] the bytes of a resumable render's parts on disk
    when its finalize starts (the most they ever hold)."""
    from gance_tpu_torch.media import resume

    inner = resume.write_source_to_disk_forward

    def measuring(*, source, video_path, **kwargs):
        parts = resume.parts_directory(Path(video_path))
        peak["bytes"] = sum(p.stat().st_size for p in parts.iterdir())
        return inner(source=source, video_path=video_path, **kwargs)

    resume.write_source_to_disk_forward = measuring
    try:
        yield
    finally:
        resume.write_source_to_disk_forward = inner


def noise_blend_resumable(wav: Path, paths: List[Path], out: Path, side: int) -> None:
    """11c's render: fp32, the networks' side, standard path, RESUME_CHUNK
    frames a chunk."""
    from gance_tpu_torch.pipelines.noise_blend import noise_blend_api

    noise_blend_api([wav], out, paths, None, PIPELINE_FPS, side, None, None, None,
                    PIPELINE_ALPHA, False, (-1.0, 1.0), compute_dtype="float32",
                    resumable=True, resume_chunk_frames=RESUME_CHUNK, device="cuda")


def flagship_resumable(source, wav: Path, paths: List[Path], out: Path,
                       overlay: Optional[Tuple[int, float, int]]) -> None:
    """11d's render: bf16, side 512, on `source` (an in-memory reader)."""
    from gance_tpu_torch.pipelines import projection_file_blend as pfb

    pfb._blend_from_reader(
        reader=source, wav=[wav], output_path=out, network_paths=paths, frames_to_visualize=None,
        output_fps=FLAGSHIP_FPS, output_side_length=RESIZE_SIDE, alpha=PIPELINE_ALPHA,
        fft_roll_enabled=False, fft_amplitude_range=(-1.0, 1.0), blend_depth=FLAGSHIP_BLEND_DEPTH,
        compute_dtype="bfloat16", complexity_change_rolling_sum_window=None,
        complexity_change_threshold=None, overlay_gates=overlay, overlay_detection_side=None,
        overlay_smoothing=0, device="cuda", resumable=True, resume_chunk_frames=RESUME_CHUNK)


def resumable_child(spec: dict) -> None:
    """11c and 11d's render in a child process, which the parent kills:
    `python3 -c "import chip_smoke; chip_smoke.resumable_child(...)"`."""
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig

    workdir, config = Path(spec["workdir"]), GeneratorConfig()
    paths = [workdir / f"{i}_net.pkl" for i in range(2)]
    if spec["kind"] == "noise-blend":
        noise_blend_resumable(workdir / "song.wav", paths, Path(spec["out"]), config.resolution)
    else:
        source = projection_source(config, workdir, False)
        flagship_resumable(source, workdir / "song.wav", paths, Path(spec["out"]),
                           tuple(spec["overlay"]) if spec["overlay"] else None)


def kill_child_when(spec: dict, ready: Callable[[], bool], env: Dict[str, str],
                    log: Path) -> float:
    """Start `resumable_child(spec)` with `env` added, SIGKILL it once
    `ready()` holds, and return the seconds it ran."""
    code = "import json, sys, chip_smoke; chip_smoke.resumable_child(json.loads(sys.argv[1]))"
    with open(log, "wb") as output:
        child = subprocess.Popen([sys.executable, "-c", code, json.dumps(spec)], cwd=ROOT,
                                 env={**os.environ, **env}, stdout=output,
                                 stderr=subprocess.STDOUT)
    start = time.perf_counter()
    try:
        while time.perf_counter() - start < 300:
            if child.poll() is not None:
                fail(f"11 {spec['kind']}: the child ended (exit {child.returncode}) before it "
                     f"could be killed:\n{log.read_text(errors='replace')[-3000:]}")
            if ready():
                child.send_signal(signal.SIGKILL)
                child.wait()
                return time.perf_counter() - start
            time.sleep(0.02)
        fail(f"11 {spec['kind']}: the child never got to the point to kill it:\n"
             f"{log.read_text(errors='replace')[-3000:]}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    return 0.0


def run_resumable(render: Callable[[], None], out: Path) -> dict:
    """Run the resumable render `render` into `out` with GANCE_TPU_EGRESS=raw-spill
    and stage stats; returns its wall seconds split into loading, audio
    features, chunks (synthesis and parts) and the finalize (parts read back
    and written again with the audio), its frames and the peak part bytes."""
    stages = out.with_suffix(".stages.jsonl")
    stages.unlink(missing_ok=True)
    os.environ.update(GANCE_TPU_STAGE_STATS=str(stages), GANCE_TPU_EGRESS="raw-spill")
    peak: Dict[str, int] = {}
    torch.cuda.synchronize()
    start = time.perf_counter()
    with peak_part_bytes(peak):
        render()
    wall = time.perf_counter() - start
    del os.environ["GANCE_TPU_STAGE_STATS"], os.environ["GANCE_TPU_EGRESS"]
    busy = {name: s.get("busy_sec", 0.0) for name, s in read_stage_stats(stages).items()}
    features, rendered, finalize = busy["audio_features"], busy["render"], busy["finalize"]
    return {"wall": wall, "loading": wall - features - rendered, "features": features,
            "chunks": rendered - finalize, "finalize": finalize, "busy": busy,
            "part_bytes": peak["bytes"]}


def describe_resumable(r: dict, frames: int) -> str:
    return (f"wall {r['wall']:.3f} s = loading {r['loading']:.3f} + audio features "
            f"{r['features']:.3f} + chunks written {r['chunks']:.3f} (the synthesis stream "
            f"{r['busy'].get('synthesis', 0.0):.3f} of it) + finalize {r['finalize']:.3f}; "
            f"{frames} frames, end to end {frames / r['wall']:.2f} frames/s, chunks "
            f"{frames / r['chunks']:.2f} frames/s; parts on disk at the peak "
            f"{r['part_bytes']} bytes")


def rate_of(label: str, phase: str) -> str:
    """The non-resumable render `label`'s frames/s, as RATES recorded it."""
    if label not in RATES:
        return f"phase {phase} did not run in this process"
    r = RATES[label]
    return (f"the non-resumable {phase} render: {r['frames'] / r['wall']:.2f} frames/s end to "
            f"end, {r['frames'] / r['render']:.2f} render")


def resumed_frames_check(label: str, out: Path, want: List[np.ndarray],
                         samples: np.ndarray) -> List[np.ndarray]:
    """The scaffolding is gone, and the output's frames equal `want` bit for
    bit with the WAV's samples as its audio; returns the frames."""
    from gance_tpu_torch.media import resume

    require(out.exists() and not resume.manifest_path(out).exists()
            and not resume.parts_directory(out).exists(),
            f"{label}: the output is missing or its manifest or parts are left")
    frames, compressed, pcm = read_avi(out)
    require(len(frames) == len(want) and not compressed,
            f"{label}: {len(frames)} frames ({compressed} compressed), {len(want)} expected")
    require(bool(np.array_equal(pcm, samples)), f"{label}: the audio is not the WAV's samples")
    differ = [i for i, (a, b) in enumerate(zip(frames, want)) if not np.array_equal(a, b)]
    if differ:
        worst, share = share_within_one_step(np.stack([frames[i] for i in differ]),
                                             np.stack([want[i] for i in differ]))
        fail(f"{label}: frames {differ} differ from the unbroken run's (max {worst} steps, "
             f"{share:.6f} within 1)")
    return frames


def resumable_noise_blend_phase(config, workdir: Path, card: str) -> Tuple[Dict[str, int], Path]:
    """11c: an unbroken resumable noise-blend, then one killed with SIGKILL in
    a child and resumed here; returns the resumed run's launches and its AVI
    (kept for 11e)."""
    from scipy.io import wavfile

    from gance_tpu_torch.audio.io import read_wavs_scale_for_video
    from gance_tpu_torch.media import resume
    from gance_tpu_torch.ops.cuda.fused_ops import LAUNCHES, reset_launch_counts
    from gance_tpu_torch.synthesis.inputs import alpha_blend_vectors_max_rms_power_audio
    from gance_tpu_torch.synthesis.orchestration import vector_synthesis
    from gance_tpu_torch.synthesis.runtime import MultiNetwork

    wav, paths = workdir / "song.wav", [workdir / f"{i}_net.pkl" for i in range(2)]
    samples = wavfile.read(str(wav))[1]
    set_phase("off")
    unbroken = workdir / "resumable-unbroken.avi"
    r_unbroken = run_resumable(
        lambda: noise_blend_resumable(wav, paths, unbroken, config.resolution), unbroken)
    want, _, _ = read_avi(unbroken)
    want = [np.array(f) for f in want]
    unbroken.unlink()
    require(len(want) == RESUME_FRAMES, f"11c: the unbroken render has {len(want)} frames")

    out = workdir / "resumable-killed.avi"
    manifest = resume.manifest_path(out)

    def durable() -> bool:
        try:
            return bool(json.loads(manifest.read_text())["chunks"])
        except (OSError, ValueError, KeyError):
            return False

    ran = kill_child_when({"kind": "noise-blend", "workdir": str(workdir), "out": str(out)},
                          durable, {"GANCE_TPU_EGRESS": "raw-spill",
                                    "GANCE_TPU_RESUME_CHUNK_DELAY": str(RESUME_CHUNK_DELAY)},
                          workdir / "child-11c.log")
    fingerprint = json.loads(manifest.read_text())["fingerprint"]
    start = resume.durable_frames(out, fingerprint)
    require(not out.exists() and 0 < start < RESUME_FRAMES and start % RESUME_CHUNK == 0,
            f"11c: killed with {start} frames durable, output exists {out.exists()}")
    reset_launch_counts()
    r = run_resumable(lambda: noise_blend_resumable(wav, paths, out, config.resolution), out)
    counts = dict(LAUNCHES)
    audio = read_wavs_scale_for_video([wav], PIPELINE_VECTOR,
                                      frames_per_second=PIPELINE_FPS).wav_data
    inputs = alpha_blend_vectors_max_rms_power_audio(
        PIPELINE_ALPHA, False, (-1.0, 1.0), audio, PIPELINE_VECTOR, [0, 1], device="cuda")
    indices = inputs.network_indices.result.data
    batches = stream_batches(indices[start:])  # the windows after the durable frames only
    expected = {k: v * len(batches) for k, v in forward_launches(config).items()}
    print(f"launches 11c resumed noise-blend ({len(batches)} forwards for the "
          f"{RESUME_FRAMES - start} frames after the durable {start}; the unbroken render's "
          f"{len(stream_batches(indices))}): {counts}", flush=True)
    require(counts == expected, f"11c: launches {counts} != {expected}")
    frames = resumed_frames_check("11c", out, want, samples)
    with MultiNetwork(paths, output_side_length=config.resolution, compute_dtype=torch.float32,
                      device="cuda") as networks:
        direct = np.stack(list(vector_synthesis(networks, inputs).synthesized_images))
    require_close_frames("11c resumed frames vs vector_synthesis run directly",
                         np.stack(frames), direct)
    del direct, frames, want
    print(f"11c resumable noise-blend (fp32, {config.resolution}px, {RESUME_FRAMES} frames at "
          f"{PIPELINE_FPS:g} fps, chunks of {RESUME_CHUNK}, raw-avi parts) unbroken: "
          f"{describe_resumable(r_unbroken, RESUME_FRAMES)}; killed after {ran:.3f} s with "
          f"{start} frames durable, resumed: {describe_resumable(r, RESUME_FRAMES - start)}; "
          f"resumed output equals the unbroken one bit for bit; {rate_of('fp32-1024', '8b')}; "
          f"on {card}", flush=True)
    return counts, out


def resumable_flagship_phase(config, workdir: Path, card: str) -> Dict[str, int]:
    """11d: an unbroken resumable flagship (bf16, 512px, the phase path, the
    README's gates where the cascades are), then one killed with SIGKILL in a
    child during detection and resumed here; returns the resumed launches."""
    from scipy.io import wavfile

    from gance_tpu_torch.audio.io import read_wavs_scale_for_video
    from gance_tpu_torch.media import resume
    from gance_tpu_torch.ops.cuda.fused_ops import reset_launch_counts
    from gance_tpu_torch.pipelines import projection_file_blend as pfb
    from gance_tpu_torch.projection import final_latents_matrices_label
    from gance_tpu_torch.synthesis.inputs import alpha_blend_projection_file

    wav, paths = workdir / "song.wav", [workdir / f"{i}_net.pkl" for i in range(2)]
    samples = wavfile.read(str(wav))[1]
    _, have_cascades = host_findings()
    overlay = FLAGSHIP_OVERLAY if have_cascades else None
    require(overlay is not None, "11d: no Haar cascade XMLs on this host, so no detection "
            "to kill")
    source = projection_source(config, workdir, False)
    set_phase("on")
    unbroken = workdir / "flagship-resumable-unbroken.avi"
    r_unbroken = run_resumable(lambda: flagship_resumable(source, wav, paths, unbroken, overlay),
                               unbroken)
    want = [np.array(f) for f in read_avi(unbroken)[0]]
    unbroken.unlink()
    count = int(FLAGSHIP_FPS // FLAGSHIP_PROJECTION_FPS) * FLAGSHIP_PROJECTION_FRAMES
    require(len(want) == count, f"11d: the unbroken render has {len(want)} frames")

    out = workdir / "flagship-resumable-killed.avi"
    sidecar = pfb._overlay_decisions_path(out)

    def decided() -> bool:
        return sidecar.exists() and len(sidecar.read_text().splitlines()) >= 2

    ran = kill_child_when({"kind": "flagship", "workdir": str(workdir), "out": str(out),
                           "overlay": list(overlay)}, decided,
                          {"GANCE_TPU_EGRESS": "raw-spill", PHASE_ENV: "on",
                           "GANCE_TPU_RESUME_DECISION_DELAY": str(RESUME_DECISION_DELAY)},
                          workdir / "child-11d.log")
    fingerprint = json.loads(sidecar.read_text().splitlines()[0])["fingerprint"]
    cached = len(pfb._load_overlay_decisions(sidecar, fingerprint))
    require(cached >= 1 and not resume.manifest_path(out).exists() and not out.exists(),
            f"11d: killed with {cached} decisions cached")
    reset_launch_counts()
    r = run_resumable(lambda: flagship_resumable(source, wav, paths, out, overlay), out)
    set_phase("off")
    audio = read_wavs_scale_for_video([wav], PIPELINE_VECTOR, target_num_vectors=count).wav_data
    inputs = alpha_blend_projection_file(final_latents_matrices_label(source), PIPELINE_ALPHA,
                                         False, (-1.0, 1.0), FLAGSHIP_BLEND_DEPTH, audio,
                                         PIPELINE_VECTOR, [0, 1], device="cuda")
    # no chunk was durable, so the resumed run composes from frame 0 and
    # synthesizes every frame again; only detection starts at the cache's end
    batches = stream_batches(inputs.network_indices.result.data)
    counts = launches_per_forward("11d resumed flagship", len(batches), config, phase=True)
    resumed_frames_check("11d", out, want, samples)
    require(not sidecar.exists(), "11d: the decision sidecar is left")
    out.unlink()
    print(f"11d resumable flagship (bf16, {RESIZE_SIDE}px, phase path, overlay {overlay}, "
          f"{count} frames, chunks of {RESUME_CHUNK}) unbroken: "
          f"{describe_resumable(r_unbroken, count)}; killed during detection after {ran:.3f} s "
          f"with {cached} decisions cached, resumed: {describe_resumable(r, count)}; detect "
          f"busy {r['busy'].get('detect', 0.0):.3f} s against the unbroken run's "
          f"{r_unbroken['busy'].get('detect', 0.0):.3f}; resumed output equals the unbroken one "
          f"bit for bit; {rate_of('flagship-bf16-512-phase', '9d')}; on {card}", flush=True)
    return counts


def spill_tools_phase(avi: Path) -> None:
    """11e: `frames_in_spill` over 11c's AVI, `spill_segment_paths` over a
    three-segment spill, and `reencode_spill` to mp4v."""
    import cv2

    from gance_tpu_torch.media.native import RawAviWriter
    from gance_tpu_torch.media.spill import frames_in_spill, reencode_spill, spill_segment_paths

    frames, _, _ = read_avi(avi)
    video = frames_in_spill(avi)
    start = time.perf_counter()
    count = 0
    for count, (got, want) in enumerate(zip(video.frames, frames), start=1):
        require(np.array_equal(got, want), f"11e: frames_in_spill frame {count - 1} differs")
    read_s = time.perf_counter() - start
    require(count == video.total_frame_count == len(frames) == RESUME_FRAMES
            and video.original_fps == PIPELINE_FPS,
            f"11e: {count} frames, {video.total_frame_count} in the headers, "
            f"{video.original_fps} fps")
    side = frames[0].shape[0]
    base = avi.with_name("segmented.avi")
    # room for the header (a few hundred bytes) and SPILL_SEGMENT_FRAMES frames
    writer = RawAviWriter(base, side, side, PIPELINE_FPS, segment_bytes=SPILL_SEGMENT_FRAMES
                          * (side * side * 3 + 24) + 1024)
    for frame in frames[: 3 * SPILL_SEGMENT_FRAMES]:
        writer.write_frame_rgb(frame)
    writer.finalize()
    segments = spill_segment_paths(base)
    want = [base, base.with_name("segmented.part001.avi"), base.with_name("segmented.part002.avi")]
    require(segments == want, f"11e: segments {segments}")
    segmented = frames_in_spill(base)
    require(segmented.total_frame_count == 3 * SPILL_SEGMENT_FRAMES
            and all(np.array_equal(a, b) for a, b in zip(segmented.frames, frames)),
            "11e: the segmented spill's frames differ")
    segments[1].unlink()
    try:
        spill_segment_paths(base)
        fail("11e: a spill with its middle segment removed did not raise")
    except ValueError as e:
        require("non-contiguous" in str(e), f"11e: {e}")
    for segment in (segments[0], segments[2]):
        segment.unlink()
    del frames
    mp4 = avi.with_name("reencoded.mp4")
    os.environ["GANCE_TPU_EGRESS"] = "raw-spill"  # the re-encode must not spill again
    start = time.perf_counter()
    try:
        written = reencode_spill(avi, mp4)
    finally:
        del os.environ["GANCE_TPU_EGRESS"]
    encode_s = time.perf_counter() - start
    capture = cv2.VideoCapture(str(mp4))
    decoded = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))
    capture.release()
    with open(mp4, "rb") as handle:
        riff = handle.read(4) == b"RIFF"
    require(written == decoded == RESUME_FRAMES and not riff,
            f"11e: re-encoded {written} frames, cv2 counts {decoded}, raw {riff}")
    print(f"11e spill tools: frames_in_spill over 11c's AVI bit for bit with the RIFF reader "
          f"({RESUME_FRAMES} frames in {read_s:.3f} s); a {len(segments)}-segment spill in "
          f"order, a hole raises; reencode_spill to mp4v {written} frames in {encode_s:.3f} s "
          f"({mp4.stat().st_size} bytes)", flush=True)
    mp4.unlink()
    avi.unlink()


def resume_phase(config, workdir: Path, card: str) -> Dict[str, int]:
    """Phase 11, with phase 3's networks and phase 8's WAV in `workdir`;
    returns the launches of 11a-11d's main-path runs."""
    torch.cuda.empty_cache()
    totals: Dict[str, int] = {}

    def add(counts: Dict[str, int]) -> None:
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    add(still_images_phase(config, workdir, card))
    add(network_checks_phase(config, workdir))
    counts, avi = resumable_noise_blend_phase(config, workdir, card)
    add(counts)
    add(resumable_flagship_phase(config, workdir, card))
    spill_tools_phase(avi)
    return totals


def serving_load(url: str, clients: int, request_frames: int, seconds: float,
                 settle_seconds: float = 2.0, trace_dir: Optional[Path] = None) -> dict:
    """`clients` threads post /synthesize requests of `request_frames` seeded z
    rows (the "count" source) back to back for `settle_seconds`, then for a
    timed window of `seconds`. Returns the window's frames/s and requests/s
    (every request that completed inside it, as tools/bench_serving_daemon.py
    counts), the client-side latency p50/p99 of the requests that both started
    and completed inside it (ms, HTTP round trip and npy decode included), the
    daemon's batches, occupancy and mean batch over the window (/stats before
    and after), and with `trace_dir` the device's idle share over the window
    (torch.profiler on the device only: 1 - the union of kernel and copy
    intervals / the span from the first device event to the last).
    tools/time_torch_serving.py measures with this."""
    from gance_tpu_torch.serving import ServingClient

    stop, lock = threading.Event(), threading.Lock()
    window: Dict[str, float] = {}
    timed: List[float] = []
    done = [0, 0]  # requests, frames
    errors = [0]

    def client(k: int) -> None:
        serving_client, i = ServingClient(url), 0
        while not stop.is_set():
            start = time.perf_counter()
            try:
                images = serving_client.synthesize(count=request_frames, seed=k * 100003 + i)
                end = time.perf_counter()
                with lock:
                    if "start" in window and "end" not in window:
                        done[0] += 1
                        done[1] += int(images.shape[0])
                        if start >= window["start"]:
                            timed.append(end - start)
            except Exception:  # pylint: disable=broad-except
                if not stop.is_set():
                    with lock:
                        errors[0] += 1
            i += 1

    threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(clients)]
    for t in threads:
        t.start()
    time.sleep(settle_seconds)
    profiler = None
    if trace_dir is not None:
        profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        profiler.__enter__()
    before = ServingClient(url).stats()
    with lock:
        window["start"] = time.perf_counter()
    time.sleep(seconds)
    with lock:
        window["end"] = time.perf_counter()
        requests, frames = done
        latencies = sorted(s * 1e3 for s in timed)
    after = ServingClient(url).stats()
    idle = None
    if profiler is not None:
        profiler.__exit__(None, None, None)
        trace_dir.mkdir(parents=True, exist_ok=True)
        path = trace_dir / "serving_trace.json"
        profiler.export_chrome_trace(str(path))
        events = sorted((e["ts"], e["ts"] + e["dur"]) for e in json.loads(path.read_text())[
            "traceEvents"] if e.get("ph") == "X" and e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset"))
        busy, end = 0.0, events[0][0] if events else 0.0
        for lo, hi in events:
            if hi > end:
                busy += hi - max(lo, end)
                end = hi
        idle = 1.0 - busy / (end - events[0][0]) if events else None
    stop.set()
    for t in threads:
        t.join(timeout=120)
    elapsed = window["end"] - window["start"]
    batches = after["batches"] - before["batches"]
    rows_out = after["dispatched_rows"] - before["dispatched_rows"]
    frames_in = after["frames"] - before["frames"]

    def quantile(q: float):
        return latencies[min(len(latencies) - 1, int(len(latencies) * q))] if latencies else None

    return {"frames_per_s": frames / elapsed,
            "requests_per_s": requests / elapsed, "requests": requests,
            "client_errors": errors[0], "latency_p50_ms": quantile(0.5),
            "latency_p99_ms": quantile(0.99), "batches": batches,
            "mean_batch": frames_in / batches if batches else None,
            "occupancy": frames_in / rows_out if rows_out else None,
            "server_latency_p50_ms": after.get("latency_p50_ms"),
            "server_latency_p99_ms": after.get("latency_p99_ms"),
            "device_idle_share": idle, "seconds": elapsed}


def describe_load(r: dict) -> str:
    idle = "" if r["device_idle_share"] is None else \
        f", device idle share {r['device_idle_share']:.3f}"
    return (f"{r['frames_per_s']:.2f} frames/s ({r['requests_per_s']:.2f} requests/s, "
            f"{r['requests']} in {r['seconds']:.2f} s), latency p50 {r['latency_p50_ms']:.1f} "
            f"ms p99 {r['latency_p99_ms']:.1f} ms (client), {r['batches']} batches of "
            f"{r['mean_batch']:.2f} frames on average, occupancy {r['occupancy']:.3f}{idle}, "
            f"{r['client_errors']} client errors")


class ServedLaunches:
    """12's launch ledger: `check(label, before)` holds the launches since the
    last reset against the batches the daemon dispatched since `before` (one
    synthesis forward each) and adds them to the totals."""

    def __init__(self, config) -> None:
        self.config, self.totals = config, {}

    def reset(self, daemon) -> int:
        from gance_tpu_torch.ops.cuda.fused_ops import reset_launch_counts

        reset_launch_counts()
        return daemon.batcher.stats()["batches"]

    def check(self, label: str, daemon, before: int, phase: bool = False,
              extra_forwards: int = 0) -> int:
        forwards = daemon.batcher.stats()["batches"] - before + extra_forwards
        for k, v in launches_per_forward(label, forwards, self.config, phase=phase).items():
            self.totals[k] = self.totals.get(k, 0) + v
        return forwards


def z_of_seeds(seeds: List[int], length: int) -> np.ndarray:
    """The daemon's "seeds" source: one N(0, 1) z per seed from RandomState."""
    return np.stack([np.random.RandomState(s).randn(length) for s in seeds]).astype(np.float32)


def decode_png(blob: bytes) -> np.ndarray:
    import cv2

    image = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    require(image is not None, "a PNG from the daemon does not decode")
    return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)


def serve_requests_phase(config, nets, daemon, ledger: ServedLaunches, workdir: Path,
                         card: str) -> None:
    """12a: /healthz, /synthesize from seeds, dlatents and by name, 8 concurrent
    clients, png, png-zip and avi, /metrics; frames against direct synthesis."""
    import io
    import urllib.request
    import zipfile

    from gance_tpu_torch.serving import ServingClient

    url = f"http://127.0.0.1:{daemon.port}"
    client = ServingClient(url)
    res, length = config.resolution, config.latent_size
    health = client.health()
    names = [n["name"] for n in health.get("networks", [])]
    require(health["ok"] and names == ["0_net", "1_net"] and health["resolution"] == res,
            f"12a /healthz: {health}")

    seeds = [1, 2, 3, 4, 5]
    before = ledger.reset(daemon)
    images = client.synthesize(seeds=seeds)
    ledger.check("12a seeds", daemon, before)
    check_frames("12a seeds", images, len(seeds), res)
    direct_seeds = nets[0].images_from_vectors(z_of_seeds(seeds, length))
    require_close_frames("12a seeds vs images_from_vectors", images, direct_seeds)

    rng = np.random.RandomState(SEED + 12)
    w_plus = rng.standard_normal((4, config.num_style_rows, config.dlatent_size)
                                 ).astype(np.float32)
    before = ledger.reset(daemon)
    images = client.synthesize(dlatents=w_plus)
    ledger.check("12a dlatents", daemon, before)
    check_frames("12a dlatents", images, 4, res)
    require_close_frames("12a dlatents vs images_from_matrices", images,
                         nets[0].images_from_matrices(w_plus))

    z = rng.standard_normal((3, length)).astype(np.float32)
    before = ledger.reset(daemon)
    images = client.synthesize(latents=z, network="1_net")
    ledger.check("12a network 1_net", daemon, before)
    require_close_frames("12a network 1_net vs its images_from_vectors", images,
                         nets[1].images_from_vectors(z))

    # 8 concurrent clients of 3-5 rows each, started together
    sizes = [3, 4, 5, 3, 4, 5, 3, 5]
    rows = [rng.standard_normal((n, length)).astype(np.float32) for n in sizes]
    results: Dict[int, np.ndarray] = {}
    barrier = threading.Barrier(len(sizes))

    def post(k: int) -> None:
        barrier.wait()
        results[k] = ServingClient(url).synthesize(latents=rows[k])

    stats_before = client.stats()
    before = ledger.reset(daemon)
    threads = [threading.Thread(target=post, args=(k,)) for k in range(len(sizes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    forwards = ledger.check("12a 8 concurrent clients", daemon, before)
    stats_after = client.stats()
    requests = stats_after["requests"] - stats_before["requests"]
    require(len(results) == len(sizes) and requests == len(sizes),
            f"12a concurrent: {len(results)} answers, {requests} requests")
    require(forwards < requests, f"12a concurrent: {forwards} batches for {requests} requests")
    direct = nets[0].images_from_vectors(np.concatenate(rows))
    offsets = np.cumsum([0] + sizes)
    for k in range(len(sizes)):
        require(results[k].shape == (sizes[k], res, res, 3), f"12a client {k}: {results[k].shape}")
        worst, share = share_within_one_step(results[k], direct[offsets[k]:offsets[k + 1]])
        require(share >= 0.999, f"12a client {k}: its rows out of order or wrong "
                f"(max {worst} steps, {share:.5f} within 1)")
    print(f"12a: {requests} concurrent requests ({sum(sizes)} rows) in {forwards} batches; each "
          "client's rows came back in order within 1 uint8 step of one direct render", flush=True)

    before = ledger.reset(daemon)
    png = client.synthesize_png(seeds=[7])
    zipped = client.synthesize_compressed(seeds=seeds[:3], format="png-zip")
    os.environ["GANCE_TPU_EGRESS"] = "raw-spill"
    try:
        avi = client.synthesize_compressed(seeds=seeds[:3], format="avi", fps=30.0)
    finally:
        del os.environ["GANCE_TPU_EGRESS"]
    ledger.check("12a png, png-zip and avi", daemon, before)
    require_close_frames("12a png vs images_from_vectors", decode_png(png)[None],
                         nets[0].images_from_vectors(z_of_seeds([7], length)))
    with zipfile.ZipFile(io.BytesIO(zipped)) as archive:
        members = sorted(archive.namelist())
        unzipped = np.stack([decode_png(archive.read(m)) for m in members])
    require(members == [f"frame_{i:06d}.png" for i in range(3)], f"12a png-zip: {members}")
    require_close_frames("12a png-zip vs images_from_vectors", unzipped, direct_seeds[:3])
    avi_path = workdir / "served.avi"
    avi_path.write_bytes(avi)
    frames, compressed, _pcm = read_avi(avi_path)
    require(len(frames) == 3 and not compressed, f"12a avi: {len(frames)} raw frames, "
            f"{compressed} compressed")
    require_close_frames("12a avi (raw) vs images_from_vectors", np.stack(frames),
                         direct_seeds[:3])
    print(f"12a egress: png {len(png)} bytes, png-zip of 3 {len(zipped)} bytes, raw avi of 3 "
          f"{len(avi)} bytes; each decoded back; on {card}", flush=True)

    with urllib.request.urlopen(url + "/metrics", timeout=60) as response:
        text = response.read().decode()
    metrics = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            metrics[name] = float(value)
    require(metrics.get("gance_serving_requests_total", 0) >= 14
            and 'gance_serving_network_frames_total{network="1_net"}' in metrics
            and metrics.get("gance_serving_draining") == 0.0,
            f"12a /metrics: {sorted(metrics)}")
    print(f"12a /metrics: {len(metrics)} samples parsed; on {card}", flush=True)


def serve_audio_phase(config, nets, daemon, ledger: ServedLaunches, workdir: Path,
                      card: str) -> None:
    """12b: /synthesize_audio: the plan against the offline planning, the frames
    against the offline render of the same plan, the flagship blend on latents
    registered by POST, a plan-cache hit."""
    from gance_tpu_torch.audio.io import read_wavs_scale_for_video
    from gance_tpu_torch.serving import ServingClient
    from gance_tpu_torch.serving.audio import plan_audio_request
    from gance_tpu_torch.synthesis.inputs import (alpha_blend_projection_file,
                                                  alpha_blend_vectors_max_rms_power_audio)
    from gance_tpu_torch.synthesis.runtime import MultiNetwork
    from gance_tpu_torch.types import MatricesLabel

    client = ServingClient(f"http://127.0.0.1:{daemon.port}")
    wav = workdir / "song.wav"
    wav_bytes = wav.read_bytes()
    multi = MultiNetwork.from_networks(nets)
    amplitude = (-10.0, 10.0)  # the daemon's default, the offline CLI's
    preview = client.synthesize_audio(wav_bytes, fps=PIPELINE_FPS, alpha=PIPELINE_ALPHA,
                                      plan=True)
    audio = read_wavs_scale_for_video([wav], PIPELINE_VECTOR,
                                      frames_per_second=PIPELINE_FPS).wav_data
    offline = alpha_blend_vectors_max_rms_power_audio(PIPELINE_ALPHA, False, amplitude, audio,
                                                      PIPELINE_VECTOR, [0, 1], device="cuda")
    indices = np.asarray(offline.network_indices.result.data)
    require(preview["indices"] == indices.tolist() and preview["names"] == ["0_net", "1_net"],
            f"12b plan: {preview['frames']} indices != the offline planning's {len(indices)}")
    payload = {"wav_base64": base64.b64encode(wav_bytes).decode(), "fps": PIPELINE_FPS,
               "alpha": PIPELINE_ALPHA}
    times = []
    for _ in range(3):
        start = time.perf_counter()
        plan = plan_audio_request(payload, nets, [0, 1], daemon.frame_cap)
        times.append(time.perf_counter() - start)
    combined = offline.combined.data.reshape(-1, PIPELINE_VECTOR)[:len(plan.combined)]
    worst = float(np.abs(plan.combined - combined).max())
    require(worst <= 1e-4, f"12b plan: combined rows {worst:.3g} from the card's offline inputs")
    print(f"12b plan: {len(indices)} frames, indices equal to the offline planning's "
          f"({np.bincount(indices).tolist()}), rows within {worst:.3g} of its card inputs; "
          f"planning the {PIPELINE_SECONDS:g} s clip on the CPU: {min(times):.3f} s min, "
          f"{sorted(times)[1]:.3f} s median of 3; on {card}", flush=True)

    before = ledger.reset(daemon)
    start = time.perf_counter()
    frames = client.synthesize_audio(wav_bytes, fps=PIPELINE_FPS, alpha=PIPELINE_ALPHA)
    served_s = time.perf_counter() - start
    ledger.check("12b noise-blend", daemon, before)
    check_frames("12b noise-blend", frames, len(indices), config.resolution)
    require_close_frames("12b noise-blend vs the offline render of its plan", frames,
                         multi.synthesize_all(plan.combined, plan.indices))
    hits = client.stats()["plan_cache"]["hits"]
    before = ledger.reset(daemon)
    start = time.perf_counter()
    again = client.synthesize_audio(wav_bytes, fps=PIPELINE_FPS, alpha=PIPELINE_ALPHA)
    hit_s = time.perf_counter() - start
    ledger.check("12b noise-blend, plan cached", daemon, before)
    require(client.stats()["plan_cache"]["hits"] == hits + 1, "12b: the repeat missed the cache")
    require_close_frames("12b plan-cache hit vs the miss", again, frames)

    source = projection_source(config, workdir, False)
    latents = source._latents[:, 0]  # (60, R, 512), rows identical
    reg = client.register_projection(final_latents=latents,
                                     projection_fps=FLAGSHIP_PROJECTION_FPS, name="phase9")
    require(reg["frames"] == FLAGSHIP_PROJECTION_FRAMES and reg["rows"] == config.num_style_rows,
            f"12b register_projection: {reg}")
    before = ledger.reset(daemon)
    start = time.perf_counter()
    blended = client.synthesize_audio(wav_bytes, fps=FLAGSHIP_FPS, alpha=PIPELINE_ALPHA,
                                      projection="phase9", blend_depth=FLAGSHIP_BLEND_DEPTH)
    flagship_s = time.perf_counter() - start
    ledger.check("12b flagship blend", daemon, before)
    count = int(FLAGSHIP_FPS / FLAGSHIP_PROJECTION_FPS) * FLAGSHIP_PROJECTION_FRAMES
    check_frames("12b flagship blend", blended, count, config.resolution)
    target = read_wavs_scale_for_video([wav], PIPELINE_VECTOR, target_num_vectors=count).wav_data
    matrices = np.ascontiguousarray(latents.transpose(1, 0, 2).reshape(
        config.num_style_rows, -1))
    direct = alpha_blend_projection_file(
        MatricesLabel(data=matrices, vector_length=PIPELINE_VECTOR, label="phase9"),
        PIPELINE_ALPHA, False, amplitude, FLAGSHIP_BLEND_DEPTH, target, PIPELINE_VECTOR, [0, 1],
        device="cpu")
    rows = direct.combined.data.reshape(config.num_style_rows, -1, PIPELINE_VECTOR
                                        ).transpose(1, 0, 2)
    quantized = np.asarray(direct.network_indices.result.data)
    n = min(len(rows), len(quantized))
    require(n == count, f"12b flagship: {n} frames planned directly, {count} expected")
    require_close_frames("12b flagship blend vs inputs.py's blend rendered directly", blended,
                         multi.synthesize_all(np.ascontiguousarray(rows[:n]), quantized[:n]))
    print(f"12b served {len(indices)} noise-blend frames of {config.resolution}px in "
          f"{served_s:.3f} s (plan cached: {hit_s:.3f} s) and {count} flagship frames in "
          f"{flagship_s:.3f} s, npy egress; on {card}", flush=True)


def serve_rollout_phase(config, daemon, ledger: ServedLaunches, workdir: Path,
                        card: str) -> None:
    """12c: /admin/load and /admin/unload of a third network, with the device
    memory it takes and gives back."""
    import gc

    from gance_tpu_torch.models.pickle_loader import save_generator_pickle
    from gance_tpu_torch.serving import ServingClient

    client = ServingClient(f"http://127.0.0.1:{daemon.port}")
    path = workdir / "2_net.pkl"
    params = smoke_params(SEED + 20, config)
    save_generator_pickle(params, path)
    param_bytes = sum(4 * int(np.prod(np.shape(a))) for a in _leaves(params))
    gc.collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    loaded = client.load_network(str(path))
    torch.cuda.synchronize()
    with_third = torch.cuda.memory_allocated()
    require(loaded["index"] == 2 and loaded["name"] == "2_net", f"12c /admin/load: {loaded}")
    before = ledger.reset(daemon)
    images = client.synthesize(seeds=[11, 12], network="2_net")
    ledger.check("12c the hot-loaded network", daemon, before)
    check_frames("12c the hot-loaded network", images, 2, config.resolution)
    gone = client.unload_network("2_net")
    require(gone == {"index": 2, "name": "2_net", "drained": True}, f"12c /admin/unload: {gone}")
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    require(with_third - resident >= 0.9 * param_bytes and with_third - after >= 0.9 * param_bytes,
            f"12c: memory_allocated {resident} -> {with_third} (load) -> {after} (unload), the "
            f"network's parameters {param_bytes} bytes")
    print(f"12c rollout: /admin/load took memory_allocated from {resident} to {with_third} "
          f"bytes, /admin/unload back to {after} (parameters {param_bytes} bytes); on {card}",
          flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    else:
        yield tree


def serve_cli_drain_phase(workdir: Path, card: str) -> None:
    """12c: the serve CLI's `run_server` in a child process over network 0:
    SIGTERM while a 96-frame request is in flight; the request completes, a
    new request gets 503, the child exits 0."""
    from gance_tpu_torch.serving import ServingClient, ServingClientError

    torch.cuda.empty_cache()  # the child needs the memory this process has cached
    log = workdir / "serve_child.log"
    code = ("import sys; from pathlib import Path; from gance_tpu_torch.cli.serve import "
            "run_server; run_server([Path(sys.argv[1])], port=0, max_batch=48, warmup='max', "
            "device='cuda')")
    start = time.perf_counter()
    with open(log, "wb") as output:
        child = subprocess.Popen([sys.executable, "-c", code, str(workdir / "0_net.pkl")],
                                 cwd=ROOT, stdout=output, stderr=subprocess.STDOUT)
    try:
        url = None
        while url is None and time.perf_counter() - start < 240:
            if child.poll() is not None:
                fail(f"12c: the serve child exited {child.returncode} at start:\n"
                     f"{log.read_text(errors='replace')[-3000:]}")
            for line in log.read_text(errors="replace").splitlines():
                if line.startswith("serving ") and " on http://" in line:
                    url = line.split(" on ", 1)[1].split(" ", 1)[0]
            time.sleep(0.05)
        require(url is not None, "12c: the serve child never bound its port")
        ready_s = time.perf_counter() - start
        client = ServingClient(url)
        require(client.synthesize(seeds=[1]).shape[0] == 1, "12c: the child's first answer")
        result: Dict[str, object] = {}

        def in_flight() -> None:
            try:
                result["images"] = client.synthesize(count=96, seed=3)
            except Exception as error:  # pylint: disable=broad-except
                result["error"] = error

        thread = threading.Thread(target=in_flight)
        thread.start()
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline and "gance_serving_live_requests 1" not in \
                _get_text(url + "/metrics"):
            time.sleep(0.01)
        child.send_signal(signal.SIGTERM)
        while time.perf_counter() < deadline and not client.health()["draining"]:
            time.sleep(0.01)
        try:
            client.synthesize(seeds=[2])
            refused = None
        except ServingClientError as error:
            refused = error.status
        thread.join(timeout=120)
        code_ = child.wait(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    images = result.get("images")
    require(images is not None and images.shape[0] == 96,
            f"12c: the in-flight request did not complete: {result.get('error')}")
    require(refused == 503, f"12c: a request during the drain got {refused}, not 503")
    require(code_ == 0, f"12c: the serve child exited {code_}:\n"
            f"{log.read_text(errors='replace')[-3000:]}")
    print(f"12c serve CLI child: bound in {ready_s:.1f} s; SIGTERM with 96 frames in flight: "
          f"they completed, a new request got 503, the child exited 0; on {card}", flush=True)


def _get_text(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as response:
        return response.read().decode()


def serve_measure_phase(config, nets, ledger: ServedLaunches, card: str) -> None:
    """12d: peak memory per warm bucket, then sustained serving under
    SERVE_LOAD concurrent clients at 1024px: fp32, bf16, and bf16 with the
    phase path on (E)."""
    from gance_tpu_torch.cli.serve import warm_networks
    from gance_tpu_torch.serving import SynthesisDaemon
    from gance_tpu_torch.serving.batcher import warmup_batch_sizes
    from gance_tpu_torch.synthesis.runtime import SynthesisNetwork

    clients, frames, seconds = SERVE_LOAD
    bf16 = SynthesisNetwork.from_staged((nets[0].params, config), nets[0].path,
                                        compute_dtype=torch.bfloat16, device=nets[0].device)
    set_phase("off")
    for label, net in (("fp32", nets[0]), ("bf16", bf16)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        peaks = {}
        for size in warmup_batch_sizes(SERVE_MAX_BATCH):
            torch.cuda.reset_peak_memory_stats()
            net.device_images_from_vectors(np.zeros((size, config.latent_size), np.float32))
            torch.cuda.synchronize()
            peaks[size] = (torch.cuda.max_memory_allocated() - base) / 2**30
        print(f"12d peak memory above the resident networks ({base / 2**30:.2f} GiB) per warm "
              f"bucket, {label}: " + ", ".join(f"{s}: {g:.2f} GiB" for s, g in peaks.items())
              + f"; on {card}", flush=True)
    for label, net, phase in (("fp32", nets[0], False), ("bf16", bf16, False),
                              ("bf16 phase path", bf16, True)):
        set_phase("on" if phase else "off")
        warm_networks([net], SERVE_MAX_BATCH, "max")
        with SynthesisDaemon([net], port=0, max_batch=SERVE_MAX_BATCH) as daemon:
            before = ledger.reset(daemon)
            r = serving_load(f"http://127.0.0.1:{daemon.port}", clients, frames, seconds,
                             SERVE_SETTLE_S)
            daemon.drain(timeout_s=120)
        ledger.check(f"12d {label}", daemon, before, phase=phase)
        require(r["client_errors"] == 0 and r["requests"] > 0, f"12d {label}: {r}")
        print(f"12d serving {config.resolution}px {label}, {clients} clients x {frames} frames: "
              f"{describe_load(r)}; on {card}", flush=True)
    set_phase("off")


def serving_phase(config, workdir: Path, card: str) -> Dict[str, int]:
    """Phase 12, with phase 3's networks and phase 8's WAV in `workdir`;
    returns the launches of its served requests."""
    from gance_tpu_torch.cli.serve import NetworkLoader, warm_networks
    from gance_tpu_torch.serving import SynthesisDaemon

    torch.cuda.empty_cache()
    set_phase("off")
    ledger = ServedLaunches(config)
    loader = NetworkLoader(device=torch.device("cuda"))
    nets = [loader(str(workdir / f"{i}_net.pkl"), i) for i in range(2)]
    # a 20 ms linger (the CLI's default is 5) so that 12a's 8 clients, started
    # together, share batches whatever the host's scheduling
    daemon = SynthesisDaemon(nets, port=0, max_batch=SERVE_MAX_BATCH, max_delay_ms=20,
                             network_loader=loader)
    with daemon:
        before = ledger.reset(daemon)
        start = time.perf_counter()
        sizes = warm_networks(nets, SERVE_MAX_BATCH, "all")
        torch.cuda.synchronize()
        print(f"12a warmup: buckets {sizes} on both lanes of both networks in "
              f"{time.perf_counter() - start:.1f} s; on {card}", flush=True)
        ledger.check("12a warmup", daemon, before, extra_forwards=2 * 2 * len(sizes))
        serve_requests_phase(config, nets, daemon, ledger, workdir, card)
        serve_audio_phase(config, nets, daemon, ledger, workdir, card)
        serve_rollout_phase(config, daemon, ledger, workdir, card)
    serve_cli_drain_phase(workdir, card)
    serve_measure_phase(config, nets, ledger, card)
    del nets
    torch.cuda.empty_cache()
    return ledger.totals


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA GPU")
    sys.path.insert(0, str(ROOT))
    from gance_tpu_torch.media import native
    from gance_tpu_torch.models.stylegan2 import GeneratorConfig
    from gance_tpu_torch.ops import precision
    from gance_tpu_torch.ops.cuda import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}")
    precision.apply_conv_precision()
    print(f"GANCE_TPU_PRECISION={precision.CONV_PRECISION}: cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    print(f"kernel build: {build.build_all():.1f} s", flush=True)
    start = time.perf_counter()
    native.build_library()  # the AVI muxer of phase 8, built here so no render times it
    print(f"native AVI muxer build (g++): {time.perf_counter() - start:.1f} s", flush=True)
    for log in sorted(build.BUILD_DIR.glob("*.log")):
        for line in log.read_text(errors="replace").splitlines():
            if "registers" in line:
                print(f"ptxas {log.stem}: {line.strip()}")

    config = GeneratorConfig()  # config-f, 1024px
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = kernel_phase(config, gen)
    # phase 3's networks stay in this directory for phase 8
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as nets_dir:
        launches, net, z = main_path_phase(config, Path(nets_dir))
        for record in records:
            record["launches"] = launches[record["name"]]
        parity_phase(net, z)
        fps_phase(net, z, smi)
        del net
        gradient_phase()
        train_parity_phase()
        with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
            train_totals = training_phase(Path(tmp), smi)
        pipeline_totals = pipeline_phase(config, Path(nets_dir), smi)
        flagship_totals = flagship_phase(config, Path(nets_dir), smi)
        projector_totals = projector_phase(config, Path(nets_dir), smi)
        resume_totals = resume_phase(config, Path(nets_dir), smi)
        serving_totals = serving_phase(config, Path(nets_dir), smi)
    for record in records:
        for totals in (train_totals, pipeline_totals, flagship_totals, projector_totals,
                       resume_totals, serving_totals):
            record["launches"] += totals.get(record["name"], 0)

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
