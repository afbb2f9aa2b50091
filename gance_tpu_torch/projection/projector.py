"""
Latent projector: optimize (w, noise planes) so the generator reproduces a
target image. The counterpart of gance_tpu/projection/projector.py, with the
same settings, schedule, loss and results; `Projector` is its `TPUProjector`.

Behavioral contract kept from NVlabs projector.py (through the JAX package):
  * optimize one (1, 512) w per frame initialized at the sampled dlatent
    average, broadcast to all style rows at synthesis time, so the final
    latents (1, R, 512) have identical rows (the invariant
    `verify_projection_file_assumptions` checks);
  * Adam with cosine ramp-down / linear ramp-up LR schedule (base 0.1);
  * annealed gaussian jitter added to w (initial_noise_factor 0.05 ×
    dlatent_std, ramp 0.75);
  * per-layer noise planes optimized jointly, pyramid cross-correlation
    regularizer (weight 1e5), re-normalized to zero-mean/unit-std every step;
  * perceptual distance evaluated at ≤256px (average-pooled);
  * default 1000 steps; a wall-clock watchdog per step.

In PyTorch: the planes are NCHW (B, 1, h, w) on the device and go into
synthesis as `noise_planes` (noise_mode "random"), so their gradient comes
through kernel A's Function (and, on the polyphase top block, kernel E's
`noise_bias`); the loss is differentiated with respect to w and the planes
only (no weight of the generator or the VGG requires grad); the optimizer
is `torch.optim.Adam` (optax.adam's defaults and arithmetic); the draws come
from a `torch.Generator` seeded with `settings.seed` (they do not equal
JAX's). JAX's `lax.scan` segments become a loop that keeps each step's w and
distance on the device and fetches them once per segment. Everything handed
out or taken in (results, `noises_shapes`, the callback's noises,
`initial_noises`) is in JAX's (B, h, w, 1) layout.
"""

import collections
import math
import time
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gance_tpu_torch.models.pickle_loader import load_generator
from gance_tpu_torch.models.stylegan2 import (
    GeneratorConfig,
    images_to_uint8,
    mapping_apply,
    resize_images,
    resolve_phase_top_block,
    synthesis_apply,
)
from gance_tpu_torch.ops.precision import apply_conv_precision
from gance_tpu_torch.projection.lpips import (
    VGGParams,
    downsample_to,
    load_vgg_params,
    lpips_distance,
    random_vgg_params,
    vgg_params_to_device,
)
from gance_tpu_torch.synthesis.runtime import params_to_device
from gance_tpu_torch.utils.device import resolve_device
from gance_tpu_torch.utils.logging import LOGGER

StepCallback = Callable[[int, np.ndarray, List[np.ndarray], np.ndarray], None]

_MULTI_DEVICE_ITEM = "ROADMAP.md Queue 1 item 12 (multi-device)"
_REMAT_ITEM = "ROADMAP.md Queue 1 item 11 (training, the rest: remat)"


class ProjectionResult(NamedTuple):
    """Final outputs of one frame's projection."""

    final_latents: np.ndarray  # (1, R, 512), rows identical
    final_image: np.ndarray  # (H, W, 3) uint8
    noises: List[np.ndarray]  # (1, h, w, 1) each, JAX's layout
    noises_shapes: List[Tuple[int, ...]]
    final_distance: float
    # Optimization steps actually run: == num_steps unless the convergence
    # early stop (ProjectorSettings.convergence_stop) fired first.
    steps_run: int = 0


@dataclass
class ProjectorSettings:
    """Hyperparameters (NVlabs projector.py defaults); every field and default
    is gance_tpu's."""

    num_steps: int = 1000
    dlatent_avg_samples: int = 10_000
    initial_learning_rate: float = 0.1
    initial_noise_factor: float = 0.05
    lr_rampdown_length: float = 0.25
    lr_rampup_length: float = 0.05
    noise_ramp_length: float = 0.75
    regularize_noise_weight: float = 1e5
    perceptual_size: int = 256
    seed: int = 303
    # Synthesis compute dtype inside the loss: "float32" (exact, the reference's
    # behavior) or "bfloat16" (latents, Adam state and the perceptual features
    # stay fp32; gradients flow through the bf16 forward).
    compute_dtype: str = "float32"
    # Steps per segment: whenever per-step host data isn't required (no
    # noises or images histories), the loop fetches from the device once per
    # segment of this many steps; the callback still receives exact per-step
    # latents and step numbers (kept on the device through the segment).
    # scan_segment=1 forces a fetch per step.
    scan_segment: int = 250
    # Convergence early stop (opt-in): stop the optimization once EVERY
    # frame's perceptual-distance trace has plateaued — the online form of the
    # reference's "80% projected" convergence analysis. The rule: compare the
    # medians of the two most recent `convergence_window`-step blocks of the
    # per-step distance trace; stop when the relative improvement falls below
    # `convergence_stop` for all frames in the batch. The check runs at
    # segment boundaries. None = run the full num_steps (reference behavior).
    # The LR/jitter schedules still stretch over the NOMINAL num_steps:
    # stopping truncates the trajectory, it does not reschedule.
    convergence_stop: Optional[float] = None
    convergence_window: int = 50
    # Earliest step the stop may fire. None scales with the budget:
    # max(2 * convergence_window, 10% of num_steps) — past the LR ramp-up
    # (the first 5% of the nominal schedule), which reads as a plateau.
    convergence_min_steps: Optional[int] = None

    def resolved_convergence_min_steps(self) -> int:
        if self.convergence_min_steps is not None:
            return self.convergence_min_steps
        return max(2 * self.convergence_window, self.num_steps // 10)
    # Rematerialize synthesis blocks in the backward pass. Not ported:
    # True raises NotImplementedError (ROADMAP.md Queue 1 item 11).
    remat: bool = False


def convergence_should_stop(
    distance_trace: np.ndarray, window: int, epsilon: float, min_steps: int
) -> bool:
    """
    Plateau detector over a per-step distance trace (T,) or (T, B): True when
    EVERY frame's relative improvement between the medians of the two most
    recent `window`-step blocks is below `epsilon`. Medians absorb the
    annealed-jitter noise; `min_steps` keeps the LR ramp-up (the first 5% of
    the nominal schedule) from reading as a plateau.
    """
    trace = np.asarray(distance_trace, np.float64)
    if trace.ndim == 1:
        trace = trace[:, None]
    if trace.shape[0] < max(min_steps, 2 * window):
        return False
    recent = np.median(trace[-window:], axis=0)
    previous = np.median(trace[-2 * window : -window], axis=0)
    improvement = (previous - recent) / np.maximum(previous, 1e-12)
    return bool(np.all(improvement < epsilon))


def _lr_schedule(t: Union[float, torch.Tensor], s: ProjectorSettings) -> torch.Tensor:
    """The learning rate at schedule position t in [0, 1), in float32 as JAX."""
    t = torch.as_tensor(t, dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)
    ramp = torch.minimum(one, (1.0 - t) / s.lr_rampdown_length)
    ramp = 0.5 - 0.5 * torch.cos(ramp * math.pi)
    ramp = ramp * torch.minimum(one, t / s.lr_rampup_length)
    return s.initial_learning_rate * ramp


def _noise_regularization(noises: Sequence[torch.Tensor]) -> torch.Tensor:
    """
    Pyramid shifted-correlation penalty (NVlabs reg_loss), per batch element:
    noises are (B, 1, H, W); returns (B,). Each plane is correlated with itself
    rolled by one along W and along H, then halved by 2x2 averaging, down to
    8x8.
    """
    batch = noises[0].shape[0] if noises else 1
    reg = torch.zeros((batch,), dtype=torch.float32,
                      device=noises[0].device if noises else None)
    for noise in noises:
        v = noise
        size = v.shape[2]
        while True:
            reg = reg + (v * torch.roll(v, 1, dims=3)).mean(dim=(1, 2, 3)) ** 2
            reg = reg + (v * torch.roll(v, 1, dims=2)).mean(dim=(1, 2, 3)) ** 2
            if size <= 8:
                break
            v = v.reshape(batch, 1, size // 2, 2, size // 2, 2).mean(dim=(3, 5))
            size //= 2
    return reg


def _normalize_noises(noises: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Zero-mean/unit-std per batch element (noises are (B, 1, H, W))."""
    out = []
    for n in noises:
        mean = n.mean(dim=(1, 2, 3), keepdim=True)
        var = (n - mean).square().mean(dim=(1, 2, 3), keepdim=True)
        out.append((n - mean) * torch.rsqrt(var + 1e-8))
    return out


def dlatent_statistics(
    params: Dict[str, Any], z: torch.Tensor, config: GeneratorConfig
) -> Tuple[torch.Tensor, float]:
    """The sampled w average (1, dlatent) and std (sqrt of the mean squared
    distance to the average) over `z` through the mapping."""
    with torch.no_grad():
        w = mapping_apply(params, z, config)
        avg = w.mean(dim=0, keepdim=True)
        std = float(torch.sqrt((w - avg).square().sum(dim=1).mean()))
    return avg, std


def to_jax_layout(plane: torch.Tensor) -> np.ndarray:
    """A (B, 1, h, w) plane -> numpy (B, h, w, 1), JAX's layout, a copy (the
    planes are updated in place)."""
    return plane.detach().permute(0, 2, 3, 1).to("cpu", copy=True).numpy()


def from_jax_layout(buffer: np.ndarray, device: torch.device) -> torch.Tensor:
    """A (B, h, w, 1) buffer -> fp32 (B, 1, h, w) on `device`, a copy (the
    planes are updated in place and must not alias the caller's array)."""
    arr = np.array(np.asarray(buffer, np.float32).transpose(0, 3, 1, 2), order="C")
    return torch.from_numpy(arr).to(device)


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Projector:
    """
    Projects images into a single generator's latent space: the port's
    counterpart of gance_tpu's `TPUProjector`, with its constructor, `from_pkl`,
    `project`, `project_batch` and `evaluate_distance`. Params stay on
    `device` ("cuda" unless the caller asks for the CPU) and are never
    differentiated. `mesh` and `settings.remat` are not ported and raise.
    """

    def __init__(
        self,
        params: Dict[str, Any],
        config: GeneratorConfig,
        num_steps: Optional[int] = None,
        vgg_weights_path: Optional[Path] = None,
        expected_time_per_step: Optional[float] = None,
        settings: Optional[ProjectorSettings] = None,
        first_step_timeout: Optional[float] = None,
        mesh: Optional[Any] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        if mesh is not None:
            raise NotImplementedError(f"mesh= is not ported yet: {_MULTI_DEVICE_ITEM}")
        # Copy the settings (never mutate a caller-owned object); an explicit
        # num_steps kwarg overrides the settings value, otherwise settings win.
        self.settings = replace(settings) if settings else ProjectorSettings()
        if num_steps is not None:
            self.settings.num_steps = num_steps
        if self.settings.remat:
            raise NotImplementedError(f"ProjectorSettings.remat is not ported yet: {_REMAT_ITEM}")
        self.config = config
        self.device = resolve_device(device)
        self.params = params_to_device(params, self.device)
        self.expected_time_per_step = expected_time_per_step
        # Step 0 includes the kernels' first launches (and their build, when
        # not built yet), so it gets its own, longer budget.
        if first_step_timeout is not None:
            self.first_step_timeout: Optional[float] = first_step_timeout
        elif expected_time_per_step is not None:
            self.first_step_timeout = max(600.0, 20.0 * expected_time_per_step)
        else:
            self.first_step_timeout = None
        self._perceptual_params = (
            load_vgg_params(vgg_weights_path)
            if vgg_weights_path is not None
            else random_vgg_params(seed=0)
        )
        self._perceptual_device_cache: Optional[Tuple[Dict[str, np.ndarray], VGGParams]] = None
        self._noise_names = sorted(
            self.params["synthesis"].get("noise", {}).keys(), key=lambda n: int(n[5:])
        )
        self._compute_dlatent_stats()

    @classmethod
    def from_pkl(
        cls, path: Path, num_steps: Optional[int] = None, **kwargs: Any
    ) -> "Projector":
        params, config = load_generator(Path(path))
        return cls(params, config, num_steps=num_steps, **kwargs)

    @property
    def noise_spatial_shapes(self) -> List[Tuple[int, int]]:
        """(h, w) of each noise plane, in layer order."""
        return [tuple(self.params["synthesis"]["noise"][n].shape[2:]) for n in self._noise_names]

    def _perceptual_on_device(self) -> VGGParams:
        """The perceptual net's weights on the device, uploaded once and
        cached; swapping self._perceptual_params (a new dict) invalidates."""
        params = self._perceptual_params
        cache = self._perceptual_device_cache
        if cache is None or cache[0] is not params:
            self._perceptual_device_cache = (params, vgg_params_to_device(params, self.device))
        return self._perceptual_device_cache[1]

    def _compute_dlatent_stats(self) -> None:
        """Sampled w average/std (NVlabs uses 10k z samples)."""
        gen = torch.Generator(device=self.device).manual_seed(self.settings.seed)
        z = torch.randn((self.settings.dlatent_avg_samples, self.config.latent_size),
                        generator=gen, device=self.device)
        self.dlatent_avg, self.dlatent_std = dlatent_statistics(self.params, z, self.config)

    @property
    def _compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.settings.compute_dtype == "bfloat16" else torch.float32

    def _synthesis_from_w(self, w: torch.Tensor, noises: Sequence[torch.Tensor]) -> torch.Tensor:
        """(B, 512) + noise planes (B, 1, h, w) -> (B, R, R, 3) fp32 image."""
        dlatents = w[:, None, :].expand(-1, self.config.num_style_rows, -1)
        return synthesis_apply(
            self.params, dlatents, self.config, noise_mode="random", noise_planes=list(noises),
            compute_dtype=self._compute_dtype,
            phase_top_block_mode=resolve_phase_top_block(self.config),
        )

    def _target_proc(self, target_images: np.ndarray) -> torch.Tensor:
        """uint8 (B, H, W, 3) targets -> (B, 3, s, s) fp32 in [-1, 1] at the
        perceptual size, resized first to the network's side with
        jax.image.resize's antialiased linear filter when it differs."""
        target = torch.as_tensor(np.asarray(target_images)).to(self.device).float() / 127.5 - 1.0
        if target.shape[1] != self.config.resolution:
            target = resize_images(target, self.config.resolution, method="linear")
        target = target.permute(0, 3, 1, 2).contiguous()
        return downsample_to(target, self.settings.perceptual_size).contiguous()

    def _distance(self, perceptual: VGGParams, images: torch.Tensor,
                  target_proc: torch.Tensor) -> torch.Tensor:
        proc = downsample_to(images.permute(0, 3, 1, 2), self.settings.perceptual_size)
        return lpips_distance(perceptual, proc.contiguous(), target_proc)

    def _loss_and_gradients(
        self,
        w: torch.Tensor,
        noises: Sequence[torch.Tensor],
        target_proc: torch.Tensor,
        w_jitter: torch.Tensor,
        perceptual: Optional[VGGParams] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        """
        One step's loss, sum over frames of (perceptual distance +
        settings.regularize_noise_weight * the noise regulariser) of the
        synthesis from w + w_jitter with `noises` (B, 1, h, w),
        and its gradient with respect to w and each noise plane only (the
        summed batch loss gives each frame exactly its own gradient).
        :return: (loss, per-frame distances (B,), the forward's fp32 images
            (B, R, R, 3), [dw, dnoise_0, ...]), all detached.
        """
        perceptual = self._perceptual_on_device() if perceptual is None else perceptual
        leaves = [w.detach().requires_grad_(True)] + [
            n.detach().requires_grad_(True) for n in noises]
        images = self._synthesis_from_w(leaves[0] + w_jitter, leaves[1:])
        dist = self._distance(perceptual, images, target_proc)
        reg = _noise_regularization(leaves[1:]) * self.settings.regularize_noise_weight
        loss = torch.sum(dist + reg)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dist.detach(), images.detach(), list(grads)

    def _step(self, w: torch.Tensor, noises: List[torch.Tensor], opt: torch.optim.Adam,
              target_proc: torch.Tensor, step_number: int, generator: torch.Generator,
              perceptual: VGGParams, noise_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimization step, updating w, the planes and Adam in place.
        Returns the step's per-frame distances and its (pre-update) images."""
        settings = self.settings
        t = step_number / max(settings.num_steps, 1)
        # noise_factor is settings.initial_noise_factor by default; warm
        # starts pass 0.0 (the jitter exists to explore away from the cold
        # dlatent-average start).
        strength = (self.dlatent_std * noise_factor
                    * max(0.0, 1.0 - t / settings.noise_ramp_length) ** 2)
        w_jitter = torch.randn(w.shape, generator=generator, device=w.device) * strength
        _, dist, images, grads = self._loss_and_gradients(w, noises, target_proc, w_jitter,
                                                          perceptual)
        for leaf, grad in zip([w] + noises, grads):
            leaf.grad = grad
        lr = float(_lr_schedule(t, settings))
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            for plane, normalized in zip(noises, _normalize_noises(noises)):
                plane.copy_(normalized)
        return dist, images

    def project(
        self,
        target_image: np.ndarray,
        step_callback: Optional[StepCallback] = None,
        want_step_images: bool = True,
        initial_latents: Optional[np.ndarray] = None,
        initial_noises: Optional[List[np.ndarray]] = None,
        noise_factor: Optional[float] = None,
    ) -> ProjectionResult:
        """
        Optimize latents to reproduce `target_image` (uint8 (H, W, 3)); stream each
        step through `step_callback(step, latents(1,R,512), noises, image_uint8)`.
        `initial_latents` ((512,) or (R, 512)) warm-starts w — see project_batch.
        """
        batch_callback = None
        if step_callback is not None:

            def batch_callback(step, latents, noises, images):
                step_callback(
                    step,
                    latents[0:1],
                    [n[0:1] for n in noises],
                    images[0] if images.size else np.zeros((0, 0, 3), np.uint8),
                )

        if initial_latents is not None:
            initial_latents = np.asarray(initial_latents)[None, ...]
        return self.project_batch(
            np.asarray(target_image)[None, ...],
            step_callback=batch_callback,
            want_step_images=want_step_images,
            initial_latents=initial_latents,
            initial_noises=initial_noises,
            noise_factor=noise_factor,
        )[0]

    def _initial_latents(self, initial_latents: Optional[np.ndarray], batch: int) -> torch.Tensor:
        if initial_latents is None:
            return self.dlatent_avg.expand(batch, -1).clone()
        w_init = np.asarray(initial_latents, np.float32)
        if w_init.ndim == 3:  # (B, R, 512): rows identical by invariant
            w_init = w_init[:, 0, :]
        if w_init.ndim == 1:  # (512,): broadcast to the batch
            w_init = np.tile(w_init[None, :], (batch, 1))
        if w_init.shape != (batch, self.config.dlatent_size):
            raise ValueError(
                f"initial_latents: expected ({batch}, {self.config.dlatent_size}), "
                f"got {tuple(w_init.shape)}"
            )
        # a copy: w is updated in place and must not alias the caller's array
        return torch.tensor(w_init, device=self.device)

    def _initial_noises(self, initial_noises: Optional[List[np.ndarray]], batch: int,
                        generator: torch.Generator) -> List[torch.Tensor]:
        shapes = self.noise_spatial_shapes
        if initial_noises is None:
            return [torch.randn((batch, 1) + shape, generator=generator, device=self.device)
                    for shape in shapes]
        if len(initial_noises) != len(shapes):
            raise ValueError(
                f"initial_noises: expected {len(shapes)} buffers, got {len(initial_noises)}"
            )
        noises = []
        for i, buf in enumerate(initial_noises):
            arr = np.asarray(buf, np.float32)
            expected_spatial = shapes[i] + (1,)
            if arr.ndim != 4 or arr.shape[0] not in (1, batch) or tuple(arr.shape[1:]) != expected_spatial:
                raise ValueError(
                    f"initial_noises[{i}]: expected {(1,) + expected_spatial} "
                    f"or {(batch,) + expected_spatial}, got {tuple(arr.shape)}"
                )
            plane = from_jax_layout(arr, self.device)
            noises.append(plane.expand(batch, -1, -1, -1).clone() if arr.shape[0] == 1 else plane)
        return noises

    def project_batch(
        self,
        target_images: np.ndarray,
        step_callback: Optional[StepCallback] = None,
        want_step_images: bool = True,
        per_step_noises: bool = True,
        initial_latents: Optional[np.ndarray] = None,
        initial_noises: Optional[List[np.ndarray]] = None,
        noise_factor: Optional[float] = None,
    ) -> List[ProjectionResult]:
        """
        Project a BATCH of frames in one optimization (each frame gets its own
        latents/noises; the summed loss keeps gradients per-frame exact).

        :param target_images: (B, H, W, 3) uint8.
        :param step_callback: per step: (step, latents (B, R, 512),
            noises [(B, h, w, 1), ...], images (B, res, res, 3) uint8 — empty
            when want_step_images is False).
        :param per_step_noises: whether the callback needs the ACTUAL per-step
            noise planes. False (with want_step_images False) lets the loop
            fetch once per `settings.scan_segment` steps, while the callback
            still receives exact per-step latents and step numbers and the
            current end-of-segment noises (valid for shape recording, which is
            all the projection writer needs when noises histories are off).
        :param initial_latents: optional warm start for the optimized w —
            (512,) broadcast to the batch, (B, 512), or (B, R, 512) (row 0 is
            taken; projection keeps all rows identical). None starts at the
            sampled dlatent average, the NVlabs behavior.
        :param initial_noises: optional warm start for the per-layer noise
            planes, in JAX's layout (the list ProjectionResult.noises carries,
            each (B, h, w, 1) or (1, h, w, 1) broadcast over the batch),
            validated before any step. None draws fresh gaussian noise.
        :param noise_factor: overrides settings.initial_noise_factor for THIS
            call. Pass 0.0 with a warm start: the annealed exploration jitter
            erases the head start otherwise.
        :return: one ProjectionResult per input frame.
        """
        settings = self.settings
        target_images = np.asarray(target_images)
        batch = int(target_images.shape[0])
        apply_conv_precision()
        target_proc = self._target_proc(target_images)

        generator = torch.Generator(device=self.device).manual_seed(settings.seed)
        w = self._initial_latents(initial_latents, batch).requires_grad_(True)
        noises = [n.requires_grad_(True) for n in
                  self._initial_noises(initial_noises, batch, generator)]
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the root
        opt = torch.optim.Adam([w] + noises, lr=settings.initial_learning_rate)
        perceptual = self._perceptual_on_device()

        use_scan = (
            settings.scan_segment > 1
            and settings.num_steps > 1
            and (step_callback is None or not (want_step_images or per_step_noises))
        )

        dist = torch.zeros((batch,), device=self.device)
        empty_image = np.zeros((batch, 0, 0, 3), np.uint8)
        effective_noise_factor = float(
            settings.initial_noise_factor if noise_factor is None else noise_factor)

        # Convergence early stop (opt-in): host-side per-step distance trace,
        # checked at segment boundaries / per step. The detector only reads
        # the last 2*window rows, and nothing can stop before
        # max(min_steps, 2*window): keep a bounded deque of recent rows and
        # skip the fetch until the trace is close enough to the gate to matter.
        converge = settings.convergence_stop is not None
        trace_window = 2 * settings.convergence_window
        trace_gate = max(settings.resolved_convergence_min_steps(), trace_window)
        distance_trace: "collections.deque" = collections.deque()
        trace_rows = 0
        steps_completed = 0

        def _record_distances(rows: np.ndarray) -> None:
            nonlocal trace_rows
            distance_trace.append(rows)
            trace_rows += rows.shape[0]
            while distance_trace and (
                trace_rows - distance_trace[0].shape[0] >= trace_window
            ):
                trace_rows -= distance_trace.popleft().shape[0]

        def _wants_trace() -> bool:
            return converge and steps_completed > trace_gate - trace_window

        def _converged() -> bool:
            if not converge or steps_completed < trace_gate or not distance_trace:
                return False
            return convergence_should_stop(
                np.concatenate(distance_trace, axis=0),
                window=settings.convergence_window,
                epsilon=float(settings.convergence_stop),
                min_steps=0,
            )

        def _latents(w_rows: np.ndarray) -> np.ndarray:
            return np.tile(w_rows[:, None, :], (1, self.config.num_style_rows, 1))

        if use_scan:
            # Checks happen at segment boundaries, so the segment length caps
            # the stop granularity: clamp it to the convergence window.
            segment_cap = (
                min(settings.scan_segment, settings.convergence_window)
                if converge
                else settings.scan_segment
            )
            step_number = 0
            while step_number < settings.num_steps:
                segment = min(segment_cap, settings.num_steps - step_number)
                start_time = time.monotonic()
                dists, w_history = [], []
                for offset in range(segment):
                    dist, _ = self._step(w, noises, opt, target_proc, step_number + offset,
                                         generator, perceptual, effective_noise_factor)
                    dists.append(dist)
                    w_history.append(w.detach().clone())
                if self.expected_time_per_step is not None or step_callback is not None:
                    _wait(self.device)
                if step_callback is not None:
                    # latents histories: the post-update w of every step
                    history = torch.stack(w_history).cpu().numpy()
                    noises_np = [to_jax_layout(n) for n in noises]
                    for offset in range(segment):
                        step_callback(step_number + offset, _latents(history[offset]),
                                      noises_np, empty_image)
                elapsed = time.monotonic() - start_time
                # Watchdog at segment granularity, with the first-step
                # allowance on the first segment.
                if self.expected_time_per_step is not None:
                    budget = self.expected_time_per_step * segment
                    if step_number == 0 and self.first_step_timeout is not None:
                        budget = max(budget, self.first_step_timeout)
                    if elapsed > budget:
                        raise RuntimeError(
                            f"Projection segment at step {step_number} took "
                            f"{elapsed:.1f}s > expected {budget}s — assuming a hang "
                            "(the reference's per-step timeout, at segment granularity)."
                        )
                step_number += segment
                steps_completed = step_number
                if _wants_trace():
                    _record_distances(torch.stack(dists).cpu().numpy())
                    if _converged():
                        LOGGER.info(
                            "Convergence stop at step %d/%d (windowed relative "
                            "improvement < %g for every frame).",
                            steps_completed, settings.num_steps, settings.convergence_stop,
                        )
                        break
        else:
            for step_number in range(settings.num_steps):
                start_time = time.monotonic()
                dist, images_dev = self._step(w, noises, opt, target_proc, step_number,
                                              generator, perceptual, effective_noise_factor)
                if self.expected_time_per_step is not None:
                    # the watchdog must observe real device progress
                    _wait(self.device)
                if step_callback is not None:
                    # Pairing note: latents are post-update, the image is the
                    # step's forward pass (pre-update) — the reference's pairing.
                    images = (images_to_uint8(images_dev).cpu().numpy()
                              if want_step_images else empty_image)
                    step_callback(step_number, _latents(w.detach().cpu().numpy()),
                                  [to_jax_layout(n) for n in noises], images)
                elapsed = time.monotonic() - start_time
                step_budget = (
                    self.first_step_timeout if step_number == 0 else self.expected_time_per_step
                )
                if step_budget is not None and elapsed > step_budget:
                    raise RuntimeError(
                        f"Projection step {step_number} took {elapsed:.1f}s > "
                        f"expected {step_budget}s — assuming a hang "
                        "(the reference's per-step timeout; step 0 has a longer budget)."
                    )
                steps_completed = step_number + 1
                if _wants_trace():
                    _record_distances(dist.cpu().numpy().reshape(1, -1))
                    if _converged():
                        LOGGER.info(
                            "Convergence stop at step %d/%d (windowed relative "
                            "improvement < %g for every frame).",
                            steps_completed, settings.num_steps, settings.convergence_stop,
                        )
                        break

        with torch.no_grad():
            final_images = images_to_uint8(self._synthesis_from_w(w, noises)).cpu().numpy()
        latents = w.detach().cpu().numpy()
        noises_np = [to_jax_layout(n) for n in noises]
        distances = dist.cpu().numpy().reshape(-1)
        return [
            ProjectionResult(
                final_latents=_latents(latents[b : b + 1]),
                final_image=final_images[b],
                noises=[n[b : b + 1] for n in noises_np],
                noises_shapes=[(1,) + tuple(n.shape[1:]) for n in noises_np],
                final_distance=float(distances[b]),
                steps_run=steps_completed,
            )
            for b in range(batch)
        ]

    def evaluate_distance(
        self,
        latents: np.ndarray,
        noises: List[np.ndarray],
        target_images: np.ndarray,
    ) -> np.ndarray:
        """
        CLEAN perceptual distance of an endpoint: synthesize from `latents`
        ((B, 512) or (B, R, 512) — row 0) with `noises` (JAX's layout, (B, h, w,
        1)) and measure against `target_images` ((B, H, W, 3) uint8), no
        exploration jitter. The streamed per-step distances include the
        annealed w-jitter early in a run, so this is the honest quality of
        stopping at a given step.
        """
        w = np.asarray(latents, np.float32)
        if w.ndim == 3:  # (B, R, 512): rows identical by invariant
            w = w[:, 0, :]
        w_t = torch.from_numpy(np.ascontiguousarray(w)).to(self.device)
        planes = [from_jax_layout(n, self.device) for n in noises]
        with torch.no_grad():
            apply_conv_precision()
            target_proc = self._target_proc(target_images)
            images = self._synthesis_from_w(w_t, planes)
            return self._distance(self._perceptual_on_device(), images,
                                  target_proc).cpu().numpy()
