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
from gance_tpu_torch.utils.device import params_to_device, resolve_device
from gance_tpu_torch.utils.logging import LOGGER

StepCallback = Callable[[int, np.ndarray, List[np.ndarray], np.ndarray], None]


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
    # Recompute each synthesis block in the backward pass instead of keeping
    # its activations (less device memory, more forward work).
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


@dataclass
class _ProjectionShard:
    """One data slot's frames of a projection: its rows of the (padded)
    batch, their optimized w and planes, Adam, targets and the perceptual
    net, all on the slot's device."""

    device: torch.device
    rows: slice
    w: torch.Tensor
    noises: List[torch.Tensor]
    opt: torch.optim.Adam
    target_proc: torch.Tensor
    perceptual: VGGParams

    def __len__(self) -> int:
        return self.rows.stop - self.rows.start


class Projector:
    """
    Projects images into a single generator's latent space: the port's
    counterpart of gance_tpu's `TPUProjector`, with its constructor, `from_pkl`,
    `project`, `project_batch` and `evaluate_distance`. Params stay on
    `device` ("cuda" unless the caller asks for the CPU) and are never
    differentiated. `settings.remat` recomputes each synthesis block in the
    backward pass.

    With `mesh` (a ('data', 'model') mesh) every batch-leading array splits
    over the data axis: the params are copied to each local data row's lead
    device, replicated as JAX's projector keeps them under any mesh (so the
    synthesis forward stays data-parallel over frames and a 'model' axis
    above 1 only leaves its other slots idle), each slot optimizes its frames (its own w, planes and Adam
    moments; frames are independent, so the summed loss gives each frame
    its own gradient), the batch is padded to a multiple of the data axis by
    repeating the last frame, and the draws (cold-start planes, w jitter)
    are the whole padded batch's on every process, each slot keeping its
    rows, so a data-parallel projection equals a single-device one. Across
    processes every process passes the same full batch and the host fetches
    are all_gathers (collectives; callers keep file writes to process 0).
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
        from gance_tpu_torch.parallel.mesh import data_axis_size, local_row_groups

        self.mesh = mesh
        self._data_axis = data_axis_size(mesh)
        # Copy the settings (never mutate a caller-owned object); an explicit
        # num_steps kwarg overrides the settings value, otherwise settings win.
        self.settings = replace(settings) if settings else ProjectorSettings()
        if num_steps is not None:
            self.settings.num_steps = num_steps
        self.config = config
        if mesh is not None:
            self._replicas = {group[0]: params_to_device(params, group[0])
                              for group in local_row_groups(mesh)}
            self.device = mesh.first_device
            self.params = self._replicas[self.device]
        else:
            self.device = resolve_device(device)
            self.params = params_to_device(params, self.device)
            self._replicas = {}  # one device: self.params serves every tensor
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
        self._perceptual_device_cache: Dict[torch.device, Tuple[Dict[str, np.ndarray],
                                                              VGGParams]] = {}
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

    def _perceptual_on_device(self, device: Optional[torch.device] = None) -> VGGParams:
        """The perceptual net's weights on `device` (the projector's by
        default), uploaded once and cached; swapping self._perceptual_params
        (a new dict) invalidates."""
        device = self.device if device is None else device
        params = self._perceptual_params
        cache = self._perceptual_device_cache.get(device)
        if cache is None or cache[0] is not params:
            cache = (params, vgg_params_to_device(params, device))
            self._perceptual_device_cache[device] = cache
        return cache[1]

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
            self._replicas.get(w.device, self.params), dlatents, self.config, noise_mode="random",
            noise_planes=list(noises),
            compute_dtype=self._compute_dtype,
            phase_top_block_mode=resolve_phase_top_block(self.config),
            remat=self.settings.remat,
        )

    def _target_proc(self, target_images: np.ndarray,
                     device: Optional[torch.device] = None) -> torch.Tensor:
        """uint8 (B, H, W, 3) targets -> (B, 3, s, s) fp32 in [-1, 1] at the
        perceptual size on `device` (the projector's by default), resized
        first to the network's side with jax.image.resize's antialiased
        linear filter when it differs."""
        device = self.device if device is None else device
        target = torch.as_tensor(np.asarray(target_images)).to(device).float() / 127.5 - 1.0
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

    def _jitter(self, shape: Tuple[int, ...], step_number: int, generator: torch.Generator,
                noise_factor: float) -> torch.Tensor:
        """A step's annealed w jitter, drawn on the generator's device.
        noise_factor is settings.initial_noise_factor by default; warm starts
        pass 0.0 (the jitter exists to explore away from the cold
        dlatent-average start)."""
        t = step_number / max(self.settings.num_steps, 1)
        strength = (self.dlatent_std * noise_factor
                    * max(0.0, 1.0 - t / self.settings.noise_ramp_length) ** 2)
        return torch.randn(shape, generator=generator, device=generator.device) * strength

    def _step(self, w: torch.Tensor, noises: List[torch.Tensor], opt: torch.optim.Adam,
              target_proc: torch.Tensor, step_number: int, generator: torch.Generator,
              perceptual: VGGParams, noise_factor: float,
              w_jitter: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimization step, updating w, the planes and Adam in place
        (`w_jitter`: the step's jitter rows, drawn here when None). Returns
        the step's per-frame distances and its (pre-update) images."""
        settings = self.settings
        t = step_number / max(settings.num_steps, 1)
        if w_jitter is None:
            w_jitter = self._jitter(tuple(w.shape), step_number, generator, noise_factor)
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
                        generator: torch.Generator,
                        work: Optional[int] = None) -> List[torch.Tensor]:
        """The start planes of a `batch`-frame projection padded to `work`
        frames (the padding repeats the last frame's plane)."""
        shapes = self.noise_spatial_shapes
        work = batch if work is None else work
        if initial_noises is None:
            return [torch.randn((work, 1) + shape, generator=generator, device=self.device)
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
            if arr.shape[0] == 1:
                plane = plane.expand(work, -1, -1, -1).clone()
            elif work > batch:
                plane = torch.cat([plane, plane[-1:].expand(work - batch, -1, -1, -1)])
            noises.append(plane)
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
        # Over a mesh: pad the batch to a data-axis multiple by repeating the
        # last frame; padded rows optimize like real ones and are dropped.
        pad = (-batch) % self._data_axis
        if pad:
            target_images = np.concatenate([target_images,
                                            np.repeat(target_images[-1:], pad, axis=0)])
        work = batch + pad

        generator = torch.Generator(device=self.device).manual_seed(settings.seed)
        w_all = self._initial_latents(initial_latents, batch)
        noises_all = self._initial_noises(initial_noises, batch, generator, work)
        if pad:
            w_all = torch.cat([w_all, w_all[-1:].expand(pad, -1)])
        shards = self._shards(work, target_images, w_all, noises_all)

        use_scan = (
            settings.scan_segment > 1
            and settings.num_steps > 1
            and (step_callback is None or not (want_step_images or per_step_noises))
        )

        dists = [torch.zeros((len(sh),), device=sh.device) for sh in shards]
        empty_image = np.zeros((batch, 0, 0, 3), np.uint8)
        effective_noise_factor = float(
            settings.initial_noise_factor if noise_factor is None else noise_factor)

        def run_step(step_number: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
            """One step on every shard, with the whole batch's jitter draw."""
            jitter = self._jitter((work, self.config.dlatent_size), step_number, generator,
                                  effective_noise_factor)
            out = [self._step(sh.w, sh.noises, sh.opt, sh.target_proc, step_number, generator,
                              sh.perceptual, effective_noise_factor,
                              w_jitter=jitter[sh.rows].to(sh.device)) for sh in shards]
            return [d for d, _ in out], [i for _, i in out]

        def gather(parts: Sequence[torch.Tensor], axis: int = 0) -> np.ndarray:
            """The whole batch's rows of per-shard tensors on the host (an
            all_gather across processes), pads dropped."""
            return self._gather(parts, work, axis).take(range(batch), axis=axis)

        def noises_host() -> List[np.ndarray]:
            return [gather([to_jax_layout(sh.noises[i]) for sh in shards])
                    for i in range(len(shards[0].noises))]

        # Convergence early stop (opt-in): host-side per-step distance trace,
        # checked at segment boundaries / per step. The detector only reads
        # the last 2*window rows, and nothing can stop before
        # max(min_steps, 2*window): keep a bounded deque of recent rows and
        # skip the fetch until the trace is close enough to the gate to matter.
        # Every process sees the same trace, so they stop together.
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
                dist_history, w_history = [], []
                for offset in range(segment):
                    dists, _ = run_step(step_number + offset)
                    dist_history.append(dists)
                    w_history.append([sh.w.detach().clone() for sh in shards])
                if self.expected_time_per_step is not None or step_callback is not None:
                    self._wait(shards)
                if step_callback is not None:
                    # latents histories: the post-update w of every step
                    history = gather([torch.stack([ws[k] for ws in w_history])
                                      for k in range(len(shards))], axis=1)
                    noises_np = noises_host()
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
                    _record_distances(gather([torch.stack([ds[k] for ds in dist_history])
                                              for k in range(len(shards))], axis=1))
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
                dists, images_dev = run_step(step_number)
                if self.expected_time_per_step is not None:
                    # the watchdog must observe real device progress
                    self._wait(shards)
                if step_callback is not None:
                    # Pairing note: latents are post-update, the image is the
                    # step's forward pass (pre-update) — the reference's pairing.
                    images = (gather([images_to_uint8(i) for i in images_dev])
                              if want_step_images else empty_image)
                    step_callback(step_number, _latents(gather([sh.w for sh in shards])),
                                  noises_host(), images)
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
                    _record_distances(gather(dists).reshape(1, -1))
                    if _converged():
                        LOGGER.info(
                            "Convergence stop at step %d/%d (windowed relative "
                            "improvement < %g for every frame).",
                            steps_completed, settings.num_steps, settings.convergence_stop,
                        )
                        break

        with torch.no_grad():
            final_images = gather([images_to_uint8(self._synthesis_from_w(sh.w, sh.noises))
                                   for sh in shards])
        latents = gather([sh.w for sh in shards])
        noises_np = noises_host()
        distances = gather(dists).reshape(-1)
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

    def _shards(self, work: int, target_images: np.ndarray, w_all: torch.Tensor,
                noises_all: List[torch.Tensor]) -> List["_ProjectionShard"]:
        """This process's slots of a `work`-frame batch, each with its rows
        of the start (copies: w and the planes are updated in place)."""
        from gance_tpu_torch.parallel.mesh import shard_batch

        parts = shard_batch(self.mesh, work) if self.mesh is not None else [
            (self.device, slice(0, work))]
        shards = []
        for device, rows in parts:
            if rows == slice(0, work) and device == self.device:
                w, noises = w_all, noises_all  # one slot holds the whole batch
            else:
                w = w_all[rows].to(device).clone()
                noises = [n[rows].to(device).clone() for n in noises_all]
            w.requires_grad_(True)
            noises = [n.requires_grad_(True) for n in noises]
            shards.append(_ProjectionShard(
                device=device, rows=rows, w=w, noises=noises,
                # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the root
                opt=torch.optim.Adam([w] + noises, lr=self.settings.initial_learning_rate),
                target_proc=self._target_proc(target_images[rows], device),
                perceptual=self._perceptual_on_device(device),
            ))
        return shards

    def _gather(self, parts: Sequence[Any], rows: int, axis: int = 0) -> np.ndarray:
        """Per-shard rows (tensors or arrays, in row order) -> the whole
        batch's on the host: an all_gather across processes."""
        local = np.concatenate([p.detach().cpu().numpy() if torch.is_tensor(p) else p
                                for p in parts], axis=axis)
        if self.mesh is None or not self.mesh.grouped:
            return local
        from gance_tpu_torch.parallel.mesh import gather_rows

        full = gather_rows(self.mesh, np.moveaxis(local, axis, 0), rows)
        return np.moveaxis(full, 0, axis)

    @staticmethod
    def _wait(shards: Sequence["_ProjectionShard"]) -> None:
        for device in dict.fromkeys(sh.device for sh in shards):
            _wait(device)

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
