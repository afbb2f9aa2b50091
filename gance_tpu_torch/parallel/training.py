"""
StyleGAN2 training on one device: the counterpart of
gance_tpu/parallel/training.py, with the same objective and names.

  * non-saturating logistic GAN loss;
  * R1 on reals, lazy: fused into the D step every `r1_interval` steps at
    interval-scaled strength (a second-order gradient through D);
  * path-length regularisation on G, lazy, every `pl_interval` steps, on
    batch // pl_minibatch_shrink samples, with the `pl_mean` EMA (a
    second-order gradient through synthesis and mapping);
  * style mixing (prob 0.9), the `dlatent_avg` EMA, and the EMA generator
    ("Gs") with `dlatent_avg` copied, not averaged;
  * Adam for both networks over fp32 master weights, in optax's arithmetic.

The kernels on this path (A, B and C in synthesis, D in the discriminator and
in C's and D's own input gradients) carry gradients of every order through
`ops/cuda/autograd.py`.

Differences from JAX, each forced by PyTorch:
  * `jax.random` draws cannot be reproduced in torch, so a step takes its
    draws explicitly (`StepDraws`). `draw_step` makes them from a
    `torch.Generator` seeded with `seed * 1000 + step`, as the JAX CLI seeds
    its step keys, so a resumed run replays an unbroken one.
  * The state is updated in place (params, Adam moments, EMA): one copy of
    each lives on the device.
  * Leaves that get no gradient (the noise buffers, `dlatent_avg`) get a zero
    one, so every leaf's Adam step count stays optax's single `count` and
    their update is exactly 0, as in optax.
  * `make_train_scan` runs a block of steps eagerly, one after another, with
    no host sync between them (one copy of the block to the device, the
    metrics stacked on the device); it is not one compiled program as JAX's
    `lax.scan` is.
  * `remat` wraps each synthesis block and each resnet block of D in a
    non-reentrant `torch.utils.checkpoint` (JAX's `jax.checkpoint`).
  * A mesh is not ported yet (ROADMAP.md Queue 1 item 12) and raises
    NotImplementedError.
"""

import pickle
from dataclasses import dataclass, fields, replace
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from gance_tpu_torch.models.stylegan2 import (
    GeneratorConfig,
    broadcast_dlatents,
    discriminator_apply,
    init_discriminator_params,
    init_generator_params,
    mapping_apply,
    synthesis_apply,
)
from gance_tpu_torch.synthesis.runtime import params_to_device, resolve_device

Params = Dict[str, Any]
Metrics = Dict[str, torch.Tensor]

_NOT_PORTED = "is not ported yet (ROADMAP.md Queue 1 item {})"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class TrainingConfig:
    """Training hyperparameters (StyleGAN2 config-f defaults), as in gance_tpu."""

    learning_rate: float = 0.002
    adam_beta1: float = 0.0
    adam_beta2: float = 0.99
    adam_eps: float = 1e-8
    r1_gamma: float = 10.0
    r1_interval: int = 16
    pl_weight: float = 2.0
    pl_interval: int = 4
    pl_decay: float = 0.01
    pl_minibatch_shrink: int = 2
    style_mixing_prob: float = 0.9
    dlatent_avg_beta: float = 0.995
    ema_beta: float = 0.999
    # 'bfloat16' runs G and D forward and backward in bf16; master weights,
    # Adam moments, EMA and the losses stay fp32.
    compute_dtype: str = "float32"
    remat: bool = False

    @property
    def pl_enabled(self) -> bool:
        return self.pl_weight > 0.0 and self.pl_interval > 0


@dataclass
class TrainingState:
    """Everything needed to resume training, on one device. Param leaves are
    fp32 tensors that require grad; the optimizers hold their Adam moments."""

    g_params: Params
    d_params: Params
    g_opt_state: torch.optim.Adam
    d_opt_state: torch.optim.Adam
    ema_params: Params
    step: int
    pl_mean: torch.Tensor  # 0-d fp32


@dataclass
class StepDraws:
    """
    Every random draw of one train step, in the order `draw_step` makes them.
    Mixing masks are (n, num_style_rows) bools, True where a row takes the
    second latent; noise lists hold one (n, 1, s, s) plane per noise-carrying
    layer (s = 2 ** ((i + 5) // 2)); the PL probe is (n_pl, R, R, 3) and
    already divided by R.
    """

    z1: torch.Tensor
    z2: torch.Tensor
    d_mix: torch.Tensor
    d_noise: List[torch.Tensor]
    z1g: torch.Tensor
    z2g: torch.Tensor
    g_mix: torch.Tensor
    g_noise: List[torch.Tensor]
    pl_mix: torch.Tensor
    pl_noise: List[torch.Tensor]
    pl_probe: torch.Tensor

    def to(self, device: Union[str, torch.device]) -> "StepDraws":
        def move(value: Any) -> Any:
            if isinstance(value, list):
                return [v.to(device) for v in value]
            return value.to(device)

        return replace(self, **{f.name: move(getattr(self, f.name)) for f in fields(self)})


def compute_dtype_of(train_config: TrainingConfig) -> torch.dtype:
    if train_config.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {train_config.compute_dtype!r}: expected {list(_DTYPES)}")
    return _DTYPES[train_config.compute_dtype]


# ---------------------------------------------------------------------------
# Param trees
# ---------------------------------------------------------------------------


def tree_leaves(tree: Params, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in sorted key order: the fixed order of the
    optimizers' parameter lists and of the checkpoint."""
    out: List[Tuple[str, Any]] = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        value = tree[key]
        if isinstance(value, dict):
            out.extend(tree_leaves(value, path))
        else:
            out.append((path, value))
    return out


def tree_from_leaves(paths_and_values: List[Tuple[str, Any]]) -> Params:
    tree: Params = {}
    for path, value in paths_and_values:
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def tree_to_numpy(tree: Params) -> Params:
    return tree_from_leaves([(p, v.detach().cpu().numpy().copy()) for p, v in tree_leaves(tree)])


def _trainable(params: Params, device: torch.device) -> Params:
    tree = params_to_device(params, device)
    for _, leaf in tree_leaves(tree):
        leaf.requires_grad_(True)
    return tree


def _adam(params: Params, train_config: TrainingConfig,
          adam: Optional[Dict[str, Any]] = None) -> torch.optim.Adam:
    """torch.optim.Adam over the leaves in sorted key order. With b1 = 0 its
    arithmetic is optax.adam's: eps outside the square root, eps_root 0,
    bias corrections from one step count. `adam` ({"count", "mu", "nu"},
    numpy trees in the port's layout) restores the moments."""
    leaves = [leaf for _, leaf in tree_leaves(params)]
    opt = torch.optim.Adam(
        leaves, lr=train_config.learning_rate,
        betas=(train_config.adam_beta1, train_config.adam_beta2), eps=train_config.adam_eps,
    )
    if adam is not None:
        mu, nu = dict(tree_leaves(adam["mu"])), dict(tree_leaves(adam["nu"]))
        for path, leaf in tree_leaves(params):
            opt.state[leaf] = {
                "step": torch.tensor(float(adam["count"]), dtype=torch.float32),
                "exp_avg": torch.tensor(np.asarray(mu[path], np.float32), device=leaf.device),
                "exp_avg_sq": torch.tensor(np.asarray(nu[path], np.float32), device=leaf.device),
            }
    return opt


def _adam_to_numpy(opt: torch.optim.Adam, params: Params) -> Dict[str, Any]:
    mu, nu, count = [], [], 0
    for path, leaf in tree_leaves(params):
        state = opt.state.get(leaf, {})
        if state:
            count = int(state["step"])
            mu.append((path, state["exp_avg"].detach().cpu().numpy().copy()))
            nu.append((path, state["exp_avg_sq"].detach().cpu().numpy().copy()))
        else:
            zeros = np.zeros(tuple(leaf.shape), np.float32)
            mu.append((path, zeros))
            nu.append((path, zeros.copy()))
    return {"count": count, "mu": tree_from_leaves(mu), "nu": tree_from_leaves(nu)}


def training_state_from_arrays(
    g_params: Params,
    d_params: Params,
    ema_params: Params,
    step: int = 0,
    pl_mean: float = 0.0,
    g_adam: Optional[Dict[str, Any]] = None,
    d_adam: Optional[Dict[str, Any]] = None,
    train_config: TrainingConfig = TrainingConfig(),
    device: Union[str, torch.device] = "cuda",
) -> TrainingState:
    """A state on `device` from numpy trees in the port's layout (fresh Adam
    moments where `g_adam` / `d_adam` are None)."""
    device = resolve_device(device)
    g = _trainable(g_params, device)
    d = _trainable(d_params, device)
    return TrainingState(
        g_params=g,
        d_params=d,
        g_opt_state=_adam(g, train_config, g_adam),
        d_opt_state=_adam(d, train_config, d_adam),
        ema_params=params_to_device(ema_params, device),
        step=int(step),
        pl_mean=torch.tensor(float(pl_mean), dtype=torch.float32, device=device),
    )


def init_training_state(
    seed: int,
    model_config: GeneratorConfig,
    train_config: TrainingConfig = TrainingConfig(),
    device: Union[str, torch.device] = "cuda",
) -> TrainingState:
    """Random G (from `seed`) and D (from `seed + 1`), EMA = G, step 0."""
    g = init_generator_params(seed, model_config)
    d = init_discriminator_params(seed + 1, model_config)
    return training_state_from_arrays(g, d, g, train_config=train_config, device=device)


# ---------------------------------------------------------------------------
# Random draws
# ---------------------------------------------------------------------------


def noise_sizes(model_config: GeneratorConfig) -> List[int]:
    """Side of each noise-carrying layer's plane: 4, 8, 8, 16, 16, ..."""
    return [2 ** ((i + 5) // 2) for i in range(model_config.num_style_rows - 1)]


def draw_step(
    seed: int,
    step: int,
    batch: int,
    model_config: GeneratorConfig,
    train_config: TrainingConfig = TrainingConfig(),
    device: Union[str, torch.device] = "cuda",
) -> StepDraws:
    """A step's draws from a torch.Generator on `device` seeded with
    seed * 1000 + step (the JAX CLI's step key), in a fixed order."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed * 1000 + step)
    rows = model_config.num_style_rows
    pl_batch = max(batch // max(train_config.pl_minibatch_shrink, 1), 1)
    res = model_config.resolution

    def normal(*shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=device)

    def mix(n: int) -> torch.Tensor:
        do_mix = torch.rand((n, 1), generator=gen, device=device) < train_config.style_mixing_prob
        cutoff = torch.randint(1, rows, (n, 1), generator=gen, device=device)
        return do_mix & (torch.arange(rows, device=device)[None, :] >= cutoff)

    def noise(n: int) -> List[torch.Tensor]:
        return [normal(n, 1, s, s) for s in noise_sizes(model_config)]

    latent = model_config.latent_size
    z1, z2, d_mix, d_noise = normal(batch, latent), normal(batch, latent), mix(batch), noise(batch)
    z1g, z2g, g_mix, g_noise = normal(batch, latent), normal(batch, latent), mix(batch), noise(batch)
    pl_mix, pl_noise = mix(pl_batch), noise(pl_batch)
    pl_probe = normal(pl_batch, res, res, model_config.num_channels) / np.sqrt(res * res)
    return StepDraws(z1, z2, d_mix, d_noise, z1g, z2g, g_mix, g_noise, pl_mix, pl_noise, pl_probe)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def mixed_dlatents(
    g_params: Params, z1: torch.Tensor, z2: torch.Tensor, take_second: torch.Tensor,
    model_config: GeneratorConfig,
) -> torch.Tensor:
    """Style mixing: w+ rows from z2 where `take_second`, else from z1."""
    d1 = broadcast_dlatents(mapping_apply(g_params, z1, model_config), model_config)
    d2 = broadcast_dlatents(mapping_apply(g_params, z2, model_config), model_config)
    return torch.where(take_second[:, :, None], d2, d1)


def _generate(g_params: Params, z1: torch.Tensor, z2: torch.Tensor, take_second: torch.Tensor,
              noise: List[torch.Tensor], model_config: GeneratorConfig,
              train_config: TrainingConfig) -> torch.Tensor:
    dlatents = mixed_dlatents(g_params, z1, z2, take_second, model_config)
    return synthesis_apply(g_params, dlatents, model_config, noise_mode="random",
                           noise_planes=noise, compute_dtype=compute_dtype_of(train_config),
                           remat=train_config.remat)


def _grads(loss: torch.Tensor, params: Params) -> List[torch.Tensor]:
    """d loss / d every leaf, zeros for the leaves it does not reach."""
    leaves = [leaf for _, leaf in tree_leaves(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def d_step_gradients(
    g_params: Params, d_params: Params, reals: torch.Tensor, draws: StepDraws, apply_r1: bool,
    model_config: GeneratorConfig, train_config: TrainingConfig,
) -> Tuple[List[torch.Tensor], Metrics]:
    """The D step's gradients (leaves in sorted key order) and its metrics.
    Fakes are made without a graph: JAX differentiates only w.r.t. D."""
    dtype = compute_dtype_of(train_config)
    with torch.no_grad():
        fakes = _generate(g_params, draws.z1, draws.z2, draws.d_mix, draws.d_noise,
                          model_config, train_config)
    remat = train_config.remat
    fake_logits = discriminator_apply(d_params, fakes, model_config, dtype, remat)
    reals = reals.float().detach().requires_grad_(apply_r1)
    real_logits = discriminator_apply(d_params, reals, model_config, dtype, remat)
    loss = F.softplus(fake_logits).mean() + F.softplus(-real_logits).mean()
    r1 = torch.zeros((), device=loss.device)
    if apply_r1:
        (r1_grads,) = torch.autograd.grad(real_logits.sum(), reals, create_graph=True)
        penalty = r1_grads.square().sum(dim=(1, 2, 3)).mean()
        r1 = penalty * (train_config.r1_gamma * 0.5) * train_config.r1_interval
    grads = _grads(loss + r1, d_params)
    return grads, {"d_loss": loss.detach(), "r1": r1.detach()}


def g_step_gradients(
    g_params: Params, d_params: Params, draws: StepDraws, pl_mean: torch.Tensor, apply_pl: bool,
    model_config: GeneratorConfig, train_config: TrainingConfig,
) -> Tuple[List[torch.Tensor], Metrics]:
    """The G step's gradients (w.r.t. G's leaves only) and its metrics."""
    dtype = compute_dtype_of(train_config)
    fakes = _generate(g_params, draws.z1g, draws.z2g, draws.g_mix, draws.g_noise,
                      model_config, train_config)
    loss = F.softplus(-discriminator_apply(d_params, fakes, model_config, dtype,
                                           train_config.remat)).mean()
    pl_penalty = pl_length = torch.zeros((), device=loss.device)
    if apply_pl:
        # NVlabs pathreg: |d sum(images * probe) / d w+| per sample, averaged
        # over the style rows, against its running mean; the penalty's
        # gradient goes through the Jacobian (second order through synthesis)
        # and through w+'s dependence on the mapping network
        pl_batch = draws.pl_mix.shape[0]
        dlatents = mixed_dlatents(g_params, draws.z1g[:pl_batch], draws.z2g[:pl_batch],
                                  draws.pl_mix, model_config)
        images = synthesis_apply(g_params, dlatents, model_config, noise_mode="random",
                                 noise_planes=draws.pl_noise, compute_dtype=dtype,
                                 remat=train_config.remat).float()
        (pl_grads,) = torch.autograd.grad((images * draws.pl_probe).sum(), dlatents,
                                          create_graph=True)
        lengths = torch.sqrt(pl_grads.square().sum(dim=2).mean(dim=1))
        penalty = (lengths - pl_mean.detach()).square().mean()
        pl_penalty = penalty * (train_config.pl_weight * train_config.pl_interval)
        pl_length = lengths.mean()
    grads = _grads(loss + pl_penalty, g_params)
    return grads, {"g_loss": loss.detach(), "pl": pl_penalty.detach(),
                   "pl_length": pl_length.detach()}


def _adam_step(opt: torch.optim.Adam, params: Params, grads: List[torch.Tensor]) -> None:
    for (_, leaf), grad in zip(tree_leaves(params), grads):
        leaf.grad = grad.detach()
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_train_step(
    model_config: GeneratorConfig,
    train_config: TrainingConfig = TrainingConfig(),
    mesh: Optional[Any] = None,
) -> Callable[[TrainingState, torch.Tensor, StepDraws], Tuple[TrainingState, Metrics]]:
    """
    The per-step trainer: (state, real images (B, R, R, 3) float in [-1, 1] on
    the state's device, the step's draws) -> (the same state, updated in
    place, and metrics d_loss, g_loss, r1, pl, pl_length as 0-d tensors).
    """
    if mesh is not None:
        raise NotImplementedError("training over a mesh " + _NOT_PORTED.format(12))
    compute_dtype_of(train_config)

    def train_step(state: TrainingState, reals: torch.Tensor,
                   draws: StepDraws) -> Tuple[TrainingState, Metrics]:
        apply_r1 = state.step % train_config.r1_interval == 0
        apply_pl = train_config.pl_enabled and state.step % train_config.pl_interval == 0

        d_grads, d_metrics = d_step_gradients(state.g_params, state.d_params, reals, draws,
                                              apply_r1, model_config, train_config)
        _adam_step(state.d_opt_state, state.d_params, d_grads)
        del d_grads

        # the G step runs against the updated D
        g_grads, g_metrics = g_step_gradients(state.g_params, state.d_params, draws,
                                              state.pl_mean, apply_pl, model_config,
                                              train_config)
        _adam_step(state.g_opt_state, state.g_params, g_grads)
        del g_grads

        with torch.no_grad():
            if apply_pl:
                state.pl_mean = state.pl_mean + train_config.pl_decay * (
                    g_metrics["pl_length"] - state.pl_mean)
            # dlatent_avg ("w_avg"): no gradient; tracks the mean mapping output
            w_avg = mapping_apply(state.g_params, draws.z1g, model_config).mean(dim=0)
            dlatent_avg = w_avg + (state.g_params["dlatent_avg"] - w_avg) * train_config.dlatent_avg_beta
            state.g_params["dlatent_avg"].copy_(dlatent_avg)
            beta = train_config.ema_beta
            for (_, ema), (_, new) in zip(tree_leaves(state.ema_params),
                                          tree_leaves(state.g_params)):
                ema.copy_(ema * beta + new * (1.0 - beta))
            # running statistics are copied, not averaged
            state.ema_params["dlatent_avg"].copy_(dlatent_avg)
        state.step += 1
        return state, {**d_metrics, **g_metrics}

    return train_step


def make_train_scan(
    model_config: GeneratorConfig,
    train_config: TrainingConfig = TrainingConfig(),
    mesh: Optional[Any] = None,
) -> Callable[[TrainingState, Any, Sequence[StepDraws]], Tuple[TrainingState, Metrics]]:
    """
    A block of S train steps with no host sync between them, the counterpart
    of JAX's `make_train_scan`: (state, real images (S, B, R, R, 3) float in
    [-1, 1], anywhere, the S steps' draws on the state's device) -> (the same
    state, updated in place, and the metrics of `make_train_step` stacked on
    the device as (S,) tensors). The block goes to the device in one copy and
    nothing is read back; the steps are those of `make_train_step`, so S
    scanned steps equal S single steps.
    """
    train_step = make_train_step(model_config, train_config, mesh)

    def train_segment(state: TrainingState, reals_block: Any,
                      draws: Sequence[StepDraws]) -> Tuple[TrainingState, Metrics]:
        if len(draws) != len(reals_block):
            raise ValueError(f"{len(reals_block)} batches of reals but {len(draws)} draws")
        device = state.pl_mean.device
        if not isinstance(reals_block, torch.Tensor):
            reals_block = torch.from_numpy(np.ascontiguousarray(reals_block, np.float32))
        block = reals_block.to(device, torch.float32)
        per_step = []
        for reals, step_draws in zip(block, draws):
            state, metrics = train_step(state, reals, step_draws)
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return train_segment


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------

CHECKPOINT_FORMAT = "gance_tpu_torch.training/1"


def save_checkpoint(path: Path, state: TrainingState) -> None:
    """Write the state as numpy trees to `path` + '.tmp', then rename it over
    `path`, so a crash mid-write leaves the previous checkpoint whole."""
    blob = {
        "format": CHECKPOINT_FORMAT,
        "step": int(state.step),
        "pl_mean": float(state.pl_mean),
        "g_params": tree_to_numpy(state.g_params),
        "d_params": tree_to_numpy(state.d_params),
        "ema_params": tree_to_numpy(state.ema_params),
        "g_adam": _adam_to_numpy(state.g_opt_state, state.g_params),
        "d_adam": _adam_to_numpy(state.d_opt_state, state.d_params),
    }
    tmp = Path(str(path) + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)


def load_checkpoint(
    path: Path,
    train_config: TrainingConfig = TrainingConfig(),
    device: Union[str, torch.device] = "cuda",
) -> TrainingState:
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if not isinstance(blob, dict) or blob.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{path} is not a {CHECKPOINT_FORMAT} checkpoint")
    return training_state_from_arrays(
        blob["g_params"], blob["d_params"], blob["ema_params"], blob["step"], blob["pl_mean"],
        blob["g_adam"], blob["d_adam"], train_config, device,
    )


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------


def run_training(
    dataset: Any,
    model_config: GeneratorConfig,
    train_config: TrainingConfig,
    checkpoint_path: Path,
    total_steps: int,
    batch_size: int,
    checkpoint_every: int = 200,
    output_network: Optional[Path] = None,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
    before_step: Optional[Callable[[int], None]] = None,
    after_step: Optional[Callable[[int, TrainingState, Metrics], None]] = None,
    scan_segment: int = 1,
    metrics_hook: Optional[Callable[[int, TrainingState], None]] = None,
) -> TrainingState:
    """
    Train to `total_steps`, resuming from `checkpoint_path` when it exists
    (the draws of step s come from seed * 1000 + s and the dataset's batch
    is a function of s, so a resumed run replays an unbroken one);
    checkpoint every `checkpoint_every` steps and at the end; write the EMA
    generator to `output_network` as an NVlabs-format pickle. `dataset` is
    anything with `batches(start_step, total_steps, batch_size)` yielding
    (step, (B, R, R, 3) float32 in [-1, 1]), such as
    `parallel/data.py::StreamingImageDataset`. Needs neither click nor cv2.

    The steps run in segments of up to `scan_segment` through
    `make_train_scan`, as JAX's CLI loop runs them: a segment ends early at
    each checkpoint boundary, and its metrics are read only there (for the
    log). `before_step(s)` runs before the segment whose first step is s;
    `after_step(s, state, metrics)` after it, with s its last step and that
    step's metrics, before any checkpoint is written; with the default
    segment of 1 both run around every step. `metrics_hook(step, state)` runs
    at each checkpoint boundary, after the checkpoint, with the count of
    steps taken (the CLI's `--metrics-every` evaluation).
    """
    from gance_tpu_torch.models.pickle_loader import save_generator_pickle
    from gance_tpu_torch.utils.logging import LOGGER

    if scan_segment < 1:
        raise ValueError(f"scan_segment must be at least 1, got {scan_segment}")
    device = resolve_device(device)
    ckpt = Path(checkpoint_path)
    if ckpt.exists():
        state = load_checkpoint(ckpt, train_config, device)
        LOGGER.info("Resumed from %s at step %d", ckpt, state.step)
    else:
        state = init_training_state(seed, model_config, train_config, device)
    train_segment = make_train_scan(model_config, train_config)
    pending: List[Tuple[int, np.ndarray]] = []
    for step, reals in dataset.batches(state.step, total_steps, batch_size):
        pending.append((step, np.asarray(reals)))
        boundary = (step + 1) % checkpoint_every == 0 or step + 1 == total_steps
        if len(pending) < scan_segment and not boundary:
            continue
        if before_step is not None:
            before_step(pending[0][0])
        draws = [draw_step(seed, s, batch_size, model_config, train_config, device)
                 for s, _ in pending]
        state, stacked = train_segment(state, np.stack([r for _, r in pending]), draws)
        metrics = {k: v[-1] for k, v in stacked.items()}
        pending.clear()
        if after_step is not None:
            after_step(step, state, metrics)
        if boundary:
            save_checkpoint(ckpt, state)
            LOGGER.info(
                "step %d: d_loss=%.4f g_loss=%.4f r1=%.4f pl=%.4f (checkpointed)", step + 1,
                float(metrics["d_loss"]), float(metrics["g_loss"]), float(metrics["r1"]),
                float(metrics["pl"]),
            )
            if metrics_hook is not None:
                metrics_hook(step + 1, state)
    if output_network is not None:
        save_generator_pickle(state.ema_params, Path(output_network))
        LOGGER.info("Wrote EMA generator to %s", output_network)
    return state
