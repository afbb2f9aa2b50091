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
  * Over a mesh (`make_train_step(mesh=)`) each data slot runs its rows of
    the global batch with its own copy of the params, and the gradients
    and metrics are summed over the slots (on the first device) and over
    the torch.distributed group. The minibatch stddev's groups are strided
    over the global batch, so D's 4x4 features are gathered with a
    differentiable all-reduce (`_GatherRows`); path length takes the first
    rows of the global batch, wherever they lie.
  * Over a mesh with a 'model' axis above 1 each data row's model slots hold
    G, D, their Adam moments and the EMA as `parallel/tensor_parallel.py::
    GroupParams` (the sharded leaves' blocks on their slots, the replicated
    leaves once on the row's lead slot), and the forwards run column-parallel.
    Autograd gives each block's gradient on its slot and each replicated
    leaf's on the lead, summed over the slots; the data-parallel reduction
    then runs per distinct leaf, as above. The optimizer and EMA updates are
    elementwise, so they run on the blocks where they lie.
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
    discriminator_features,
    discriminator_head,
    init_discriminator_params,
    init_generator_params,
    mapping_apply,
    synthesis_apply,
)
from gance_tpu_torch.parallel.mesh import all_reduce_sum_
from gance_tpu_torch.parallel.tensor_parallel import GroupParams
from gance_tpu_torch.utils.device import params_to_device, resolve_device

Params = Dict[str, Any]
Metrics = Dict[str, torch.Tensor]

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
    """Everything needed to resume training, on one device or one model
    group (`GroupParams` trees). Param leaves are fp32 tensors that require
    grad; the optimizers hold their Adam moments."""

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


def _flat(tree: Any) -> List[torch.Tensor]:
    """A params tree's distinct leaves in a fixed order: the optimizers'
    parameter lists (a model group's blocks each count as a leaf)."""
    if isinstance(tree, GroupParams):
        return tree.flat()
    return [leaf for _, leaf in tree_leaves(tree)]


def _flat_arrays(tree: Any, arrays: Params) -> List[np.ndarray]:
    """A tree of whole arrays shaped like `tree`'s leaves, laid out as `_flat(tree)`."""
    if isinstance(tree, GroupParams):
        return tree.flat_arrays(arrays)
    by_path = dict(tree_leaves(arrays))
    return [np.asarray(by_path[path], np.float32) for path, _ in tree_leaves(tree)]


def _whole(tree: Any, arrays: Sequence[np.ndarray]) -> Params:
    """Arrays laid out as `_flat(tree)` -> a tree of whole arrays."""
    if isinstance(tree, GroupParams):
        return tree.whole(arrays)
    return tree_from_leaves([(path, a) for (path, _), a in zip(tree_leaves(tree), arrays)])


def tree_to_numpy(tree: Any) -> Params:
    """Whole leaves on the host (a model group's blocks concatenated)."""
    return _whole(tree, [v.detach().cpu().numpy().copy() for v in _flat(tree)])


def _trainable(params: Params, device: torch.device) -> Params:
    tree = params_to_device(params, device)
    for _, leaf in tree_leaves(tree):
        leaf.requires_grad_(True)
    return tree


def _adam(params: Any, train_config: TrainingConfig,
          adam: Optional[Dict[str, Any]] = None) -> torch.optim.Adam:
    """torch.optim.Adam over the leaves in sorted key order (a model group's
    blocks each a leaf, so its moments lie beside them). With b1 = 0 its
    arithmetic is optax.adam's: eps outside the square root, eps_root 0,
    bias corrections from one step count. `adam` ({"count", "mu", "nu"},
    numpy trees of whole leaves in the port's layout) restores the moments."""
    leaves = _flat(params)
    opt = torch.optim.Adam(
        leaves, lr=train_config.learning_rate,
        betas=(train_config.adam_beta1, train_config.adam_beta2), eps=train_config.adam_eps,
    )
    if adam is not None:
        mu, nu = _flat_arrays(params, adam["mu"]), _flat_arrays(params, adam["nu"])
        for leaf, m, v in zip(leaves, mu, nu):
            opt.state[leaf] = {
                "step": torch.tensor(float(adam["count"]), dtype=torch.float32),
                "exp_avg": torch.tensor(np.array(m, np.float32), device=leaf.device),
                "exp_avg_sq": torch.tensor(np.array(v, np.float32), device=leaf.device),
            }
    return opt


def _adam_to_numpy(opt: torch.optim.Adam, params: Any) -> Dict[str, Any]:
    """The moments as trees of whole leaves (a model group's gathered)."""
    mu, nu, count = [], [], 0
    for leaf in _flat(params):
        state = opt.state.get(leaf, {})
        if state:
            count = int(state["step"])
            mu.append(state["exp_avg"].detach().cpu().numpy().copy())
            nu.append(state["exp_avg_sq"].detach().cpu().numpy().copy())
        else:
            zeros = np.zeros(tuple(leaf.shape), np.float32)
            mu.append(zeros)
            nu.append(zeros.copy())
    return {"count": count, "mu": _whole(params, mu), "nu": _whole(params, nu)}


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
    model_devices: Optional[Sequence[torch.device]] = None,
) -> TrainingState:
    """A state on `device` from numpy trees of whole leaves in the port's
    layout (fresh Adam moments where `g_adam` / `d_adam` are None). With
    `model_devices` (a data row's model slots, lead first, more than one)
    G, D, their moments and the EMA are sharded over them as `GroupParams`
    and `device` is the lead."""
    if model_devices is not None and len(model_devices) > 1:
        g = GroupParams.place(g_params, model_devices, shared=True, trainable=True)
        d = GroupParams.place(d_params, model_devices, shared=True, trainable=True)
        ema = GroupParams.place(ema_params, model_devices, shared=True)
        device = g.lead
    else:
        device = resolve_device(device)
        g = _trainable(g_params, device)
        d = _trainable(d_params, device)
        ema = params_to_device(ema_params, device)
    return TrainingState(
        g_params=g,
        d_params=d,
        g_opt_state=_adam(g, train_config, g_adam),
        d_opt_state=_adam(d, train_config, d_adam),
        ema_params=ema,
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


# ---------------------------------------------------------------------------
# Data parallelism
# ---------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """Sum over the process group, differentiable to any order (its adjoint
    is itself)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum_(x.clone())

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> torch.Tensor:
        return _AllReduceSum.apply(grad)


class _GatherRows(torch.autograd.Function):
    """
    Rows [offset, offset + len(local)) of a `total`-row batch from each
    process -> the whole batch on every process (zeros elsewhere, summed
    over the group: exact). Its gradient sums every process's gradient of
    the whole batch and keeps this process's rows, so autograd through it,
    to any order, is the gradient of the sum of every process's loss.
    """

    @staticmethod
    def forward(ctx: Any, local: torch.Tensor, total: int, offset: int) -> torch.Tensor:
        ctx.rows = (offset, offset + local.shape[0])
        full = local.new_zeros((total,) + tuple(local.shape[1:]))
        full[offset: offset + local.shape[0]] = local
        return all_reduce_sum_(full)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Tuple[torch.Tensor, None, None]:
        start, stop = ctx.rows
        return _AllReduceSum.apply(grad)[start:stop], None, None


@dataclass
class _Shard:
    """One slot's part of a step: its rows of the global batch and the G and
    D params it runs with (the state's own on the state's device, copies
    elsewhere)."""

    device: torch.device
    rows: slice
    g: Params
    d: Params


@dataclass
class _Split:
    """A step's batch as this process computes it: `batch` global rows,
    this process's `shards` (rows [local.start, local.stop) in all), and
    whether it is reduced over a process group (which holds the rest)."""

    batch: int
    shards: List[_Shard]
    local: slice
    multi_process: bool

    @property
    def master(self) -> torch.device:
        return self.shards[0].device if self.shards else torch.device("cpu")

    def discriminate(self, images: Sequence[torch.Tensor], model_config: GeneratorConfig,
                     train_config: TrainingConfig) -> List[torch.Tensor]:
        """D's logits of each shard's images, with the minibatch stddev over
        the whole global batch (the features gathered differentiably)."""
        dtype, remat = compute_dtype_of(train_config), train_config.remat
        feats = [discriminator_features(s.d, x, model_config, dtype, remat)
                 for s, x in zip(self.shards, images)]
        full = torch.cat([f.to(self.master) for f in feats])
        if self.multi_process:
            full = _GatherRows.apply(full, self.batch, self.local.start)
        return [discriminator_head(s.d, f, model_config, full, s.rows.start)
                for s, f in zip(self.shards, feats)]

    def total(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """This process's sum of per-shard scalars, on the master device."""
        out = torch.zeros((), device=self.master)
        for part in parts:
            out = out + part.to(self.master)
        return out


def _rows(value: torch.Tensor, shard: _Shard, rows: Optional[slice] = None) -> torch.Tensor:
    return value[shard.rows if rows is None else rows].to(shard.device)


def _single_split(g_params: Any, d_params: Params, batch: int) -> _Split:
    device = _flat(g_params)[0].device
    return _Split(batch, [_Shard(device, slice(0, batch), g_params, d_params)],
                  slice(0, batch), False)


def _reals_of(reals: Any, rows: slice) -> torch.Tensor:
    """Rows of the global batch of reals: a tensor, an array or
    `distributed.GlobalRows` (a process's rows only)."""
    from gance_tpu_torch.parallel.distributed import GlobalRows

    if isinstance(reals, GlobalRows):
        return torch.from_numpy(np.ascontiguousarray(reals.rows(rows.start, rows.stop)))
    if not torch.is_tensor(reals):
        reals = torch.from_numpy(np.ascontiguousarray(reals))
    return reals[rows]


def _split_grads(loss: torch.Tensor, split: _Split, which: str) -> List[torch.Tensor]:
    """d loss / d the G or D leaves, summed over this process's copies (on
    the master device) and over the process group: the gradient of the
    global loss."""
    copies = list({id(getattr(s, which)): getattr(s, which) for s in split.shards}.values())
    leaves = [_flat(tree) for tree in copies]
    flat = [leaf for tree in leaves for leaf in tree]
    raw = torch.autograd.grad(loss, flat, allow_unused=True)
    count = len(leaves[0])
    grads = []
    for i, leaf in enumerate(leaves[0]):
        total = torch.zeros_like(leaf)
        for copy in range(len(copies)):
            g = raw[copy * count + i]
            if g is not None:
                total = total + g.to(leaf.device)
        grads.append(total)
    if split.multi_process:
        _all_reduce_buckets_(grads, split.master)
    return grads


# The largest bucket of gradients one collective sums (a larger leaf goes
# alone); read at call time.
_REDUCE_BUCKET_BYTES = 1 << 24


def _all_reduce_buckets_(grads: List[torch.Tensor], master: torch.device) -> None:
    """
    Sum `grads` over the process group, in place, in buckets of consecutive
    leaves of at most `_REDUCE_BUCKET_BYTES`: each bucket is staged on
    `master` (a model group's blocks come from their slots), reduced and
    copied back before the next, so the master never holds more than one
    bucket of the other slots' gradients. The buckets depend only on the
    leaves' sizes, so every process cuts them alike.
    """
    def flush(bucket: List[torch.Tensor]) -> None:
        if len(bucket) == 1:
            all_reduce_sum_(bucket[0])
            return
        flat = torch.cat([g.reshape(-1).to(master) for g in bucket])
        all_reduce_sum_(flat)
        for chunk, g in zip(torch.split(flat, [g.numel() for g in bucket]), bucket):
            g.copy_(chunk.view_as(g))

    bucket: List[torch.Tensor] = []
    size = 0
    for g in grads:
        nbytes = g.numel() * g.element_size()
        if bucket and size + nbytes > _REDUCE_BUCKET_BYTES:
            flush(bucket)
            bucket, size = [], 0
        bucket.append(g)
        size += nbytes
    if bucket:
        flush(bucket)


def _metric(value: torch.Tensor, split: _Split) -> torch.Tensor:
    value = value.detach()
    return all_reduce_sum_(value.clone()) if split.multi_process else value


def d_step_gradients(
    g_params: Params, d_params: Params, reals: Any, draws: StepDraws, apply_r1: bool,
    model_config: GeneratorConfig, train_config: TrainingConfig,
    split: Optional[_Split] = None,
) -> Tuple[List[torch.Tensor], Metrics]:
    """The D step's gradients (leaves in sorted key order) and its metrics.
    Fakes are made without a graph: JAX differentiates only w.r.t. D. Under
    data parallelism (`split`) each shard runs its rows of the global batch
    and the gradients are the global loss's."""
    split = split or _single_split(g_params, d_params, draws.z1.shape[0])
    with torch.no_grad():
        fakes = [_generate(s.g, _rows(draws.z1, s), _rows(draws.z2, s), _rows(draws.d_mix, s),
                           [_rows(n, s) for n in draws.d_noise], model_config, train_config)
                 for s in split.shards]
    fake_logits = split.discriminate(fakes, model_config, train_config)
    real_images = [_reals_of(reals, s.rows).to(s.device).float().detach()
                   .requires_grad_(apply_r1) for s in split.shards]
    real_logits = split.discriminate(real_images, model_config, train_config)
    batch = split.batch
    loss = (split.total([F.softplus(x).sum() for x in fake_logits]) / batch
            + split.total([F.softplus(-x).sum() for x in real_logits]) / batch)
    r1 = torch.zeros((), device=loss.device)
    if apply_r1:
        r1_grads = torch.autograd.grad(split.total([x.sum() for x in real_logits]), real_images,
                                       create_graph=True)
        penalty = split.total([g.square().sum() for g in r1_grads]) / batch
        r1 = penalty * (train_config.r1_gamma * 0.5) * train_config.r1_interval
    grads = _split_grads(loss + r1, split, "d")
    return grads, {"d_loss": _metric(loss, split), "r1": _metric(r1, split)}


def g_step_gradients(
    g_params: Params, d_params: Params, draws: StepDraws, pl_mean: torch.Tensor, apply_pl: bool,
    model_config: GeneratorConfig, train_config: TrainingConfig,
    split: Optional[_Split] = None,
) -> Tuple[List[torch.Tensor], Metrics]:
    """The G step's gradients (w.r.t. G's leaves only) and its metrics. Path
    length runs on the first rows of the global batch, wherever they lie."""
    split = split or _single_split(g_params, d_params, draws.z1g.shape[0])
    dtype = compute_dtype_of(train_config)
    fakes = [_generate(s.g, _rows(draws.z1g, s), _rows(draws.z2g, s), _rows(draws.g_mix, s),
                       [_rows(n, s) for n in draws.g_noise], model_config, train_config)
             for s in split.shards]
    logits = split.discriminate(fakes, model_config, train_config)
    loss = split.total([F.softplus(-x).sum() for x in logits]) / split.batch
    pl_penalty = pl_length = torch.zeros((), device=loss.device)
    if apply_pl:
        # NVlabs pathreg: |d sum(images * probe) / d w+| per sample, averaged
        # over the style rows, against its running mean; the penalty's
        # gradient goes through the Jacobian (second order through synthesis)
        # and through w+'s dependence on the mapping network
        pl_batch = draws.pl_mix.shape[0]
        penalties, lengths_sum = [], []
        for s in split.shards:
            rows = slice(s.rows.start, min(s.rows.stop, pl_batch))
            if rows.stop <= rows.start:
                continue  # this shard holds none of the path-length rows
            local = slice(rows.start - s.rows.start, rows.stop - s.rows.start)
            dlatents = mixed_dlatents(s.g, _rows(draws.z1g, s)[local], _rows(draws.z2g, s)[local],
                                      _rows(draws.pl_mix, s, rows), model_config)
            images = synthesis_apply(s.g, dlatents, model_config, noise_mode="random",
                                     noise_planes=[_rows(n, s, rows) for n in draws.pl_noise],
                                     compute_dtype=dtype, remat=train_config.remat).float()
            (pl_grads,) = torch.autograd.grad((images * _rows(draws.pl_probe, s, rows)).sum(),
                                              dlatents, create_graph=True)
            lengths = torch.sqrt(pl_grads.square().sum(dim=2).mean(dim=1))
            penalties.append((lengths - pl_mean.detach().to(s.device)).square().sum())
            lengths_sum.append(lengths.sum())
        penalty = split.total(penalties) / pl_batch
        pl_penalty = penalty * (train_config.pl_weight * train_config.pl_interval)
        pl_length = split.total(lengths_sum) / pl_batch
    grads = _split_grads(loss + pl_penalty, split, "g")
    return grads, {"g_loss": _metric(loss, split), "pl": _metric(pl_penalty, split),
                   "pl_length": _metric(pl_length, split)}


def _adam_step(opt: torch.optim.Adam, params: Any, grads: List[torch.Tensor]) -> None:
    for leaf, grad in zip(_flat(params), grads):
        leaf.grad = grad.detach()
    opt.step()
    opt.zero_grad(set_to_none=True)


def _copy_on(tree: Any, devices: Tuple[torch.device, ...]) -> Any:
    """A trainable copy of a state's params tree on a data row's devices."""
    if isinstance(tree, GroupParams):
        return GroupParams.place(tree.gather(), devices, shared=True, trainable=True)
    return _trainable(tree, devices[0])


class _Replicas:
    """Copies of the state's G and D params on the mesh's other local data
    rows (one device each, or a model group), refreshed from the state
    before each step."""

    def __init__(self) -> None:
        self._trees: Dict[Tuple[torch.device, ...], Tuple[Any, Any]] = {}

    def split(self, state: TrainingState, mesh: Any, batch: int) -> _Split:
        from gance_tpu_torch.parallel.mesh import process_rows, shard_rows

        master = state.pl_mean.device
        shards = []
        for devices, rows in shard_rows(mesh, batch):
            if devices[0] == master:
                shards.append(_Shard(master, rows, state.g_params, state.d_params))
                continue
            if devices not in self._trees:
                self._trees[devices] = (_copy_on(state.g_params, devices),
                                        _copy_on(state.d_params, devices))
            g, d = self._trees[devices]
            with torch.no_grad():
                for tree, source in ((g, state.g_params), (d, state.d_params)):
                    for copy, leaf in zip(_flat(tree), _flat(source)):
                        copy.copy_(leaf)
            shards.append(_Shard(devices[0], rows, g, d))
        if not shards:
            raise ValueError(f"a batch of {batch} leaves this process's data slots empty")
        return _Split(batch, shards, process_rows(mesh, batch), mesh.grouped)


def make_train_step(
    model_config: GeneratorConfig,
    train_config: TrainingConfig = TrainingConfig(),
    mesh: Optional[Any] = None,
) -> Callable[[TrainingState, Any, StepDraws], Tuple[TrainingState, Metrics]]:
    """
    The per-step trainer: (state, real images (B, R, R, 3) float in [-1, 1] on
    the state's device, the step's draws) -> (the same state, updated in
    place, and metrics d_loss, g_loss, r1, pl, pl_length as 0-d tensors).

    With `mesh` (a ('data', 'model') mesh; the state placed by
    `shard_training_state`), the global batch splits over the data axis:
    each local data row runs its rows with its copy of the params (over its
    model slots, tensor-parallel, when 'model' is above 1), the minibatch
    stddev and path length see the global batch, and gradients and metrics
    are summed over the rows and the process group, so a step equals the
    single-device step on the global batch. The reals are the
    global batch, or a process's rows of it (`distributed.global_batch`);
    the draws are the global batch's, the same on every process.
    """
    compute_dtype_of(train_config)
    replicas = _Replicas() if mesh is not None else None

    def train_step(state: TrainingState, reals: Any,
                   draws: StepDraws) -> Tuple[TrainingState, Metrics]:
        apply_r1 = state.step % train_config.r1_interval == 0
        apply_pl = train_config.pl_enabled and state.step % train_config.pl_interval == 0
        batch = draws.z1.shape[0]
        split = (replicas.split(state, mesh, batch) if replicas is not None
                 else _single_split(state.g_params, state.d_params, batch))
        if replicas is None and torch.is_tensor(reals):
            reals = reals.to(split.master)

        d_grads, d_metrics = d_step_gradients(state.g_params, state.d_params, reals, draws,
                                              apply_r1, model_config, train_config, split)
        _adam_step(state.d_opt_state, state.d_params, d_grads)
        del d_grads
        if replicas is not None:  # the G step runs against the updated D everywhere
            split = replicas.split(state, mesh, batch)

        g_grads, g_metrics = g_step_gradients(state.g_params, state.d_params, draws,
                                              state.pl_mean, apply_pl, model_config,
                                              train_config, split)
        _adam_step(state.g_opt_state, state.g_params, g_grads)
        del g_grads

        with torch.no_grad():
            if apply_pl:
                state.pl_mean = state.pl_mean + train_config.pl_decay * (
                    g_metrics["pl_length"] - state.pl_mean)
            # dlatent_avg ("w_avg"): no gradient; tracks the mean mapping output
            # of the global batch (this process's rows, summed over processes)
            w = mapping_apply(state.g_params, draws.z1g[split.local].to(split.master),
                              model_config)
            w_avg = _metric(w.sum(dim=0), split) / batch if split.multi_process else w.mean(dim=0)
            dlatent_avg = w_avg + (state.g_params["dlatent_avg"] - w_avg) * train_config.dlatent_avg_beta
            state.g_params["dlatent_avg"].copy_(dlatent_avg)
            beta = train_config.ema_beta
            for ema, new in zip(_flat(state.ema_params), _flat(state.g_params)):
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
    from gance_tpu_torch.parallel.distributed import GlobalRows

    train_step = make_train_step(model_config, train_config, mesh)

    def train_segment(state: TrainingState, reals_block: Any,
                      draws: Sequence[StepDraws]) -> Tuple[TrainingState, Metrics]:
        if len(draws) != len(reals_block):
            raise ValueError(f"{len(reals_block)} batches of reals but {len(draws)} draws")
        if isinstance(reals_block, GlobalRows):  # a process's rows (global_scan_block)
            block: Sequence[Any] = [reals_block.step(s) for s in range(len(reals_block))]
        else:
            if not isinstance(reals_block, torch.Tensor):
                reals_block = torch.from_numpy(np.ascontiguousarray(reals_block, np.float32))
            block = reals_block.to(state.pl_mean.device, torch.float32)
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


def shard_training_state(
    mesh: Any,
    state: TrainingState,
    train_config: TrainingConfig = TrainingConfig(),
) -> TrainingState:
    """
    Place a training state for `make_train_step(mesh=)` (JAX's
    `shard_training_state`): on the first local data row (its device, or
    with a 'model' axis above 1 its model slots, G, D, their Adam moments
    and the EMA sharded alike), and, across processes, process 0's values
    everywhere (params, EMA, Adam moments, step and pl_mean), so that
    processes that loaded different checkpoints, or none, start from one
    state. Collective across processes. The other local data rows get their
    copies of G and D at each step.
    """
    from gance_tpu_torch.parallel.mesh import broadcast_, local_row_groups

    devices = local_row_groups(mesh)[0]
    device = devices[0]
    blob = {
        "g_params": tree_to_numpy(state.g_params), "d_params": tree_to_numpy(state.d_params),
        "ema_params": tree_to_numpy(state.ema_params),
        "g_adam": _adam_to_numpy(state.g_opt_state, state.g_params),
        "d_adam": _adam_to_numpy(state.d_opt_state, state.d_params),
    }
    placed = training_state_from_arrays(
        blob["g_params"], blob["d_params"], blob["ema_params"], state.step, float(state.pl_mean),
        blob["g_adam"], blob["d_adam"], train_config, device, model_devices=devices)
    if not mesh.grouped:
        return placed
    with torch.no_grad():
        for tree in (placed.g_params, placed.d_params, placed.ema_params):
            for leaf in _flat(tree):
                broadcast_(leaf.data)
        for opt in (placed.g_opt_state, placed.d_opt_state):
            for moments in opt.state.values():
                broadcast_(moments["exp_avg"])
                broadcast_(moments["exp_avg_sq"])
        count = blob["g_adam"]["count"]
        scalars = torch.tensor([float(placed.step), float(placed.pl_mean), float(count)],
                               dtype=torch.float64, device=device)
        broadcast_(scalars)
    placed.step, placed.pl_mean = int(scalars[0]), scalars[1].float().clone()
    for opt in (placed.g_opt_state, placed.d_opt_state):
        for moments in opt.state.values():
            moments["step"] = torch.tensor(float(scalars[2]), dtype=torch.float32)
    return placed


def save_checkpoint(path: Path, state: TrainingState) -> None:
    """Write the state as numpy trees to `path` + '.tmp', then rename it over
    `path`, so a crash mid-write leaves the previous checkpoint whole. In a
    group of several processes only process 0 writes (every process holds
    the whole state; a model group's blocks are gathered into whole
    leaves, so the checkpoint loads on one device or any mesh)."""
    from gance_tpu_torch.parallel.distributed import is_coordinator

    if not is_coordinator():
        return
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
    mesh: Optional[Any] = None,
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

    With `mesh` the steps run data-parallel over its data axis
    (`make_train_step(mesh=)`), the state on the mesh's first device. Across
    processes `batch_size` is per process, as in JAX's CLI: each process
    trains on its dataset shard's batches as its rows of the global batch of
    batch_size x processes, the draws are the global batch's, process 0's
    state is everyone's start, and only process 0 writes files.
    """
    from gance_tpu_torch.models.pickle_loader import save_generator_pickle
    from gance_tpu_torch.utils.logging import LOGGER

    if scan_segment < 1:
        raise ValueError(f"scan_segment must be at least 1, got {scan_segment}")
    from gance_tpu_torch.parallel.distributed import global_scan_block, is_coordinator

    device = resolve_device(device) if mesh is None else mesh.first_device
    ckpt = Path(checkpoint_path)
    if ckpt.exists():
        state = load_checkpoint(ckpt, train_config, device)
        LOGGER.info("Resumed from %s at step %d", ckpt, state.step)
    else:
        state = init_training_state(seed, model_config, train_config, device)
    global_size = batch_size
    if mesh is not None:
        state = shard_training_state(mesh, state, train_config)
        global_size = batch_size * mesh.process_count
        LOGGER.info("Training over mesh %s, global batch %d", mesh.shape, global_size)
    train_segment = make_train_scan(model_config, train_config, mesh)
    pending: List[Tuple[int, np.ndarray]] = []
    for step, reals in dataset.batches(state.step, total_steps, batch_size):
        pending.append((step, np.asarray(reals)))
        boundary = (step + 1) % checkpoint_every == 0 or step + 1 == total_steps
        if len(pending) < scan_segment and not boundary:
            continue
        if before_step is not None:
            before_step(pending[0][0])
        draws = [draw_step(seed, s, global_size, model_config, train_config, device)
                 for s, _ in pending]
        block = np.stack([r for _, r in pending])
        if mesh is not None:
            block = global_scan_block(mesh, block)
        state, stacked = train_segment(state, block, draws)
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
    if output_network is not None and is_coordinator():
        save_generator_pickle(tree_to_numpy(state.ema_params), Path(output_network))
        LOGGER.info("Wrote EMA generator to %s", output_network)
    return state
