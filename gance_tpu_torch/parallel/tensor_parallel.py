"""
Tensor parallelism over a mesh's 'model' axis: what GSPMD does for
gance_tpu's `P(..., 'model')` param shardings (gance_tpu/parallel/mesh.py),
with the collectives placed by hand.

A data row's model slots hold a `GroupParams`: each slot's tree carries its
block of every sharded leaf (`parallel/mesh.py::shard_dim`: the output
channels of the large `weight`s, in contiguous blocks of ceil(C / model)) and
the replicated leaves whole. It is a `models/stylegan2.py::Layers`, so the
model's own forwards (`mapping_apply`, `synthesis_apply`,
`discriminator_features`, `discriminator_head`) run over it, and it runs
each layer column-parallel:

  * a sharded layer takes its whole input on every slot (`x.to(slot)`), each
    slot computes its block of output channels on its own device:
    modulation with the whole style, demodulation per output channel from
    its own weight block (exact and local), then the layer's epilogue on its
    channels (kernel A with the bias block and the shared noise plane, and
    on `Conv0_up` kernel C), and the blocks are gathered back along channels
    on the lead slot (`torch.cat` of `.to(lead)`);
  * a replicated layer runs once, on the lead slot, and so does everything
    between layers: every ToRGB and kernel B in the skip chain, the top
    `Conv1` or kernel E on the phase path, the mbstd and the
    discriminator's down blurs (kernel D, once per blurred input; each slot
    then convolves the blurred input with its block).

The kernels launch on their tensors' device (`ops/cuda/fused_ops.py`), so no
slot needs its device made current. Both moves are differentiable, so
autograd gives a sharded leaf's gradient on its slot and a replicated leaf's
on the lead, summed over the slots, when the replicated leaves live on the
lead only (`GroupParams.place(shared=True)`, the trainer's placement). For
inference each distinct device keeps its own copy of the replicated leaves,
so a call moves only activations.

On the phase path (`ops/phase_block.py`) each slot folds its own `Conv0_up`
block into a phase conv and runs the per-phase epilogue on its channels; the
blocks are gathered within each phase, back into the ph * C + c layout that
kernel E's operands expect.
"""

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gance_tpu_torch.models.stylegan2 import Layers
from gance_tpu_torch.parallel.mesh import param_spec, shard_slices

Params = Dict[str, Any]
Path = Tuple[str, ...]


def _get(tree: Params, path: Path) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def _paths(spec: Params, prefix: Path = ()) -> Iterator[Tuple[Path, Optional[int]]]:
    """Every leaf's path and shard dim, in sorted key order at each level
    (the order of `parallel/training.py::tree_leaves`)."""
    for key in sorted(spec):
        value = spec[key]
        if isinstance(value, dict):
            yield from _paths(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _set(tree: Params, path: Path, value: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _whole_tensor(value: Any) -> torch.Tensor:
    if torch.is_tensor(value):
        return value.detach()
    return torch.from_numpy(np.array(value, dtype=np.float32))


def _leaf(value: torch.Tensor, device: torch.device, trainable: bool) -> torch.Tensor:
    leaf = value.contiguous().to(device=device, dtype=torch.float32, copy=True)
    return leaf.requires_grad_(trainable)


class GroupParams(Layers):
    """
    A params tree over the model slots of one data row (`devices`, lead
    first): `slots[m]` is slot m's tree, with its block of each sharded leaf
    on `devices[m]` and the replicated leaves whole. `spec` is the tree of
    `shard_dim`. Indexing (`group["dlatent_avg"]`) reads the lead's tree.
    """

    def __init__(self, devices: Sequence[torch.device], slots: List[Params], spec: Params) -> None:
        super().__init__(slots[0])
        self.devices = tuple(devices)
        self.slots = slots
        self.spec = spec

    @classmethod
    def place(cls, params: Params, devices: Sequence[Any], shared: bool = False,
              trainable: bool = False) -> "GroupParams":
        """
        Whole `params` (numpy arrays or tensors) over `devices`: each
        sharded leaf split into ceil(C / model) blocks, block m on
        devices[m]; each replicated leaf copied once to each distinct device,
        or with `shared` once to the lead and named by every slot's tree (the
        trainer's placement, for which autograd sums a replicated leaf's
        gradient on the lead). `trainable` makes every leaf require grad.
        """
        devices = tuple(torch.device(d) for d in devices)
        spec = param_spec(params)
        slots: List[Params] = [{} for _ in devices]
        for path, dim in _paths(spec):
            whole = _whole_tensor(_get(params, path))
            if dim is None:
                copies: Dict[torch.device, torch.Tensor] = {}
                for m, device in enumerate(devices):
                    home = devices[0] if shared else device
                    if home not in copies:
                        copies[home] = _leaf(whole, home, trainable)
                    _set(slots[m], path, copies[home])
                continue
            for m, piece in enumerate(shard_slices(whole.shape[dim], len(devices))):
                block = whole.narrow(dim, piece.start, piece.stop - piece.start)
                _set(slots[m], path, _leaf(block, devices[m], trainable))
        return cls(devices, slots, spec)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def flat(self) -> List[torch.Tensor]:
        """Each distinct leaf once, in a fixed order: per path (sorted), the
        blocks of a sharded leaf in slot order, else the lead's leaf."""
        out = []
        for path, dim in _paths(self.spec):
            if dim is None:
                out.append(_get(self.slots[0], path))
            else:
                out.extend(_get(slot, path) for slot in self.slots)
        return out

    def flat_arrays(self, tree: Params) -> List[np.ndarray]:
        """A tree of whole arrays (such as Adam moments) laid out as `flat()`."""
        out = []
        for path, dim in _paths(self.spec):
            value = np.asarray(_get(tree, path), np.float32)
            if dim is None:
                out.append(value)
                continue
            for m, slot in enumerate(self.slots):
                width = _get(slot, path).shape[dim]
                start = sum(_get(s, path).shape[dim] for s in self.slots[:m])
                out.append(np.take(value, np.arange(start, start + width), axis=dim))
        return out

    def whole(self, arrays: Sequence[np.ndarray]) -> Params:
        """The inverse of `flat_arrays`: arrays laid out as `flat()` -> a tree
        of whole arrays, the blocks concatenated."""
        tree: Params = {}
        arrays = list(arrays)
        i = 0
        for path, dim in _paths(self.spec):
            if dim is None:
                _set(tree, path, arrays[i])
                i += 1
            else:
                _set(tree, path, np.concatenate(arrays[i:i + len(self.slots)], axis=dim))
                i += len(self.slots)
        return tree

    def gather(self) -> Params:
        """Whole leaves on the host (numpy), for checkpoints and tests."""
        return self.whole([t.detach().cpu().numpy().copy() for t in self.flat()])

    def run(self, path: Path, fn: Callable[..., torch.Tensor], x: torch.Tensor,
            *extras: Optional[torch.Tensor], phase_channels: bool = False) -> torch.Tensor:
        """
        Layer `path` on x: `fn(layer, x, *extras)`. A replicated layer runs
        once on the lead slot. A sharded one runs on every slot with a
        non-empty block, on the whole x and extras moved there and the
        slot's layer params (its weight block, its block of the output
        `bias`, the other leaves whole); the blocks come back to the lead
        and are gathered along channels (within each phase where
        `phase_channels`).
        """
        dim = _get(self.spec, path).get("weight")
        if dim is None:
            return fn(_get(self.slots[0], path), x, *extras)
        blocks = []
        start = 0
        for slot, device in zip(self.slots, self.devices):
            layer = _get(slot, path)
            stop = start + layer["weight"].shape[dim]
            if stop > start:
                args = {name: (leaf[start:stop] if name == "bias" else leaf).to(device)
                        for name, leaf in layer.items()}
                y = fn(args, x.to(device), *(_at(e, device) for e in extras))
                blocks.append(y.to(self.lead))
            start = stop
        return (_cat_phase_channels if phase_channels else _cat_channels)(blocks)

    def layer(self, path: Path) -> Params:
        """Layer `path`'s params whole on the lead (a sharded weight's blocks
        gathered there): for a layer that runs on the lead alone."""
        layer = dict(_get(self.slots[0], path))
        dim = _get(self.spec, path).get("weight")
        if dim is not None:
            layer["weight"] = torch.cat([_get(slot, path)["weight"].to(self.lead)
                                         for slot in self.slots], dim=dim)
        return layer


def _at(value: Optional[torch.Tensor], device: torch.device) -> Optional[torch.Tensor]:
    return None if value is None else value.to(device)


def _cat_channels(blocks: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat(blocks, dim=1)


def _cat_phase_channels(blocks: List[torch.Tensor]) -> torch.Tensor:
    """Phase planes (B, 4*c_m, h, w), channel ph*c_m + c, of each slot's
    block -> (B, 4*C, h, w) with channel ph*C + c: gathered within each phase."""
    split = [b.reshape(b.shape[0], 4, b.shape[1] // 4, *b.shape[2:]) for b in blocks]
    return torch.cat(split, dim=2).flatten(1, 2)
