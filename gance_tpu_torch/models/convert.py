"""
Carry weights and training state over from gance_tpu's trees to the port's.

gance_tpu keeps activations NHWC and conv weights HWIO, moves the TF pickle's
const and noise buffers to NHWC, and permutes the rows of the discriminator's
4x4/Dense0 weight to NHWC order. `params_from_reference` and
`discriminator_params_from_reference` take those trees, as numpy arrays, and
return the port's (OIHW conv weights, NCHW buffers, Dense0 in the pickle's
NCHW row order), so that both packages compute the same function.
`training_state_from_reference` carries a whole JAX `TrainingState`.
"""

from typing import Any, Dict, Union

import numpy as np

Params = Dict[str, Any]


def _synthesis_from_reference(tree: Params) -> Params:
    out: Params = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _synthesis_from_reference(value)
            continue
        value = np.asarray(value, dtype=np.float32)
        if key == "weight" and value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif value.ndim == 4 and (key == "const" or key.startswith("noise")):
            value = value.transpose(0, 3, 1, 2)  # NHWC -> NCHW
        out[key] = value.copy()  # C-contiguous; keeps 0-d strengths 0-d
    return out


def params_from_reference(tree: Params) -> Params:
    """gance_tpu generator params (numpy, NHWC/HWIO) -> the port's params."""
    return {
        "mapping": {
            name: {k: np.asarray(v, dtype=np.float32) for k, v in layer.items()}
            for name, layer in tree["mapping"].items()
        },
        "synthesis": _synthesis_from_reference(tree["synthesis"]),
        "dlatent_avg": np.asarray(tree["dlatent_avg"], dtype=np.float32),
    }


def discriminator_params_from_reference(tree: Params) -> Params:
    """gance_tpu discriminator params (numpy, HWIO, Dense0 rows in NHWC
    order) -> the port's (OIHW, Dense0 rows in the pickle's NCHW order)."""
    out: Params = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = discriminator_params_from_reference(value)
            continue
        value = np.asarray(value, dtype=np.float32)
        if key == "weight" and value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[key] = value.copy()
    dense0 = out.get("4x4", {}).get("Dense0")
    if dense0 is not None:
        fan_in, fan_out = dense0["weight"].shape
        c = fan_in // 16
        dense0["weight"] = np.ascontiguousarray(  # rows (h, w, c) -> (c, h, w)
            dense0["weight"].reshape(4, 4, c, fan_out).transpose(2, 0, 1, 3).reshape(fan_in, fan_out)
        )
    return out


def training_state_from_reference(state: Any, train_config: Any = None,
                                  device: Union[str, Any] = "cuda") -> Any:
    """
    A gance_tpu `TrainingState` as numpy (`jax.tree.map(np.asarray, state)`)
    -> the port's `TrainingState` on `device`: G, D and EMA params, optax's
    `ScaleByAdamState(count, mu, nu)` as each optimizer's moments and step
    count, `step` and `pl_mean`.
    """
    from gance_tpu_torch.parallel import training

    def adam(opt_state: Any, convert: Any) -> Dict[str, Any]:
        scale = next(s for s in opt_state if hasattr(s, "mu"))
        return {"count": int(np.asarray(scale.count)), "mu": convert(scale.mu),
                "nu": convert(scale.nu)}

    return training.training_state_from_arrays(
        params_from_reference(state.g_params),
        discriminator_params_from_reference(state.d_params),
        params_from_reference(state.ema_params),
        step=int(np.asarray(state.step)),
        pl_mean=float(np.asarray(state.pl_mean)),
        g_adam=adam(state.g_opt_state, params_from_reference),
        d_adam=adam(state.d_opt_state, discriminator_params_from_reference),
        train_config=train_config or training.TrainingConfig(),
        device=device,
    )
