"""
Read and write NVlabs StyleGAN2 `.pkl` network pickles without TF.

A capture-only unpickler intercepts `dnnlib.tflib.network.Network` and records
its state dict (version, name, static_kwargs, components, variables) instead
of running the embedded network source. The variables are re-keyed into the
port's params tree. The files are the same TF-format pickles that
gance_tpu/models/pickle_loader.py reads and writes, so a pickle written by
either package loads in the other.

Layout conversions (TF -> port), for the generator and the discriminator:
  * conv weights: (kh, kw, in, out) HWIO -> (out, in, kh, kw) OIHW.
  * 4x4/Const/const (1, C, 4, 4) and noise buffers (1, 1, H, W): kept as TF
    stores them (they are already NCHW).
  * dense / style-affine weights, biases, dlatent_avg, noise_strength: as-is
    (the discriminator's 4x4/Dense0 too: the port flattens NCHW, as TF does).

The unpickler admits only numpy scalar/array reconstruction, a few builtin
containers and the captured dnnlib classes; any other global raises.
"""

import io
import json
import pickle
import sys
import types
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from gance_tpu_torch.models.stylegan2 import GeneratorConfig, config_from_params
from gance_tpu_torch.utils.logging import LOGGER

NETWORK_SUFFIX = ".pkl"


class EasyDict(dict):
    """Mirror of dnnlib.EasyDict: a dict with attribute access (capture-only)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


class CapturedNetwork:
    """Stand-in for dnnlib.tflib.network.Network that records its pickled state."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        self.state: Dict[str, Any] = {}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.state = dict(state)

    @property
    def name(self) -> str:
        return str(self.state.get("name", ""))

    @property
    def variables(self) -> Dict[str, np.ndarray]:
        return {name: np.asarray(value) for name, value in self.state.get("variables", [])}

    @property
    def components(self) -> Dict[str, "CapturedNetwork"]:
        return dict(self.state.get("components", {}) or {})


_ALLOWED_GLOBALS = {
    ("collections", "OrderedDict"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("builtins", "set"),
    ("builtins", "frozenset"),
    ("builtins", "complex"),
    ("builtins", "bytearray"),
    ("_codecs", "encode"),  # numpy array byte payloads under protocol 2
}


class _CaptureUnpickler(pickle.Unpickler):
    """Unpickler admitting only numpy data + the captured dnnlib surface."""

    def find_class(self, module: str, name: str) -> Any:
        if module.startswith("dnnlib"):
            # Network -> captured state; EasyDict and unknown helpers -> inert dict
            return CapturedNetwork if name == "Network" else EasyDict
        if (module, name) in _ALLOWED_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"Blocked global during network unpickling: {module}.{name}"
        )


@dataclass
class LoadedNetworks:
    """The (G, D, Gs) triple as captured state (any element may be None)."""

    generator: Optional[CapturedNetwork]
    discriminator: Optional[CapturedNetwork]
    generator_ema: Optional[CapturedNetwork]


def read_network_pickle(path: Path) -> LoadedNetworks:
    """Read an NVlabs-format pickle: a (G, D, Gs) triple or a bare network."""
    with open(str(path), "rb") as infile:
        obj = _CaptureUnpickler(infile).load()
    if isinstance(obj, CapturedNetwork):
        return LoadedNetworks(None, None, obj)
    if isinstance(obj, (tuple, list)):
        nets = list(obj) + [None] * (3 - len(obj))
        return LoadedNetworks(nets[0], nets[1], nets[2])
    raise ValueError(f"Unrecognized network pickle structure in {path}: {type(obj)}")


def _nested_set(tree: Dict[str, Any], dotted: str, value: np.ndarray) -> None:
    parts = dotted.split("/")
    node = tree
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def generator_params_from_captured(gs: CapturedNetwork) -> Dict[str, Any]:
    """Convert a captured Gs network (mapping + synthesis) into the port's params."""
    components = gs.components
    if "mapping" not in components or "synthesis" not in components:
        raise ValueError(
            f"Network '{gs.name}' lacks mapping/synthesis components; found {list(components)}"
        )
    params: Dict[str, Any] = {"mapping": {}, "synthesis": {"noise": {}}}
    for name, value in gs.variables.items():
        if name == "dlatent_avg":
            params["dlatent_avg"] = value.astype(np.float32).reshape(-1)
        else:
            LOGGER.debug("Ignoring top-level generator variable %s %s", name, value.shape)
    for name, value in components["mapping"].variables.items():
        _nested_set(params["mapping"], name, value.astype(np.float32))
    for name, value in components["synthesis"].variables.items():
        value = value.astype(np.float32)
        if name.startswith("noise"):
            params["synthesis"]["noise"][name] = value  # (1, 1, H, W) as stored
        elif name.endswith("/weight") and value.ndim == 4:
            _nested_set(params["synthesis"], name, np.ascontiguousarray(value.transpose(3, 2, 0, 1)))
        else:
            _nested_set(params["synthesis"], name, value)
    if "dlatent_avg" not in params:
        w_dim = params["synthesis"]["4x4"]["Conv"]["mod_weight"].shape[0]
        LOGGER.warning("Pickle lacks dlatent_avg; truncation will be a no-op.")
        params["dlatent_avg"] = np.zeros((w_dim,), np.float32)
    return params


def discriminator_params_from_captured(d: CapturedNetwork) -> Dict[str, Any]:
    """Convert a captured D network into the port's discriminator params."""
    params: Dict[str, Any] = {}
    for name, value in d.variables.items():
        value = value.astype(np.float32)
        if name.endswith("/weight") and value.ndim == 4:
            value = np.ascontiguousarray(value.transpose(3, 2, 0, 1))
        _nested_set(params, name, value)
    return params


def load_generator(path: Path) -> Tuple[Dict[str, Any], GeneratorConfig]:
    """Load the EMA generator (Gs, element 2 of the triple) as (params, config)."""
    nets = read_network_pickle(Path(path))
    gs = nets.generator_ema or nets.generator
    if gs is None:
        raise ValueError(f"No generator network found in {path}")
    params = generator_params_from_captured(gs)
    return params, config_from_params(params)


# ---------------------------------------------------------------------------
# port params -> TF-format pickle
# ---------------------------------------------------------------------------


def _flatten_tree(tree: Dict[str, Any], prefix: str = "") -> List[Tuple[str, np.ndarray]]:
    out: List[Tuple[str, np.ndarray]] = []
    for key, value in tree.items():
        dotted = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.extend(_flatten_tree(value, dotted))
        else:
            out.append((dotted, np.asarray(value)))
    return out


def captured_state_from_generator_params(
    params: Dict[str, Any], name: str = "Gs"
) -> Dict[str, Any]:
    """Build an NVlabs-format state dict (the inverse of the loader conversions)."""
    mapping_vars = _flatten_tree(params["mapping"])
    synthesis = params["synthesis"]
    synthesis_vars: List[Tuple[str, np.ndarray]] = []
    for dotted, value in _flatten_tree({k: v for k, v in synthesis.items() if k != "noise"}):
        if dotted.endswith("/weight") and value.ndim == 4:
            value = np.ascontiguousarray(value.transpose(2, 3, 1, 0))  # OIHW -> HWIO
        synthesis_vars.append((dotted, value))
    for noise_name, value in sorted(
        synthesis.get("noise", {}).items(), key=lambda kv: int(kv[0][5:])
    ):
        synthesis_vars.append((noise_name, np.asarray(value)))

    def network_state(net_name: str, variables: List[Tuple[str, np.ndarray]],
                      components: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        return {
            "version": 4,
            "name": net_name,
            "static_kwargs": {},
            "components": components or {},
            "build_module_src": "# gance_tpu interop pickle (no executable source)",
            "build_func_name": "gance_tpu_stub",
            "variables": [(n, np.asarray(v)) for n, v in variables],
        }

    mapping_net = CapturedNetwork()
    mapping_net.__setstate__(network_state("G_mapping", mapping_vars))
    synthesis_net = CapturedNetwork()
    synthesis_net.__setstate__(network_state("G_synthesis", synthesis_vars))
    top_vars = [("dlatent_avg", np.asarray(params["dlatent_avg"]))]
    return network_state(
        name, top_vars, components={"mapping": mapping_net, "synthesis": synthesis_net}
    )


class _PickleNetwork:
    """Pickles as dnnlib.tflib.network.Network carrying an NVlabs state dict."""

    __module__ = "dnnlib.tflib.network"
    __qualname__ = "Network"

    def __init__(self, state: Dict[str, Any]) -> None:
        self._state = state

    def __getstate__(self) -> Dict[str, Any]:
        return self._state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self._state = state


def _install_dnnlib_stub_modules() -> None:
    """
    Register stub `dnnlib` / `dnnlib.tflib` / `dnnlib.tflib.network` modules
    whose Network is `_PickleNetwork`, so pickling under the reference's class
    path succeeds. Where another package already registered them, only the
    Network attribute is replaced, for the duration of the dump.
    """
    network_mod = sys.modules.get("dnnlib.tflib.network")
    if network_mod is None:
        network_mod = types.ModuleType("dnnlib.tflib.network")
        sys.modules["dnnlib.tflib.network"] = network_mod
    tflib_mod = sys.modules.setdefault("dnnlib.tflib", types.ModuleType("dnnlib.tflib"))
    tflib_mod.network = network_mod  # type: ignore[attr-defined]
    dnnlib_mod = sys.modules.setdefault("dnnlib", types.ModuleType("dnnlib"))
    dnnlib_mod.tflib = tflib_mod  # type: ignore[attr-defined]
    if not hasattr(dnnlib_mod, "EasyDict"):
        dnnlib_mod.EasyDict = EasyDict  # type: ignore[attr-defined]


def save_generator_pickle(params: Dict[str, Any], path: Path) -> None:
    """
    Write port generator params (numpy arrays or tensors) as an NVlabs-format
    (G, D, Gs) triple whose class references resolve to
    dnnlib.tflib.network.Network.
    """
    _install_dnnlib_stub_modules()
    network_mod = sys.modules["dnnlib.tflib.network"]

    def to_numpy(tree: Any) -> Any:
        if isinstance(tree, dict):
            return {k: to_numpy(v) for k, v in tree.items()}
        if hasattr(tree, "detach"):  # a torch tensor
            return tree.detach().cpu().numpy()
        return np.asarray(tree)

    def wrap(state: Dict[str, Any]) -> _PickleNetwork:
        comps = {key: wrap(net.state) for key, net in (state.get("components") or {}).items()}
        return _PickleNetwork(dict(state, components=comps))

    gs = wrap(captured_state_from_generator_params(to_numpy(params)))
    buffer = io.BytesIO()
    saved = getattr(network_mod, "Network", None)
    network_mod.Network = _PickleNetwork  # type: ignore[attr-defined]
    try:
        pickle.Pickler(buffer, protocol=2).dump((gs, None, gs))  # reference reads [2]
    finally:
        if saved is not None:
            network_mod.Network = saved  # type: ignore[attr-defined]
    Path(path).write_bytes(buffer.getvalue())


# ---------------------------------------------------------------------------
# Network discovery
# ---------------------------------------------------------------------------


def sorted_networks_in_directory(directory: Path) -> List[Path]:
    """Alphanumeric sort of `*.pkl` in a directory."""
    return sorted(Path(directory).glob(f"*{NETWORK_SUFFIX}"))


def parse_network_paths(
    networks_directory: Optional[Path],
    network_paths: Optional[List[Path]],
    networks_json: Optional[Path],
) -> List[Path]:
    """Merge the three network sources: a directory (sorted), explicit paths and
    a JSON file {"networks": [paths...]}."""
    paths: List[Path] = []
    if networks_directory is not None:
        paths.extend(sorted_networks_in_directory(Path(networks_directory)))
    if network_paths:
        paths.extend(Path(p) for p in network_paths)
    if networks_json is not None:
        blob = json.loads(Path(networks_json).read_text())
        if not isinstance(blob, dict) or "networks" not in blob:
            raise ValueError(f"{networks_json} must contain a 'networks' list")
        for p in blob["networks"]:
            candidate = Path(p)
            if not candidate.is_file():
                raise ValueError(f"networks-json entry is not a file: {candidate}")
            paths.append(candidate)
    if not paths:
        raise ValueError("No networks given (directory, paths, or json required).")
    return paths
