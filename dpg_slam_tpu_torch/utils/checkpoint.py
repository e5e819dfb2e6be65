"""Engine state from and to flat numpy dicts — how state crosses between
the JAX package and the port.

A checkpoint (dpg_slam_tpu/utils/checkpoint.py's format) is a directory
with ``config.json`` and ``state.npz``, the SlamState flattened to keys
such as ``"poses"`` and ``"graph/edge_idx"``. The port writes the same
files and reads the JAX package's unchanged, so checkpoints load in both
directions.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from dpg_slam_tpu_torch.config import DpgConfig

__all__ = ["state_from_numpy", "state_to_numpy", "save_checkpoint", "load_checkpoint"]

_STATE_FILE = "state.npz"
_CONFIG_FILE = "config.json"


def _flat_items(obj, prefix=""):
    """(key, tensor) pairs of a NamedTuple tree, keys joined with '/'."""
    for name in obj._fields:
        child = getattr(obj, name)
        if hasattr(child, "_fields"):
            yield from _flat_items(child, f"{prefix}{name}/")
        else:
            yield f"{prefix}{name}", child


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """Flatten a SlamState to the checkpoint's flat key -> array dict."""
    return {k: v.detach().cpu().numpy() for k, v in _flat_items(state)}


def state_from_numpy(flat: dict[str, np.ndarray], config: DpgConfig, device="cuda", lanes: int | None = None):
    """Build a SlamState on `device` from a flat checkpoint dict. Fields the
    dict lacks keep their initial values; shapes must match the config.
    With `lanes`, every field carries a leading lane axis of that size (a
    stacked state of the session-batched mode)."""
    from dpg_slam_tpu_torch.engine import _init_state

    lead = () if lanes is None else (lanes,)

    def rebuild(obj, prefix=""):
        vals = {}
        for name in obj._fields:
            child = getattr(obj, name)
            key = f"{prefix}{name}"
            if hasattr(child, "_fields"):
                vals[name] = rebuild(child, key + "/")
            elif key in flat:
                arr = np.asarray(flat[key])
                if arr.shape != lead + tuple(child.shape):
                    raise ValueError(
                        f"checkpoint field {key} has shape {arr.shape}, "
                        f"config expects {lead + tuple(child.shape)}"
                    )
                vals[name] = torch.tensor(arr, device=device).to(child.dtype)  # a copy
            else:
                vals[name] = child.expand(lead + tuple(child.shape)).clone()
        return type(obj)(**vals)

    return rebuild(_init_state(config, device))


def save_checkpoint(path: str | pathlib.Path, engine) -> None:
    """Persist an engine session: state.npz (the flat state, compressed,
    written to a temporary file and renamed into place) and config.json."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (_STATE_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **state_to_numpy(engine.state))
    tmp.replace(path / _STATE_FILE)
    (path / _CONFIG_FILE).write_text(engine.config.to_json())


def load_checkpoint(path: str | pathlib.Path, device="cuda"):
    """Restore an engine on `device` (the card unless the caller names
    another) from a checkpoint directory (config.json + state.npz, as the
    JAX package writes them)."""
    from dpg_slam_tpu_torch.engine import DpgSlamEngine

    path = pathlib.Path(path)
    config = DpgConfig.from_json((path / _CONFIG_FILE).read_text())
    engine = DpgSlamEngine(config, device)
    with np.load(path / _STATE_FILE, allow_pickle=False) as stored:
        engine.state = state_from_numpy(dict(stored), config, engine.device)
    return engine
