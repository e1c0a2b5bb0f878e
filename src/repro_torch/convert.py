"""Carry sampler / service state between the reference package and the port.

The reference ``MultiSampler.state_dict()`` (and ``StreamStatsService``'s,
which adds ``exact_ok``) is a flat dict of numpy arrays.  Randomness comes
only from ``(salt, key, eid)`` hashing, so a state carried across continues
the stream exactly where the other package left it: this takes the place of
carrying weights across.
"""
from __future__ import annotations

import numpy as np
import torch

# leaf name -> (numpy dtype, torch dtype), in the reference's order
_LEAVES = {
    "keys": (np.int32, torch.int32),
    "counts": (np.float32, torch.float32),
    "kb": (np.float32, torch.float32),
    "seed": (np.float32, torch.float32),
    "tau": (np.float32, torch.float32),
    "step": (np.int32, torch.int32),
    "overflow": (np.int32, torch.int32),
    "bk_keys": (np.int32, torch.int32),
    "bk_seeds": (np.float32, torch.float32),
    "n_seen": (np.int32, torch.int32),
    "n_real": (np.int64, torch.int64),
    "ls": (np.float32, torch.float32),
    "salt": (np.uint32, torch.uint32),
    "rem_keys": (np.int32, torch.int32),
    "rem_weights": (np.float32, torch.float32),
    "rem_len": (np.int32, torch.int32),
    "exact_ok": (np.bool_, torch.bool),
}
SAMPLER_LEAVES = tuple(name for name in _LEAVES if name != "exact_ok")


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def state_from_reference(d: dict, *, device) -> dict[str, torch.Tensor]:
    """A reference state dict (numpy arrays, or this package's tensors) as
    this package's: tensors on ``device`` with the reference's dtypes."""
    unknown = set(d) - set(_LEAVES)
    if unknown:
        raise KeyError(f"unknown state leaves {sorted(unknown)}")
    out = {}
    for name, v in d.items():
        np_dtype, torch_dtype = _LEAVES[name]
        a = _host(v)
        if a.dtype != np_dtype:
            raise TypeError(f"state leaf {name!r} is {a.dtype}, expected "
                            f"{np.dtype(np_dtype)}")
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return out


def state_to_reference(d: dict) -> dict[str, np.ndarray]:
    """This package's state dict as the reference's: numpy arrays."""
    return {name: _host(v) for name, v in d.items()}
