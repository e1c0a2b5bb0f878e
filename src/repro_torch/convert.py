"""Carry state and weights between the reference package and the port.

The reference ``MultiSampler.state_dict()`` (and ``StreamStatsService``'s,
which adds ``exact_ok``) is a flat dict of numpy arrays.  Randomness comes
only from ``(salt, key, eid)`` hashing, so a state carried across continues
the stream exactly where the other package left it.

A transformer's parameters are the reference ``init_params`` tree (nested
dicts, layer leaves stacked on [L, ...]) with numpy leaves; bf16 leaves are
numpy's ``bfloat16`` extension type on the reference side and travel as
their 16-bit patterns.  A recsys model's are the reference's ``*_init``
tree: dicts, MLPs as lists of ``{"w", "b"}``, BST's ``blocks`` stacked on
[n_blocks, ...].
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


def _tensor_from_np(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bit pattern
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _np_from_tensor(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the reference side's bf16 numpy type

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _check_tree(tree, shapes, where="params"):
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise KeyError(f"{where}: expected keys {sorted(shapes)}, got {got}")
        for k in shapes:
            _check_tree(tree[k], shapes[k], f"{where}.{k}")
    elif isinstance(shapes, list):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(shapes):
            got = len(tree) if isinstance(tree, (list, tuple)) else type(tree).__name__
            raise KeyError(f"{where}: expected a list of {len(shapes)}, got {got}")
        for i, (t, sh) in enumerate(zip(tree, shapes)):
            _check_tree(t, sh, f"{where}[{i}]")
    elif tuple(tree.shape) != tuple(shapes):
        raise ValueError(f"{where}: shape {tuple(tree.shape)}, expected {tuple(shapes)}")


def transformer_params_from_reference(np_tree: dict, cfg, device) -> dict:
    """The reference transformer's ``init_params`` tree (numpy leaves) as
    the port's parameters: tensors on ``device`` in ``cfg.dtype``, the same
    tree and shapes."""
    # imported here: the model imports core.incremental, which imports this module
    from .models.transformer import param_shapes

    return _params_from_reference(np_tree, param_shapes(cfg), cfg.dtype, device)


def _params_from_reference(np_tree, shapes, dtype, device) -> dict:
    from .models.transformer import tree_map

    _check_tree(np_tree, shapes)
    return tree_map(lambda a: _tensor_from_np(np.asarray(a), device).to(dtype), np_tree)


def transformer_params_to_reference(params: dict) -> dict:
    """The port's transformer parameters as the reference's tree of numpy
    arrays (bf16 as numpy's ``bfloat16``)."""
    from .models.transformer import tree_map

    return tree_map(_np_from_tensor, params)


def recsys_params_from_reference(np_tree: dict, arch: str, cfg, device) -> dict:
    """A reference recsys model's ``*_init`` tree (numpy leaves) for ``arch``
    (``two-tower-retrieval``, ``din``, ``bst`` or ``mind``) as the port's
    parameters: tensors on ``device`` in ``cfg.dtype``, the same tree and
    shapes."""
    from .models.recsys import ARCHS

    return _params_from_reference(np_tree, ARCHS[arch][0](cfg), cfg.dtype, device)


# the port's recsys parameters as the reference's tree of numpy arrays
recsys_params_to_reference = transformer_params_to_reference
