"""Saving and loading an :class:`~chomp_tpu_torch.emulator.Emulator`.

The file is the JAX package's ``utils.io.save_pytree`` npz of its
``Emulator``: the leaves ``leaf_0 ...`` in the pytree's order (each
layer's w then b, head last, then x_mu, x_sd, y_mu, basis, c_sd) and a
``__treedef__`` text kept for provenance.  So either package reads the
other's files (the JAX package's ``load_pytree`` with a template
emulator of the same layer count).
"""

from __future__ import annotations

import numpy as np
import torch

_TAIL = ("x_mu", "x_sd", "y_mu", "basis", "c_sd")


def save_emulator(path, emu) -> None:
    """Write ``emu`` to the npz file ``path`` (float64 leaves)."""
    leaves = [t for wb in emu.weights for t in wb]
    leaves += [getattr(emu, name) for name in _TAIL]
    tree = f"Emulator(n_layers={len(emu.weights)})"
    np.savez(path, __treedef__=np.frombuffer(tree.encode(), dtype=np.uint8),
             **{f"leaf_{i}": t.detach().cpu().numpy()
                for i, t in enumerate(leaves)})


def load_emulator(path, *, device, dtype):
    """The :class:`Emulator` in ``path`` (written by :func:`save_emulator`
    or the JAX package's ``save_pytree``), on ``device`` in ``dtype``."""
    from chomp_tpu_torch.emulator import Emulator

    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = [torch.as_tensor(data[f"leaf_{i}"], dtype=dtype,
                                  device=device) for i in range(n)]
    n_w = n - len(_TAIL)
    if n_w < 2 or n_w % 2:
        raise ValueError(f"{path}: {n} leaves are not an Emulator's")
    weights = list(zip(leaves[:n_w:2], leaves[1:n_w:2]))
    return Emulator(weights, *leaves[n_w:])
