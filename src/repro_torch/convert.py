"""Move parameter trees between the JAX package and the port.

The two frameworks draw different numbers from the same seed, so parity
between them comes from moved weights: a JAX parameter tree turned into
numpy (``jax.tree.map(np.asarray, params)``) goes through
:func:`params_from_jax` and into ``StreamModel.load_params``. Neither
function imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy"]


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree):
    """Nested dict of numpy arrays (JAX layout) -> same nesting of CPU
    tensors, dtypes kept (``StreamModel.load_params`` moves them to the
    model's device)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return _to_torch(tree)


def params_to_numpy(tree):
    """Nested dict of tensors -> numpy. bfloat16 comes back as float32
    (numpy has no bfloat16; the JAX checkpoint stores it the same way)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
