"""Stage data carried across between the JAX package and the port.

The JAX package holds field elements as numpy/JAX uint32 arrays of 24
16-bit limbs (last axis), Montgomery form where its stages do; the port
holds the same limbs in int64 torch tensors (limbs.py). An Fq2 is
(..., 2, 24), an Fq12 (2, 3, 2, 24). These helpers convert nested
tuples/lists of such arrays leaf by leaf, so identical stage inputs can be
fed to both packages and their outputs compared bit for bit. Boolean
arrays stay boolean; other integer arrays (masks, bits) become int64.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(x, device="cpu"):
    """numpy/array-like (or nested tuples/lists of them) -> torch on device."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_torch(e, device) for e in x)
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a.astype(np.int64), device=device)


def to_numpy(x):
    """torch (or nested tuples/lists) -> numpy: bool stays bool, integer
    tensors become the reference's uint32."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(e) for e in x)
    t = x.detach().cpu()
    if t.dtype == torch.bool:
        return t.numpy()
    return t.numpy().astype(np.uint32)


def fixed_base_tables(tables, device="cpu"):
    """The JAX package's FixedBaseMSM comb tables (its `_tables`: three (16
    n, 24) uint32 arrays of 16-bit limbs, Montgomery Jacobian, row j holding
    2^(16 j) P_i) -> the port's (tx, ty, tz), int64 tensors on `device`, the
    layout kernels.msm_precompute returns."""
    return tuple(to_torch(np.asarray(t), device) for t in tables)
