"""Carry the JAX package's operator bundles into the port.

The solver has no learned weights; its "parameters" are the host-f64
operator bundles: ``SharedOperators`` (the shared affine enhancement map,
1D and 2D), ``VarCoeffOperators`` (the statics of the 1D per-element
kernel) and ``VarCoeff2DOperators`` (the operator parts of the 2D
per-element solve).  Their JAX counterparts are converted field by field,
through a dict of numpy arrays made with ``np.asarray`` on each field, e.g.

    arrays = {k: np.asarray(v) for k, v in jax_ops._asdict().items()
              if v is not None}
    ops = shared_operators_from_arrays(arrays, device="cuda")
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.hybrid2d import VarCoeff2DOperators
from ..ops.kernels import VarCoeffOperators
from ..ops.kkt import SharedOperators


def _tensors(cls, arrays, device, dtype):
    fields = {}
    for fld in dataclasses.fields(cls):
        if fld.name not in arrays or arrays[fld.name] is None:
            continue
        v = np.asarray(arrays[fld.name])
        fields[fld.name] = torch.tensor(v, dtype=dtype, device=device)
    return fields


def shared_operators_from_arrays(arrays: dict, device=None,
                                 dtype=torch.float32) -> SharedOperators:
    """``SharedOperators`` on ``device`` in ``dtype`` from numpy arrays
    keyed by field name (absent optional fields stay None).  The shared 2D
    bundle of ``prepare_shared_2d`` has the same fields (with K = 4M-4
    trace rows) and goes through this function too."""
    return SharedOperators(**_tensors(SharedOperators, arrays, device, dtype))


def varcoeff_operators_from_arrays(arrays: dict, device=None,
                                   dtype=torch.float32) -> VarCoeffOperators:
    """``VarCoeffOperators`` from numpy arrays keyed AZ, AP, Z, Pbc, B and
    the scalars K, s2."""
    fields = _tensors(VarCoeffOperators, arrays, device, dtype)
    fields = {k: v for k, v in fields.items() if k not in ("K", "s2")}
    return VarCoeffOperators(K=int(arrays["K"]), s2=float(arrays["s2"]),
                             **fields)


def varcoeff2d_operators_from_arrays(arrays: dict, device=None,
                                     dtype=torch.float32
                                     ) -> VarCoeff2DOperators:
    """``VarCoeff2DOperators`` from numpy arrays keyed by field name (Lap,
    Gx, Gy, Dconst, B, Z, Pbc, AZ, AP, NZ) and the scalars s2, n_terms."""
    fields = _tensors(VarCoeff2DOperators, arrays, device, dtype)
    fields = {k: v for k, v in fields.items() if k not in ("s2", "n_terms")}
    return VarCoeff2DOperators(s2=float(arrays["s2"]),
                               n_terms=int(arrays["n_terms"]), **fields)
