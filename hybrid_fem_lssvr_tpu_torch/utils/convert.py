"""Carry the JAX package's operator bundles into the port.

The solver has no learned weights; its "parameters" are the host-f64
operator bundles: ``SharedOperators`` (the shared affine enhancement map,
1D, 2D and 3D), ``VarCoeffOperators`` (the statics of the 1D per-element
kernel), ``VarCoeff2DOperators`` and ``VarCoeff3DOperators`` (the operator
parts of the 2D and 3D per-element solves) and ``Graded2DOperators`` and
``Graded3DOperators`` (the reference parts of the graded 2D and 3D
solves).  The elasticity bundles (2D and
3D) pair a ``SharedOperators`` with their collocation and trace points
(``elastic_bundle_from_arrays``), the clamped beam and plate bundles with
their collocation points and, for the plate, its trace matrix
(``clamped_bundle_from_arrays``).  Their JAX counterparts are converted
field by field, through a dict of numpy arrays made with ``np.asarray`` on
each field, e.g.

    arrays = {k: np.asarray(v) for k, v in jax_ops._asdict().items()
              if v is not None}
    ops = shared_operators_from_arrays(arrays, device="cuda")
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.hybrid2d import VarCoeff2DOperators
from ..models.hybrid2d_graded import Graded2DOperators
from ..models.hybrid3d import VarCoeff3DOperators
from ..models.hybrid3d_graded import Graded3DOperators
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
    and 3D bundles of ``prepare_shared_2d`` / ``prepare_shared_3d`` have the
    same fields (K = 4M-4 trace rows in 2D, S surface rows in 3D) and go
    through this function too."""
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


def graded2d_operators_from_arrays(arrays: dict, device=None,
                                   dtype=torch.float32) -> Graded2DOperators:
    """``Graded2DOperators`` from numpy arrays keyed by field name (W20,
    W02, W10, W01, W00, B, Z, Pbc, AZ, AP)."""
    return Graded2DOperators(**_tensors(Graded2DOperators, arrays, device,
                                        dtype))


def graded3d_operators_from_arrays(arrays: dict, device=None,
                                   dtype=torch.float32) -> Graded3DOperators:
    """``Graded3DOperators`` from numpy arrays keyed by field name (W200,
    W020, W002, W100, W010, W001, W000, B, Z, Pbc)."""
    return Graded3DOperators(**_tensors(Graded3DOperators, arrays, device,
                                        dtype))


def varcoeff3d_operators_from_arrays(arrays: dict, device=None,
                                     dtype=torch.float32
                                     ) -> VarCoeff3DOperators:
    """``VarCoeff3DOperators`` from numpy arrays keyed by field name (Lap,
    Gx, Gy, Gz, Dconst, B, Z, Pbc)."""
    return VarCoeff3DOperators(**_tensors(VarCoeff3DOperators, arrays,
                                          device, dtype))


def elastic_bundle_from_arrays(arrays: dict, t_int, pts, device=None,
                               dtype=torch.float32):
    """The port's elasticity bundle (``SharedOperators``, (t_int, pts)) from
    the JAX package's ``prepare_shared_elastic`` or
    ``prepare_shared_elastic_3d`` output given as numpy arrays: the operator
    fields keyed by name, the collocation points ``t_int`` [C] and the trace
    points ``pts`` ([4M-4, 2] in 2D, [S, 3] in 3D), kept as host float64
    arrays as the port's precompute returns them."""
    return (shared_operators_from_arrays(arrays, device, dtype),
            (np.asarray(t_int, np.float64), np.asarray(pts, np.float64)))


def clamped_bundle_from_arrays(arrays: dict, t_int, T_all=None, device=None,
                               dtype=torch.float64):
    """The port's clamped-biharmonic bundle from the JAX package's
    ``prepare_shared_clamped`` (1D: ``(shared, t_int)``) or
    ``prepare_shared_clamped_2d`` (2D: ``(shared, t_int, T_all)``) output
    given as numpy arrays: the operator fields keyed by name, the
    collocation points ``t_int`` [C] (kept as a host float64 array, as the
    port's precompute returns it) and the plate's BFS trace matrix
    ``T_all`` [8M-4, 16] (a tensor on ``device`` in ``dtype``).  Float64 is
    the default: the clamped solvers refuse float32."""
    shared = shared_operators_from_arrays(arrays, device, dtype)
    t_int = np.array(t_int, np.float64)
    if T_all is None:
        return shared, t_int
    return shared, t_int, torch.tensor(np.asarray(T_all), dtype=dtype,
                                       device=device)
