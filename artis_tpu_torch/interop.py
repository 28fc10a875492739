"""Carry state between the JAX package and the port as numpy arrays.

``from_numpy(cls, arrays, device, dtype)`` builds one of the port's
dataclasses (DeviceAtomicData, GridData, CellState, PacketState,
Estimators, StepContext, RateCoeffTables, ProcessRates, MacroAtomAux,
PelletTables) from a mapping of field name -> numpy array (or Python scalar
for metadata such as ``nlines``); ``to_numpy(obj)`` goes the other way.
``nlte_indices_from_numpy`` carries the NLTE solver's host-side index lists
(``plasma.nltepop.ElementNlteIndex``, numpy by design), and
``nonthermal_data_from_numpy`` the non-thermal solver's shell and
excitation tables (``plasma.nonthermal.NonthermalData``). The port never sees
a jax array: callers turn the JAX package's structures into numpy
themselves (``np.asarray`` on each field).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping

import numpy as np
import torch

from . import options as options_mod


_SCALARS = {"float": float, "int": int, "bool": bool}


def _to_tensor(a: np.ndarray, device, dtype):
    a = np.array(a, copy=True)  # jax hands out read-only buffers
    if a.dtype == np.bool_:
        return torch.as_tensor(a).to(device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64)).to(device)
    t = torch.as_tensor(a)
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def from_numpy(cls, arrays: Mapping[str, object], device="cpu", dtype=None):
    """Build ``cls`` from numpy arrays by field name. Float arrays become
    ``dtype`` tensors (their own dtype when None), integer arrays int64,
    booleans bool; fields annotated float/int/bool take a 0-d array as a
    Python scalar; other values (metadata) pass through, with enums mapped
    onto the port's enum of the same name."""
    kw = {}
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        if f.name not in arrays:
            if f.default is not dataclasses.MISSING:
                continue
            raise KeyError(f"{cls.__name__}.{f.name} missing from the arrays")
        v = arrays[f.name]
        scalar = _SCALARS.get(f.type if isinstance(f.type, str) else getattr(f.type, "__name__", ""))
        if scalar is not None and isinstance(v, (np.ndarray, np.generic)):
            v = scalar(np.asarray(v).reshape(()))
        elif isinstance(v, np.ndarray):
            v = _to_tensor(v, device, dtype)
        elif isinstance(v, enum.Enum):
            v = getattr(options_mod, type(v).__name__)[v.name]
        kw[f.name] = v
    return cls(**kw)


def to_numpy(obj) -> dict:
    """Field name -> numpy array (tensors) or the value itself (metadata)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v.detach().cpu().numpy() if torch.is_tensor(v) else v
    return out


def nlte_indices_from_numpy(indices) -> list:
    """The port's ``ElementNlteIndex`` list from mappings of field name ->
    numpy array or Python scalar, one per element (the JAX package's
    ``nltepop.build_indices`` output, field by field)."""
    from .plasma.nltepop import ElementNlteIndex

    out = []
    for arrays in indices:
        kw = {}
        for f in dataclasses.fields(ElementNlteIndex):
            v = arrays[f.name]
            kw[f.name] = (np.array(v) if isinstance(v, (np.ndarray, np.generic)) and np.ndim(v)
                          else (v.item() if isinstance(v, np.generic) else v))
        out.append(ElementNlteIndex(**kw))
    return out


def nonthermal_data_from_numpy(arrays: Mapping[str, object], ion_element, device="cpu"):
    """The port's ``NonthermalData`` from mappings of field name -> numpy
    array or Python scalar (the JAX package's ``build_nonthermal_data``
    output, field by field), floats in float64; ``ion_element`` (nions,)
    gives the per-ion top-ion index the JAX table does not carry."""
    from .plasma.nonthermal import NonthermalData, ion_topion

    return from_numpy(NonthermalData,
                      dict(arrays, ion_topion=ion_topion(np.asarray(ion_element))),
                      device=device, dtype=torch.float64)
