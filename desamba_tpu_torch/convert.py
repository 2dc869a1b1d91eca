"""The port's device tables, built from an index or carried across from
the JAX package's tables.

`build_tables` builds (FmArrays, EkArrays, LocArrays, RefArrays) from the
port's HostIndex (index.loader.load_index). `tables_from_jax` takes the
JAX package's FmArrays, EkArrays, LocArrays and RefArrays — anything
whose leaves np.asarray can read, with the same attribute names — and
returns the same four port tables on a device. Both routes give equal
arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.ekmer import EkArrays
from .ops.fm import FmArrays
from .ops.locate import LocArrays
from .ops.refwin import RefArrays


def build_tables(ti, device="cpu", fold_bits="auto"):
    """(FmArrays, EkArrays, LocArrays, RefArrays) on `device` from a
    HostIndex. fold_bits="auto" folds big exist filters as the JAX
    FastClassifier does."""
    return (FmArrays.from_tensor_index(ti, device),
            EkArrays.from_tensor_index(ti, device, fold_bits=fold_bits),
            LocArrays.from_tensor_index(ti, device),
            RefArrays.from_tensor_index(ti, device))


def _t(a, device) -> torch.Tensor:
    """numpy leaf -> tensor; uint32 leaves become int32 with the same bits."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def tables_from_jax(fm, ek, loc, ra, device="cpu"):
    """The port's four tables from the JAX package's four table objects."""
    fm_t = FmArrays(
        occ32=_t(fm.occ32, device), pad=_t(fm.pad, device),
        rank=_t(fm.rank, device), hash13=_t(fm.hash13, device),
        sa_uni=_t(fm.sa_uni, device), sa_off=_t(fm.sa_off, device),
        lfc=_t(fm.lfc, device), L=int(np.asarray(fm.L)),
        dollar_pos=int(np.asarray(fm.dollar_pos)))
    ek_t = EkArrays(_t(ek.w01, device), ek.n_words0, ek.mask_bits, ek.lek,
                    ek.single_base_max, getattr(ek, "fold_bits", 0))
    loc_t = LocArrays(**{k: _t(getattr(loc, k), device)
                         for k in LocArrays.FIELDS})
    ra_t = RefArrays(_t(ra.ref_words_lsb, device), _t(ra.ref_offset, device),
                     _t(ra.ref_len, device))
    return fm_t, ek_t, loc_t, ra_t
