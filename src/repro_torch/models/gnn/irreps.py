"""Minimal E(3) irrep algebra for NequIP/MACE (l <= 2 by default), the
port of ``repro.models.gnn.irreps``.

* real spherical harmonics (component-normalized, e3nn-style (y, z, x)
  order for l=1),
* exact Clebsch-Gordan coefficients via the Racah formula, transformed to
  the real basis (numpy, float64; the port keeps its own copy of the
  reference's tables code, which imports no JAX),
* irrep feature containers {l: [..., mult, 2l+1]} and the weighted tensor
  product that is the NequIP/MACE interaction hot loop.

The CG tensors are built once per (path, dtype, device) and kept.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import randn
from repro_torch.utils.device import DeviceLike

IrrepFeat = Dict[int, torch.Tensor]   # l -> [..., mult, 2l+1]


# ----------------------------------------------------------- complex CG

def _f(n: int) -> float:
    return float(math.factorial(n))


@lru_cache(maxsize=None)
def _cg_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    """⟨l1 m1 l2 m2 | l3 m3⟩ (Condon-Shortley), shape [2l1+1, 2l2+1, 2l3+1]."""
    out = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return out
    pref_delta = math.sqrt(
        _f(l1 + l2 - l3) * _f(l1 - l2 + l3) * _f(-l1 + l2 + l3)
        / _f(l1 + l2 + l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            pref = math.sqrt(
                (2 * l3 + 1)
                * _f(l3 + m3) * _f(l3 - m3)
                * _f(l1 - m1) * _f(l1 + m1)
                * _f(l2 - m2) * _f(l2 + m2))
            s = 0.0
            for k in range(0, l1 + l2 - l3 + 1):
                denoms = (k, l1 + l2 - l3 - k, l1 - m1 - k, l2 + m2 - k,
                          l3 - l2 + m1 + k, l3 - l1 - m2 + k)
                if any(d < 0 for d in denoms):
                    continue
                s += (-1) ** k / np.prod([_f(d) for d in denoms])
            out[m1 + l1, m2 + l2, m3 + l3] = pref_delta * pref * s
    return out


@lru_cache(maxsize=None)
def _real_to_complex(l: int) -> np.ndarray:
    """U with y_complex = U @ s_real; real basis ordered m = -l..l
    (m<0 ~ sin-type, m>0 ~ cos-type), Condon-Shortley phases."""
    d = 2 * l + 1
    U = np.zeros((d, d), complex)
    for m in range(-l, l + 1):
        i = m + l
        if m > 0:
            U[i, m + l] = (-1) ** m / math.sqrt(2)
            U[i, -m + l] = 1j * (-1) ** m / math.sqrt(2)
        elif m == 0:
            U[i, l] = 1.0
        else:  # m < 0
            U[i, -m + l] = 1 / math.sqrt(2)
            U[i, m + l] = -1j / math.sqrt(2)
    return U


@lru_cache(maxsize=None)
def cg_real(l1: int, l2: int, l3: int) -> Tuple[np.ndarray, bool]:
    """Real-basis CG tensor [d1, d2, d3]; second value False if path is zero."""
    C = _cg_complex(l1, l2, l3)
    U1 = _real_to_complex(l1)
    U2 = _real_to_complex(l2)
    U3 = _real_to_complex(l3)
    # s3 = U3^dagger C (U1 s1 ⊗ U2 s2)
    Cr = np.einsum("abc,ai,bj,ck->ijk", C, U1, U2, U3.conj())
    re, im = np.real(Cr), np.imag(Cr)
    if np.abs(re).max() >= np.abs(im).max():
        out = re
    else:
        out = im
    if np.abs(out).max() < 1e-12:
        return np.zeros_like(out), False
    return out, True


@lru_cache(maxsize=None)
def cg_tensor(l1: int, l2: int, l3: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """:func:`cg_real`'s tensor as a torch tensor, built once per path,
    dtype and device."""
    return torch.as_tensor(cg_real(l1, l2, l3)[0], dtype=dtype,
                           device=device)


# ----------------------------------------------------- real spherical harm.

def spherical_harmonics(vec: torch.Tensor, l_max: int) -> IrrepFeat:
    """Component-normalized real SH of (not necessarily unit) vectors.

    vec: [..., 3]; returns {l: [..., 1, 2l+1]} evaluated on normalized vec.
    Basis order m = -l..l matching :func:`_real_to_complex` (so l=1 is
    (y, z, x) up to normalization)."""
    # safe-norm (double-where): keeps gradients finite at zero vectors
    eps = 1e-9
    r2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    safe = r2 > eps
    r = torch.sqrt(torch.where(safe, r2, 1.0))
    u = torch.where(safe, vec / torch.where(safe, r, 1.0), 0.0)
    # zero-length edges (self-loops / padding) have no direction: their l>0
    # harmonics are zeroed, otherwise they would inject a fixed non-rotating
    # direction and silently break equivariance.
    ok = safe.to(vec.dtype)
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    out: IrrepFeat = {0: torch.ones((*vec.shape[:-1], 1, 1), dtype=vec.dtype,
                                    device=vec.device)}
    if l_max >= 1:
        s1 = math.sqrt(3.0)
        y1 = torch.stack([s1 * y, s1 * z, s1 * x], dim=-1) * ok
        out[1] = y1[..., None, :]
    if l_max >= 2:
        s15 = math.sqrt(15.0)
        s5 = math.sqrt(5.0)
        y2 = torch.stack([
            s15 * x * y,                       # m = -2
            s15 * y * z,                       # m = -1
            s5 / 2.0 * (3 * z * z - 1.0),      # m = 0
            s15 * x * z,                       # m = +1
            s15 / 2.0 * (x * x - y * y),       # m = +2
        ], dim=-1) * ok
        out[2] = y2[..., None, :]
    return out


# --------------------------------------------------------------- utilities

def valid_paths(l_in: Sequence[int], l_edge: Sequence[int],
                l_out: Sequence[int]) -> List[Tuple[int, int, int]]:
    paths = []
    for a in l_in:
        for b in l_edge:
            for c in l_out:
                if abs(a - b) <= c <= a + b:
                    _, ok = cg_real(a, b, c)
                    if ok:
                        paths.append((a, b, c))
    return paths


def tensor_product(feat: IrrepFeat, sh: IrrepFeat,
                   weights: Dict[Tuple[int, int, int], torch.Tensor],
                   l_out: Sequence[int]) -> IrrepFeat:
    """Weighted CG tensor product: out^{l3} = Σ_paths w ⊙ CG(feat^{l1}, sh^{l2}).

    feat: {l1: [E, M, d1]}, sh: {l2: [E, 1, d2]},
    weights: {(l1,l2,l3): [E, M]} (per-edge radial weights),
    returns {l3: [E, M, d3]}.
    """
    out: IrrepFeat = {}
    for (l1, l2, l3), w in weights.items():
        if l1 not in feat or l2 not in sh or l3 not in l_out:
            continue
        if not cg_real(l1, l2, l3)[1]:
            continue
        x = feat[l1]
        C = cg_tensor(l1, l2, l3, x.dtype, x.device)
        term = torch.einsum("emi,euj,ijk->emk", x, sh[l2], C)
        term = term * w[..., None]
        out[l3] = out[l3] + term if l3 in out else term
    return out


def irrep_linear(params: Dict[str, torch.Tensor], feat: IrrepFeat
                 ) -> IrrepFeat:
    """Per-l linear mix over multiplicity channels (equivariant)."""
    out = {}
    for l, x in feat.items():
        w = params[f"l{l}"]                      # [M_in, M_out]
        out[l] = torch.einsum("...mi,mn->...ni", x, w)
    return out


def irrep_linear_init(gen: torch.Generator, l_list: Sequence[int],
                      m_in: int, m_out: int,
                      dtype: torch.dtype = torch.float32,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    return {f"l{l}": randn(gen, (m_in, m_out), dtype, device) / math.sqrt(m_in)
            for l in l_list}


def gate(feat: IrrepFeat) -> IrrepFeat:
    """Equivariant gated nonlinearity: silu on scalars; l>0 scaled by
    sigmoid of the matching scalar channel."""
    out = dict(feat)
    scal = feat[0][..., 0]                       # [..., M]
    out[0] = F.silu(feat[0])
    g = torch.sigmoid(scal)[..., None]
    for l, x in feat.items():
        if l > 0:
            out[l] = x * g
    return out


def norm_squared(feat: IrrepFeat) -> torch.Tensor:
    """Rotation-invariant per-channel squared norms, concatenated."""
    parts = [torch.sum(x * x, dim=-1) for _, x in sorted(feat.items())]
    return torch.cat(parts, dim=-1)
