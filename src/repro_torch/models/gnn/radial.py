"""Radial and angular basis functions (DimeNet / NequIP / MACE), the port
of ``repro.models.gnn.radial``."""
from __future__ import annotations

import math

import torch


def safe_norm(vec: torch.Tensor, dim: int = -1, eps: float = 1e-9
              ) -> torch.Tensor:
    """|vec| with finite gradients at zero (double-where trick): a padded
    edge has r = 0 and a zero gradient, not a NaN."""
    r2 = torch.sum(vec * vec, dim=dim)
    safe = r2 > eps
    return torch.sqrt(torch.where(safe, r2, 1.0)) * safe.to(vec.dtype)


def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """DimeNet/NequIP radial basis: sqrt(2/c) sin(n pi r / c) / r."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    return (math.sqrt(2.0 / cutoff)
            * torch.sin(n * math.pi * r[..., None] / cutoff) / r[..., None])


def poly_envelope(r: torch.Tensor, cutoff: float, p: int = 6
                  ) -> torch.Tensor:
    """DimeNet's smooth polynomial cutoff u(r) (zero value/derivs at
    cutoff)."""
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2)
    c = -p * (p + 1) / 2.0
    return 1.0 + a * x ** p + b * x ** (p + 1) + c * x ** (p + 2)


def legendre(cos_theta: torch.Tensor, n: int) -> torch.Tensor:
    """P_0..P_{n-1}(cos θ) by recursion -> [..., n]."""
    outs = [torch.ones_like(cos_theta)]
    if n > 1:
        outs.append(cos_theta)
    for l in range(2, n):
        outs.append(((2 * l - 1) * cos_theta * outs[-1]
                     - (l - 1) * outs[-2]) / l)
    return torch.stack(outs[:n], dim=-1)


def spherical_basis(r: torch.Tensor, cos_theta: torch.Tensor,
                    n_spherical: int, n_radial: int, cutoff: float
                    ) -> torch.Tensor:
    """DimeNet a_SBF(r, θ): outer product of radial Bessel × Legendre(θ),
    enveloped — [..., n_spherical * n_radial]."""
    rb = bessel_rbf(r, n_radial, cutoff) * poly_envelope(r, cutoff)[..., None]
    ang = legendre(cos_theta, n_spherical)
    out = rb[..., None, :] * ang[..., :, None]
    return out.reshape(*out.shape[:-2], n_spherical * n_radial)
