"""MACE: higher-order E(3)-equivariant message passing (Batatia et al.),
the JAX package's ``models/mace.py`` on one device.

The same structure for l_max=2, correlation order 3: real spherical
harmonics Y_lm (9 components) of the edge unit vectors, a Bessel radial
basis with a polynomial cutoff into a radial MLP giving per-(channel, l)
weights, first-order features A_i = sum_j R(r_ij) Y(r_hat_ij) h_j by
segment sum, higher orders by Gaunt contractions (B2 = G(A, A), B3 =
G(B2, A), capped at l <= 2), per-order and per-l channel mixing with a
residual update, and an invariant readout.  Messages are built from the
senders' scalar channels, as in the JAX package.

The JAX package also carries the l = 1, 2 components of the node
features across layers and mixes them (``.at[:, :, sel].add``); nothing
reads them, since messages take the senders' scalar channel and the
readout the invariant one.  The port computes the scalar channel alone
(and of B3 its l = 0 component): the same energy, and for the l > 0
mixes a zero gradient, as in the JAX package.  The Gaunt table is this
module's own numpy quadrature, the JAX package's computation line for
line.
"""
from __future__ import annotations

import functools
import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import Params, _Init, gather, seg_sum

_LM_L = np.array([0, 1, 1, 1, 2, 2, 2, 2, 2])   # l of each component


def real_sph_harm(u: torch.Tensor) -> torch.Tensor:
    """u: (..., 3) unit vectors -> (..., 9) real SH values, l=0,1,2."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    c0 = 0.28209479177387814
    c1 = 0.4886025119029199
    c2a = 1.0925484305920792
    c2b = 0.31539156525252005
    c2c = 0.5462742152960396
    return torch.stack([
        torch.full_like(x, c0),
        c1 * y, c1 * z, c1 * x,
        c2a * x * y, c2a * y * z, c2b * (3 * z * z - 1),
        c2a * x * z, c2c * (x * x - y * y),
    ], dim=-1)


def _real_sph_harm_np(u: np.ndarray) -> np.ndarray:
    """numpy twin of ``real_sph_harm`` for the quadrature."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    c0, c1 = 0.28209479177387814, 0.4886025119029199
    c2a, c2b, c2c = 1.0925484305920792, 0.31539156525252005, 0.5462742152960396
    return np.stack([
        np.full_like(x, c0), c1 * y, c1 * z, c1 * x,
        c2a * x * y, c2a * y * z, c2b * (3 * z * z - 1),
        c2a * x * z, c2c * (x * x - y * y)], axis=-1)


@functools.lru_cache()
def gaunt_table() -> np.ndarray:
    """(9, 9, 9) real Gaunt coefficients via spherical quadrature
    (Gauss-Legendre in cos(theta) x a uniform phi grid, exact for this
    bandwidth)."""
    nt, nphi = 32, 64
    xs, ws = np.polynomial.legendre.leggauss(nt)      # cos(theta) nodes
    phi = (np.arange(nphi) + 0.5) * (2 * np.pi / nphi)
    ct = xs[:, None]
    st = np.sqrt(1 - ct ** 2)
    x = st * np.cos(phi)[None, :]
    y = st * np.sin(phi)[None, :]
    z = np.broadcast_to(ct, x.shape)
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    w = (np.broadcast_to(ws[:, None], x.shape) * (2 * np.pi / nphi)).reshape(-1)
    Y = _real_sph_harm_np(pts)                         # (Q, 9)
    return np.einsum("qa,qb,qc,q->abc", Y, Y, Y, w)


def bessel_basis(d: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """Sinc-like Bessel radial basis with a smooth polynomial cutoff."""
    d = torch.clamp(d, min=1e-9)[..., None]
    n = torch.arange(1, n_rbf + 1, dtype=d.dtype, device=d.device)
    rb = math.sqrt(2.0 / r_cut) * torch.sin(n * math.pi * d / r_cut) / d
    t = torch.clamp(d / r_cut, 0, 1)
    env = 1 - 10 * t ** 3 + 15 * t ** 4 - 6 * t ** 5   # p=3 poly cutoff
    return rb * env


def init_mace(cfg: GNNConfig, n_species: int = 16, n_out: int = 1,
              seed: int = 0, device="cpu") -> Params:
    init = _Init(seed, device)
    C, L = cfg.d_hidden, cfg.n_layers
    p: Params = {"embed": init.normal((n_species, C), 0.5)}
    for l in range(L):
        p[f"rad_w0_{l}"] = init.normal((cfg.n_rbf, 32), 0.3)
        p[f"rad_w1_{l}"] = init.normal((32, C * 3), 0.2)
        # channel mixes per correlation order (1, 2, 3) and per l (3)
        p[f"mix_{l}"] = init.normal((3, 3, C, C), C ** -0.5)
        p[f"upd_{l}"] = init.normal((C, C), C ** -0.5)
    p["out_w0"] = init.normal((C, C), C ** -0.5)
    p["out_w1"] = init.normal((C, n_out), C ** -0.5)
    return p


def _gaunt_contract(a: torch.Tensor, b: torch.Tensor, G: torch.Tensor
                    ) -> torch.Tensor:
    """a, b: (N, C, 9) -> (N, C, 9) equivariant product, capped at l<=2:
    out[..., k] = sum_ab a_a G[a, b, k] b_b, one output component at a
    time so that no (N, C, 9, 9) tensor is made."""
    return torch.stack([((a @ G[:, :, k]) * b).sum(-1)
                        for k in range(G.shape[2])], dim=-1)


def mace_forward(p: Params, cfg: GNNConfig, species, pos, senders, receivers,
                 edge_mask, n: int, r_cut: float = 3.0) -> torch.Tensor:
    G = torch.as_tensor(gaunt_table(), dtype=pos.dtype, device=pos.device)
    lmap = torch.as_tensor(_LM_L, device=pos.device)
    h0 = gather(p["embed"], species)              # (N, C) scalar channel

    rvec = gather(pos, receivers) - gather(pos, senders)
    d = torch.linalg.vector_norm(rvec + 1e-12, dim=-1)
    u = rvec / torch.clamp(d, min=1e-9)[:, None]
    Y = real_sph_harm(u)                                    # (E, 9)
    rb = bessel_basis(d, cfg.n_rbf, r_cut)                  # (E, n_rbf)
    em = edge_mask[:, None, None]
    for l in range(cfg.n_layers):
        R = F.silu(rb @ p[f"rad_w0_{l}"]) @ p[f"rad_w1_{l}"]
        R = R.reshape(R.shape[0], -1, 3)                    # (E, C, l)
        Rlm = R[:, :, lmap]                                 # (E, C, 9)
        msg = Rlm * Y[:, None, :] * gather(h0, senders)[:, :, None]
        A = seg_sum(msg * em, receivers, n)                 # (N, C, 9)
        B2 = _gaunt_contract(A, A, G)
        B3_0 = _gaunt_contract(B2, A, G[:, :, :1])[:, :, 0]
        mix = p[f"mix_{l}"]                     # (order, l, C, C)
        m0 = A[:, :, 0] @ mix[0, 0] + B2[:, :, 0] @ mix[1, 0] \
            + B3_0 @ mix[2, 0]
        h0 = h0 + m0
        h0 = h0 + h0 @ p[f"upd_{l}"]
    e_node = F.silu(h0 @ p["out_w0"]) @ p["out_w1"]        # invariant part
    return e_node                                           # (N, n_out)


def mace_energy(p: Params, cfg: GNNConfig, species, pos, senders, receivers,
                edge_mask, graph_ids, n_graphs: int) -> torch.Tensor:
    e = mace_forward(p, cfg, species, pos, senders, receivers, edge_mask,
                     species.shape[0])
    return seg_sum(e[:, 0], graph_ids, n_graphs)


def params_from_jax(cfg: GNNConfig, params_np: Mapping[str, np.ndarray],
                    device="cpu") -> Params:
    """The JAX package's MACE parameter dict (numpy arrays) as float32
    tensors on ``device``."""
    missing = [k for l in range(cfg.n_layers)
               for k in (f"rad_w0_{l}", f"rad_w1_{l}", f"mix_{l}", f"upd_{l}")
               if k not in params_np]
    if missing:
        raise KeyError(f"{cfg.arch}: the parameters lack {missing}")
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in params_np.items()}
