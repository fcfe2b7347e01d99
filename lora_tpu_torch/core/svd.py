"""SVD distillation: a rank-r LoRA extracted from a full fine-tune, the
counterpart of lora_tpu/core/svd.py (the reference's cli_svd.py:28-92).

Each site's residual W_tuned - W_base is taken in f32 on the weights'
device and flattened to 2-D (a conv kernel to (out, in * kh * kw)). Its
top r singular triplets, the factors U * S and Vh, come in f64 from the
eigendecomposition of its smaller Gram matrix (torch.linalg.eigh), which
on an H100 takes a tenth of the time of torch.linalg.svd of the same
matrix; where the top r singular values are not well apart from zero the
full torch.linalg.svd(full_matrices=False) is taken instead. lora_tpu
factors with jnp.linalg.svd in f32. The factors, rounded to f32, are
clamped at the `clamp_quantile` quantile of their joint absolute values.
Singular vectors are fixed only up to sign, and the two packages and
devices choose differently: factors agree as up @ down, not one by one.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .lora import LoraTree
from .sites import Site


# s_r / s_1 from which the Gram route is taken: below it the rounding of
# the Gram matrix (~1e-16 * n * s_1^2) would reach the f32 factors
_GRAM_MIN_RATIO = 1e-2


def _top_factors(d2: torch.Tensor, rank: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(U_r * S_r, Vh_r) of a 2-D matrix, f64. The eigenvectors of the
    smaller Gram matrix are the singular vectors of that side: for a tall
    matrix V, and U * S = d2 @ V with no division; for a wide one U, and
    Vh = U^T d2 / S."""
    x = d2.double()
    tall = x.shape[0] >= x.shape[1]
    lam, vecs = torch.linalg.eigh(x.T @ x if tall else x @ x.T)
    vecs = vecs[:, -rank:].flip(-1)  # eigh sorts ascending
    s = lam[-rank:].flip(-1).clamp(min=0).sqrt()
    if bool(s[-1] > _GRAM_MIN_RATIO * s[0]):
        if tall:
            return x @ vecs, vecs.T
        return vecs * s, (vecs.T @ x) / s[:, None]
    U, S, Vh = torch.linalg.svd(x, full_matrices=False)
    return U[:, :rank] * S[None, :rank], Vh[:rank, :]


def svd_distill_site(w_base: torch.Tensor, w_tuned: torch.Tensor, rank: int,
                     clamp_quantile: float = 0.99
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(up, down) in torch layout, float32, on the weights' device: (out,
    r) and (r, in) for a linear; (out, r, 1, 1) and (r, in, kh, kw) for a
    conv (the down conv carries the kernel)."""
    shape = w_base.shape
    diff = w_tuned.float() - w_base.float()
    US, Vh = _top_factors(diff.reshape(shape[0], -1), rank)
    U, Vh = US.float(), Vh.float()
    # torch.quantile takes at most 2**24 elements; r * (out + in * kh * kw)
    # is under 2**17 at rank 8 on SDXL's widest site (10240 + 1280) and
    # under 2**24 at any rank the sites admit
    dist = torch.cat([U.flatten(), Vh.flatten()])
    hi = torch.quantile(dist.abs(), clamp_quantile)  # linear, as jnp's
    U = U.clamp(-hi, hi)
    Vh = Vh.clamp(-hi, hi)
    if len(shape) == 4:
        return (U.reshape(shape[0], rank, 1, 1),
                Vh.reshape(rank, shape[1], shape[2], shape[3]))
    return U, Vh


def svd_distill(base_params: Dict[str, torch.Tensor],
                tuned_params: Dict[str, torch.Tensor],
                sites: Sequence[Site], rank: int = 4,
                clamp_quantile: float = 0.99) -> LoraTree:
    """A LoRA tree over `sites` distilled from two param dicts (on one
    device), scale 1."""
    site_tree = {}
    for s in sites:
        key = s.name + ".weight"
        up, down = svd_distill_site(base_params[key], tuned_params[key],
                                    rank, clamp_quantile)
        site_tree[s.name] = {"up": up, "down": down}
    device = next(iter(base_params.values())).device
    return {"sites": site_tree,
            "scale": torch.tensor(1.0, dtype=torch.float32, device=device)}
