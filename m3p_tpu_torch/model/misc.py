"""Image-text fusion and the latent transforms (counterpart of
`m3p_tpu/model/misc.py`).

`CrossAlignMatrix` is the model's ``cross_align`` under ``image_fusion``
(`M3PModel.embed_text`'s ``image_enc`` / ``image_mask``); `VaeEncoder` and
`LatentDecoder` are the reference's ``is_latent`` modules, which the JAX
package keeps beside the model and no forward topology calls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from m3p_tpu_torch.model.layers import Dense, LayerNorm


class CrossAlignMatrix(nn.Module):
    """BiDAF-style context-to-query attention fusing image features into
    the text stream (`m3p_tpu/model/misc.py:24-59`): s_ij = w_c . c_i +
    w_q . q_j + w_cq . (c_i * q_j), clipped to +-15, masked image
    positions at the fp32 minimum times 0.7, softmax over the image axis
    in fp32, then ``align_output`` over the attended image features.
    ``cq_weight`` is the JAX module's raw (D, 1) array, untransposed."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.att_weight_c = Dense(dim, 1, dtype)
        self.att_weight_q = Dense(dim, 1, dtype)
        self.cq_weight = nn.Parameter(torch.empty(dim, 1))
        self.align_output = Dense(dim, dim, dtype)

    def forward(self, c: torch.Tensor, q: torch.Tensor,
                q_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """c (B, Sc, D) text, q (B, Sq, D) image, q_mask (B, Sq) -> (B, Sc,
        D)."""
        dt = self.compute_dtype
        cq = torch.einsum("bcd,bqd->bcq", c * self.cq_weight[:, 0].to(dt), q)
        s = self.att_weight_c(c) + self.att_weight_q(q).transpose(1, 2) + cq
        s = torch.clamp(s, -15.0, 15.0).float()
        if q_mask is not None:
            s = s.masked_fill(~q_mask[:, None, :],
                              torch.finfo(torch.float32).min * 0.7)
        a = torch.softmax(s, dim=2).to(c.dtype)
        return self.align_output(torch.einsum("bcq,bqd->bcd", a, q))


class VaeEncoder(nn.Module):
    """The reparameterized latent transform (`m3p_tpu/model/misc.py:
    62-88`): mu = ``x_to_mu``(x); deterministic, z = mu and no KL term;
    else z = mu + eps * exp(logvar / 2) with eps drawn from ``generator``
    and the KL term per position; then ``out_dense`` over [z; c]."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.x_to_mu = Dense(dim, dim, dtype)
        self.x_to_logvar = Dense(dim, dim, dtype)
        self.out_dense = Dense(2 * dim, dim, dtype)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        mu = self.x_to_mu(x)
        if deterministic or generator is None:
            z, kld = mu, None
        else:
            logvar = self.x_to_logvar(x)
            eps = torch.randn(mu.shape, dtype=mu.dtype,
                              device=generator.device,
                              generator=generator).to(mu.device)
            z = mu + eps * torch.exp(0.5 * logvar)
            kld = -0.5 * torch.sum(1 + logvar - mu.float() ** 2
                                   - torch.exp(logvar.float()), dim=-1)
        return self.out_dense(torch.cat([z, c], dim=-1)), kld


class LatentDecoder(nn.Module):
    """dense -> dense_mu -> LN -> tanh (`m3p_tpu/model/misc.py:91-102`)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(dim, dim, dtype)
        self.dense_mu = Dense(dim, dim, dtype)
        self.ln = LayerNorm(dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.ln(self.dense_mu(self.dense(x))))
