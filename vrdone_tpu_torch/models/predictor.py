"""MaskFormer-style query predictor head (counterpart of
``vrdone_tpu/models/predictor.py``).

N learned queries decode against the coarsest pyramid level; each query
emits a class logit vector and a temporal mask embedding, and the mask
logits come from an einsum against the full-resolution FPN mask features
(reference MaskedTransformerPredictor, models/predictor.py:15-125).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import ChannelLayerNorm, ConvMLP, Dense, DecoderOnly

Tensor = torch.Tensor

NON_ATTN_CONST = -10.0  # fill for invalid temporal positions (reference :85)


class MaskedTransformerPredictor(nn.Module):

    def __init__(self, n_input: int, n_embd: int, n_head: int, n_hidden: int,
                 num_queries: int, num_classes: int, path_pdrop: float = 0.1,
                 cls_prior_prob: float = 0.01, n_qx_stride: int = 0,
                 n_kv_stride: int = 1, num_layers: int = 4,
                 deep_supervision: bool = False,
                 enforce_input_project: bool = False,
                 proj_pdrop: float = 0.0, *, device: torch.device):
        super().__init__()
        self.deep_supervision = deep_supervision
        self.input_norm = ChannelLayerNorm(n_input, device=device)
        self.input_proj = (Dense(n_input, n_embd, device=device)
                           if n_input != n_embd or enforce_input_project
                           else None)
        self.query_embed = nn.Parameter(torch.empty(num_queries, n_embd,
                                                    device=device))
        self.transformer = DecoderOnly(
            n_embd, n_head, n_hidden, path_pdrop=path_pdrop,
            n_qx_stride=n_qx_stride, n_kv_stride=n_kv_stride,
            num_layers=num_layers, return_intermediate=deep_supervision,
            proj_pdrop=proj_pdrop, device=device)
        # focal prior on the class bias (reference :79-81); the weight's
        # variance_scaling(1/3, fan_in, uniform) is Dense's U(+-1/sqrt(fan_in))
        bias_value = -math.log((1 - cls_prior_prob) / cls_prior_prob)
        self.class_embed = Dense(n_embd, num_classes + 1,
                                 bias_value=bias_value, device=device)
        self.mask_embed = ConvMLP(n_embd, n_embd, n_embd, num_layers=3,
                                  device=device)

    def init_params(self, generator: torch.Generator) -> None:
        self.query_embed.normal_(0.0, 1.0, generator=generator)

    def forward(self, x: Tensor, mask_features: Tensor, mask: Tensor,
                output_mask: Tensor,
                generator: torch.Generator | None = None) -> dict:
        """x: (B, Tc, C) coarsest level; mask_features: (B, T0, Cm);
        mask: (B, Tc); output_mask: (B, T0). Returns pred_logits
        (B, Q, K+1), pred_masks (B, Q, T0), aux_outputs (with deep
        supervision) and output_mask."""
        src = self.input_norm(x)
        if self.input_proj is not None:
            src = self.input_proj(src) * mask[..., None].to(src.dtype)
        hs, _ = self.transformer(src, mask, self.query_embed,
                                 generator=generator)         # (L, B, Q, C)
        outputs_class = self.class_embed(hs)                   # (L, B, Q, K+1)
        out = {"pred_logits": outputs_class[-1]}
        invalid = ~output_mask                                 # (B, T0)
        if self.deep_supervision:
            mask_embed = self.mask_embed(hs, generator)        # (L, B, Q, C)
            # fp32 products of the operands, as JAX's einsum with
            # preferred_element_type=float32 takes them under bf16
            seg = torch.einsum("lbqc,btc->lbqt", mask_embed.float(),
                               mask_features.float())
            seg = seg.masked_fill(invalid[None, :, None, :], NON_ATTN_CONST)
            out["pred_masks"] = seg[-1]
            out["aux_outputs"] = [
                {"pred_logits": outputs_class[i], "pred_masks": seg[i]}
                for i in range(seg.shape[0] - 1)]
        else:
            mask_embed = self.mask_embed(hs[-1], generator)    # (B, Q, C)
            seg = torch.einsum("bqc,btc->bqt", mask_embed.float(),
                               mask_features.float())
            out["pred_masks"] = seg.masked_fill(invalid[:, None, :],
                                                NON_ATTN_CONST)
        out["output_mask"] = output_mask
        return out
