"""PitchExtractor (port of ``stylesinger_tpu/models/pe.py``): F0 and uv
predicted from a mel by a conv-block encoder and a pitch predictor, and
its loss."""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from stylesinger_torch.dsp.pitch import denorm_f0
from stylesinger_torch.models.common import ConvBlocks, PitchPredictor
from stylesinger_torch.training.losses import f0_uv_losses


class PitchExtractor(nn.Module):
    """mel [B, T, M] -> {'pitch_pred': [B, T, 2], 'f0_denorm_pred' [B, T],
    'nonpadding' [B, T]}; a frame is padding where every mel bin is 0."""

    def __init__(self, cfg: Any):
        super().__init__()
        c = self.cfg = cfg
        h = c["hidden_size"]
        self.mel_encoder = ConvBlocks(c["audio_num_mel_bins"], h,
                                      dilations=(1,) * 5, kernel_size=5)
        self.pitch_predictor = PitchPredictor(
            h, h, odim=2, n_layers=c["predictor_layers"],
            kernel_size=c["predictor_kernel"],
            dropout=c["predictor_dropout"])

    def forward(self, mel: torch.Tensor, drop=None
                ) -> Dict[str, torch.Tensor]:
        """``drop`` None is the deterministic pass."""
        c = self.cfg
        nonpadding = (mel.abs().sum(-1) > 0).to(torch.float32)
        x = self.mel_encoder(mel, nonpadding, drop)
        pred = self.pitch_predictor(x, nonpadding, drop)
        uv = (pred[:, :, 1] > 0).to(torch.float32)
        f0_denorm = denorm_f0(
            pred[:, :, 0], uv if c["use_uv"] else None,
            pitch_norm=c["pitch_norm"], f0_mean=c["f0_mean"],
            f0_std=c["f0_std"], pitch_padding=nonpadding == 0)
        return {"pitch_pred": pred, "f0_denorm_pred": f0_denorm,
                "nonpadding": nonpadding}


def pe_loss(ret: Dict, f0: torch.Tensor, uv: torch.Tensor,
            cfg: Any) -> Dict[str, torch.Tensor]:
    """uv BCE + voiced-masked F0 L1 on the extractor's own nonpadding."""
    return f0_uv_losses(ret["pitch_pred"], f0, uv, ret["nonpadding"], cfg)
