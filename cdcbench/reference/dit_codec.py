"""The reference codec with a DiT refiner: ``codec_ref.RefCodec`` (the
entropy stage, the conditioning head, g_s, the DDIM chain and the blend, in
f32 from the weights file) whose denoiser is the plain DiT of ``dit``,
carrying the refiner's weights as the port's ``DiT.state_dict()`` holds
them. The weights file's UNet is loaded and not run."""

from __future__ import annotations

import torch

from cdcbench.reference import codec_ref
from cdcbench.reference.dit import DiTReference


class RefDiTCodec(codec_ref.RefCodec):
    """``RefCodec`` of ``config`` (a configuration file's ``config``) and
    ``weights``, whose ``model.denoise`` runs the DiT of ``dit_state``."""

    def __init__(self, config: dict, weights, device, dit_state: dict):
        super().__init__(codec_ref.build_config(config), weights, device)
        dit_config = config["model"]["dit"]
        if self.cfg.model.cond.output_stride != dit_config["space_to_depth"]:
            raise ValueError("the conditioning head's grid is not the DiT's "
                             "space-to-depth grid")
        dit = DiTReference.from_config(dit_config)
        dit.load_state_dict(dit_state, strict=True)
        self.dit = dit.to(self.device).eval()
        synthesis = self.cfg.model.codec.synthesis

        def denoise(x_t, t, cond_f, cond_t, x_bar=None):
            x = torch.cat([x_t, x_bar.to(x_t.dtype)], -1) if synthesis else x_t
            return self.dit(x, t, cond_f)
        # The reference model's denoiser is the DiT (``RefCodec.refine``
        # calls ``model.denoise``).
        self.model.denoise = denoise
