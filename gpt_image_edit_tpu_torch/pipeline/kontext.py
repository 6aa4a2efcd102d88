"""FluxKontext sampling pipeline.

Counterpart of `gpt_image_edit_tpu.pipeline.kontext`: reference image ->
VAE encode -> pack -> N-step flow-matching Euler loop over the MMDiT ->
unpack -> VAE decode. The JAX package runs the loop as one jitted lax.scan;
here it is a Python loop of eager kernels on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gpt_image_edit_tpu_torch.models.common import first_leaf
from gpt_image_edit_tpu_torch.models.flux.config import FluxConfig
from gpt_image_edit_tpu_torch.models.flux.model import apply as apply_flux
from gpt_image_edit_tpu_torch.models.vae.config import VaeConfig
from gpt_image_edit_tpu_torch.models.vae.model import (
    decode_from_scaled_latents,
    encode_to_scaled_latents,
)
from gpt_image_edit_tpu_torch.ops.packing import latent_image_ids, pack_latents, unpack_latents
from gpt_image_edit_tpu_torch.ops.rope import flux_rope_freqs
from gpt_image_edit_tpu_torch.pipeline.scheduler import flow_sigmas
from gpt_image_edit_tpu_torch.utils.platform import resolve_device

# The aspect buckets Kontext was trained on (a copy of the JAX package's table).
PREFERRED_KONTEXT_RESOLUTIONS = [
    (672, 1568), (688, 1504), (720, 1456), (752, 1392), (800, 1328),
    (832, 1248), (880, 1184), (944, 1104), (1024, 1024), (1104, 944),
    (1184, 880), (1248, 832), (1328, 800), (1392, 752), (1456, 720),
    (1504, 688), (1568, 672),
]


def pick_kontext_resolution(width: int, height: int) -> Tuple[int, int]:
    """Closest trained bucket by aspect ratio -> (width, height)."""
    aspect = width / height
    _, w, h = min((abs(aspect - w / h), w, h) for w, h in PREFERRED_KONTEXT_RESOLUTIONS)
    return w, h


@torch.inference_mode()
def denoise_scan(
    flux_params,
    flux_cfg: FluxConfig,
    *,
    latents: torch.Tensor,                  # (B, S_target, 64) packed noise
    image_latents: Optional[torch.Tensor],  # (B, S_ref, 64) packed ref latents
    latent_ids: torch.Tensor,               # (S_target + S_ref, 3)
    prompt_embeds: torch.Tensor,            # (B, S_txt, 4096)
    pooled_embeds: torch.Tensor,            # (B, 768)
    sigmas: torch.Tensor,                   # (num_steps + 1,) fp32
    guidance: torch.Tensor,                 # (B,) fp32
    num_steps: int,
    neg_prompt_embeds: Optional[torch.Tensor] = None,
    neg_pooled_embeds: Optional[torch.Tensor] = None,
    true_cfg_scale: float = 1.0,
    txt_pad_mask: Optional[torch.Tensor] = None,      # (B, S_txt)
    neg_txt_pad_mask: Optional[torch.Tensor] = None,  # (B, S_txt_neg)
    step_callback=None,                     # host fn(step_idx), called before each step
) -> torch.Tensor:
    """The N-step Euler flow-matching loop: each step feeds
    [latents ++ image_latents] to the MMDiT, truncates the prediction back to
    the target tokens, optionally combines true-CFG, and takes an Euler step
    in fp32 while the carry keeps the latent dtype."""
    b, s_target = latents.shape[0], latents.shape[1]
    do_cfg = true_cfg_scale > 1.0 and neg_prompt_embeds is not None
    dev = latents.device

    def full_mask(tmask):
        if tmask is None:
            return None
        ones = torch.ones(b, latent_ids.shape[0], dtype=torch.bool, device=dev)
        return torch.cat([tmask.to(device=dev, dtype=torch.bool), ones], dim=-1)

    def rope_for(s_txt):
        ids = torch.cat([torch.zeros(s_txt, 3, dtype=torch.float32, device=dev), latent_ids], dim=0)
        return flux_rope_freqs(ids, flux_cfg.axes_dims_rope, flux_cfg.rope_theta)

    pad_mask = full_mask(txt_pad_mask)
    rope = rope_for(prompt_embeds.shape[1])
    if do_cfg:
        neg_pad_mask = full_mask(neg_txt_pad_mask)
        neg_rope = (rope if neg_prompt_embeds.shape[1] == prompt_embeds.shape[1]
                    else rope_for(neg_prompt_embeds.shape[1]))

    def model(lat_in, sigma, embeds, pooled, mask, rope_tab):
        pred = apply_flux(
            flux_params, flux_cfg,
            hidden_states=lat_in,
            encoder_hidden_states=embeds,
            pooled_projections=pooled,
            timestep=sigma.expand(b),
            img_ids=latent_ids,
            guidance=guidance if flux_cfg.guidance_embeds else None,
            pad_mask=mask,
            rope=rope_tab,
        )
        return pred[:, :s_target]

    lat = latents
    for i in range(num_steps):
        if step_callback is not None:
            step_callback(i)
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        lat_in = lat if image_latents is None else torch.cat([lat, image_latents.to(lat.dtype)], dim=1)
        pred = model(lat_in, sigma, prompt_embeds, pooled_embeds, pad_mask, rope)
        if do_cfg:
            neg = model(lat_in, sigma, neg_prompt_embeds, neg_pooled_embeds, neg_pad_mask, neg_rope)
            pred = neg + true_cfg_scale * (pred - neg)
        lat = (lat.float() + (sigma_next - sigma) * pred.float()).to(lat.dtype)
    return lat


class KontextPipeline:
    """End-to-end edit sampler: ref-image VAE encode -> denoise loop -> VAE decode.

    Prompt embeddings come from the LVLM (and optionally T5); they are
    inputs here, as in the JAX pipeline. `device` defaults to the card and
    raises without one unless the caller passes device="cpu"; the params
    must already lie on it (`utils.synthetic` or `utils.convert.from_jax`).
    """

    def __init__(self, flux_params, flux_cfg: FluxConfig, vae_params, vae_cfg: VaeConfig,
                 *, device="cuda"):
        self.device = resolve_device(device)
        for name, tree in (("flux", flux_params), ("vae", vae_params)):
            leaf = first_leaf(tree)
            if leaf.device.type != self.device.type:
                raise ValueError(f"{name} params are on {leaf.device}, the pipeline on {self.device}")
        self.flux_params = flux_params
        self.flux_cfg = flux_cfg
        self.vae_params = vae_params
        self.vae_cfg = vae_cfg
        # VAE compute dtype follows its params (bf16 serving keeps fp32
        # group-norm statistics inside group_norm)
        self.vae_dtype = first_leaf(vae_params).dtype

    @torch.inference_mode()
    def _encode(self, image: torch.Tensor) -> torch.Tensor:
        x = image.to(device=self.device, dtype=self.vae_dtype)
        return encode_to_scaled_latents(self.vae_params, self.vae_cfg, x)

    @torch.inference_mode()
    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        return decode_from_scaled_latents(self.vae_params, self.vae_cfg, z.to(self.vae_dtype))

    def encode_reference(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """image: (B, H, W, 3) in [-1, 1] -> (packed ref latents, ref ids)."""
        return self.encode_references([image])

    def encode_references(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each conditioning image VAE-encoded and packed, concatenated along
        the sequence; the k-th reference gets rope modality id k+1."""
        packed, ids = [], []
        for k, img in enumerate(images):
            lat = self._encode(img)
            _, h, w, _ = lat.shape
            packed.append(pack_latents(lat))
            ids.append(latent_image_ids(h // 2, w // 2, modality=k + 1, device=self.device))
        return torch.cat(packed, dim=1), torch.cat(ids, dim=0)

    def __call__(
        self,
        *,
        prompt_embeds: torch.Tensor,
        pooled_prompt_embeds: torch.Tensor,
        image=None,                    # (B, H, W, 3) in [-1, 1], or a list of them
        image_latents: Optional[torch.Tensor] = None,  # pre-packed alternative
        image_ids: Optional[torch.Tensor] = None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 28,
        guidance_scale: float = 3.5,
        true_cfg_scale: float = 1.0,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        negative_pooled_prompt_embeds: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        output_type: str = "pixels",
        txt_pad_mask: Optional[torch.Tensor] = None,
        neg_txt_pad_mask: Optional[torch.Tensor] = None,
        step_callback=None,
        num_images_per_prompt: int = 1,
    ) -> torch.Tensor:
        dev = self.device
        if num_images_per_prompt > 1:
            # batched sampling: tile the conditioning, one loop at B = N
            n = num_images_per_prompt

            def tile(x):
                return None if x is None else torch.repeat_interleave(x, n, dim=0)

            prompt_embeds, pooled_prompt_embeds = tile(prompt_embeds), tile(pooled_prompt_embeds)
            negative_prompt_embeds = tile(negative_prompt_embeds)
            negative_pooled_prompt_embeds = tile(negative_pooled_prompt_embeds)
            txt_pad_mask, neg_txt_pad_mask = tile(txt_pad_mask), tile(neg_txt_pad_mask)
            latents, image_latents = tile(latents), tile(image_latents)
            if isinstance(image, (list, tuple)):
                image = [tile(im) for im in image]
            else:
                image = tile(image)

        def on_dev(x):
            return None if x is None else x.to(dev)

        prompt_embeds, pooled_prompt_embeds = on_dev(prompt_embeds), on_dev(pooled_prompt_embeds)
        negative_prompt_embeds = on_dev(negative_prompt_embeds)
        negative_pooled_prompt_embeds = on_dev(negative_pooled_prompt_embeds)
        b = prompt_embeds.shape[0]
        down = self.vae_cfg.downscale
        lat_h = 2 * (height // (down * 2))
        lat_w = 2 * (width // (down * 2))

        if latents is None:
            if generator is None:
                raise ValueError("need a generator (or latents) for the initial noise")
            noise = torch.randn(b, lat_h, lat_w, self.vae_cfg.latent_channels, dtype=torch.float32,
                                device=dev, generator=generator).to(prompt_embeds.dtype)
            latents = pack_latents(noise)
        latents = latents.to(dev)

        latent_ids = latent_image_ids(lat_h // 2, lat_w // 2, modality=0, device=dev)
        if image is not None:
            images = list(image) if isinstance(image, (list, tuple)) else [image]
            image_latents, image_ids = self.encode_references(images)
            image_latents = image_latents.to(latents.dtype)
        if image_latents is not None:
            if image_ids is None:
                raise ValueError("image_latents need image_ids")
            latent_ids = torch.cat([latent_ids, image_ids.to(dev)], dim=0)

        sigmas = torch.from_numpy(flow_sigmas(num_inference_steps, latents.shape[1])).to(dev)
        guidance = torch.full((b,), guidance_scale, dtype=torch.float32, device=dev)
        final = denoise_scan(
            self.flux_params, self.flux_cfg,
            latents=latents,
            image_latents=on_dev(image_latents),
            latent_ids=latent_ids,
            prompt_embeds=prompt_embeds,
            pooled_embeds=pooled_prompt_embeds,
            sigmas=sigmas,
            guidance=guidance,
            num_steps=num_inference_steps,
            neg_prompt_embeds=negative_prompt_embeds,
            neg_pooled_embeds=negative_pooled_prompt_embeds,
            true_cfg_scale=true_cfg_scale,
            txt_pad_mask=on_dev(txt_pad_mask),
            neg_txt_pad_mask=on_dev(neg_txt_pad_mask),
            step_callback=step_callback,
        )
        if output_type == "latent":
            return final
        z = unpack_latents(final, lat_h, lat_w).float()
        return self._decode(z)


def postprocess_to_uint8(images: torch.Tensor) -> np.ndarray:
    """(B, H, W, 3) in [-1, 1] -> uint8 numpy."""
    arr = images.detach().float().cpu().numpy()
    arr = np.clip(arr / 2.0 + 0.5, 0.0, 1.0)
    return (arr * 255.0).round().astype(np.uint8)
