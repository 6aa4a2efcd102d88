from gpt_image_edit_tpu_torch.models.vae.config import VaeConfig
from gpt_image_edit_tpu_torch.models.vae.model import (
    init as init_vae,
    encode as vae_encode,
    decode as vae_decode,
    encode_to_scaled_latents,
    decode_from_scaled_latents,
)
