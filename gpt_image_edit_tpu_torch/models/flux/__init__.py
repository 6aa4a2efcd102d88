from gpt_image_edit_tpu_torch.models.flux.config import FluxConfig
from gpt_image_edit_tpu_torch.models.flux.model import init as init_flux, apply as apply_flux
