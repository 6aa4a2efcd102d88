from gpt_image_edit_tpu_torch.pipeline.scheduler import (
    calculate_shift,
    flow_sigmas,
    shift_sigmas,
)
from gpt_image_edit_tpu_torch.pipeline.kontext import (
    KontextPipeline,
    PREFERRED_KONTEXT_RESOLUTIONS,
    pick_kontext_resolution,
    postprocess_to_uint8,
)
