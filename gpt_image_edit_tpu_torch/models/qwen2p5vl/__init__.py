from gpt_image_edit_tpu_torch.models.qwen2p5vl.config import (
    Qwen2p5VLConfig,
    TextConfig,
    VisionConfig,
)
from gpt_image_edit_tpu_torch.models.qwen2p5vl.model import (
    apply as apply_qwen,
    init as init_qwen,
)
