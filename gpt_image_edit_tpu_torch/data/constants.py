"""Special tokens and Qwen2.5-VL token ids (a copy of
`gpt_image_edit_tpu.data.constants`)."""

GENERATE_TOKEN = "<gen_image>"

SPECIAL_TOKENS = {
    "image_token": "<|image_pad|>",
    "image_begin_token": "<|vision_start|>",
    "image_end_token": "<|vision_end|>",
}

# Qwen2.5-VL tokenizer ids
IMAGE_TOKEN_ID = 151655
VIDEO_TOKEN_ID = 151656
VISION_START_ID = 151652
VISION_END_ID = 151653
IM_START_ID = 151644
IM_END_ID = 151645
ASSISTANT_TOKEN_ID = 77091  # task-head probe token

# CLIP normalization used by the Qwen image processor
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
