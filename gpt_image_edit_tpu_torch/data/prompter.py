"""ChatML prompt templating (a copy of
`gpt_image_edit_tpu.data.prompter.Qwen2VLPrompter`, the serving half)."""

from __future__ import annotations

from typing import Dict, List


class Qwen2VLPrompter:
    system_role = "system"
    user_role = "user"
    assistant_role = "assistant"
    default_system = "You are a helpful assistant."

    def __call__(self, conversations: List[Dict[str, str]], add_generation_prompt: bool = True) -> str:
        out = []
        if not any(c["from"] == self.system_role for c in conversations):
            out.append(f"<|im_start|>system\n{self.default_system}<|im_end|>\n")
        for c in conversations:
            out.append(f"<|im_start|>{c['from']}\n{c['value']}<|im_end|>\n")
        if add_generation_prompt:
            out.append("<|im_start|>assistant\n")
        return "".join(out)
