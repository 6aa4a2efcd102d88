"""One-shot edit CLI (counterpart of `gpt_image_edit_tpu.serve.cli`, its
single-edit mode).

    python -m gpt_image_edit_tpu_torch.serve.cli --synthetic_full --quantize w8a8-attn \\
        --image in.png --prompt "make the sky dramatic" --output out.png
    python -m gpt_image_edit_tpu_torch.serve.cli --tiny --device cpu --prompt "demo"

`--synthetic_full` builds the full-size models with seeded random weights
on the card (no checkpoint loading yet); `--tiny` the tiny configs. The
device defaults to the card and the run fails without one unless `--device
cpu` is given. The REPL and `--understand` (chat) come with a later slice.
"""

from __future__ import annotations

import argparse
import logging
import sys

from PIL import Image

from gpt_image_edit_tpu_torch.serve.runtime import QUANTIZE_MODES, UnivaRuntime


def build_parser():
    p = argparse.ArgumentParser(description="GPT-Image-Edit serving CLI (PyTorch/CUDA)")
    p.add_argument("--tiny", action="store_true", help="random tiny weights (plumbing demo)")
    p.add_argument("--synthetic_full", action="store_true",
                   help="full-size models with seeded random weights (no checkpoint)")
    p.add_argument("--image", type=str, default=None)
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--output", type=str, default="output.png")
    p.add_argument("--steps", type=int, default=28)
    p.add_argument("--guidance", type=float, default=3.5)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quantize", type=str, default=None, choices=[None, *QUANTIZE_MODES],
                   help="denoiser quantization: w8a8 = int8 products, w8a8-qk8 = + int8 "
                        "q k^T attention (K3), w8a8-attn = + int8 q k^T and p v attention (K4); "
                        "the weight-only int8 / int4 modes come in a later slice")
    p.add_argument("--understand", action="store_true",
                   help="text answer instead of an edit (not ported yet)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    if args.understand:
        raise NotImplementedError("--understand (chat) is not ported yet: it comes with the VLM's "
                                  "KV-cache decode, a later slice of the port")
    if args.prompt is None:
        raise NotImplementedError("the REPL (chat turns) is not ported yet; pass --prompt")
    rt = UnivaRuntime(tiny=args.tiny, synthetic_full=args.synthetic_full, seed=args.seed,
                      quantize=args.quantize, device=args.device)
    image = Image.open(args.image) if args.image else None
    out = rt.edit(args.prompt, image, steps=args.steps, guidance=args.guidance,
                  height=args.height, width=args.width, seed=args.seed)
    out.save(args.output)
    print(f"saved {args.output} ({out.width}x{out.height}); stage seconds "
          + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in rt.last_timings.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
