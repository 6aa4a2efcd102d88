"""gpt_image_edit_tpu_torch — the PyTorch/CUDA port of gpt_image_edit_tpu.

A second package beside the JAX one, for one NVIDIA H100. It keeps the JAX
package's module layout and parameter layout, so every module has a
counterpart there to be held against. Plain tensor code is PyTorch; each
Pallas TPU kernel on a ported path becomes a CUDA kernel written for Hopper
(sm_90a) under `csrc/`, built with nvcc on first use. The package imports
neither jax nor gpt_image_edit_tpu.

Ported so far: the FLUX.1-Kontext edit pipeline (VAE encode -> flow-matching
Euler loop over the MMDiT -> VAE decode) in bf16, with the flash-attention
forward kernel (K1); and its W8A8 serving modes (`utils.quantize`, the
quantized branches of `models.common`), "w8a8" and "w8a8-qk8", with the
fused LayerNorm + modulate + int8 row quantization kernel (K2) and the
int8-q k^T flash-attention kernel (K3).
"""

__version__ = "0.1.0"
