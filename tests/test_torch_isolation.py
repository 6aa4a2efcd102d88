"""The port stands alone: it imports neither jax nor the JAX package, its
entry points refuse to fall back to the CPU, and a CUDA tensor never reaches
the attention kernel's plain version."""

import ast
import inspect
import pkgutil
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest
import torch

import gpt_image_edit_tpu_torch
from gpt_image_edit_tpu_torch.ops.kernels import flash_attention as fa_mod
from gpt_image_edit_tpu_torch.ops.kernels import flash_attention_int8 as k4_mod
from gpt_image_edit_tpu_torch.ops.kernels import flash_attention_qk8 as qk8_mod
from gpt_image_edit_tpu_torch.ops.kernels import fused_quant as fq_mod

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "gpt_image_edit_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "gpt_image_edit_tpu")


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(gpt_image_edit_tpu_torch.__path__,
                                                        "gpt_image_edit_tpu_torch."))


def test_import_pulls_in_no_jax():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {_all_modules()!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in {FORBIDDEN!r})
        assert not bad, bad
        print(len({_all_modules()!r}))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 19


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from gpt_image_edit_tpu_torch.models.flux import FluxConfig
    from gpt_image_edit_tpu_torch.models.vae import VaeConfig
    from gpt_image_edit_tpu_torch.pipeline import KontextPipeline
    from gpt_image_edit_tpu_torch.utils.convert import from_jax
    from gpt_image_edit_tpu_torch.utils.synthetic import synthetic_flux, synthetic_vae

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_flux(FluxConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_vae(VaeConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax({"kernel": torch.zeros(2, 2).numpy()})
    fp = synthetic_flux(FluxConfig.tiny(), device="cpu")
    vp = synthetic_vae(VaeConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KontextPipeline(fp, FluxConfig.tiny(), vp, VaeConfig.tiny())
    KontextPipeline(fp, FluxConfig.tiny(), vp, VaeConfig.tiny(), device="cpu")


def test_cuda_tensor_goes_to_kernel_not_plain(monkeypatch):
    calls = []

    def fake_kernel(q, k, v, **kw):
        calls.append(q)
        return "kernel"

    def plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(fa_mod, "_flash_attention_cuda", fake_kernel)
    monkeypatch.setattr(fa_mod, "flash_attention_reference", plain)
    q = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert fa_mod.flash_attention(q, q, q, pad_mask=None) == "kernel"
    assert calls == [q]


def test_kernel_path_has_no_fallback():
    """The CUDA path neither calls the plain version nor catches errors."""
    src = inspect.getsource(fa_mod._flash_attention_cuda)
    tree = ast.parse(textwrap.dedent(src))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    called = {n.func.id for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert "flash_attention_reference" not in called


def test_kernel_wrapper_rejects_non_cuda_tensors():
    q = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa_mod.flash_attention(q, q, q)


@pytest.mark.parametrize("cuda_path, plain", [
    (fq_mod._ln_modulate_quant_rows_cuda, "ln_modulate_quant_rows_reference"),
    (qk8_mod._flash_attention_qk8_cuda, "flash_attention_qk8_reference"),
    (k4_mod._flash_attention_int8_cuda, "flash_attention_int8_reference"),
], ids=["K2_fused_quant", "K3_flash_attention_qk8", "K4_flash_attention_int8"])
def test_new_kernel_paths_have_no_fallback(cuda_path, plain):
    """K2's, K3's and K4's CUDA paths neither call their plain versions nor catch errors."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(cuda_path)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    called = {n.func.id for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert plain not in called


def test_every_kernel_source_has_a_wrapper_that_builds_it():
    """Each csrc/*.cu has a wrapper that loads it through ops.kernels.build."""
    from gpt_image_edit_tpu_torch.ops.kernels import build

    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert sources == ["flash_attention_fwd", "flash_attention_int8", "flash_attention_qk8",
                       "fused_quant"]
    wrappers = "".join(p.read_text() for p in (PKG / "ops" / "kernels").glob("*.py"))
    for name in sources:
        assert f'kernel_function("{name}"' in wrappers, name
        assert build.library_path(name).parent == ROOT / "build" / "kernels"
