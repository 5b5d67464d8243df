"""Reference goldens through the port: tests/golden/*.npz hold the reference
torch modules' state dicts (fp16), inputs and outputs. The port loads the
state dicts with its reference-checkpoint loader (io.convert: key
normalisation, 1×1 convs onto Linear, interleaved → half-split RoPE rows)
and must reproduce the outputs. Tolerances as tests/test_golden.py: 2e-4 for
one module, 5e-4 for the tiny UNet (fp16-rounded weights, fp32 math), and
the pipeline-level golden's ≥ 35 dB PSNR contract (BASELINE.md)."""

import json
import os

import numpy as np
import pytest
import torch

from lavie_tpu_torch.core.config import CLIPTextConfig, UNetConfig, VAEConfig
from lavie_tpu_torch.io.convert import load_reference_state_dict
from lavie_tpu_torch.nn.attention import Attention, TemporalAttention
from lavie_tpu_torch.nn.resnet import ResnetBlock3D
from lavie_tpu_torch.nn.unet import UNet3D
from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def load(name):
    path = os.path.join(GOLDEN, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden dump {name} absent")
    z = np.load(path)
    sd = {k[3:]: z[k].astype(np.float32) for k in z.files if k.startswith("sd.")}
    ins = {k[3:]: z[k] for k in z.files if k.startswith("in.")}
    outs = {k[4:]: z[k] for k in z.files if k.startswith("out.")}
    return sd, ins, outs


def _bcfhw_to_port(x):  # reference (B, C, F, H, W) → port (B, F, H, W, C)
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 3, 4, 1)))


def test_resnet_block3d_golden():
    sd, ins, outs = load("resnet_block3d")
    m = ResnetBlock3D(16, 24, temb_channels=32, groups=8).eval()
    load_reference_state_dict(m, sd, heads=1, rot_dim=0)
    with torch.no_grad():
        got = m(_bcfhw_to_port(ins["x"]), torch.from_numpy(ins["temb"]))
    np.testing.assert_allclose(got.numpy().transpose(0, 4, 1, 2, 3), outs["y"], atol=2e-4)


@pytest.mark.parametrize("name,ctx_dim", [("cross_attention_self", None), ("cross_attention_text", 20)])
def test_cross_attention_golden(name, ctx_dim):
    sd, ins, outs = load(name)
    m = Attention(32, heads=4, head_dim=8, cross_attention_dim=ctx_dim).eval()
    load_reference_state_dict(m, sd, heads=4, rot_dim=0)
    ctx = torch.from_numpy(ins["ctx"]) if ctx_dim else None
    with torch.no_grad():
        got = m(torch.from_numpy(ins["x"]), ctx)
    np.testing.assert_allclose(got.numpy(), outs["y"], atol=2e-4)


def test_temporal_attention_golden():
    sd, ins, outs = load("temporal_attention")
    m = TemporalAttention(32, heads=4, head_dim=8, rope_dim=8).eval()
    load_reference_state_dict(m, sd, heads=4, rot_dim=8)
    x = ins["x"]  # (B·S, F, C) rows → the port's (B, F, S, C) with B = 1
    xin = torch.from_numpy(x.transpose(1, 0, 2)[None].copy())
    with torch.no_grad():
        got = m(xin)[0].numpy().transpose(1, 0, 2)
    np.testing.assert_allclose(got, outs["y"], atol=2e-4)


def test_tiny_base_unet_golden():
    sd, ins, outs = load("tiny_base_unet")
    cfg = UNetConfig(
        block_out_channels=(32, 32, 32, 32), layers_per_block=1,
        num_attention_heads=1, norm_num_groups=8, cross_attention_dim=24, rope_dim=32,
    )
    m = UNet3D(cfg).eval()
    load_reference_state_dict(m, sd, heads=1, rot_dim=32)
    x = torch.from_numpy(ins["x"].transpose(0, 2, 3, 4, 1).copy())  # (B,C,F,H,W) → (B,F,H,W,C)
    ts = torch.from_numpy(ins["t"].astype(np.int64).reshape(-1))
    with torch.no_grad():
        got = m(x, ts, torch.from_numpy(ins["ctx"])).numpy().transpose(0, 4, 1, 2, 3)
    np.testing.assert_allclose(got, outs["y"], atol=5e-4)


def test_pipeline_level_golden():
    """The reference's own tiny base UNet driven by its denoise loop (10 DDIM
    steps, CFG 7.5, injected latents and text states) and decoded by the
    torch VAE twin, replayed through the port's TextToVideoPipeline."""
    z = np.load(os.path.join(GOLDEN, "pipeline_base.npz"))
    meta = json.loads(str(z["meta"]))
    cfg = lambda c, d: c(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})  # noqa: E731
    unet_cfg, vae_cfg = cfg(UNetConfig, meta["unet"]), cfg(VAEConfig, meta["vae"])
    pipe = TextToVideoPipeline(unet_cfg, vae_cfg, CLIPTextConfig.vit_l().tiny(),
                               dtype=torch.float32, device="cpu")
    for prefix, module in (("unet::", pipe.unet), ("vae::", pipe.vae)):
        sd = {k[len(prefix):]: z[k].astype(np.float32) for k in z.files if k.startswith(prefix)}
        load_reference_state_dict(module, sd, heads=unet_cfg.num_attention_heads,
                                  rot_dim=unet_cfg.rope_dim)
    out = pipe("", latents=z["latents"].transpose(0, 2, 3, 4, 1), text_states=z["text_states"],
               num_inference_steps=int(meta["steps"]), guidance_scale=float(meta["guidance"]),
               sample_method="ddim")
    np.testing.assert_allclose(out.latents.numpy(), z["final_latents"].transpose(0, 2, 3, 4, 1),
                               atol=5e-3)  # 10 steps, CFG 7.5 amplifies fp32 order effects
    mse = np.mean((out.video.astype(np.float64) - z["video"].astype(np.float64)) ** 2)
    psnr = float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)
    print(f"pipeline-level PSNR {psnr:.2f} dB")
    assert psnr >= 35.0, f"pipeline-level PSNR {psnr:.2f} dB < 35"
