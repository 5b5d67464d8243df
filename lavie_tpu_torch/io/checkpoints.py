"""Checkpoint loading for the port's pipelines (port of
lavie_tpu.io.checkpoints): the reference's monolithic .pt files (the `ema`
sub-dict preferred, reference: base/download.py:10-18) and the diffusers
component folders (`vae/`, `text_encoder/`) of SD-1.4 and the x4 upscaler,
converted by io.convert into the pipeline's own modules, in place.

Native checkpoints (`save_native`/`load_native`, in place of the JAX
package's orbax checkpoints): any tree of dicts, lists, tensors and numbers
written with torch.save into a directory, as the training layer's
`checkpoint-{step}` directories hold them.

Every UNet is re-based from the reference's interleaved RoPE into the port's
half-split basis by its stage config (rot_dim 0 where the temporal attention
has no RoPE, as in the TSR UNet). The JAX package's entry points skip that
re-basis; the port does not copy the omission.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from lavie_tpu_torch.io.convert import (
    convert_clip_text,
    export_reference_state_dict,
    load_reference_state_dict,
    load_torch_state_dict,
)

# the files Predictor.setup(ckpt_dir) and the cascade CLI look for
BASE_CKPT, TSR_CKPT, VSR_CKPT = "lavie_base.pt", "lavie_interpolation.pt", "lavie_vsr.pt"
SD_DIR, UPSCALER_DIR = "stable-diffusion-v1-4", "stable-diffusion-x4-upscaler"


def unet_rebasis(cfg) -> dict:
    """The RoPE re-basis of a stage's UNet: its heads, and rot_dim 0 where
    the temporal attention has no RoPE (the TSR UNet)."""
    return {"heads": cfg.num_attention_heads,
            "rot_dim": cfg.rope_dim if cfg.temporal_attention == "rope_relbias" else 0}


def load_pipeline_params(pipe, unet_ckpt: Optional[str] = None,
                         sd_path: Optional[str] = None) -> None:
    """Fill a stage pipeline's `unet`, `vae` and `text_encoder` from
    reference files, in place, keeping their dtype and device: the UNet from
    `unet_ckpt`, the VAE and text tower from `sd_path`'s `vae/` and
    `text_encoder/`. A path or file that does not exist leaves its module's
    weights as they were."""
    if unet_ckpt and os.path.exists(unet_ckpt):
        load_reference_state_dict(pipe.unet, load_torch_state_dict(unet_ckpt),
                                  **unet_rebasis(pipe.unet_config))
    if sd_path:
        vae_bin = _find_weights(os.path.join(sd_path, "vae"))
        if vae_bin:
            load_reference_state_dict(pipe.vae, load_torch_state_dict(vae_bin), heads=1, rot_dim=0)
        text_bin = _find_weights(os.path.join(sd_path, "text_encoder"))
        if text_bin:
            convert_clip_text(pipe.text_encoder, load_torch_state_dict(text_bin))


def save_pipeline_params(pipe, unet_ckpt: str, sd_path: Optional[str] = None) -> None:
    """The inverse of load_pipeline_params, in fp32 and the reference layout
    (io.convert.export_reference_state_dict): the UNet as {"ema": state
    dict} at `unet_ckpt`, the VAE and the text tower as `sd_path`'s
    vae/diffusion_pytorch_model.bin and text_encoder/pytorch_model.bin. It
    writes the files that the tests and the smoke run load back."""
    files = [(unet_ckpt, "ema",
              export_reference_state_dict(pipe.unet, **unet_rebasis(pipe.unet_config)))]
    if sd_path:
        files += [(os.path.join(sd_path, "vae", "diffusion_pytorch_model.bin"), None,
                   export_reference_state_dict(pipe.vae)),
                  (os.path.join(sd_path, "text_encoder", "pytorch_model.bin"), None,
                   export_reference_state_dict(pipe.text_encoder))]
    for path, wrap, sd in files:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
        torch.save({wrap: sd} if wrap else sd, path)


def _find_weights(folder: str) -> Optional[str]:
    for name in ("diffusion_pytorch_model.bin", "pytorch_model.bin", "model.pt"):
        path = os.path.join(folder, name)
        if os.path.exists(path):
            return path
    return None


def load_cascade_checkpoints(cascade, ckpt_dir: str) -> None:
    """Each stage of a VideoCascadePipeline from `ckpt_dir`, as the server's
    setup does (reference: predict.py:45-60): lavie_base.pt and
    lavie_interpolation.pt with stable-diffusion-v1-4/'s VAE and text tower,
    lavie_vsr.pt with stable-diffusion-x4-upscaler/'s. A stage whose UNet
    file is absent keeps its weights."""
    sd = os.path.join(ckpt_dir, SD_DIR)
    for stage, name, folder in ((cascade.base, BASE_CKPT, sd), (cascade.interpolation, TSR_CKPT, sd),
                                (cascade.vsr, VSR_CKPT, os.path.join(ckpt_dir, UPSCALER_DIR))):
        path = os.path.join(ckpt_dir, name)
        if stage is not None and os.path.exists(path):
            load_pipeline_params(stage, path, folder)


# ---------------------------------------------------------------------------
# native checkpoints
# ---------------------------------------------------------------------------

NATIVE_FILE = "state.pt"


def _detached(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree


def save_native(path: str, tree: Any) -> None:
    """Write `tree` (dicts, lists, tuples, tensors, numbers, strings) as the
    directory `path`, replacing its file whole: the file is written beside
    it first and then renamed over it."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, NATIVE_FILE)
    torch.save(_detached(tree), target + ".tmp")
    os.replace(target + ".tmp", target)


def load_native(path: str, map_location: Any = "cpu") -> Any:
    """The tree save_native wrote at `path`, its tensors on map_location."""
    return torch.load(os.path.join(path, NATIVE_FILE), map_location=map_location,
                      weights_only=True)
