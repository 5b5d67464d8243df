"""Configuration dataclasses for the PyTorch port (a copy of lavie_tpu.core.config,
which the port must not import).

The port covers base text-to-video, temporal interpolation (TSR) and video
super-resolution (VSR), so the configs carry those three stages' fields.
Public config surface mirrors the reference's OmegaConf YAML files
(reference: base/configs/sample.yaml, interpolation/configs/sample.yaml,
vsr/configs/sample.yaml).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Spatio-temporal UNet. Defaults reproduce base text-to-video: the
    SD-1.4 UNet inflated to video (reference: base/models/unet.py:101-295
    and the SD-1.4 unet config.json); `interpolation()` is the TSR UNet."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "DownBlock3D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
    )
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # Number of attention heads per block. The reference inherits diffusers'
    # misnamed `attention_head_dim=8`, which for SD-1.4 actually means 8 heads
    # (reference: base/models/unet_blocks.py:289-291 divides channels by it).
    num_attention_heads: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    mid_block_scale_factor: float = 1.0
    # Opt-in int8 turbo convs ("none" | "int8", nn/quant.py): outside the
    # parity contract, off by default.
    conv_quant: str = "none"
    # substrings of a conv's JAX module path that keep it exact in int8 mode
    # (selective quantisation, e.g. ("samplers", "up_blocks"))
    conv_quant_exclude: Tuple[str, ...] = ()
    # "self": spatial self-attention (base); "sparse_causal": each frame's
    # k/v are frames {0, i-1} (interpolation; reference
    # interpolation/models/attention.py:609-665)
    spatial_attention: str = "self"
    # "rope_relbias": RoPE on q/k + bucketed relative-position bias (base);
    # "plain": bare frame-axis attention (interpolation)
    temporal_attention: str = "rope_relbias"
    # the interpolation block runs its FF before temporal attention
    # (reference: interpolation/models/attention.py:570-607)
    ff_before_temporal: bool = False
    rope_dim: int = 32
    relpos_num_buckets: int = 32
    relpos_max_distance: int = 32

    # VSR variants (reference: vsr/configs/unet_3d_config.json)
    # only-cross blocks: attn1 attends to the text too; one flag or one per
    # down block (mirrored on the way up)
    only_cross_attention: Union[bool, Tuple[bool, ...]] = False
    # (the reference's use_linear_projection has no counterpart: proj_in and
    # proj_out are nn.Linear over channels-last tokens in every config)
    # None | "num_embeds": learned noise-level embedding added to the time
    # embedding (reference: vsr/models/unet.py:179-186)
    class_embed_type: Optional[str] = None
    num_class_embeds: Optional[int] = None
    # a TemporalModule3D after every down/mid/up block
    use_temporal_modules: bool = False
    # every Transformer3D starts with a ResnetBlock3DCNN(k=3) inside its residual
    transformer_temporal_resblock: bool = False
    # branches of the temporal module that the shipped config switches off;
    # the port raises NotImplementedError when one is switched on
    temporal_module_attention_types: Tuple[str, str] = ("", "")
    temporal_module_use_dcn_warpping: bool = False
    temporal_module_use_deformable_conv: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def only_cross_attention_per_block(self) -> Tuple[bool, ...]:
        oca = self.only_cross_attention
        if isinstance(oca, bool):
            return (oca,) * len(self.down_block_types)
        return tuple(oca)

    @classmethod
    def base_t2v(cls) -> "UNetConfig":
        return cls()

    @classmethod
    def interpolation(cls, use_mask: bool = False) -> "UNetConfig":
        """TSR UNet: 8 input channels (4 noise + 4 copied-video latents), or 9
        with a mask channel (reference: interpolation/models/unet.py:503-508);
        sparse-causal spatial attention, plain temporal attention, FF before
        temporal."""
        return cls(
            in_channels=9 if use_mask else 8,
            spatial_attention="sparse_causal",
            temporal_attention="plain",
            ff_before_temporal=True,
        )

    @classmethod
    def vsr(cls) -> "UNetConfig":
        """The x4-upscaler UNet inflated to video: 7 input channels (4 latent
        + 3 low-res RGB), widths 256/512/512/1024, only-cross blocks at the
        three upper levels, a noise-level class embedding, temporal modules
        after every block and a temporal resblock in every transformer
        (reference: vsr/configs/unet_3d_config.json, vsr/models/unet.py)."""
        return cls(
            in_channels=7,
            block_out_channels=(256, 512, 512, 1024),
            down_block_types=("DownBlock3D", "CrossAttnDownBlock3D", "CrossAttnDownBlock3D",
                              "CrossAttnDownBlock3D"),
            up_block_types=("CrossAttnUpBlock3D", "CrossAttnUpBlock3D", "CrossAttnUpBlock3D",
                            "UpBlock3D"),
            cross_attention_dim=1024,
            only_cross_attention=(True, True, True, False),
            class_embed_type="num_embeds",
            num_class_embeds=1000,
            use_temporal_modules=True,
            transformer_temporal_resblock=True,
        )

    def tiny(self, **overrides: Any) -> "UNetConfig":
        """A scaled-down config with the same topology, for tests."""
        small = dataclasses.replace(
            self,
            block_out_channels=tuple(32 for _ in self.block_out_channels),
            layers_per_block=1,
            num_attention_heads=2,
            norm_num_groups=8,
            # matches CLIPTextConfig.tiny().hidden_size so tiny pipelines wire up
            cross_attention_dim=32,
            rope_dim=4,
        )
        return dataclasses.replace(small, **overrides)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL: the SD-1.4 f8 VAE."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    mid_block_attention: bool = True
    # opt-in int8 turbo for the codec's wide 3×3 convs (see UNetConfig)
    conv_quant: str = "none"
    conv_quant_exclude: Tuple[str, ...] = ()

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def sd(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def vsr(cls) -> "VAEConfig":
        """The x4-upscaler's f4 VAE (reference: vsr/configs/vae_config.json)."""
        return cls(block_out_channels=(128, 256, 512), scaling_factor=0.08333)

    def tiny(self) -> "VAEConfig":
        return dataclasses.replace(
            self,
            block_out_channels=tuple(16 for _ in self.block_out_channels),
            layers_per_block=1,
            norm_num_groups=4,
        )


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text encoder. Defaults are ViT-L/14 (SD-1.4 text encoder,
    reference: base/models/clip.py:32-58 wraps transformers CLIPTextModel)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    # the MLP's activation: "quick_gelu" (the OpenAI ViT-L towers) or "gelu"
    # (erf-exact; the x4-upscaler's OpenCLIP-H text tower)
    hidden_act: str = "quick_gelu"

    @classmethod
    def vit_l(cls) -> "CLIPTextConfig":
        return cls()

    @classmethod
    def open_clip_h(cls) -> "CLIPTextConfig":
        """OpenCLIP ViT-H/14's text tower, the VSR stage's text states."""
        return cls(hidden_size=1024, num_layers=23, num_heads=16, intermediate_size=4096,
                   hidden_act="gelu")

    def tiny(self) -> "CLIPTextConfig":
        return dataclasses.replace(
            self,
            vocab_size=128,
            hidden_size=32,
            num_layers=2,
            num_heads=2,
            intermediate_size=64,
            max_position_embeddings=16,
        )


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Sampling recipe. Defaults match the reference base stage
    (reference: base/configs/sample.yaml:23-40)."""

    video_length: int = 16
    height: int = 320
    width: int = 512
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    sample_method: str = "ddpm"  # ddpm | ddim | eulerdiscrete
    beta_start: float = 1e-4
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    num_train_timesteps: int = 1000
    steps_offset: int = 1
    prediction_type: str = "epsilon"  # epsilon | v_prediction
    eta: float = 0.0
    fps: int = 8
    # The reference builds DDPM/DDIM via from_pretrained on the SD-1.4
    # scheduler config (base/pipelines/sample.py:44-60): that config has no
    # clip_sample key, so diffusers' default clip_sample=True applies, and it
    # sets set_alpha_to_one=false (DDIM's terminal previous-alpha is ᾱ₀, not
    # 1). The VSR stage overrides both from the x4-upscaler config
    # (clip_sample=false there).
    clip_sample: bool = True
    set_alpha_to_one: bool = False

    @classmethod
    def interpolation(cls) -> "SamplingConfig":
        """The TSR stage: 61 frames, 50 DDIM steps on OpenAI's spaced chain,
        CFG 4.0, no x0 clipping (reference: interpolation/sample.py:118-126
        samples with clip_denoised=False)."""
        return cls(video_length=61, num_inference_steps=50, guidance_scale=4.0,
                   sample_method="ddim", clip_sample=False)

    @classmethod
    def vsr(cls) -> "SamplingConfig":
        """The VSR stage: 50 v-prediction DDIM steps, CFG 5.0, no x0
        clipping (the x4-upscaler scheduler config; reference:
        vsr/sample.py:49-53)."""
        return cls(num_inference_steps=50, guidance_scale=5.0, sample_method="ddim",
                   prediction_type="v_prediction", clip_sample=False)


def with_conv_quant(cfg, mode: str = "none", exclude: Sequence[str] = ()):
    """A UNetConfig or VAEConfig with the int8 turbo keys set as the JAX
    package's CLIs and cascade set them: mode "none" leaves cfg as it is;
    "VAE" in `exclude` keeps the VAE exact and is not handed on as a
    pattern (lavie_tpu/pipelines/cascade.py's mk)."""
    if mode == "none":
        return cfg
    if isinstance(cfg, VAEConfig) and "VAE" in exclude:
        mode = "none"
    return dataclasses.replace(cfg, conv_quant=mode,
                               conv_quant_exclude=tuple(p for p in exclude if p != "VAE"))


def yaml_conv_quant(cfg: dict) -> Tuple[str, Tuple[str, ...]]:
    """(conv_quant, conv_quant_exclude) from a CLI's YAML keys: the mode, and
    the patterns comma-separated (lavie_tpu/cli/sample.py's surface)."""
    exclude = tuple(p for p in str(cfg.get("conv_quant_exclude", "")).split(",") if p)
    return str(cfg.get("conv_quant", "none")), exclude


def load_yaml_config(path: str) -> dict:
    """Load an OmegaConf-style YAML config file (reference CLI surface:
    base/pipelines/sample.py:95-100)."""
    import yaml  # not installed everywhere the port runs; only the CLI needs it

    with open(path, "r") as f:
        return yaml.safe_load(f)
