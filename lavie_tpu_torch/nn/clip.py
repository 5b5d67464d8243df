"""CLIP towers (port of lavie_tpu.nn.clip): the text encoder (pre-LN blocks,
causal mask, a quick-gelu (ViT-L) or erf-gelu (OpenCLIP-H) MLP; token ids
(B, L) → last_hidden_state (B, L, hidden)), the ViT vision tower of the
fork's image conditioning (NHWC pixels → (B, 1 + patches, hidden), blocks
without a mask), the dual encoder that pools and projects both, and
`token_drop`/`TextEmbedder`, the text tower with the training recipe's
caption dropout.
Parameter names follow the JAX package's flat layout (`layers.N.self_attn.
q_proj`, `token_embedding`, `position_embedding`, `patch_embedding`,
`class_embedding`, the reference's `pre_layrnorm`)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lavie_tpu_torch.core.config import CLIPTextConfig, CLIPVisionConfig


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in fp32, returned in x's dtype."""
    return F.layer_norm(
        x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps
    ).to(x.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, causal: bool = True):
        super().__init__()
        self.num_heads, self.causal = num_heads, causal
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        hd = c // self.num_heads
        q, k, v = (
            p(x).view(b, s, self.num_heads, hd).transpose(1, 2)
            for p in (self.q_proj, self.k_proj, self.v_proj)
        )
        out = F.scaled_dot_product_attention(q, k, v, is_causal=self.causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, c))


class CLIPMLP(nn.Module):
    """fc1 → activation → fc2; `hidden_act` "quick_gelu" (the OpenAI ViT-L
    towers) or "gelu" (erf-exact, the OpenCLIP-H tower)."""

    def __init__(self, hidden_size: int, intermediate_size: int, hidden_act: str = "quick_gelu"):
        super().__init__()
        if hidden_act not in ("quick_gelu", "gelu"):
            raise ValueError(f"unsupported CLIP hidden_act: {hidden_act!r}")
        self.hidden_act = hidden_act
        self.fc1 = nn.Linear(hidden_size, intermediate_size)
        self.fc2 = nn.Linear(intermediate_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        if self.hidden_act == "gelu":
            return self.fc2(F.gelu(x))
        return self.fc2(x * torch.sigmoid(1.702 * x))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg, causal: bool = True):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads, causal)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size,
                           getattr(cfg, "hidden_act", "quick_gelu"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(_layer_norm(self.layer_norm1, x))
        return x + self.mlp(_layer_norm(self.layer_norm2, x))


class CLIPTextModel(nn.Module):
    """Token ids (B, L) → last_hidden_state (B, L, hidden)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.token_embedding = nn.Embedding(config.vocab_size, config.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.randn(config.max_position_embeddings, config.hidden_size) * 0.02
        )
        self.layers = nn.ModuleList([CLIPEncoderLayer(config) for _ in range(config.num_layers)])
        self.final_layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(input_ids) + self.position_embedding[: input_ids.shape[1]]
        for layer in self.layers:
            x = layer(x)
        return _layer_norm(self.final_layer_norm, x)


def token_drop(token_ids: torch.Tensor, uncond_ids: torch.Tensor,
               generator: Optional[torch.Generator] = None, drop_prob: float = 0.1,
               force_drop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Classifier-free-guidance caption dropout: with probability
    `drop_prob` a row of token_ids (B, L) is replaced by the empty prompt's
    ids uncond_ids (L,) or (1, L) (reference: TextEmbedder.token_drop
    base/models/clip.py:70-81, which blanks the prompt string before
    tokenising: the same operation on ids). force_drop (B,) bool overrides
    the draw."""
    b = token_ids.shape[0]
    if force_drop is None:
        gen_device = generator.device if generator is not None else "cpu"
        drop = (torch.rand((b,), generator=generator, device=gen_device) < drop_prob).to(
            token_ids.device)
    else:
        drop = force_drop.to(device=token_ids.device, dtype=torch.bool)
    uncond = torch.as_tensor(uncond_ids, device=token_ids.device).reshape(1, -1).expand_as(token_ids)
    return torch.where(drop[:, None], uncond.to(token_ids.dtype), token_ids)


class TextEmbedder(nn.Module):
    """The CLIP text tower with CFG caption dropout for training (reference:
    TextEmbedder base/models/clip.py:61-88); parameters under `text_model`."""

    def __init__(self, config: CLIPTextConfig, dropout_prob: float = 0.1):
        super().__init__()
        self.dropout_prob = dropout_prob
        self.text_model = CLIPTextModel(config)

    def forward(self, token_ids: torch.Tensor, uncond_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, train: bool = False,
                force_drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (train and self.dropout_prob > 0) or force_drop is not None:
            if uncond_ids is None:
                raise ValueError("token_drop needs the empty prompt's ids")
            token_ids = token_drop(token_ids, uncond_ids, generator, self.dropout_prob, force_drop)
        return self.text_model(token_ids)


class CLIPVisionModel(nn.Module):
    """Pixels (B, H, W, 3), CLIP-normalised (eval.clipsim.clip_preprocess) →
    last_hidden_state (B, 1 + patches, hidden). The image conditioning reads
    the raw last_hidden_state; `with_post_layernorm` adds the final
    `post_layernorm`, whose class token the dual encoder pools."""

    def __init__(self, config: CLIPVisionConfig, with_post_layernorm: bool = False):
        super().__init__()
        self.config = config
        c = config.hidden_size
        self.patch_embedding = nn.Conv2d(3, c, config.patch_size, stride=config.patch_size,
                                         bias=False)
        self.class_embedding = nn.Parameter(torch.randn(c) * 0.02)
        self.position_embedding = nn.Parameter(torch.randn(config.num_positions, c) * 0.02)
        self.pre_layrnorm = nn.LayerNorm(c, eps=config.layer_norm_eps)
        self.layers = nn.ModuleList([CLIPEncoderLayer(config, causal=False)
                                     for _ in range(config.num_layers)])
        self.post_layernorm = (nn.LayerNorm(c, eps=config.layer_norm_eps)
                               if with_post_layernorm else None)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = pixel_values.to(self.patch_embedding.weight.dtype).permute(0, 3, 1, 2)
        patches = self.patch_embedding(x).flatten(2).transpose(1, 2)  # (B, h·w, C), rows first
        cls = self.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1) + self.position_embedding.to(patches.dtype)
        x = _layer_norm(self.pre_layrnorm, x)
        for layer in self.layers:
            x = layer(x)
        return x if self.post_layernorm is None else _layer_norm(self.post_layernorm, x)


class CLIPDualEncoder(nn.Module):
    """The CLIP joint text-image embedding model (transformers CLIPModel):
    EOS-pooled text through `text_projection`, the post-LN class token
    through `visual_projection`, both without bias."""

    def __init__(self, text_config: CLIPTextConfig, vision_config: CLIPVisionConfig):
        super().__init__()
        self.text_model = CLIPTextModel(text_config)
        self.vision_model = CLIPVisionModel(vision_config, with_post_layernorm=True)
        proj = text_config.projection_dim
        self.text_projection = nn.Linear(text_config.hidden_size, proj, bias=False)
        self.visual_projection = nn.Linear(vision_config.hidden_size, proj, bias=False)

    def get_text_embeds(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(B, L) ids → (B, proj), pooled at the first EOS: the end-of-text
        id is the vocabulary's highest and the padding repeats it, so the
        first argmax finds it."""
        hidden = self.text_model(input_ids)
        eos = torch.argmax(input_ids, dim=-1)
        return self.text_projection(hidden[torch.arange(hidden.shape[0], device=hidden.device), eos])

    def get_image_embeds(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, proj)."""
        return self.visual_projection(self.vision_model(pixel_values)[:, 0])

    def forward(self, input_ids: torch.Tensor, pixel_values: torch.Tensor):
        return self.get_text_embeds(input_ids), self.get_image_embeds(pixel_values)
