"""CLIP text encoder (port of lavie_tpu.nn.clip.CLIPTextModel): pre-LN
blocks, causal mask, a quick-gelu (ViT-L) or erf-gelu (OpenCLIP-H) MLP.
Token ids (B, L) → last_hidden_state (B, L, hidden). Parameter names follow the JAX package's flat layout
(`layers.N.self_attn.q_proj`, `token_embedding`, `position_embedding`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lavie_tpu_torch.core.config import CLIPTextConfig


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in fp32, returned in x's dtype."""
    return F.layer_norm(
        x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps
    ).to(x.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
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
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
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
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act)

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
