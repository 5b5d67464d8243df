"""The spatio-temporal UNet of base text-to-video, interpolation and video
super-resolution (port of lavie_tpu.nn.unet, the blocks
`UNetConfig.base_t2v()`, `.interpolation()` and `.vsr()` use). The VSR UNet
adds a noise-level class embedding, a TemporalModule3D after every block,
and `forward_prefix`: the text-independent leading blocks, run once per
step and shared by the two CFG halves; `forward_split_cfg` runs a step's
prefix and both halves under one `unet` span. `conv_quant` "int8" turns on the
int8 turbo convs (nn/quant.py) in forward and forward_prefix alike.

Frame sharding: after `set_mesh(mesh)`, forward(..., frames=F) takes this
rank's frames of F-frame videos sharded over the mesh's sp axis
(core/mesh.py). Per-frame work runs on this rank's frames; the modules that
read across frames (the temporal and sparse-causal attentions, the
GroupNorms whose statistics span the video) get the shard for the call.
The VSR UNet is not frame-sharded: its temporal convolutions would need
neighbouring frames at every tap (its pipeline spreads windows instead).

Tensor parallelism: `shard_tensor_parallel(mesh)` keeps this rank's shard
of every attention and feed-forward projection the JAX dry run's rule
splits over the mesh's tp axis (core/tensor_parallel.py), for a training
step (train/step.py::make_train_step). Only the base UNet takes it: the
sparse-causal attention (TSR) and the VSR UNet's only-cross blocks and
temporal modules raise ValueError.

Layout: (B, F, H, W, C) channels-last video tensors throughout.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
from torch import nn

from lavie_tpu_torch.core.config import UNetConfig
from lavie_tpu_torch.core.mesh import Mesh
from lavie_tpu_torch.core.tensor_parallel import mesh_shard, shard_parameters
from lavie_tpu_torch.nn import quant
from lavie_tpu_torch.nn.attention import Attention, SparseCausalAttention, TemporalAttention
from lavie_tpu_torch.nn.layers import GroupNorm, InflatedConv, TimestepEmbedding
from lavie_tpu_torch.nn.resnet import Downsample3D, ResnetBlock3D, Upsample3D
from lavie_tpu_torch.nn.temporal_module import TemporalModule3D
from lavie_tpu_torch.nn.transformer import FeedForward, Transformer3D
from lavie_tpu_torch.utils.profiling import span

Prefix = Tuple[torch.Tensor, List[torch.Tensor]]


def _transformer(cfg: UNetConfig, channels: int, only_cross: bool = False) -> Transformer3D:
    heads = cfg.num_attention_heads
    return Transformer3D(
        channels, heads, channels // heads, num_layers=1,
        cross_attention_dim=cfg.cross_attention_dim, norm_num_groups=cfg.norm_num_groups,
        rope_dim=cfg.rope_dim, relpos_num_buckets=cfg.relpos_num_buckets,
        relpos_max_distance=cfg.relpos_max_distance, spatial_attention=cfg.spatial_attention,
        temporal_attention=cfg.temporal_attention, ff_before_temporal=cfg.ff_before_temporal,
        only_cross_attention=only_cross, use_temporal_resblock=cfg.transformer_temporal_resblock,
    )


def _resnet(cfg: UNetConfig, cin: int, cout: int, scale: float = 1.0) -> ResnetBlock3D:
    return ResnetBlock3D(cin, cout, cfg.time_embed_dim, cfg.norm_num_groups, cfg.norm_eps, scale)


class CrossAttnDownBlock3D(nn.Module):
    """(resnet → Transformer3D) × layers + optional downsample."""

    def __init__(self, cfg: UNetConfig, cin: int, cout: int, num_layers: int, add_downsample: bool,
                 only_cross: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList(
            [_resnet(cfg, cin if i == 0 else cout, cout) for i in range(num_layers)]
        )
        self.attentions = nn.ModuleList([_transformer(cfg, cout, only_cross)
                                         for _ in range(num_layers)])
        self.downsamplers = nn.ModuleList([Downsample3D(cout)]) if add_downsample else None

    def forward(self, x, temb, ehs):
        out = []
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(x, temb), ehs)
            out.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            out.append(x)
        return x, out


class DownBlock3D(nn.Module):
    """resnet × layers + optional downsample."""

    def __init__(self, cfg: UNetConfig, cin: int, cout: int, num_layers: int, add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [_resnet(cfg, cin if i == 0 else cout, cout) for i in range(num_layers)]
        )
        self.downsamplers = nn.ModuleList([Downsample3D(cout)]) if add_downsample else None

    def forward(self, x, temb, ehs=None):
        out = []
        for resnet in self.resnets:
            x = resnet(x, temb)
            out.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            out.append(x)
        return x, out


class UNetMidBlock3DCrossAttn(nn.Module):
    """resnet → (Transformer3D → resnet) × layers."""

    def __init__(self, cfg: UNetConfig, channels: int, num_layers: int = 1):
        super().__init__()
        scale = cfg.mid_block_scale_factor
        self.resnets = nn.ModuleList(
            [_resnet(cfg, channels, channels, scale) for _ in range(num_layers + 1)]
        )
        self.attentions = nn.ModuleList([_transformer(cfg, channels) for _ in range(num_layers)])

    def forward(self, x, temb, ehs):
        x = self.resnets[0](x, temb)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            x = resnet(attn(x, ehs), temb)
        return x


class CrossAttnUpBlock3D(nn.Module):
    """(skip-concat → resnet → Transformer3D) × layers + optional upsample."""

    has_attention = True

    def __init__(self, cfg: UNetConfig, cin: int, prev: int, cout: int, num_layers: int,
                 add_upsample: bool, only_cross: bool = False):
        super().__init__()
        resnets = []
        for i in range(num_layers):
            skip = cin if i == num_layers - 1 else cout
            res_in = prev if i == 0 else cout
            resnets.append(_resnet(cfg, res_in + skip, cout))
        self.resnets = nn.ModuleList(resnets)
        if self.has_attention:
            self.attentions = nn.ModuleList([_transformer(cfg, cout, only_cross)
                                             for _ in range(num_layers)])
        self.upsamplers = nn.ModuleList([Upsample3D(cout)]) if add_upsample else None

    def forward(self, x, skips: List[torch.Tensor], temb, ehs):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=-1), temb)
            if self.has_attention:
                x = self.attentions[i](x, ehs)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UpBlock3D(CrossAttnUpBlock3D):
    """(skip-concat → resnet) × layers + optional upsample."""

    has_attention = False


class UNet3D(nn.Module):
    """forward(sample (B,F,H,W,Cin), timesteps (B,), encoder_hidden_states
    (B,L,D), class_labels (B,) for the VSR noise level) → (B,F,H,W,Cout)
    prediction."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        boc = cfg.block_out_channels
        self.conv_in = InflatedConv(cfg.in_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(
            boc[0], cfg.time_embed_dim, cfg.flip_sin_to_cos, cfg.freq_shift
        )
        if cfg.class_embed_type == "num_embeds":
            self.class_embedding = nn.Embedding(cfg.num_class_embeds, cfg.time_embed_dim)
        elif cfg.class_embed_type is not None:
            raise NotImplementedError(f"class_embed_type {cfg.class_embed_type!r}")
        else:
            self.class_embedding = None
        oca = cfg.only_cross_attention_per_block

        def make(block_type: str, *args, only_cross: bool):
            if block_type.startswith("CrossAttn"):
                return blocks[block_type](cfg, *args, only_cross=only_cross)
            return blocks[block_type](cfg, *args)

        blocks = {"CrossAttnDownBlock3D": CrossAttnDownBlock3D, "DownBlock3D": DownBlock3D}
        self.down_blocks = nn.ModuleList()
        cout = boc[0]
        for i, block_type in enumerate(cfg.down_block_types):
            cin, cout = cout, boc[i]
            self.down_blocks.append(make(block_type, cin, cout, cfg.layers_per_block,
                                         i < len(boc) - 1, only_cross=oca[i]))

        self.mid_block = UNetMidBlock3DCrossAttn(cfg, boc[-1])

        blocks = {"CrossAttnUpBlock3D": CrossAttnUpBlock3D, "UpBlock3D": UpBlock3D}
        rev = list(reversed(boc))
        self.up_blocks = nn.ModuleList()
        cout = rev[0]
        for i, block_type in enumerate(cfg.up_block_types):
            prev, cout = cout, rev[i]
            cin = rev[min(i + 1, len(boc) - 1)]
            self.up_blocks.append(make(block_type, cin, prev, cout, cfg.layers_per_block + 1,
                                       i < len(boc) - 1, only_cross=oca[::-1][i]))

        self.down_temporal_blocks = self.mid_temporal_block = self.up_temporal_blocks = None
        if cfg.use_temporal_modules:
            tm = lambda ch: TemporalModule3D(  # noqa: E731
                ch, cfg.time_embed_dim, cfg.norm_num_groups, cfg.temporal_module_attention_types,
                cfg.temporal_module_cross_frame_mode, cfg.temporal_module_shift_fold_div,
                num_attention_heads=cfg.num_attention_heads,
                use_dcn_warpping=cfg.temporal_module_use_dcn_warpping,
                use_deformable_conv=cfg.temporal_module_use_deformable_conv)
            self.down_temporal_blocks = nn.ModuleList([tm(boc[i]) for i in range(len(boc))])
            self.mid_temporal_block = tm(boc[-1])
            self.up_temporal_blocks = nn.ModuleList([tm(c) for c in rev])

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, boc[0], cfg.norm_eps)
        self.conv_out = InflatedConv(boc[0], cfg.out_channels, 3, padding=1)
        quant.configure(self, cfg.conv_quant, cfg.conv_quant_exclude)
        self.mesh: Optional[Mesh] = None

    def set_mesh(self, mesh: Optional[Mesh]) -> None:
        """The mesh whose sp axis forward(..., frames=) shards frames over
        (None: no mesh)."""
        self.mesh = mesh

    def shard_tensor_parallel(self, mesh: Mesh) -> None:
        """Keep this rank's shard of the parameters the tp rule splits over
        the mesh's tp axis in place of the whole ones, and run the attentions
        at heads/tp heads and the feed-forwards at I/tp hidden columns, their
        out-projections summed over tp. Every rank of the tp group calls it
        and then runs the same forwards. Nothing happens at tp = 1. Raises
        ValueError for a UNet other than the base one, a model already
        sharded, or a tp that divides no heads or hidden width."""
        tp = mesh.shape["tp"]
        if tp == 1:
            return
        cfg = self.config
        if (cfg.spatial_attention != "self" or cfg.use_temporal_modules
                or cfg.transformer_temporal_resblock or any(cfg.only_cross_attention_per_block)):
            raise ValueError("tensor parallelism takes the base UNet only: the sparse-causal "
                             "attention (TSR) and the VSR UNet's only-cross blocks and temporal "
                             "modules run whole")
        mods = [m for m in self.modules() if isinstance(m, (Attention, TemporalAttention, FeedForward))]
        if any(m.tp is not None for m in mods):
            raise ValueError("shard_tensor_parallel: this UNet is sharded already")
        for m in mods:
            n = m.net[2].weight.shape[1] if isinstance(m, FeedForward) else m.heads
            if n % tp:
                raise ValueError(f"tp={tp} does not divide {n} "
                                 f"{'hidden columns' if isinstance(m, FeedForward) else 'heads'}")
        whole = dict(self.named_parameters())
        for name, p in shard_parameters(whole, mesh).items():
            if p is not whole[name]:
                owner, attr = name.rsplit(".", 1)
                setattr(self.get_submodule(owner), attr,
                        nn.Parameter(p, requires_grad=whole[name].requires_grad))
        shard = mesh_shard(mesh)
        for m in mods:
            m.tp = shard
            if not isinstance(m, FeedForward):
                m.heads //= tp

    def _cross_frame_modules(self) -> List[nn.Module]:
        """The modules that read across a video's frames: the temporal and
        sparse-causal attentions, and the GroupNorms over (F, H, W) of
        every resnet and of the output."""
        mods = [m for m in self.modules() if isinstance(m, (TemporalAttention, SparseCausalAttention))]
        mods += [n for m in self.modules() if isinstance(m, ResnetBlock3D) for n in (m.norm1, m.norm2)]
        return mods + [self.conv_norm_out]

    @contextlib.contextmanager
    def _frame_sharded(self, sample: torch.Tensor, frames: Optional[int]):
        """Within the block the cross-frame modules hold this rank's share of
        `frames`-frame videos (nothing when frames is None)."""
        if frames is None:
            yield
            return
        if self.mesh is None:
            raise ValueError("forward(..., frames=) shards frames over a mesh: call set_mesh first")
        if self.config.use_temporal_modules or self.config.transformer_temporal_resblock:
            raise ValueError("the VSR UNet is not frame-sharded: its temporal convolutions "
                             "need neighbouring frames (VSR windows go over the mesh instead)")
        shard = self.mesh.frame_shard(frames)
        if sample.shape[1] != shard.local:
            raise ValueError(f"sample holds {sample.shape[1]} frames; this rank's share of "
                             f"{frames} over sp={len(shard.counts)} is {shard.local}")
        if len(shard.counts) == 1:  # one rank's share is the whole video
            yield
            return
        mods = self._cross_frame_modules()
        for m in mods:
            m.frame_shard = shard
        try:
            yield
        finally:
            for m in mods:
                m.frame_shard = None

    @property
    def num_prefix_blocks(self) -> int:
        """Leading down blocks without cross-attention: everything up to and
        including them (conv_in, the embeddings, the blocks and their
        temporal modules) is the same for both CFG halves."""
        n = 0
        for t in self.config.down_block_types:
            if t != "DownBlock3D":
                break
            n += 1
        return n

    @staticmethod
    def _batch_timesteps(sample: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """A scalar step broadcast to (B,): the temporal modules' versatile
        attention reads the steps as the embedding does."""
        return timesteps.expand(sample.shape[0]) if timesteps.ndim == 0 else timesteps

    def _embed(self, sample: torch.Tensor, timesteps: torch.Tensor,
               class_labels: Optional[torch.Tensor]) -> torch.Tensor:
        emb = self.time_embedding(timesteps)
        if self.class_embedding is not None:
            if class_labels is None:
                raise ValueError("this UNet takes class_labels (the noise level)")
            emb = emb + self.class_embedding(class_labels.reshape(-1).expand(
                sample.shape[0]).long()).to(emb.dtype)
        return emb

    def _down(self, x: torch.Tensor, skips: List[torch.Tensor], emb: torch.Tensor,
              ehs: Optional[torch.Tensor], blocks: range, timesteps: torch.Tensor) -> torch.Tensor:
        for i in blocks:
            x, res = self.down_blocks[i](x, emb, ehs)
            skips.extend(res)
            if self.down_temporal_blocks is not None:
                x = self.down_temporal_blocks[i](x, emb, timesteps)
        return x

    def forward_prefix(self, sample: torch.Tensor, timesteps: torch.Tensor,
                       class_labels: Optional[torch.Tensor] = None) -> Prefix:
        """The text-independent prefix; feed it to forward(..., prefix=) of
        each CFG half."""
        timesteps = self._batch_timesteps(sample, timesteps)
        emb = self._embed(sample, timesteps, class_labels)
        x = self.conv_in(sample.to(self.conv_in.weight.dtype))
        skips = [x]
        x = self._down(x, skips, emb, None, range(self.num_prefix_blocks), timesteps)
        return x, skips

    def forward_split_cfg(self, sample: torch.Tensor, timesteps: torch.Tensor,
                          encoder_hidden_states: torch.Tensor,
                          class_labels: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One split-CFG step's UNet work, under one `unet` span: the prefix
        of `sample` once, then the uncond and cond halves of
        encoder_hidden_states (2B, L, D) [uncond; cond] on it. Returns the
        halves' predictions, each what forward(..., prefix=) gives with the
        text states of its half."""
        with span("unet"):
            prefix = self.forward_prefix(sample, timesteps, class_labels)
            uncond, cond = (self._forward(sample, timesteps, states, class_labels, prefix)
                            for states in encoder_hidden_states.chunk(2))
            return uncond, cond

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                class_labels: Optional[torch.Tensor] = None,
                prefix: Optional[Prefix] = None, frames: Optional[int] = None) -> torch.Tensor:
        """`frames`: the videos' frame count when `sample` holds this rank's
        share of them over the mesh's sp axis (set_mesh); None: every frame."""
        with span("unet"), self._frame_sharded(sample, frames):
            return self._forward(sample, timesteps, encoder_hidden_states, class_labels, prefix)

    def _forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                 encoder_hidden_states: Optional[torch.Tensor], class_labels: Optional[torch.Tensor],
                 prefix: Optional[Prefix]) -> torch.Tensor:
        dtype = self.conv_in.weight.dtype
        timesteps = self._batch_timesteps(sample, timesteps)
        emb = self._embed(sample, timesteps, class_labels)
        if encoder_hidden_states is not None:
            encoder_hidden_states = encoder_hidden_states.to(dtype)
        if prefix is None:
            x = self.conv_in(sample.to(dtype))
            skips, start = [x], 0
        else:
            x, skips = prefix[0], list(prefix[1])
            start = self.num_prefix_blocks
        x = self._down(x, skips, emb, encoder_hidden_states, range(start, len(self.down_blocks)),
                       timesteps)
        x = self.mid_block(x, emb, encoder_hidden_states)
        if self.mid_temporal_block is not None:
            x = self.mid_temporal_block(x, emb, timesteps)
        for i, block in enumerate(self.up_blocks):
            n = len(block.resnets)
            res, skips = skips[-n:], skips[:-n]
            x = block(x, res, emb, encoder_hidden_states)
            if self.up_temporal_blocks is not None:
                x = self.up_temporal_blocks[i](x, emb, timesteps)
        return self.conv_out(self.conv_norm_out(x, silu=True))
