"""Rank processes for tests/test_torch_port_mesh.py (imports nothing of JAX,
so a rank starts in a second or two; not collected: no test_ prefix).

`run(name, world, tmp_path, **kwargs)` starts `world` processes (spawn),
each joining a gloo group through a file in tmp_path (no TCP port: the
suite runs several workers at once) with its intra-op threads capped, runs
the worker function `name` of this module with the kwargs, and returns the
ranks' results in rank order. A rank that raises fails the run with its
traceback.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

THREADS = 2  # per rank
TIMEOUT = 240  # seconds a run may take


def _rank_main(name: str, rank: int, world: int, folder: str, kwargs: dict) -> None:
    torch.set_num_threads(THREADS)
    out = os.path.join(folder, f"rank{rank}.pkl")
    try:
        dist.init_process_group("gloo", init_method=f"file://{folder}/rendezvous", rank=rank,
                                world_size=world)
        try:
            result = globals()[name](**kwargs)
        finally:
            dist.destroy_process_group()
        payload = {"ok": result}
    except BaseException:
        payload = {"error": traceback.format_exc()}
    with open(out, "wb") as f:
        pickle.dump(payload, f)


def run(name: str, world: int, tmp_path, **kwargs) -> list:
    import multiprocessing as mp

    folder = tempfile.mkdtemp(prefix=f"{name}-{world}-", dir=str(tmp_path))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(name, r, world, folder, kwargs))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"{name}: {len(alive)} ranks still running after {TIMEOUT} s"
    results = []
    for r in range(world):
        with open(os.path.join(folder, f"rank{r}.pkl"), "rb") as f:
            payload = pickle.load(f)
        assert "ok" in payload, f"{name} rank {r}:\n{payload['error']}"
        results.append(payload["ok"])
    return results


def _np(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    return (x if x.dtype == torch.float64 else x.float()).numpy()


# ---------------------------------------------------------------------------
# workers: each runs on every rank of an initialised gloo group; the
# one-process references they return are computed by the rank alone, with
# no mesh
# ---------------------------------------------------------------------------


def _mesh(shape):
    from lavie_tpu_torch.core.mesh import make_mesh

    if shape is None:
        return None
    dp, sp, tp = shape
    return make_mesh(dp=dp, sp=sp, tp=tp, backend="gloo")


def full_step(shape, state_dict: dict, latents: np.ndarray, text: np.ndarray, draws: dict,
              lr: float, max_grad_norm: float, ckpt=None) -> dict:
    """One full-parameter step (train/step.py) of the tiny base UNet with
    `state_dict`, every parameter trained, AdamW with clipping, on the mesh
    of `shape` (None: this rank alone) over `latents`, `text` with the
    injected `draws` ({"t", "noise"}): the loss, the global norm the
    clipping took, and, whole (gather_train_state on a tp mesh): the
    gradients the optimizer got, the first moments and the parameters
    after the step; the tp collectives' calls and bytes, and the tokens of
    each feed-forward call (N·C). `ckpt`: rank 0 writes the whole state
    there with save_native."""
    from lavie_tpu_torch.core import tensor_parallel as tpm
    from lavie_tpu_torch.core.config import UNetConfig
    from lavie_tpu_torch.diffusion.schedule import NoiseSchedule
    from lavie_tpu_torch.io.checkpoints import save_native
    from lavie_tpu_torch.nn.transformer import FeedForward
    from lavie_tpu_torch.nn.unet import UNet3D
    from lavie_tpu_torch.train.optim import AdamW
    from lavie_tpu_torch.train.step import TrainState, gather_train_state, make_train_step

    mesh = _mesh(shape)
    unet = UNet3D(UNetConfig.base_t2v().tiny())
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    opt = AdamW(lr, max_grad_norm=max_grad_norm)
    seen = {}
    update = opt.step

    def spy(params, grads, state, square_sum=None):
        squares = sum((g * g).sum() for g in grads.values()) if square_sum is None else square_sum(grads)
        seen.update(grads=dict(grads), norm=float(torch.sqrt(squares)))
        return update(params, grads, state, square_sum=square_sum)

    opt.step = spy
    step = make_train_step(unet, NoiseSchedule.create(), opt, min_snr_gamma=5.0, mesh=mesh)
    state = TrainState.create(dict(unet.named_parameters()), opt)
    tokens = []
    for m in unet.modules():
        if isinstance(m, FeedForward):
            m.register_forward_hook(lambda mod, args, out: tokens.append(args[0].numel()))
    for fn in tpm.TP_COLLECTIVES:
        fn.calls = fn.bytes = 0
    batch = {"latents": torch.from_numpy(latents), "text_states": torch.from_numpy(text)}
    state, loss = step(state, batch, **{k: torch.from_numpy(v) for k, v in draws.items()})
    grads = seen["grads"]
    if mesh is not None and mesh.shape["tp"] > 1:
        state, grads = gather_train_state(state, mesh), tpm.gather_parameters(grads, mesh)
        if ckpt is not None and dist.get_rank() == 0:
            save_native(ckpt, {"step": state.step, "params": state.params,
                               "opt_state": state.opt_state})
    return {"loss": float(loss), "norm": seen["norm"], "tokens": tokens,
            "grads": {k: _np(v) for k, v in grads.items()},
            "mu": {k: _np(v) for k, v in state.opt_state["mu"].items()},
            "params": {k: _np(v) for k, v in state.params.items()},
            "collectives": {fn.__name__: {"calls": fn.calls, "bytes": fn.bytes}
                            for fn in tpm.TP_COLLECTIVES}}


def layouts(shapes, refused, rows: np.ndarray, tp_step: dict) -> dict:
    """make_mesh's layout for each (dp, sp, tp) of `shapes` (None: the
    defaults), its message for each shape of `refused`; and
    gather_across_hosts of this rank's row of `rows` over a (2, 2, 1)
    mesh's dp group and over the world. Then `full_step(**tp_step)` on its
    mesh (a (1, 2, 2) one: frames over sp, the projections over tp), and on
    rank 0 alone."""
    from lavie_tpu_torch.core.mesh import make_mesh
    from lavie_tpu_torch.train.timestep_sampler import gather_across_hosts

    out = {"layouts": [], "refused": []}
    for shape in shapes:
        mesh = make_mesh(backend="gloo") if shape is None else _mesh(shape)
        out["layouts"].append({
            "shape": mesh.shape, "coords": mesh.coords,
            "groups": {a: dist.get_process_group_ranks(g) for a, g in mesh.groups.items()}})
    for dp, sp, tp in refused:
        try:
            make_mesh(dp=dp, sp=sp, tp=tp, backend="gloo")
            out["refused"].append("")
        except ValueError as e:
            out["refused"].append(str(e))
    mesh = _mesh((2, 2, 1))
    mine = rows[dist.get_rank()]
    out["gather"] = {"dp": gather_across_hosts(mine, mesh), "world": gather_across_hosts(mine)}
    out["tp_step"] = full_step(**tp_step)
    if dist.get_rank() == 0:
        out["tp_step_one_process"] = full_step(**{**tp_step, "shape": None})
    return out


def collectives(frame_counts, halo_shape, seed: int) -> dict:
    """Over an sp mesh of every rank: for each frame count, frames_to_positions
    and back on this rank's frames of one seeded (2, F, 8, 3) tensor, with
    the gradient of a seeded weighting of both; then the sparse-causal plain
    version over borrowed anchor and halo frames on this rank's frames of a
    (B, F, S, H·d) q/k/v (halo_shape = B, F, S, H, d), and the gradient of
    a seeded weighting of the borrowed frames, taken back through the
    collective."""
    from lavie_tpu_torch.core.collectives import (
        frames_to_positions,
        positions_to_frames,
        sparse_causal_halo,
    )
    from lavie_tpu_torch.kernels.flash_attention import flash_sparse_causal

    mesh = _mesh((1, dist.get_world_size(), 1))
    n, i = mesh.shape["sp"], mesh.coords["sp"]
    out = {"a2a": []}
    for frames in frame_counts:
        shard = mesh.frame_shard(frames)
        g = torch.Generator().manual_seed(seed)
        full = torch.randn(2, frames, 8, 3, generator=g, dtype=torch.float64)
        w = torch.randn(2, frames, 8, 3, generator=g, dtype=torch.float64)
        x = mesh.shard(full, 1, "sp").clone().requires_grad_()
        y = frames_to_positions(x, shard)
        back = positions_to_frames(y, shard)
        sn = 8 // n
        loss = (y * w[:, :, i * sn:(i + 1) * sn]).sum() + (back ** 2).sum()
        (grad,) = torch.autograd.grad(loss, x)
        out["a2a"].append({"y": _np(y), "back": _np(back), "x": _np(x), "grad": _np(grad),
                           "start": shard.start, "local": shard.local})
    b, f, s, h, d = halo_shape
    shard = mesh.frame_shard(f)
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, f, s, h * d, generator=g) for _ in range(3))
    wts = torch.randn(4, b, s, h * d, generator=g, dtype=torch.float64)
    mine = [mesh.shard(x, 1, "sp").reshape(b * shard.local, s, h * d) for x in (q, k, v)]
    ak, av, hk, hv = sparse_causal_halo(mine[1], mine[2], shard)
    att = flash_sparse_causal(*mine, frames=shard.local, heads=h, scale=d ** -0.5,
                              anchor=(ak, av), halo=(hk, hv))
    kk, vv = (x.double().requires_grad_() for x in mine[1:])
    borrowed = torch.stack(sparse_causal_halo(kk, vv, shard))
    gk, gv = torch.autograd.grad((borrowed * wts).sum(), (kk, vv))
    out["halo"] = {"out": _np(att.view(b, shard.local, s, h * d)), "start": shard.start,
                   "local": shard.local, "grad_k": _np(gk.view(b, shard.local, s, h * d)),
                   "grad_v": _np(gv.view(b, shard.local, s, h * d))}
    out["tp"] = _tp_collectives(seed)
    return out


def _tp_collectives(seed: int) -> dict:
    """Over a (1, 1, world) mesh: reduce_from_tp of this rank's row of a
    seeded (world, 3, 5) tensor, and the gradients of a seeded weighting of
    its sum (through reduce_from_tp) and of this rank's row weighted by its
    own weights (through copy_to_tp); then the tiny base UNet's state dict
    (seeded) through shard_parameters and gather_parameters."""
    from lavie_tpu_torch.core import tensor_parallel as tpm
    from lavie_tpu_torch.core.config import UNetConfig
    from lavie_tpu_torch.nn.unet import UNet3D
    from lavie_tpu_torch.pipelines.t2v import random_init_

    n, i = dist.get_world_size(), dist.get_rank()
    mesh = _mesh((1, 1, n))
    tp = tpm.mesh_shard(mesh)
    g = torch.Generator().manual_seed(seed)
    xs, ws = torch.randn(n, 3, 5, generator=g), torch.randn(n, 3, 5, generator=g)
    x = xs[i].clone().requires_grad_()
    y = tpm.reduce_from_tp(x, tp)
    (grad_reduce,) = torch.autograd.grad((y * ws[0]).sum(), x)
    (grad_copy,) = torch.autograd.grad((tpm.copy_to_tp(x, tp) * ws[i]).sum(), x)
    unet = UNet3D(UNetConfig.base_t2v().tiny())
    random_init_(unet, seed)
    whole = dict(unet.state_dict())
    local = tpm.shard_parameters(whole, mesh)
    back = tpm.gather_parameters(local, mesh)
    return {"y": _np(y), "grad_reduce": _np(grad_reduce), "grad_copy": _np(grad_copy),
            "calls": {fn.__name__: fn.calls for fn in tpm.TP_COLLECTIVES},
            "split": sorted(k for k in whole if local[k] is not whole[k]),
            "round_trip": all(torch.equal(back[k], v) for k, v in whole.items())}


def unets(cases) -> list:
    """For each (config, state dict, x, timesteps, text): the UNet3D forward
    over this rank's frames on an sp mesh of every rank, and the same
    forward over every frame with no mesh."""
    from lavie_tpu_torch.nn.unet import UNet3D

    mesh = _mesh((1, dist.get_world_size(), 1))
    out = []
    for cfg, sd, x, ts, ctx in cases:
        unet = UNet3D(cfg).eval()
        unet.load_state_dict(sd)
        args = (torch.from_numpy(ts), torch.from_numpy(ctx))
        xt = torch.from_numpy(x)
        with torch.no_grad():
            whole = unet(xt, *args)
            unet.set_mesh(mesh)
            mine = unet(mesh.shard(xt, 1, "sp"), *args, frames=x.shape[1])
        out.append({"sharded": _np(mine), "whole": _np(whole)})
    return out


def _tiny(kind: str):
    from lavie_tpu_torch.core.config import CLIPTextConfig, UNetConfig, VAEConfig

    unet = {"t2v": UNetConfig.base_t2v, "tsr": UNetConfig.interpolation, "vsr": UNetConfig.vsr}[kind]
    vae = VAEConfig.vsr if kind == "vsr" else VAEConfig.sd
    text = CLIPTextConfig.open_clip_h if kind == "vsr" else CLIPTextConfig.vit_l
    return dict(unet_config=unet().tiny(), vae_config=vae().tiny(), text_config=text().tiny(),
                dtype=torch.float32, device="cpu")


def _run_both(pipe, shape, *args, **kwargs):
    """(the pipeline's output on the mesh of `shape`, its output with none)."""
    pipe.mesh = _mesh(shape)
    sharded = pipe(*args, **kwargs)
    pipe.mesh = None
    return sharded, pipe(*args, **kwargs)


def t2v(cases) -> list:
    """The tiny base pipeline (seeded weights) for each (mesh shape,
    prompts, call kwargs): its video on the mesh and with none."""
    from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline

    pipe = TextToVideoPipeline.init_random(0, **_tiny("t2v"))
    out = []
    for shape, prompts, call in cases:
        sharded, whole = _run_both(pipe, shape, prompts, **call)
        out.append({"sharded": sharded.video, "whole": whole.video,
                    "latents": _np(sharded.latents), "whole_latents": _np(whole.latents)})
    return out


def tsr(video: np.ndarray, cases) -> list:
    """The tiny interpolation pipeline over `video` for each call kwargs,
    on an sp mesh of every rank and with none."""
    from lavie_tpu_torch.pipelines.interpolate import VideoInterpolationPipeline

    pipe = VideoInterpolationPipeline.init_random(0, **_tiny("tsr"))
    shape = (1, dist.get_world_size(), 1)
    return [[r.video for r in _run_both(pipe, shape, video, **call)] for call in cases]


def vsr(video: np.ndarray, shape, window_batch: int, **call) -> list:
    """The tiny VSR pipeline (window 4) over `video`: on the mesh, and with
    none at `window_batch`."""
    from lavie_tpu_torch.pipelines.vsr import VideoSuperResolutionPipeline

    pipe = VideoSuperResolutionPipeline.init_random(0, window=4, decode_chunk=2, **_tiny("vsr"))
    pipe.mesh = _mesh(shape)
    sharded = pipe(video, **call).video
    pipe.mesh, pipe.window_batch = None, window_batch
    return [sharded, pipe(video, **call).video]


def cascade(shape, **call) -> np.ndarray:
    """The tiny cascade (option 4) under set_mesh."""
    from lavie_tpu_torch.pipelines.cascade import VideoCascadePipeline

    pipe = VideoCascadePipeline.init_random(0, tiny=True, dtype=torch.float32, device="cpu")
    pipe.set_mesh(_mesh(shape))
    return pipe("a cat", **call).video


def training(shapes, batch: dict, latents: np.ndarray, text: np.ndarray, seed: int,
             tp_step: dict) -> dict:
    """On each mesh of `shapes`, then with none: the LoRA + mapper loss and
    gradients of the tiny image-conditioned base modules on the whole
    `batch` (seeded weights, adapters and draws), and one full-parameter
    step (train/step.py) of the tiny base UNet on four parameters over
    `latents`, `text`: its loss and the gradients its optimizer got. On a
    mesh with tp > 1, and with none, `full_step(**tp_step)` instead: every
    parameter of the tiny base UNet, tensor parallel on the mesh."""
    from lavie_tpu_torch.core.config import UNetConfig
    from lavie_tpu_torch.diffusion.schedule import NoiseSchedule
    from lavie_tpu_torch.nn.unet import UNet3D
    from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline, random_init_
    from lavie_tpu_torch.train.finetune import FinetuneConfig, LoRAFinetuner
    from lavie_tpu_torch.train.optim import AdamW
    from lavie_tpu_torch.train.step import TrainState, make_train_step

    pipe = TextToVideoPipeline.init_random(0, with_image_conditioning=True, **_tiny("t2v"))
    tuner = LoRAFinetuner(pipe.unet, pipe.vae, pipe.text_encoder, pipe.vision_encoder,
                          pipe.mapping, FinetuneConfig(lora_rank=4, lora_alpha=4))
    state = tuner.init_state(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # every adapter's B nonzero: gradients reach both factors
        for k, v in state.lora.items():
            if k.endswith("lora_b"):
                v.copy_(0.1 * torch.randn(v.shape, generator=g))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    unet = UNet3D(UNetConfig.base_t2v().tiny())
    random_init_(unet, seed)
    names = ["conv_in.weight", "down_blocks.0.attentions.0.transformer_blocks.0.attn_temp.to_q.weight",
             "up_blocks.1.resnets.0.conv1.weight", "conv_out.weight"]
    step_batch = {"latents": torch.from_numpy(latents), "text_states": torch.from_numpy(text)}

    out = []
    for shape in list(shapes) + [None]:
        tuner.mesh = _mesh(shape)
        loss, (mse, align), grads = tuner.grads(state, tbatch, torch.Generator().manual_seed(seed + 2))
        row = {"loss": float(loss.detach()), "mse": float(mse.detach()),
               "align": float(align.detach()), "grads": {k: _np(v) for k, v in grads.items()}}
        if shape is None or shape[2] > 1:
            row["full_step"] = full_step(**{**tp_step, "shape": shape})
            if shape is not None:
                out.append(row)
                continue
        opt = AdamW(1e-3)
        got = {}
        update = opt.step
        opt.step = lambda params, gr, st: (got.update(gr), update(params, gr, st))
        tstate = TrainState.create({n: p for n, p in unet.named_parameters() if n in names}, opt)
        step = make_train_step(unet, NoiseSchedule.create(), opt, min_snr_gamma=5.0,
                               mesh=_mesh(shape))
        _, step_loss = step(tstate, step_batch, torch.Generator().manual_seed(seed + 3))
        unet.set_mesh(None)
        row.update(step_loss=float(step_loss), step_grads={n: _np(got[n]) for n in names})
        out.append(row)
    return out
