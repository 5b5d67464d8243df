"""The fork's training layer in the port, on the CPU, against the JAX package
(fp32, tiny shapes, weights randomised with numpy and carried over by
from_jax):

- lora_merge equals the JAX merge (1e-6), and the adapters carry over key for
  key;
- LoRAFinetuner's loss and its LoRA and mapper gradients equal
  jax.value_and_grad(LoRAFinetuner._loss) with the JAX draws injected: the
  loss to 1e-5 relative, each gradient within 2e-4 of its tensor's largest
  magnitude (about forty fp32 layers between the loss and the deepest
  adapter; the worst tensor agreed to 1.2e-5 when this was written);
- the optimizer chain (clip → AdamW with warmup/cosine, accumulation 2)
  equals optax's parameters over three updates (1e-6), the first update at
  learning rate 0;
- make_mapping_train_step, make_train_step and the two diffusion losses, one
  step or call each, the draws injected;
- min_snr_weight, ema_update, token_drop/TextEmbedder and both timestep
  samplers;
- the four datasets, the transforms and the loader bit for bit on clips
  written into tmp_path;
- checkpoint rotation, and resume: k steps, save, resume, one more step
  equals k + 1 straight steps, bit for bit;
- both CLIs on tiny YAMLs: method 4 through main, method 3 through
  clipsim() with a tiny scorer;
- KernelWithPlainBackward run with the plain forward equals plain autograd
  bit for bit, for GEGLU and the temporal attention.

The JAX loss and gradients are computed once (module-scoped fixture).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_util import randomize_params, t

from lavie_tpu.core.config import CLIPTextConfig as JCLIPTextConfig
from lavie_tpu.core.config import UNetConfig as JUNetConfig
from lavie_tpu.core.config import VAEConfig as JVAEConfig
from lavie_tpu.data import datasets as jds
from lavie_tpu.data import loader as jloader
from lavie_tpu.data import transforms as jtr
from lavie_tpu.diffusion.noise_aug import low_scale_schedule as jlow_scale_schedule
from lavie_tpu.diffusion.schedule import NoiseSchedule as JNoiseSchedule
from lavie_tpu.nn.clip import CLIPTextModel as JCLIPTextModel
from lavie_tpu.nn.clip import CLIPVisionConfig as JCLIPVisionConfig
from lavie_tpu.nn.clip import CLIPVisionModel as JCLIPVisionModel
from lavie_tpu.nn.clip import TextEmbedder as JTextEmbedder
from lavie_tpu.nn.clip import token_drop as jtoken_drop
from lavie_tpu.nn.mapping import MappingNetwork as JMappingNetwork
from lavie_tpu.nn.unet import UNet3D as JUNet3D
from lavie_tpu.nn.vae import AutoencoderKL as JAutoencoderKL
from lavie_tpu.train import step as jstep
from lavie_tpu.train import timestep_sampler as jts
from lavie_tpu.train.finetune import FinetuneConfig as JFinetuneConfig
from lavie_tpu.train.finetune import LoRAFinetuner as JLoRAFinetuner
from lavie_tpu.train.lora import lora_init as jlora_init
from lavie_tpu.train.lora import lora_merge as jlora_merge
from lavie_tpu.train.mapping_trainer import make_mapping_train_step as jmake_mapping_step
from lavie_tpu.utils.ema import ema_update as jema_update

from lavie_tpu_torch.core.config import CLIPTextConfig, CLIPVisionConfig, UNetConfig, VAEConfig
from lavie_tpu_torch.data import datasets as pds
from lavie_tpu_torch.data import loader as ploader
from lavie_tpu_torch.data import transforms as ptr
from lavie_tpu_torch.diffusion.noise_aug import low_scale_schedule
from lavie_tpu_torch.diffusion.schedule import NoiseSchedule
from lavie_tpu_torch.io.from_jax import load_jax_params, lora_from_jax, state_dict_from_jax
from lavie_tpu_torch.kernels._autograd import KernelWithPlainBackward, needs_grad, refuse_grad
from lavie_tpu_torch.kernels.geglu import geglu_reference
from lavie_tpu_torch.kernels.temporal_fused import temporal_attention_reference
from lavie_tpu_torch.nn.clip import CLIPTextModel, CLIPVisionModel, TextEmbedder, token_drop
from lavie_tpu_torch.nn.mapping import MappingNetwork
from lavie_tpu_torch.nn.unet import UNet3D
from lavie_tpu_torch.nn.vae import AutoencoderKL
from lavie_tpu_torch.train import step as pstep
from lavie_tpu_torch.train import timestep_sampler as pts
from lavie_tpu_torch.train.finetune import FinetuneConfig, LoRAFinetuner, make_schedule
from lavie_tpu_torch.train.lora import lora_merge, lora_param_count, lora_target_paths
from lavie_tpu_torch.train.mapping_trainer import make_mapping_train_step
from lavie_tpu_torch.train.optim import AdamW
from lavie_tpu_torch.utils.ema import ema_update

MAPPER = dict(input_dim=32, output_dim=32, num_layers=1, num_heads=2, seq_len_in=5, seq_len_out=16)
GRAD_TOL = 2e-4  # of each gradient tensor's largest magnitude


def _init(module, seed, *inputs):
    params = jax.jit(module.init)(jax.random.PRNGKey(0), *(jnp.asarray(x) for x in inputs))["params"]
    return randomize_params(jax.device_get(params), seed)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """The tiny frozen models and the mapper, on both sides, with one batch."""
    rng = np.random.RandomState(0)
    jm = {
        "unet": JUNet3D(config=JUNetConfig.base_t2v().tiny()),
        "vae": JAutoencoderKL(config=JVAEConfig.sd().tiny()),
        "text_encoder": JCLIPTextModel(config=JCLIPTextConfig.vit_l().tiny()),
        "vision_encoder": JCLIPVisionModel(config=JCLIPVisionConfig().tiny()),
        "mapping": JMappingNetwork(**MAPPER),
    }
    frozen = {
        "unet": _init(jm["unet"], 1, np.zeros((1, 2, 8, 8, 4), np.float32), np.array([1]),
                      np.zeros((1, 32, 32), np.float32)),
        "vae": _init(jm["vae"], 2, np.zeros((1, 64, 64, 3), np.float32)),
        "text_encoder": _init(jm["text_encoder"], 3, np.zeros((1, 16), np.int32)),
        "vision_encoder": _init(jm["vision_encoder"], 4, np.zeros((1, 28, 28, 3), np.float32)),
    }
    mapper = _init(jm["mapping"], 5, np.zeros((1, 5, 32), np.float32),
                   np.zeros((1, 16, 32), np.float32))
    # B drawn nonzero, so that both factors of every adapter get gradients
    lora = jax.tree.map(lambda x: np.asarray(x) + (rng.randn(*x.shape).astype(np.float32) * 0.05
                                                   if x.shape[0] == 2 else 0.0),
                        jlora_init(jax.random.PRNGKey(6), frozen["unet"], rank=2))
    batch = {"video": (rng.rand(2, 2, 64, 64, 3) * 2 - 1).astype(np.float32),
             "token_ids": rng.randint(1, 127, (2, 16)).astype(np.int32),
             "cond_image": rng.randn(2, 28, 28, 3).astype(np.float32)}

    pm = {"unet": UNet3D(UNetConfig.base_t2v().tiny()), "vae": AutoencoderKL(VAEConfig.sd().tiny()),
          "text_encoder": CLIPTextModel(CLIPTextConfig.vit_l().tiny()),
          "vision_encoder": CLIPVisionModel(CLIPVisionConfig().tiny()),
          "mapping": MappingNetwork(**MAPPER)}
    for name, module in pm.items():
        load_jax_params(module, mapper if name == "mapping" else frozen[name])
        module.eval()
    pbatch = {"video": t(batch["video"]), "token_ids": torch.from_numpy(batch["token_ids"].astype(np.int64)),
              "cond_image": t(batch["cond_image"])}
    return dict(jm=jm, frozen=frozen, mapper=mapper, lora=lora, batch=batch, pm=pm, pbatch=pbatch)


def _finetune_cfg(**kw):
    return dict(lora_rank=2, lora_alpha=4, learning_rate=1e-3, **kw)


def _port_tuner(tiny, **kw):
    pm = tiny["pm"]
    return LoRAFinetuner(pm["unet"], pm["vae"], pm["text_encoder"], pm["vision_encoder"],
                         pm["mapping"], FinetuneConfig(**_finetune_cfg(**kw)))


@pytest.fixture(scope="module")
def jax_loss(tiny):
    """jax.value_and_grad(LoRAFinetuner._loss) once, and its draws."""
    jm = tiny["jm"]
    tuner = JLoRAFinetuner(jm["unet"], jm["vae"], jm["text_encoder"], jm["vision_encoder"],
                           jm["mapping"], tiny["frozen"], JFinetuneConfig(**_finetune_cfg()))
    rng = jax.random.PRNGKey(7)
    trainables = {"lora": tiny["lora"], "mapper": tiny["mapper"]}
    batch = {k: jnp.asarray(v) for k, v in tiny["batch"].items()}
    (loss, (mse, align)), grads = jax.jit(jax.value_and_grad(tuner._loss, has_aux=True))(
        trainables, tiny["frozen"], batch, rng)
    enc_key, t_key, n_key, _ = jax.random.split(rng, 4)
    draws = {"posterior_noise": t(jax.random.normal(enc_key, (4, 8, 8, 4), jnp.float32)),
             "t": torch.from_numpy(np.asarray(jax.random.randint(t_key, (2,), 0, 1000)).astype(np.int64)),
             "noise": t(jax.random.normal(n_key, (2, 2, 8, 8, 4), jnp.float32))}
    return dict(loss=float(loss), mse=float(mse), align=float(align), grads=_np(grads), draws=draws)


def _port_state(tiny, tuner):
    return tuner.init_state(lora=lora_from_jax(tiny["lora"]),
                            mapper_params=state_dict_from_jax(tiny["mapper"]))


def _close_grad(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * max(scale, 1e-12), err_msg=name)


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def test_lora_targets_and_merge_match_jax(tiny):
    unet = tiny["pm"]["unet"]
    lora = lora_from_jax(tiny["lora"])
    paths = lora_target_paths(unet)
    assert {p.split(".")[-1] for p in paths} == {"to_q", "to_k", "to_v", "0"}
    assert {p.replace(".to_out.0", ".to_out").split(".")[-2] for p in paths} == {
        "attn1", "attn2", "attn_temp"}
    assert sorted(f"{p}.lora_{s}" for p in paths for s in "ab") == sorted(lora)
    assert lora_param_count(lora) == sum(x.size for x in jax.tree.leaves(tiny["lora"]))
    want = state_dict_from_jax(jlora_merge(tiny["frozen"]["unet"], tiny["lora"], alpha=4, rank=2))
    got = lora_merge(dict(unet.named_parameters()), lora, alpha=4, rank=2)
    assert len(got) == len(paths)
    for key, w in want.items():
        ref = got.get(key, dict(unet.named_parameters())[key])
        np.testing.assert_allclose(ref.detach().numpy(), w.numpy(), rtol=1e-6, atol=1e-6, err_msg=key)


# ---------------------------------------------------------------------------
# the fine-tuning loss, its gradients and the optimizer
# ---------------------------------------------------------------------------


def test_finetune_loss_and_gradients_match_jax(tiny, jax_loss):
    tuner = _port_tuner(tiny)
    state = _port_state(tiny, tuner)
    loss, (mse, align), grads = tuner.grads(state, tiny["pbatch"], **jax_loss["draws"])
    for got, want in ((mse, "mse"), (align, "align"), (loss, "loss")):
        np.testing.assert_allclose(float(got.detach()), jax_loss[want], rtol=1e-5)
    want_lora = lora_from_jax(jax_loss["grads"]["lora"])
    want_mapper = state_dict_from_jax(jax_loss["grads"]["mapper"])
    assert set(grads) == {f"lora/{k}" for k in want_lora} | {f"mapper/{k}" for k in want_mapper}
    # B is drawn nonzero, so both factors learn; only the query and key
    # projections of the self-attention over one token (the mid block's
    # 1×1 level: a softmax over one key) get none on either side
    silent = {k for k, w in want_lora.items() if not w.abs().max() > 0}
    assert silent == {f"mid_block.attentions.0.transformer_blocks.0.attn1.to_{p}.lora_{f}"
                      for p in "qk" for f in "ab"}
    for key, want in want_lora.items():
        got = grads[f"lora/{key}"]
        if key in silent:  # rounding noise of PyTorch's attention operator
            assert float(got.abs().max()) < 1e-8, key
        else:
            _close_grad(got.numpy(), want.numpy(), key)
    for key, want in want_mapper.items():
        got = grads[f"mapper/{key}"]
        if key.endswith("k_proj.bias"):  # a key bias shifts no softmax: 0 up to rounding
            assert max(float(got.abs().max()), float(want.abs().max())) < 1e-8, key
        else:
            _close_grad(got.numpy(), want.numpy(), key)


def _grad_trees(seed, n):
    rng = np.random.RandomState(seed)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * (10.0 if i == 2 else 1.0)).astype(np.float32)
              for k, s in shapes.items()} for i in range(n)]
    return params, grads


def test_optimizer_matches_optax_with_warmup_cosine_and_accumulation():
    """Six mini-steps at accumulation 2: three updates, the warmup's first
    at learning rate 0, one with its mean gradient clipped."""
    kw = dict(learning_rate=1e-2, lr_scheduler="cosine", lr_warmup_steps=2, max_train_steps=10,
              gradient_accumulation_steps=2, max_grad_norm=1.0)
    tx = JLoRAFinetuner(None, None, None, None, None, {}, JFinetuneConfig(**kw)).tx
    cfg = FinetuneConfig(**kw)
    opt = AdamW(make_schedule(cfg), b1=cfg.adam_beta1, b2=cfg.adam_beta2, eps=cfg.adam_epsilon,
                weight_decay=cfg.adam_weight_decay, max_grad_norm=cfg.max_grad_norm,
                accumulation_steps=cfg.gradient_accumulation_steps)
    params, grads = _grad_trees(0, 6)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    pp = {k: t(v) for k, v in params.items()}
    pstate = opt.init(pp)
    for i, g in enumerate(grads):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        moved = opt.step(pp, {k: t(v) for k, v in g.items()}, pstate)
        assert moved == (i % 2 == 1)
        for k in params:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        if i == 1:  # the first update: learning rate 0, weight decay too
            for k in params:
                np.testing.assert_array_equal(pp[k].numpy(), params[k])
    assert pstate["count"] == 3


def test_mapping_train_step_matches_jax(tiny):
    """One step with Adam's epsilon at 1e-4, above the rounding noise of
    the gradients that vanish exactly in theory (the attention's key
    biases), which a first Adam step would otherwise blow up to ±lr."""
    jm = tiny["jm"]
    batch = {"token_ids": tiny["batch"]["token_ids"], "pixel_values": tiny["batch"]["cond_image"]}
    jstep_fn = jmake_mapping_step(jm["mapping"], jm["text_encoder"], jm["vision_encoder"],
                                  optax.adamw(1e-3, eps=1e-4))
    jp, _, jmetrics = jstep_fn(tiny["mapper"], optax.adamw(1e-3, eps=1e-4).init(tiny["mapper"]),
                               tiny["frozen"], {k: jnp.asarray(v) for k, v in batch.items()})
    pm = tiny["pm"]
    opt = AdamW(1e-3, eps=1e-4)
    params = {k: v.clone().requires_grad_() for k, v in state_dict_from_jax(tiny["mapper"]).items()}
    step = make_mapping_train_step(pm["mapping"], pm["text_encoder"], pm["vision_encoder"], opt)
    params, _, metrics = step(params, opt.init(params), {"token_ids": tiny["pbatch"]["token_ids"],
                                                         "pixel_values": tiny["pbatch"]["cond_image"]})
    for k in ("loss", "mse", "contrast"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-4)
    for key, want in state_dict_from_jax(_np(jp)).items():
        np.testing.assert_allclose(params[key].detach().numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# the diffusion losses and the full-parameter step, on a one-layer model
# ---------------------------------------------------------------------------


def _japply(variables, x, ts, states):
    p = variables["params"]
    return (x[..., :4] * p["w"] + p["b"] * (ts.astype(jnp.float32) / 1000.0)[:, None, None, None, None]
            + states.mean(axis=(1, 2))[:, None, None, None, None])


class _Toy(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w, self.b = torch.nn.Parameter(t(w)), torch.nn.Parameter(t(b))

    def forward(self, x, ts, states):
        return (x[..., :4] * self.w + self.b * (ts.float() / 1000.0)[:, None, None, None, None]
                + states.mean(dim=(1, 2))[:, None, None, None, None])


def _toy(seed):
    rng = np.random.RandomState(seed)
    w, b = rng.randn(4).astype(np.float32), rng.randn(4).astype(np.float32)
    latents = rng.randn(2, 3, 4, 4, 4).astype(np.float32)
    states = rng.randn(2, 5, 8).astype(np.float32)
    return {"w": w, "b": b}, latents, states


@pytest.mark.parametrize("prediction_type,gamma,offset", [("epsilon", 5.0, 0.1), ("v_prediction", None, 0.0)])
def test_diffusion_loss_and_train_step_match_jax(prediction_type, gamma, offset):
    params, latents, states = _toy(1)
    sched, jsched = NoiseSchedule.create("linear"), JNoiseSchedule.create("linear")
    rng = jax.random.PRNGKey(3)
    t_key, n_key, off_key = jax.random.split(rng, 3)
    draws = dict(t=torch.from_numpy(np.asarray(jax.random.randint(t_key, (2,), 0, 1000)).astype(np.int64)),
                 noise=t(jax.random.normal(n_key, latents.shape)))
    if offset:
        draws["offset_noise"] = t(jax.random.normal(off_key, (2, 3, 1, 1, 4)))
    kw = dict(prediction_type=prediction_type, min_snr_gamma=gamma)
    want = jstep.diffusion_loss(_japply, params, jsched, jnp.asarray(latents), jnp.asarray(states),
                                rng, noise_offset=offset, **kw)
    model = _Toy(params["w"], params["b"])
    got = pstep.diffusion_loss(model, None, sched, t(latents), t(states), noise_offset=offset,
                               **draws, **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    if offset:
        return
    # make_train_step: one adam step over both parameters
    jtx = optax.adam(1e-2)
    jstate = jstep.TrainState.create(params, jtx)
    jnew, jloss = jstep.make_train_step(_japply, jsched, jtx, **kw)(
        jstate, {"latents": jnp.asarray(latents), "text_states": jnp.asarray(states)}, rng)
    opt = AdamW(1e-2, weight_decay=0.0)
    state = pstep.TrainState.create(dict(model.named_parameters()), opt)
    state, loss = pstep.make_train_step(model, sched, opt, **kw)(
        state, {"latents": t(latents), "text_states": t(states)}, **draws)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.step == 1
    for k in params:
        np.testing.assert_allclose(state.params[k].detach().numpy(), np.asarray(jnew.params[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_conditioned_diffusion_loss_matches_jax(masked):
    params, latents, states = _toy(2)
    rng = np.random.RandomState(4)
    cond = rng.randn(2, 3, 4, 4, 3).astype(np.float32)
    mask = (rng.rand(2, 3, 1, 1, 1) > 0.5).astype(np.float32) * np.ones((1, 1, 4, 4, 1), np.float32)
    noise = rng.randn(*latents.shape).astype(np.float32)
    aug_noise = rng.randn(*cond.shape).astype(np.float32)
    ts, aug, weights = np.array([10, 900]), np.array([3, 150]), np.array([0.5, 2.0], np.float32)
    kw = dict(prediction_type="v_prediction", max_aug_level=200)
    want, jaux = jstep.conditioned_diffusion_loss(
        _japply, params, JNoiseSchedule.create("linear"), jnp.asarray(latents), jnp.asarray(cond),
        jnp.asarray(states), jax.random.PRNGKey(0), mask=jnp.asarray(mask) if masked else None,
        t=jnp.asarray(ts), loss_weights=jnp.asarray(weights), noise_aug_schedule=jlow_scale_schedule(),
        noise=jnp.asarray(noise), aug_level=jnp.asarray(aug), aug_noise=jnp.asarray(aug_noise), **kw)
    got, aux = pstep.conditioned_diffusion_loss(
        _Toy(params["w"], params["b"]), None, NoiseSchedule.create("linear"), t(latents), t(cond),
        t(states), mask=t(mask) if masked else None, t=torch.from_numpy(ts),
        loss_weights=t(weights), noise_aug_schedule=low_scale_schedule(), noise=t(noise),
        aug_level=torch.from_numpy(aug), aug_noise=t(aug_noise), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(aux["per_sample_loss"].detach().numpy(),
                               np.asarray(jaux["per_sample_loss"]), rtol=1e-5)


def test_min_snr_weight_and_ema_match_jax():
    sched, jsched = NoiseSchedule.create("scaled_linear", 1000, 0.00085, 0.012), \
        JNoiseSchedule.create("scaled_linear", 1000, 0.00085, 0.012)
    ts = np.array([0, 1, 250, 999])
    for pt in ("epsilon", "v_prediction"):
        np.testing.assert_allclose(pstep.min_snr_weight(sched, torch.from_numpy(ts), 5.0, pt).numpy(),
                                   np.asarray(jstep.min_snr_weight(jsched, jnp.asarray(ts), 5.0, pt)),
                                   rtol=1e-6)
    rng = np.random.RandomState(5)
    ema, params = ({k: rng.randn(3, 2).astype(np.float32) for k in "xy"} for _ in range(2))
    want = jema_update({k: jnp.asarray(v) for k, v in ema.items()},
                       {k: jnp.asarray(v) for k, v in params.items()}, 0.99)
    got = ema_update({k: t(v) for k, v in ema.items()}, {k: t(v) for k, v in params.items()}, 0.99)
    for k in ema:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


def test_token_drop_and_text_embedder_match_jax():
    cfg = JCLIPTextConfig.vit_l().tiny()
    ids = np.random.RandomState(6).randint(1, 127, (3, 16)).astype(np.int32)
    uncond = np.full((16,), 127, np.int32)
    uncond[0] = 126
    force = np.array([True, False, True])
    want = np.asarray(jtoken_drop(jnp.asarray(ids), jnp.asarray(uncond), jax.random.PRNGKey(0), 0.5,
                                  jnp.asarray(force)))
    pids, puncond = torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(uncond.astype(np.int64))
    np.testing.assert_array_equal(token_drop(pids, puncond, force_drop=torch.from_numpy(force)).numpy(),
                                  want)
    assert torch.equal(token_drop(pids, puncond, drop_prob=0.0), pids)
    assert torch.equal(token_drop(pids, puncond, drop_prob=1.0), puncond.expand(3, 16))
    jm = JTextEmbedder(config=cfg, dropout_prob=0.5)
    params = _init(jm, 8, ids)
    want = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(uncond),
                    force_drop=jnp.asarray(force))
    pm = TextEmbedder(CLIPTextConfig.vit_l().tiny(), dropout_prob=0.5).eval()
    load_jax_params(pm, params)
    with torch.no_grad():
        got = pm(pids, puncond, force_drop=torch.from_numpy(force))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        pm(pids, train=True)


def test_timestep_samplers_match_jax():
    for name in ("uniform", "loss-second-moment"):
        js, ps = (m.create_named_schedule_sampler(name, 20) for m in (jts, pts))
        rng = np.random.RandomState(9)
        for _ in range(25):  # warms the resampler up (10 losses for each of 20 steps)
            ts, losses = rng.randint(0, 20, 16), rng.rand(16)
            js.update_with_all_losses(ts, losses)
            ps.update_with_all_losses(ts, losses)
        np.testing.assert_array_equal(ps.weights(), js.weights())
        a, b = (s.sample(8, np.random.default_rng(3)) for s in (js, ps))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(NotImplementedError):
        pts.create_named_schedule_sampler("nope", 10)
    x = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(pts.gather_across_hosts(x), x)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _write_clips(folder, names, frames=5, size=(24, 40), seed=0):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name in names:
        np.save(os.path.join(folder, name + ".npy"),
                rng.randint(0, 256, (frames,) + size + (3,)).astype(np.uint8))


def _same_sample(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


def test_transforms_match_jax():
    rng = np.random.RandomState(10)
    v = rng.randint(0, 256, (5, 24, 40, 3)).astype(np.uint8)
    f = jtr.to_float(v)
    np.testing.assert_array_equal(ptr.to_float(v), f)
    np.testing.assert_array_equal(ptr.normalize(f), jtr.normalize(f))
    for size in ((16, 16), (33, 50), (24, 40)):
        np.testing.assert_array_equal(ptr.resize_bilinear(f, size), jtr.resize_bilinear(f, size))
    for total, n in ((5, 3), (2, 4), (16, 16)):
        np.testing.assert_array_equal(ptr.temporal_crop_indices(total, n),
                                      jtr.temporal_crop_indices(total, n))
        np.testing.assert_array_equal(
            ptr.temporal_crop_indices(total, n, 2, np.random.RandomState(1)),
            jtr.temporal_crop_indices(total, n, 2, np.random.RandomState(1)))
    np.testing.assert_array_equal(ptr.pad_or_truncate(v, 8), jtr.pad_or_truncate(v, 8))
    np.testing.assert_array_equal(ptr.horizontal_flip(v), jtr.horizontal_flip(v))
    np.testing.assert_array_equal(ptr.adjust_brightness(v, 1.3), jtr.adjust_brightness(v, 1.3))


def test_datasets_and_loader_match_jax(tmp_path):
    vids = str(tmp_path / "vids")
    _write_clips(vids, ["a_dog_runs", "b_cat", "c_bird_sings", "d_fish", "e_owl"])
    with open(os.path.join(vids, "z_broken.npy"), "w") as fh:
        fh.write("not a clip")  # decodes to None, which the loader skips
    ann = tmp_path / "annotations.txt"
    ann.write_text("a_dog_runs a dog runs\na_dog_runs the dog\n\nb_cat a cat sits\nd_fish swims\n")
    (tmp_path / "msrvtt.json").write_text(json.dumps({
        "videos": [{"video_id": "a_dog_runs", "split": "train"}, {"video_id": "b_cat", "split": "test"},
                   {"video_id": "e_owl", "split": "train"}, {"video_id": "nope", "split": "train"}],
        "sentences": [{"video_id": "a_dog_runs", "caption": "x"}, {"video_id": "a_dog_runs", "caption": "y"},
                      {"video_id": "b_cat", "caption": "z"}, {"video_id": "e_owl", "caption": "w"},
                      {"video_id": "nope", "caption": "missing"}]}))
    (tmp_path / "ucf.csv").write_text("c_bird_sings.npy,Bird_Sings\nd_fish.npy\nmissing.npy,X\n")
    kw = dict(num_frames=3, size=(16, 24))
    cases = [
        (jds.VideoFolderDataset(vids, seed=1, **kw), pds.VideoFolderDataset(vids, seed=1, **kw)),
        (jds.MSVDDataset(vids, str(ann), seed=2, **kw), pds.MSVDDataset(vids, str(ann), seed=2, **kw)),
        (jds.MSRVTTDataset(vids, str(tmp_path / "msrvtt.json"), seed=3, **kw),
         pds.MSRVTTDataset(vids, str(tmp_path / "msrvtt.json"), seed=3, **kw)),
        (jds.UCF101Dataset(vids, str(tmp_path / "ucf.csv"), **kw),
         pds.UCF101Dataset(vids, str(tmp_path / "ucf.csv"), **kw)),
    ]
    for jd, pd_ in cases:
        assert len(jd) == len(pd_) > 0
        for _ in range(2):  # the second pass continues each dataset's draws
            for i in range(len(jd)):
                _same_sample(jd[i], pd_[i])
    # one worker thread each: the MSVD augmentation draws from the dataset's
    # one RNG, so with more threads the draws follow the threads' timing
    for shuffle, drop_last, bs in ((True, True, 2), (False, False, 4)):
        jl = jloader.DataLoader(jds.MSVDDataset(vids, str(ann), seed=4, **kw), batch_size=bs,
                                shuffle=shuffle, seed=5, drop_last=drop_last, num_workers=1)
        pl = ploader.DataLoader(pds.MSVDDataset(vids, str(ann), seed=4, **kw), batch_size=bs,
                                shuffle=shuffle, seed=5, drop_last=drop_last, num_workers=1)
        assert len(jl) == len(pl)
        for _ in range(2):  # two epochs: the shuffle order moves with the epoch
            jb, pb = list(jl), list(pl)
            assert len(jb) == len(pb) > 0
            for a, b in zip(jb, pb):
                _same_sample(a, b)


# ---------------------------------------------------------------------------
# checkpoints, resume, the CLIs
# ---------------------------------------------------------------------------


def _snapshot(state):
    return {k: v.detach().clone() for k, v in state.trainables().items()}


def test_checkpoint_rotation_and_resume_equal_straight_steps(tiny, tmp_path):
    """Three straight steps against two, a save, a resume into a fresh
    state and one more step, at accumulation 2 (the resumed step emits the
    second update from the saved half-accumulated gradient)."""
    kw = dict(checkpoints_total_limit=2, gradient_accumulation_steps=2, lr_warmup_steps=1)
    gen = lambda step: torch.Generator().manual_seed(100 + step)  # noqa: E731
    tuner = _port_tuner(tiny, **kw)
    straight = _port_state(tiny, tuner)
    for step in range(3):
        straight, _ = tuner.train_step(straight, tiny["pbatch"], gen(step))

    tuner = _port_tuner(tiny, **kw)
    state = _port_state(tiny, tuner)
    out = str(tmp_path / "ckpt")
    os.makedirs(out)
    for step in range(2):
        state, _ = tuner.train_step(state, tiny["pbatch"], gen(step))
        tuner.save_checkpoint(out, state)
    tuner.save_checkpoint(out, state)  # the same step again: overwritten in place
    resumed, ok = tuner.load_latest_checkpoint(out, _port_state(tiny, tuner))
    assert ok and resumed.step == 2
    assert sorted(os.listdir(out)) == ["checkpoint-1", "checkpoint-2"]
    resumed, _ = tuner.train_step(resumed, tiny["pbatch"], gen(2))
    tuner.save_checkpoint(out, resumed)
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-3"]
    assert resumed.step == straight.step == 3
    a, b = _snapshot(resumed), _snapshot(straight)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert resumed.opt_state["count"] == straight.opt_state["count"] == 1
    for part in ("mu", "nu", "acc"):
        for k in a:
            assert torch.equal(resumed.opt_state[part][k], straight.opt_state[part][k])
    fresh, ok = tuner.load_latest_checkpoint(str(tmp_path / "none"), straight)
    assert not ok and fresh is straight


def _train_yaml(tmp_path, **extra):
    clips = tmp_path / "clips"
    _write_clips(str(clips), ["v0_a_cat", "v1_a_dog", "v2_a_cow"], frames=4, size=(32, 48))
    (tmp_path / "annotations.txt").write_text("v0_a_cat a cat walks\nv1_a_dog a dog runs\n")
    cfg = dict(model_scale="tiny", train_data_dir=str(clips),
               annotations_path=str(tmp_path / "annotations.txt"), train_batch_size=1,
               max_train_steps=2, checkpointing_steps=1, checkpoints_total_limit=1, rank=2,
               learning_rate=1e-3, output_dir=str(tmp_path / "out"),
               logging_dir=str(tmp_path / "logs"), seed=0)
    cfg.update(extra)
    path = tmp_path / f"train{len(extra)}.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in cfg.items()))
    return str(path)


def test_finetune_cli_trains_rotates_and_resumes(tmp_path):
    from lavie_tpu_torch.cli.finetune import clipsim, main
    from lavie_tpu_torch.core.config import CLIPTextConfig, CLIPVisionConfig, load_yaml_config
    from lavie_tpu_torch.eval import CLIPSimilarityScorer

    state = main(["--config", _train_yaml(tmp_path), "--device", "cpu"])
    assert state.step == 2
    assert os.listdir(tmp_path / "out") == ["checkpoint-2"]  # rotated to the newest
    lines = (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(json.loads(x)["loss"]) for x in lines)
    state = main(["--config", _train_yaml(tmp_path, resume_from_checkpoint="latest",
                                          max_train_steps=3), "--device", "cpu"])
    assert state.step == 3 and os.listdir(tmp_path / "out") == ["checkpoint-3"]
    dirs = dict(eval_video_dir=str(tmp_path / "clips"), real_video_dir=str(tmp_path / "clips"))
    # the evaluation methods: FVD of the clips against themselves through the
    # CLI, CLIPSIM through its function with tiny towers (the CLI's is ViT-L/14)
    assert np.isfinite(main(["--config", _train_yaml(tmp_path, **dirs), "--method", "4",
                             "--device", "cpu"]))
    scorer = CLIPSimilarityScorer(CLIPTextConfig.vit_l().tiny(), CLIPVisionConfig().tiny(),
                                  device="cpu")
    assert np.isfinite(clipsim(load_yaml_config(_train_yaml(tmp_path, **dirs)), scorer=scorer))


def test_finetune_cli_reads_the_schedule_keys():
    """lr_scheduler and lr_warmup_steps reach the optimizer (the JAX CLI
    leaves them unread): the warmup's first update at rate 0, the cosine's
    end at 0."""
    from lavie_tpu_torch.cli.finetune import _build

    cfg = {"model_scale": "tiny", "lr_scheduler": "cosine", "lr_warmup_steps": 2,
           "max_train_steps": 6, "learning_rate": 1e-3}
    tuner, _ = _build(cfg, "cpu")
    lr = tuner.optimizer.lr
    assert (lr(0), lr(2), lr(6)) == (0.0, 1e-3, 0.0) and 0 < lr(4) < 1e-3
    assert _build({"model_scale": "tiny"}, "cpu")[0].optimizer.lr(0) == 1e-4


def test_train_mapping_cli_trains_and_saves(tmp_path):
    from lavie_tpu_torch.cli.train_mapping import main
    from lavie_tpu_torch.io.checkpoints import load_native

    params, history = main(["--config", _train_yaml(tmp_path), "--device", "cpu"])
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)
    saved = load_native(str(tmp_path / "out" / "mapper"))
    assert saved.keys() == params.keys()
    assert all(torch.equal(saved[k], params[k].detach()) for k in params)


# ---------------------------------------------------------------------------
# gradients through the kernels' wrappers
# ---------------------------------------------------------------------------


def _grads_both_ways(reference, inputs, grad_out):
    """(KernelWithPlainBackward with the plain forward, plain autograd):
    outputs and gradients of every input that requires grad."""
    out = []
    for fn in (lambda *x: KernelWithPlainBackward.apply(reference, reference, *x), reference):
        xs = [x.detach().clone().requires_grad_(x.requires_grad) if x is not None else None
              for x in inputs]
        y = fn(*xs)
        wrt = [x for x in xs if x is not None and x.requires_grad]
        out.append((y.detach(), torch.autograd.grad(y, wrt, grad_out)))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geglu_function_equals_plain_autograd(dtype):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g).to(dtype)  # noqa: E731
    x, w0, b0, w2, b2 = r(2, 7, 16), r(128, 16), r(128), r(16, 64), r(16)
    for x_, w in ((x, False), (x, True)):  # activations only; with the weights too
        inputs = [x_.requires_grad_()] + [p.requires_grad_(w) for p in (w0, b0, w2, b2)]
        (y1, g1), (y2, g2) = _grads_both_ways(geglu_reference, inputs, r(2, 7, 16))
        assert torch.equal(y1, y2) and len(g1) == (5 if w else 1)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("rope", [True, False])
def test_temporal_attention_function_equals_plain_autograd(rope):
    g = torch.Generator().manual_seed(1)
    b, f, s, h, d = 2, 5, 3, 2, 8
    r = lambda *shape: torch.randn(*shape, generator=g)  # noqa: E731
    q, k, v = (r(b, f, s, h * d).requires_grad_() for _ in range(3))
    bias = r(h, f, f).requires_grad_()
    cos, sin = (r(f, 2), r(f, 2)) if rope else (None, None)

    def reference(*x):
        return temporal_attention_reference(*x, 0.3, 4 if rope else 0, h)

    (y1, g1), (y2, g2) = _grads_both_ways(reference, [q, k, v, bias, cos, sin], r(b, f, s, h * d))
    assert torch.equal(y1, y2) and len(g1) == 4
    assert all(torch.equal(a, c) for a, c in zip(g1, g2))


def test_grad_refusal():
    x = torch.ones(2, requires_grad=True)
    assert needs_grad([None, x]) and not needs_grad([x.detach()])
    with torch.no_grad():
        assert not needs_grad([x])
        refuse_grad("entry", [x])
    with pytest.raises(RuntimeError, match="entry: this kernel route has no gradient"):
        refuse_grad("entry", [None, x])
