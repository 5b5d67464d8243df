"""The port's evaluation layer against the JAX package, on the CPU in fp32:
R3D-18's features and its torchvision-keyed conversion, FVD's
preprocessing, Fréchet distance and flow, the CLIPSIM scorer, the
profiling helpers' counts, and the fine-tuning CLI's methods 3 (CLIPSIM)
and 4 (FVD) on synthetic clips.

Inputs are made from a seed with numpy; JAX params (every leaf random) are
carried by io/from_jax.py. Tolerances: R3D-18 features 1e-4 of their max
(eleven fp32 3-D convs); preprocessing 1e-6; the Fréchet distance and FVD
on the same features 1e-6 relative; CLIPSIM 1e-5; the CLI's FVD, whose
features differ by fp32 summation order and whose sqrtm over three clips
(singular covariances) amplifies that, 1e-3 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_util import randomize_params, t

from lavie_tpu.core.config import CLIPTextConfig as JCLIPTextConfig
from lavie_tpu.eval import clipsim as jclipsim
from lavie_tpu.eval import fvd as jfvd
from lavie_tpu.eval import r3d as jr3d
from lavie_tpu.nn.clip import CLIPVisionConfig as JCLIPVisionConfig
from lavie_tpu.utils import profiling as jprof

from lavie_tpu_torch.core.config import CLIPTextConfig, CLIPVisionConfig
from lavie_tpu_torch.eval import CLIPSimilarityScorer, compute_fvd, frechet_distance
from lavie_tpu_torch.eval.fvd import FVDFeatureExtractor, fvd_preprocess
from lavie_tpu_torch.eval.r3d import R3D18, convert_r3d18
from lavie_tpu_torch.io.from_jax import load_jax_params, state_dict_from_jax
from lavie_tpu_torch.nn.clip import CLIPDualEncoder
from lavie_tpu_torch.utils import profiling


def _r3d_params(seed, frames=8, size=32):
    """R3D-18's JAX params, every leaf random; running variances positive."""
    init = jr3d.R3D18(features_only=True).init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, frames, size, size, 3)))["params"]
    params = randomize_params(jax.device_get(init), seed)

    def fix(node):
        return {k: fix(v) if isinstance(v, dict) else (np.abs(v) + 0.5 if k == "running_var" else v)
                for k, v in node.items()}

    return fix(params)


def _port_r3d(params):
    net = R3D18()
    load_jax_params(net, params)
    return net.eval()


def test_r3d18_features_match():
    params = _r3d_params(1)
    x = np.random.RandomState(2).randn(2, 8, 32, 32, 3).astype(np.float32)
    want = np.asarray(jr3d.R3D18(features_only=True).apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_r3d(params)(t(x)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_convert_r3d18_matches_jax():
    """A seeded torchvision-keyed dict (num_batches_tracked buffers and the
    classifier included, unused by the features-only net) lands where the
    JAX conversion puts it."""
    rng = np.random.RandomState(3)
    own = R3D18().state_dict()
    sd = {k: rng.randn(*v.shape).astype(np.float32) for k, v in own.items()}
    for k in own:
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = np.array(7)
    sd["fc.weight"], sd["fc.bias"] = rng.randn(400, 512), rng.randn(400)
    init = jr3d.R3D18(features_only=True).init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 4, 16, 16, 3)))["params"]
    want = state_dict_from_jax(jr3d.convert_r3d18(jax.device_get(init), sd))
    net = R3D18()
    convert_r3d18(net, sd)
    got = net.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    with pytest.raises(KeyError):
        convert_r3d18(net, {k: v for k, v in sd.items() if k != "layer4.1.conv2.0.weight"})


@pytest.mark.parametrize("h,w", [(300, 400), (64, 64), (120, 301)])
def test_fvd_preprocess_matches(h, w):
    """Cropped, zero-padded (under 270 px) and both at once."""
    videos = np.random.RandomState(4).randint(0, 256, (2, 10, h, w, 3)).astype(np.uint8)
    want = jfvd.fvd_preprocess(videos, num_frames=4, size=56)
    got = fvd_preprocess(videos, num_frames=4, size=56)
    assert got.shape == (2, 4, 56, 56, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if h < 270:  # the padding reads as black: (0 - mean) / std at the corners
        np.testing.assert_allclose(got[0, 0, 0, 0], -jfvd.IMAGENET_MEAN / jfvd.IMAGENET_STD,
                                   atol=1e-6)


@pytest.mark.parametrize("n,d", [(40, 8), (3, 8), (2, 16)])
def test_frechet_distance_matches(n, d):
    """Many samples, and few (singular covariances: the eps retry)."""
    rng = np.random.RandomState(5)
    a, b = rng.randn(n, d), rng.randn(n, d) + 0.3
    want = jfvd.frechet_distance(a, b)
    got = frechet_distance(a, b)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert abs(frechet_distance(a, a)) < 1e-6 * max(1.0, np.trace(np.cov(a, rowvar=False)))


def test_frechet_distance_takes_a_scipy_without_disp(monkeypatch):
    """A scipy whose sqrtm no longer takes `disp` (the card machine's)
    gives the same distance."""
    from scipy import linalg

    rng = np.random.RandomState(19)
    a, b = rng.randn(4, 16), rng.randn(4, 16)
    want = frechet_distance(a, b)
    sqrtm = linalg.sqrtm

    def without_disp(m, **kw):
        if kw:
            raise TypeError("sqrtm() got an unexpected keyword argument 'disp'")
        return sqrtm(m, disp=False)[0]

    monkeypatch.setattr(linalg, "sqrtm", without_disp)
    assert frechet_distance(a, b) == want


def test_compute_fvd_matches_on_the_same_features():
    rng = np.random.RandomState(6)
    real = rng.randint(0, 256, (5, 6, 20, 24, 3)).astype(np.uint8)
    fake = rng.randint(0, 200, (5, 6, 20, 24, 3)).astype(np.uint8)

    def features(v):  # a deterministic numpy extractor both sides share
        x = fvd_preprocess(v, num_frames=4, size=8)
        return x.reshape(len(v), 4, -1).mean(axis=1)[:, :16]

    np.testing.assert_allclose(compute_fvd(real, fake, features),
                               jfvd.compute_fvd(real, fake, features), rtol=1e-6)


def test_fvd_extractor_matches():
    params = _r3d_params(7, frames=8, size=48)
    videos = np.random.RandomState(8).randint(0, 256, (3, 10, 40, 56, 3)).astype(np.uint8)
    jext = jfvd.FVDFeatureExtractor(params=params, num_frames=8, size=48, batch=2)
    ext = FVDFeatureExtractor(net=_port_r3d(params), num_frames=8, size=48, batch=2, device="cpu")
    want, got = jext(videos), ext(videos)
    assert got.shape == (3, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    seeded = FVDFeatureExtractor(seed=3, num_frames=8, size=48, device="cpu")
    np.testing.assert_array_equal(seeded(videos[:1]),
                                  FVDFeatureExtractor(seed=3, num_frames=8, size=48,
                                                      device="cpu")(videos[:1]))


def _scorers(seed):
    jtext, jvision = JCLIPTextConfig.vit_l().tiny(), JCLIPVisionConfig().tiny()
    jscorer = jclipsim.CLIPSimilarityScorer(jtext, jvision)
    jscorer.params = randomize_params(jax.device_get(jscorer.params), seed)
    model = CLIPDualEncoder(CLIPTextConfig.vit_l().tiny(), CLIPVisionConfig().tiny())
    load_jax_params(model, jscorer.params)
    scorer = CLIPSimilarityScorer(CLIPTextConfig.vit_l().tiny(), CLIPVisionConfig().tiny(),
                                  model=model, device="cpu")
    return jscorer, scorer


def test_clipsim_scorer_matches():
    jscorer, scorer = _scorers(9)
    rng = np.random.RandomState(10)
    videos = [rng.randint(0, 256, (4, 40, 56, 3)).astype(np.uint8) for _ in range(2)]
    prompts = ["a cat walks on the street", "stripes drifting sideways, 2k"]
    assert scorer.tokenizer([prompts[0]]).shape == (1, 16)  # the text tower's own length
    for v, p in zip(videos, prompts):
        np.testing.assert_allclose(scorer.score(v, p), jscorer.score(v, p), atol=1e-5)
    np.testing.assert_allclose(scorer.score_batch(videos, prompts),
                               jscorer.score_batch(videos, prompts), atol=1e-5)


def test_clipsim_scorer_takes_a_transformers_state_dict():
    """from_transformers_state_dict goes through convert_clip_dual_encoder:
    an exported dict of a seeded scorer's model loads back into the same
    scores."""
    from lavie_tpu_torch.io.convert import export_reference_state_dict

    _, scorer = _scorers(11)
    m = scorer.model
    sd = {**export_reference_state_dict(m.text_model), **export_reference_state_dict(m.vision_model),
          "text_projection.weight": m.text_projection.weight.detach().numpy(),
          "visual_projection.weight": m.visual_projection.weight.detach().numpy()}
    again = CLIPSimilarityScorer.from_transformers_state_dict(
        sd, CLIPTextConfig.vit_l().tiny(), CLIPVisionConfig().tiny(), device="cpu")
    v = np.random.RandomState(12).randint(0, 256, (2, 30, 30, 3)).astype(np.uint8)
    assert again.score(v, "a dog") == scorer.score(v, "a dog")


def _tf32_switches():
    return torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision


def test_eval_models_run_without_tf32_whatever_the_callers_flags():
    """cuDNN takes TF32 for fp32 convolutions by default: the scorer's and
    the extractor's forwards run with it off, as their fp32 is stated, and
    give the caller's switches back."""
    _, scorer = _scorers(20)
    ext = FVDFeatureExtractor(seed=0, num_frames=4, size=32, device="cpu")
    seen = []
    for m in (scorer.model.vision_model, ext.net):
        m.register_forward_pre_hook(lambda *_: seen.append(_tf32_switches()))
    saved = _tf32_switches()
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    try:
        scorer.score(np.zeros((2, 30, 30, 3), np.uint8), "a dog")
        ext(np.zeros((1, 4, 40, 40, 3), np.uint8))
        assert _tf32_switches() == ("tf32", "tf32")
    finally:
        torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision = saved
    assert seen == [("ieee", "ieee")] * 2


def test_profiling_counts_match_jax(tmp_path):
    params = _r3d_params(13)
    assert profiling.count_params(_port_r3d(params)) == jprof.count_params(params)
    assert profiling.count_params(params) == jprof.count_params(params)
    assert (profiling.count_flops_attention(2, 8, 4096, 77, 40)
            == jprof.count_flops_attention(2, 8, 4096, 77, 40))
    a = np.random.RandomState(14).randn(64, 48).astype(np.float32)
    b = np.random.RandomState(15).randn(48, 32).astype(np.float32)
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("mm"):
            torch.matmul(t(a), t(b))
    assert [sp.name for sp in profiling.spans()] == ["mm"]
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def _clip_dirs(tmp_path):
    rng = np.random.RandomState(16)
    for name, hi in (("real", 256), ("fake", 160)):
        os.makedirs(tmp_path / name)
        for i in range(3):
            np.save(tmp_path / name / f"a_{name}_video_{i}.npy",
                    rng.randint(0, hi, (10, 48, 72, 3)).astype(np.uint8))
    return {"eval_video_dir": str(tmp_path / "fake"), "real_video_dir": str(tmp_path / "real")}


def test_cli_methods_3_and_4_match_jax(tmp_path, capsys):
    """The JAX CLI's two loops (lavie_tpu/cli/finetune.py:201-226) over the
    same folders, with its weights handed to the port's functions."""
    from lavie_tpu.data import VideoFolderDataset as JVideoFolderDataset

    from lavie_tpu_torch.cli import finetune

    cfg = _clip_dirs(tmp_path)
    jscorer, scorer = _scorers(17)
    ds = JVideoFolderDataset(cfg["eval_video_dir"], num_frames=8, size=(64, 64))
    to_u8 = lambda v: ((v + 1) * 127.5).astype(np.uint8)  # noqa: E731
    samples = [ds[i] for i in range(len(ds))]  # once each: the dataset draws its frames
    want = np.mean([jscorer.score(to_u8(s["video"]), s["caption"]) for s in samples])
    got = finetune.clipsim(cfg, scorer=scorer)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert capsys.readouterr().out.strip() == f"CLIPSIM over 3 videos: {got:.4f}"

    params = _r3d_params(18, frames=8, size=64)
    jext = jfvd.FVDFeatureExtractor(params=params, num_frames=8, size=64)
    stack = lambda d: np.stack([to_u8(d[i]["video"]) for i in range(len(d))])  # noqa: E731
    want = jfvd.compute_fvd(
        stack(JVideoFolderDataset(cfg["real_video_dir"], num_frames=8, size=(64, 64))),
        stack(JVideoFolderDataset(cfg["eval_video_dir"], num_frames=8, size=(64, 64))), jext)
    ext = FVDFeatureExtractor(net=_port_r3d(params), num_frames=8, size=64, device="cpu")
    got = finetune.fvd(cfg, extractor=ext)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert capsys.readouterr().out.strip() == f"FVD: {got:.2f}"
