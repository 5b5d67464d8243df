"""Import hygiene of the PyTorch port: no module of lavie_tpu_torch/, and not
chip_smoke.py, imports JAX, flax or the JAX package (lavie_tpu), and every
entry point that takes a device defaults to the GPU."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "lavie_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "flax", "lavie_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_device_parameters_default_to_cuda():
    seen = 0
    for path in FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args.args + node.args.kwonlyargs
                defaults = [None] * (len(node.args.args) - len(node.args.defaults)) + list(
                    node.args.defaults) + list(node.args.kw_defaults)
                for arg, default in zip(args, defaults):
                    if arg.arg == "device" and default is not None:
                        seen += 1
                        assert isinstance(default, ast.Constant) and default.value == "cuda", (
                            f"{path.name}:{node.lineno} {node.name}(device=...) must default to 'cuda'")
            if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                    and node.args and getattr(node.args[0], "value", None) == "--device"):
                seen += 1
                kw = {k.arg: k.value for k in node.keywords}
                assert getattr(kw.get("default"), "value", None) == "cuda"
    # per pipeline: __init__/init_random, its CLI's build_pipeline and --device
    assert seen >= 12


def test_entry_points_default_to_cuda():
    import inspect

    from lavie_tpu_torch.cli import cascade, interpolate, sample, vsr
    from lavie_tpu_torch.pipelines.cascade import VideoCascadePipeline
    from lavie_tpu_torch.pipelines.interpolate import VideoInterpolationPipeline
    from lavie_tpu_torch.pipelines.t2v import TextToVideoPipeline
    from lavie_tpu_torch.pipelines.vsr import VideoSuperResolutionPipeline
    from lavie_tpu_torch.serve import Predictor

    for fn in (TextToVideoPipeline.__init__, TextToVideoPipeline.init_random, sample.build_pipeline,
               VideoInterpolationPipeline.__init__, VideoInterpolationPipeline.init_random,
               interpolate.build_pipeline, VideoSuperResolutionPipeline.__init__,
               VideoSuperResolutionPipeline.init_random, vsr.build_pipeline,
               VideoCascadePipeline.init_random, Predictor.setup, cascade.build_pipeline):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # the cascade CLI's --device
    tree = ast.parse((ROOT / "lavie_tpu_torch" / "cli" / "cascade.py").read_text())
    defaults = [k.value.value for node in ast.walk(tree) if isinstance(node, ast.Call)
                and node.args and getattr(node.args[0], "value", None) == "--device"
                for k in node.keywords if k.arg == "default"]
    assert defaults == ["cuda"]


def test_package_imports_without_a_card():
    import importlib

    for path in FILES[:-1]:
        rel = path.relative_to(ROOT).with_suffix("")
        importlib.import_module(".".join(rel.parts).removesuffix(".__init__"))


def test_turbo_is_off_by_default_at_every_entry_point():
    """nn/quant.py's int8 mode is opt-in: every config and entry point that
    takes conv_quant defaults to "none", with no exclude pattern."""
    import inspect

    from lavie_tpu_torch.core.config import UNetConfig, VAEConfig
    from lavie_tpu_torch.nn import quant
    from lavie_tpu_torch.pipelines.cascade import VideoCascadePipeline
    from lavie_tpu_torch.serve import Predictor

    assert quant.VALID_MODES == ("none", "int8") and quant.MIN_CHANNELS == 128
    for cfg in (UNetConfig(), UNetConfig.vsr(), VAEConfig(), VAEConfig.vsr()):
        assert (cfg.conv_quant, cfg.conv_quant_exclude) == ("none", ())
    for fn in (VideoCascadePipeline.init_random, Predictor.setup):
        params = inspect.signature(fn).parameters
        assert params["conv_quant"].default == "none" and params["conv_quant_exclude"].default == ()


def test_every_new_module_is_checked():
    """The text cross-attention, temporal projection, host codec, checkpoint,
    image-conditioning and training modules are among the files the import
    checks above walk, and the training CLIs take --device cuda by default."""
    checked = {str(p.relative_to(ROOT)) for p in FILES}
    for rel in ("kernels/cross_attention.py", "kernels/temporal_proj.py", "native/__init__.py",
                "native/mjpeg.py", "io/checkpoints.py", "io/convert.py", "nn/clip.py",
                "nn/mapping.py", "eval/__init__.py", "eval/clipsim.py", "kernels/_autograd.py",
                "train/__init__.py", "train/lora.py", "train/optim.py", "train/step.py",
                "train/timestep_sampler.py", "train/finetune.py", "train/mapping_trainer.py",
                "data/__init__.py", "data/transforms.py", "data/datasets.py", "data/loader.py",
                "utils/ema.py", "utils/logging.py", "cli/finetune.py", "cli/train_mapping.py"):
        assert f"lavie_tpu_torch/{rel}" in checked
    import inspect

    from lavie_tpu_torch.cli import finetune, train_mapping

    for fn in (finetune._build, finetune.train, train_mapping.train):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for name in ("finetune", "train_mapping"):
        tree = ast.parse((ROOT / "lavie_tpu_torch" / "cli" / f"{name}.py").read_text())
        assert [k.value.value for node in ast.walk(tree) if isinstance(node, ast.Call)
                and node.args and getattr(node.args[0], "value", None) == "--device"
                for k in node.keywords if k.arg == "default"] == ["cuda"]


def test_native_codec_builds_beside_the_kernels():
    """The port's MJPEG/AVI loader compiles into build/ at the root of the
    checkout, as the CUDA kernels do, never into the package directory."""
    from lavie_tpu_torch.kernels import _build
    from lavie_tpu_torch.native import mjpeg

    assert mjpeg.BUILD == _build.BUILD == ROOT / "build"
    assert mjpeg.library_path().parent == ROOT / "build"
    assert mjpeg.SRC == ROOT / "csrc" / "mjpeg_avi.c"
