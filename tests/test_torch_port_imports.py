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


KERNELS = ROOT / "lavie_tpu_torch" / "kernels"
OWNERS = ("__init__", "_autograd", "_build", "_hopper")
WRAPPERS = sorted(p for p in KERNELS.glob("*.py") if p.stem not in OWNERS)


def _top_level_names(tree):
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            yield node.name
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                yield from (n.id for n in ast.walk(target) if isinstance(n, ast.Name))


@pytest.mark.parametrize("path", WRAPPERS, ids=lambda p: p.stem)
def test_kernel_wrappers_take_what_they_share_from_one_owner(path):
    """What the Hopper wrappers share is defined once, in kernels/_hopper.py
    (the card's shared memory, the staged GEMM's constants and plans, the
    LayerNorm-and-GEMM kernels' checks and plain pieces), and a launch
    reads its card's SM count and stream through _build.launch_device: no
    wrapper defines a name of _hopper's, writes out the shared-memory
    budget, asks torch.cuda for the stream, device or SM count, or imports
    an underscore name from another wrapper."""
    from lavie_tpu_torch.kernels import _hopper

    assert len(WRAPPERS) == 10
    shared = set(_top_level_names(ast.parse((KERNELS / "_hopper.py").read_text())))
    tree = ast.parse(path.read_text())
    assert not set(_top_level_names(tree)) & shared
    budgets = {_hopper.SMEM_MAX, _hopper.SMEM_PER_SM}
    assert not [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and n.value in budgets]
    asked = [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
             and n.attr in ("current_stream", "current_device", "get_device_properties")
             and isinstance(n.value, ast.Attribute) and n.value.attr == "cuda"]
    assert not asked, asked
    stems = {p.stem for p in WRAPPERS}
    aliases, private = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("lavie_tpu_torch.kernels"):
            if node.module.rsplit(".", 1)[-1] in stems:
                private += [a.name for a in node.names if a.name.startswith("_")]
            elif node.module == "lavie_tpu_torch.kernels":
                aliases |= {a.asname or a.name for a in node.names if a.name in stems}
        elif isinstance(node, ast.Import):
            aliases |= {a.asname for a in node.names if a.asname
                        and a.name.rsplit(".", 1)[-1] in stems}
    private += [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name) and n.value.id in aliases
                and n.attr.startswith("_")]
    assert not private, private


def test_smoke_script_reads_the_benchmarks_yardstick():
    """chip_smoke.py groups kernels and bounds them with port_bench's frozen
    yardstick itself, so the two cannot drift apart: the same peaks and
    groups, and its bound the yardstick's in ms with what bounds it."""
    import chip_smoke
    from port_bench import yardstick

    assert chip_smoke.KERNEL_GROUPS is yardstick.KERNEL_GROUPS
    assert chip_smoke.group_of is yardstick.group_of
    for name in ("HBM_BYTES_PER_S", "BF16_FLOPS", "FP32_FLOPS"):
        assert getattr(chip_smoke, name) is getattr(yardstick, name)
    for n_bytes, ops in ((1e9, ((1e12, yardstick.BF16_FLOPS),)),
                         (1e12, ((1e9, yardstick.BF16_FLOPS), (1e9, yardstick.FP32_FLOPS))),
                         (2e9, ((1e12, chip_smoke.INT8_OPS),)), (0.0, ())):
        ms, by = chip_smoke.bound(n_bytes, ops)
        assert ms == yardstick.bound_s(n_bytes, ops) * 1e3
        t_ops = sum(n / rate for n, rate in ops)
        assert by == ("bytes" if n_bytes / yardstick.HBM_BYTES_PER_S >= t_ops else "operations")
