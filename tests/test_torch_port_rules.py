"""Rules of the PyTorch/CUDA port that hold without a card.

- No module of ``pcp_tpu_torch`` and not ``chip_smoke.py`` imports JAX,
  Flax or the JAX package (not even its numpy-only modules), nor the
  repo's ``tests`` and ``tools`` (the port keeps its own scene factory and
  quality tools).
- Entry points resolve their device through ``pcp_tpu_torch.device``:
  ``None``/``"cuda"`` mean the card and raise without one; ``"cpu"`` runs
  only when asked for.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from pcp_tpu_torch.device import resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "pcp_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "pcp_tpu", "tests", "tools")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, (ast.Attribute, ast.Name))
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def test_forbidden_matcher_tells_packages_apart():
    assert _forbidden("pcp_tpu")
    assert _forbidden("pcp_tpu.ops.projection")
    assert _forbidden("jax.numpy")
    assert _forbidden("tests.synthetic")
    assert _forbidden("tools.quality_scale_run")
    assert not _forbidden("pcp_tpu_torch")
    assert not _forbidden("pcp_tpu_torch.ops.composite")
    assert not _forbidden("pcp_tpu_torch.tools.synthetic")


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_imports_no_jax(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = [(ln, m) for ln, m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{rel} imports {bad}"


def test_device_rule():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    else:
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError):
                resolve_device(dev)


def _tiny_inputs():
    from pcp_tpu_torch.ops.projection import CameraIntrin

    rng = np.random.default_rng(0)
    n = 8
    xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(3, 5, n)], -1).astype(np.float32)
    intrin = CameraIntrin(*(torch.tensor(v) for v in (40.0, 40.0, 16.0, 16.0)))
    return dict(
        xyz=xyz, scales=np.full((n, 3), 0.1, np.float32),
        quats=np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
        opacities=np.full(n, 0.5, np.float32),
        sh=np.zeros((n, 1, 3), np.float32), viewmat=np.eye(4, dtype=np.float32),
        intrin=intrin, image_size=(32, 32),
        background=np.zeros(3, np.float32), sh_degree=0,
    )


def test_rasterize_without_device_needs_the_card():
    from pcp_tpu_torch.ops.rasterize import rasterize

    kw = _tiny_inputs()
    img, aux = rasterize(**kw, device="cpu")
    assert img.shape == (32, 32, 3) and img.device.type == "cpu"
    assert aux["n_dropped"] == 0
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        rasterize(**kw)


def test_render_views_without_device_needs_the_card():
    from pcp_tpu_torch.eval.render_batch import render_views
    from pcp_tpu_torch.models.gaussians import params_from_numpy
    from pcp_tpu_torch.scene.cameras import Camera

    n = 4
    params = {
        "xyz": np.zeros((n, 3), np.float32) + [0, 0, 4],
        "f_dc": np.zeros((n, 3), np.float32),
        "f_rest": np.zeros((n, 0, 3), np.float32),
        "scaling": np.full((n, 3), -2.0, np.float32),
        "rotation": np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
        "opacity": np.zeros((n, 1), np.float32),
    }
    cam = Camera(uid=0, viewmat=np.eye(4, dtype=np.float32), fx=30.0,
                 fy=30.0, width=32, height=32)
    p_cpu, alive = params_from_numpy(params, np.ones(n, bool), "cpu")
    (img,) = render_views(p_cpu, alive, [cam], 0, torch.zeros(3),
                          device="cpu")
    assert img.shape == (32, 32, 3)
    assert 0.0 <= img.min() and img.max() <= 1.0
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        render_views(p_cpu, alive, [cam], 0, torch.zeros(3))
    with pytest.raises(RuntimeError):
        params_from_numpy(params, np.ones(n, bool))


def test_render_cli_defaults_to_the_card(tmp_path):
    from pcp_tpu_torch.cli import render

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        render.main(["-s", str(tmp_path), "-m", str(tmp_path)])


def _tiny_scene(tmp_path):
    from pcp_tpu_torch.scene.dataset import CameraInfo, SceneInfo

    rng = np.random.default_rng(1)
    cam = CameraInfo(uid=0, image_id=1, R=np.eye(3), t=np.zeros(3),
                     fovx=1.0, fovy=0.8, width=32, height=24,
                     image_name="a.png", image_path="")
    return SceneInfo(cameras=[cam], points=rng.uniform(-1, 1, (8, 3))
                     .astype(np.float32) + [0, 0, 4],
                     colors=rng.uniform(0, 1, (8, 3)).astype(np.float32),
                     extent=1.0)


def test_train_scene_without_device_needs_the_card(tmp_path):
    from pcp_tpu_torch.train.config import (
        ModelConfig,
        OptimConfig,
        TrainRunConfig,
    )
    from pcp_tpu_torch.train.loop import init_state, train_scene

    cfg = TrainRunConfig(model=ModelConfig(model_path=str(tmp_path)),
                         optim=OptimConfig(iterations=1, capacity=16))
    scene = _tiny_scene(tmp_path)
    state = init_state(scene, cfg, torch.Generator().manual_seed(0), "cpu")
    assert state.alive.device.type == "cpu" and int(state.alive.sum()) == 8
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        train_scene(scene, cfg, log_fn=None)
    with pytest.raises(RuntimeError):
        init_state(scene, cfg, torch.Generator().manual_seed(0))


def test_train_step_state_without_device_needs_the_card():
    from pcp_tpu_torch.train.step import train_state_from_numpy

    n = 4
    params = {
        "xyz": np.zeros((n, 3), np.float32), "f_dc": np.zeros((n, 3)),
        "f_rest": np.zeros((n, 0, 3)), "scaling": np.zeros((n, 3)),
        "rotation": np.tile([1.0, 0, 0, 0], (n, 1)),
        "opacity": np.zeros((n, 1)),
    }
    opt = {"mu": params, "nu": params, "count": 0}
    stats = {k: np.zeros(n) for k in ("grad_accum", "denom", "max_radii2d")}
    args = (params, None, opt, None, np.ones(n, bool), stats)
    state = train_state_from_numpy(*args, device="cpu")
    assert state.params["xyz"].device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        train_state_from_numpy(*args)


def test_train_cli_defaults_to_the_card(tmp_path):
    from pcp_tpu_torch.cli import train

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        train.main(["-s", str(tmp_path), "-m", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
