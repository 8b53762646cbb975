"""The port's viewer (``pcp_tpu_torch.viewer``, ``train.loop.poll_viewer``,
``cli.train``'s viewer flags) against the JAX package's, on the CPU.

- Parsing: the same bytes sent to JAX's ``NetworkGUI`` and to the port's
  give equal ``ViewerCamera`` fields (matrices byte-equal), for a full
  message, one without the optional keys, a zero resolution (no camera,
  the connection kept), malformed JSON and a client that leaves
  mid-message (no camera, the connection closed).
- ``poll_viewer``: JAX's and the port's on one 120-Gaussian PLY at SH 3,
  loaded by each package, give frames within 1 level of 255 (floats
  within 3e-5 may round to neighbouring integers, as in
  ``tests/test_torch_render.py``), the same verify string, and the same
  return value over the whole keep_alive x train x training_done table.
  JAX's render runs under ``jax.jit`` here (one compile per frame size in
  place of one per operation: seconds, not a minute); the function is the
  same.
- The loop: ``train_scene`` with a viewer that asks for two frames, two
  paused frames and a training frame takes no step across the pause and
  writes the PLY bytes of a run without a viewer.
- The CLI: ``--disable_viewer`` and ``--ip none`` bind no socket,
  ``--ip``/``--port`` reach ``NetworkGUI``, which is closed afterwards,
  and a port already bound trains headless.

Every socket here is on an ephemeral port and every read has a 10 s
timeout; the clients send everything before the server reads, so no test
needs a thread.
"""

import contextlib
import functools
import json
import socket
import struct
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.io.ply import save_gaussian_ply
from pcp_tpu.models.gaussians import GaussianConfig as JConfig
from pcp_tpu.models.gaussians import load_gaussians_ply as j_load_ply
from pcp_tpu.train import config as jcfg
from pcp_tpu.train import loop as jloop
from pcp_tpu.utils.sh import rgb_to_sh
from pcp_tpu.viewer import NetworkGUI as JGUI
from pcp_tpu_torch.cli import train as train_cli
from pcp_tpu_torch.models import gaussians as tG
from pcp_tpu_torch.ops.projection import CameraIntrin
from pcp_tpu_torch.ops.rasterize import rasterize
from pcp_tpu_torch.scene import load_scene
from pcp_tpu_torch.train import config as tcfg
from pcp_tpu_torch.train import loop as tloop
from pcp_tpu_torch.viewer import NetworkGUI as TGUI
from pcp_tpu_torch.utils.graphics import world_to_view
from pcp_tpu_torch.utils.sh import rgb_to_sh as t_rgb_to_sh
from pcp_tpu_torch.viewer import ViewerCamera
from tests import synthetic

TIMEOUT = 10.0
CAPACITY = 160
MAX_PER_TILE = 128        # above the scene's 120 Gaussians: no clamp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite's workers share the cores (tests/test_torch_checkpoint.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_true_scene(xyz, rgb, scales, quats, opac, R, t, fx, fy, W, H):
    """``tests.synthetic.render_true_scene`` through the port's rasterizer
    on the CPU (the same image within 3e-5, tests/test_torch_render.py),
    which spares this file JAX's per-operation compiles of it."""
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[:3, :3] = R
    viewmat[:3, 3] = t
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    img, _ = rasterize(
        *(torch.from_numpy(np.asarray(a, np.float32))
          for a in (xyz, scales, quats, opac)),
        t_rgb_to_sh(torch.from_numpy(rgb))[:, None, :],
        torch.from_numpy(viewmat),
        CameraIntrin(f32(fx), f32(fy), f32(W / 2), f32(H / 2)), (W, H),
        torch.zeros(3), 0, device="cpu")
    return np.clip(img.numpy(), 0.0, 1.0)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 4-camera 64x48 COLMAP scene and a 120-Gaussian PLY at SH 3 in its
    view (as tests/test_torch_render.py), loaded by both packages."""
    root = tmp_path_factory.mktemp("torch_viewer")
    src = str(root / "scene")
    rng = np.random.default_rng(11)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(synthetic, "render_true_scene", _port_true_scene)
        xyz, rgb, scales, quats, opac = synthetic.write_synthetic_scene(
            src, rng=rng, n_points=120, n_cams=4, W=64, H=48)
    ply = str(root / "point_cloud.ply")
    save_gaussian_ply(
        ply, xyz, np.asarray(rgb_to_sh(rgb)),
        rng.normal(0.0, 0.1, (len(xyz), 15, 3)).astype(np.float32),
        np.log(opac / (1.0 - opac))[:, None], np.log(scales), quats)
    j_params, j_alive = j_load_ply(ply, JConfig(sh_degree=3,
                                                capacity=CAPACITY))
    t_params, t_alive = tG.load_gaussians_ply(
        ply, tG.GaussianConfig(sh_degree=3, capacity=CAPACITY), "cpu")
    cam = load_scene(src).cameras[0]
    return types.SimpleNamespace(
        src=src, cam=cam,
        jstate=types.SimpleNamespace(params=j_params, alive=j_alive),
        tstate=types.SimpleNamespace(params=t_params, alive=t_alive))


def _viewmat(cam_info):
    """A scene camera's world->camera matrix, as ``from_info`` makes it."""
    return world_to_view(cam_info.R, cam_info.t).astype(np.float32)


def _message(viewmat=None, w=64, h=48, fovx=1.0, fovy=0.8, **extra):
    """A viewer message from which ``receive`` recovers ``viewmat``
    (world->camera) as ``world_view_transform.T``."""
    wvt = np.eye(4, dtype=np.float32) if viewmat is None else \
        np.asarray(viewmat, np.float32).T.copy()
    wvt[:, 1] = -wvt[:, 1]
    wvt[:, 2] = -wvt[:, 2]
    proj = np.arange(16, dtype=np.float32).reshape(4, 4) / 7.0
    msg = {"resolution_x": w, "resolution_y": h, "fov_x": fovx,
           "fov_y": fovy, "z_near": 0.01, "z_far": 100.0,
           "view_matrix": [float(v) for v in wvt.flatten()],
           "view_projection_matrix": [float(v) for v in proj.flatten()]}
    msg.update(extra)
    return msg


def _frame_bytes(msg) -> bytes:
    blob = json.dumps(msg).encode()
    return struct.pack("<I", len(blob)) + blob


@contextlib.contextmanager
def _connected(gui_cls):
    """(gui, client): a server on an ephemeral port with one client
    accepted, both ends with TIMEOUT on every read."""
    gui = gui_cls("127.0.0.1", 0)
    client = socket.create_connection(gui.listener.getsockname(),
                                      timeout=TIMEOUT)
    try:
        deadline = time.monotonic() + TIMEOUT
        while not gui.try_connect():
            assert time.monotonic() < deadline, "the client was not accepted"
            time.sleep(0.005)
        gui.conn.settimeout(TIMEOUT)
        yield gui, client
    finally:
        client.close()
        gui.close()


def _read_exact(sock, n) -> bytes:
    out = b""
    while len(out) < n:
        b = sock.recv(n - len(out))
        assert b, "the server closed the connection"
        out += b
    return out


def _reply(sock, w, h):
    """(frame (h, w, 3) uint8, verify string) of one reply."""
    img = np.frombuffer(_read_exact(sock, w * h * 3), np.uint8)
    (n,) = struct.unpack("<I", _read_exact(sock, 4))
    return img.reshape(h, w, 3), _read_exact(sock, n).decode("ascii")


def _fields(cam):
    return {k: (v.tobytes() if isinstance(v, np.ndarray) else v)
            for k, v in vars(cam).items()}


PARSE_CASES = {
    "full": [_message(fovx=0.9, fovy=0.7, train=False, keep_alive=False,
                      scaling_modifier=0.5, shs_python=True,
                      rot_scale_python=True)],
    "defaults": [_message()],
    "zero_resolution": [_message(w=0), _message(w=32, h=24)],
}


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_receive_matches_jax(case):
    msgs = PARSE_CASES[case]
    got = {}
    for name, cls in (("jax", JGUI), ("torch", TGUI)):
        with _connected(cls) as (gui, client):
            client.sendall(b"".join(_frame_bytes(m) for m in msgs))
            got[name] = [gui.receive() for _ in msgs]
            assert gui.conn is not None          # the connection is kept
    for j, t in zip(got["jax"], got["torch"]):
        assert (j is None) == (t is None)
        if t is not None:
            assert isinstance(t, ViewerCamera)
            assert _fields(t) == _fields(j)
    if case == "zero_resolution":
        assert got["torch"][0] is None and got["torch"][1].width == 32
    if case == "defaults":
        t = got["torch"][0]
        assert (t.do_training, t.keep_alive, t.scaling_modifier,
                t.shs_python, t.rot_scale_python) == (True, True, 1.0,
                                                      False, False)
        np.testing.assert_array_equal(t.world_view_transform, np.eye(4))


@pytest.mark.parametrize("payload", [
    struct.pack("<I", 9) + b"{not json",
    struct.pack("<I", 3) + b"\xff\xfe\xfd",
    struct.pack("<I", 100) + b'{"resolution_x": 8',   # then the client leaves
    b"\x01\x02",                                       # a cut length prefix
], ids=["malformed_json", "not_utf8", "leaves_mid_message", "cut_prefix"])
def test_malformed_input_closes_the_connection_as_jax(payload):
    for cls in (JGUI, TGUI):
        with _connected(cls) as (gui, client):
            client.sendall(payload)
            client.shutdown(socket.SHUT_WR)
            assert gui.receive() is None
            assert gui.conn is None
            assert gui.try_connect() is False    # no viewer waiting


def test_network_gui_round_trip():
    # tests/test_eval_viewer.py's round trip, on the port's server
    with _connected(TGUI) as (gui, client):
        client.sendall(_frame_bytes(dict(
            _message(w=8, h=6), view_matrix=[float(v) for v in
                                             np.eye(4).flatten()])))
        cam = gui.receive()
        assert cam is not None and (cam.width, cam.height) == (8, 6)
        assert cam.world_view_transform[1, 1] == -1.0     # Y/Z flip
        gui.send(np.full((6, 8, 3), 7, np.uint8), "ok")
        frame, verify = _reply(client, 8, 6)
    assert verify == "ok" and (frame == 7).all()


def _jit_render(orig):
    """JAX's ``render_gaussians`` under ``jax.jit`` (static sizes)."""
    @functools.lru_cache(maxsize=None)
    def compiled(size, sh_degree, max_per_tile, max_pairs, smod):
        return jax.jit(lambda p, a, v, i, b: orig(
            p, a, v, i, size, b, sh_degree, max_per_tile=max_per_tile,
            max_pairs=max_pairs, scaling_modifier=smod))

    def render(params, alive, viewmat, intrin, image_size, background,
               sh_degree, *, max_per_tile, max_pairs, scaling_modifier):
        return compiled(tuple(image_size), sh_degree, max_per_tile,
                        max_pairs, scaling_modifier)(
            params, alive, viewmat, intrin, background)
    return render


def _polls(scene, msgs, training_done=False, sh_degree=3):
    """Both packages' poll_viewer over ``msgs``: per package, the return
    values and the replies."""
    out = {}
    runs = (("jax", JGUI, jloop, scene.jstate, jnp.zeros(3),
             jcfg.OptimConfig(max_per_tile=MAX_PER_TILE)),
            ("torch", TGUI, tloop, scene.tstate, torch.zeros(3),
             tcfg.OptimConfig(max_per_tile=MAX_PER_TILE)))
    for name, cls, loop, state, bg, ocfg in runs:
        with _connected(cls) as (gui, client):
            client.sendall(b"".join(_frame_bytes(m) for m in msgs))
            rets = [loop.poll_viewer(gui, state, sh_degree, bg, ocfg,
                                     training_done) for _ in msgs]
            replies = [_reply(client, m["resolution_x"], m["resolution_y"])
                       for m in msgs]
        out[name] = (rets, replies)
    return out


@pytest.mark.parametrize("w,h,smod", [(64, 48, 1.0), (37, 29, 0.7)],
                         ids=["64x48", "37x29_scaled"])
@pytest.mark.parametrize("sh_degree", [0, 3])
def test_poll_viewer_frames_match_jax(scene, monkeypatch, w, h, smod,
                                      sh_degree):
    monkeypatch.setattr(jloop, "render_gaussians",
                        _jit_render(jloop.render_gaussians))
    cam, vm = scene.cam, _viewmat(scene.cam)
    msg = _message(vm, w, h, fovx=cam.fovx, fovy=cam.fovy,
                   scaling_modifier=smod)
    out = _polls(scene, [msg], sh_degree=sh_degree)
    (j_ret,), ((j_frame, j_verify),) = out["jax"]
    (t_ret,), ((t_frame, t_verify),) = out["torch"]
    assert t_verify == j_verify == tloop.VIEWER_VERIFY == "pcp_tpu"
    assert t_ret == j_ret is False
    diff = np.abs(t_frame.astype(np.int16) - j_frame.astype(np.int16))
    assert int(diff.max()) <= 1
    assert float(np.std(t_frame)) > 5        # not blank
    # the bytes sent are the device frame of the split render
    vcam = ViewerCamera(w, h, cam.fovx, cam.fovy, 0.01, 100.0, vm.T,
                        np.eye(4, dtype=np.float32), True, True, smod,
                        False, False)
    frame = tloop.to_frame(tloop.viewer_image(
        scene.tstate, vcam, sh_degree, torch.zeros(3),
        tcfg.OptimConfig(max_per_tile=MAX_PER_TILE)))
    assert frame.dtype == torch.uint8
    np.testing.assert_array_equal(frame.numpy(), t_frame)


def test_poll_viewer_return_table_matches_jax(scene, monkeypatch):
    # the render is not what this test is about: both packages' renders
    # give a black frame, so only the poll's control flow runs
    monkeypatch.setattr(
        jloop, "render_gaussians",
        lambda p, a, v, i, size, *args, **kw: (
            jnp.zeros((size[1], size[0], 3)), None))
    monkeypatch.setattr(
        tloop, "viewer_image",
        lambda state, cam, *args: torch.zeros((cam.height, cam.width, 3)))
    table = [(keep, train, done) for keep in (False, True)
             for train in (False, True) for done in (False, True)]
    for done in (False, True):
        msgs = [_message(w=8, h=6, keep_alive=keep, train=train)
                for keep, train, d in table if d == done]
        out = _polls(scene, msgs, training_done=done)
        want = [keep and not train and not done
                for keep, train, d in table if d == done]
        assert out["torch"][0] == out["jax"][0] == want
        assert [v for _, v in out["torch"][1]] == ["pcp_tpu"] * len(msgs)


class _TimedGUI(TGUI):
    """The port's server with TIMEOUT on the accepted connection's reads
    (``try_connect`` makes them blocking, as the reference does)."""

    def try_connect(self):
        new = self.conn is None
        ok = super().try_connect()
        if ok and new:
            self.conn.settimeout(TIMEOUT)
        return ok


def _run_cfg(src, out):
    return tcfg.TrainRunConfig(
        model=tcfg.ModelConfig(source_path=src, model_path=str(out),
                               resolution=1),
        optim=tcfg.OptimConfig(iterations=6, capacity=256,
                               max_per_tile=MAX_PER_TILE,
                               densify_from_iter=2,
                               densification_interval=2,
                               opacity_reset_interval=100_000),
        test_iterations=[], save_iterations=[6])


def test_train_scene_pauses_for_the_viewer_and_trains_the_same(
        scene, tmp_path, monkeypatch):
    monkeypatch.setenv("PCP_TENSORBOARD", "0")
    info = load_scene(scene.src)
    steps, polls = [], []
    real_step, real_poll = tloop.train_step_impl, tloop.poll_viewer

    def step(*a, **kw):
        steps.append(1)
        return real_step(*a, **kw)

    def poll(*a, **kw):
        ret = real_poll(*a, **kw)
        polls.append((len(steps), ret))
        return ret

    monkeypatch.setattr(tloop, "train_step_impl", step)
    monkeypatch.setattr(tloop, "poll_viewer", poll)
    vm = _viewmat(scene.cam)
    msgs = [_message(vm, 32, 24, fovx=scene.cam.fovx, fovy=scene.cam.fovy,
                     **kw) for kw in ({}, {}, {"train": False},
                                      {"train": False}, {})]
    gui = _TimedGUI("127.0.0.1", 0)
    client = socket.create_connection(gui.listener.getsockname(),
                                      timeout=TIMEOUT)
    try:
        client.sendall(b"".join(_frame_bytes(m) for m in msgs))
        client.shutdown(socket.SHUT_WR)     # then the viewer leaves
        tloop.train_scene(info, _run_cfg(scene.src, tmp_path / "viewer"),
                          log_fn=None, viewer=gui, device="cpu")
        replies = [_reply(client, 32, 24) for _ in msgs]
    finally:
        client.close()
        gui.close()
    n_viewer = len(steps)
    tloop.train_scene(info, _run_cfg(scene.src, tmp_path / "headless"),
                      log_fn=None, device="cpu")

    assert n_viewer == 6 and len(steps) == 12
    # polls: frame, frame, paused, paused, frame (then the viewer is gone)
    assert polls[:5] == [(0, False), (1, False), (2, True), (2, True),
                         (2, False)]
    assert polls[5:] == [(s, False) for s in range(3, 6)]
    assert [v for _, v in replies] == ["pcp_tpu"] * 5
    frames = [f for f, _ in replies]
    assert (frames[2] == frames[3]).all() and (frames[3] == frames[4]).all()
    assert not (frames[0] == frames[2]).all()    # training moved the view
    plys = [tmp_path / d / "point_cloud" / "iteration_6" / "point_cloud.ply"
            for d in ("viewer", "headless")]
    assert plys[0].read_bytes() == plys[1].read_bytes()


def _cli_args(src, out, *extra):
    return ["-s", src, "-m", str(out), "--device", "cpu", "--iterations",
            "2", "--capacity", "256", "--max_per_tile", str(MAX_PER_TILE),
            "--resolution", "1", "--save_iterations", "2",
            "--test_iterations", "0", "--quiet", *extra]


@pytest.mark.parametrize("extra,bound", [
    ((), ("127.0.0.1", 6009)),
    (("--ip", "127.0.0.2", "--port", "7123"), ("127.0.0.2", 7123)),
    (("--disable_viewer",), None),
    (("--ip", "none"), None),
], ids=["defaults", "ip_port", "disable_viewer", "ip_none"])
def test_cli_viewer_flags(scene, tmp_path, monkeypatch, extra, bound):
    import pcp_tpu_torch.viewer as viewer_pkg

    monkeypatch.setenv("PCP_TENSORBOARD", "0")
    made = []

    class Fake:
        def __init__(self, host, port):
            made.append([(host, port), False])

        def try_connect(self):
            return False

        def close(self):
            made[-1][1] = True

    monkeypatch.setattr(viewer_pkg, "NetworkGUI", Fake)
    train_cli.main(_cli_args(scene.src, tmp_path / "m", *extra))
    assert made == ([] if bound is None else [[bound, True]])


def test_cli_trains_headless_when_the_port_is_taken(scene, tmp_path,
                                                    monkeypatch, capsys):
    monkeypatch.setenv("PCP_TENSORBOARD", "0")
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        train_cli.main(_cli_args(scene.src, tmp_path / "m", "--port",
                                 str(port)))
    assert "viewer socket unavailable" in capsys.readouterr().out
    assert (tmp_path / "m" / "point_cloud" / "iteration_2" /
            "point_cloud.ply").exists()


def test_a_failed_render_raises_out_of_the_loop(scene, tmp_path,
                                                monkeypatch):
    # only socket errors close the connection; a render that fails (a
    # kernel launch on the card) stops training
    monkeypatch.setenv("PCP_TENSORBOARD", "0")

    def broken(*a, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(tloop, "viewer_image", broken)
    gui = _TimedGUI("127.0.0.1", 0)
    client = socket.create_connection(gui.listener.getsockname(),
                                      timeout=TIMEOUT)
    try:
        client.sendall(_frame_bytes(dict(
            _message(w=8, h=6), view_matrix=[float(v) for v in
                                             np.eye(4).flatten()])))
        with pytest.raises(RuntimeError, match="launch failed"):
            tloop.train_scene(load_scene(scene.src),
                              _run_cfg(scene.src, tmp_path / "m"),
                              log_fn=None, viewer=gui, device="cpu")
    finally:
        client.close()
        gui.close()
