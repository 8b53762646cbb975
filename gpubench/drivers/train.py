"""The ``train`` traffic kind: one client trains a block in a closed loop,
as the port's ``train/loop.train_scene`` runs it.

Set-up builds one training state from the seed (``scene``), drives it
through ``check_steps`` iterations with the loop's own call and feed (the
last of them a densify iteration), and hands that same state to the
window. The window runs the loop's body from the next iteration: the view
of the shuffled order, ``camera_tensors``, the GT bank, ``train_step_impl``,
and ``densify_impl`` / ``opacity_reset_impl`` on the loop's cadence, each
call in a span of the benchmark's own. Once the window has closed, the same
loop runs on, untimed, to a copy of its state and ``tail_check_steps``
more iterations, the last again a densify iteration. Once the port's state
is freed, the plain reference (``reference.train``) repeats the set-up's
check steps from the seed's inputs, and the tail's from the copy of the
port's state (the reference cannot repeat the window's hundreds of steps),
and densifies each state the port densified.
"""

from __future__ import annotations

import math
import os
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.profiler import record_function

from gpubench import compare, roofline, scene, trace
from gpubench.reference import render as ref_render
from gpubench.reference import train as ref_train

GIB = float(1 << 30)
# a path that no run creates, looked for as the loop looks for its STOP file
STOP_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_cache", "STOP")


def optim_config(cfg: Dict):
    """The port's OptimConfig for the configuration's schedule."""
    from pcp_tpu_torch.train.config import OptimConfig

    lr = cfg["lr"]
    return OptimConfig(
        iterations=int(cfg["iterations"]),
        position_lr_init=lr["position_init"],
        position_lr_final=lr["position_final"],
        position_lr_delay_mult=lr["position_delay_mult"],
        position_lr_max_steps=int(cfg["position_lr_max_steps"]),
        feature_lr=lr["feature"], opacity_lr=lr["opacity"],
        scaling_lr=lr["scaling"], rotation_lr=lr["rotation"],
        appearance_embeddings_lr=lr["appearance_embeddings"],
        appearance_network_lr=lr["appearance_network"],
        percent_dense=cfg["percent_dense"],
        lambda_dssim=cfg["lambda_dssim"],
        densification_interval=int(cfg["densification_interval"]),
        opacity_reset_interval=int(cfg["opacity_reset_interval"]),
        densify_from_iter=int(cfg["densify_from_iter"]),
        densify_until_iter=int(cfg["densify_until_iter"]),
        densify_grad_threshold=cfg["densify_grad_threshold"],
        min_opacity=cfg["min_opacity"],
        capacity=int(cfg["block"]["capacity"]),
        max_per_tile=int(cfg["max_per_tile"]))


class Block:
    """The inputs of one seed: the block's Gaussians and appearance state,
    its training views and their GT."""

    def __init__(self, cfg: Dict, seed: int, device):
        self.cfg, self.seed, self.dev = cfg, seed, torch.device(device)
        rig = cfg["block"]["rig"]
        all_views = scene.views(cfg, rig)
        self.views, _ = scene.split_views(all_views, int(rig["hold"]))
        self.extent = scene.extent(all_views)
        self.background = torch.zeros(3, device=self.dev)

    def gaussians(self):
        return scene.gaussians(dict(self.cfg["block"],
                                    sh_degree=self.cfg["sh_degree"]),
                               self.seed, self.dev)

    def appearance(self):
        return scene.appearance_weights(self.seed, self.dev)

    def gt(self, view) -> torch.Tensor:
        return scene.gt_image(self.seed, view.uid, view.width, view.height,
                              self.dev)


def port_state(block: Block, start_iter: int):
    """The port's TrainState for the block's inputs: Adam counts at the
    iteration before ``start_iter``, moments and statistics zero."""
    from pcp_tpu_torch.models import gaussians as G
    from pcp_tpu_torch.models.appearance import AppearanceNetwork
    from pcp_tpu_torch.train import optim
    from pcp_tpu_torch.train.step import TrainState, app_groups

    params, alive = block.gaussians()
    w = block.appearance()
    net = AppearanceNetwork(float(block.cfg["app_map_scale"])).to(block.dev)
    with torch.no_grad():
        for conv, (wt, b) in zip(net.convs(), w["convs"]):
            conv.weight.copy_(wt)
            conv.bias.copy_(b)
    app = {"embeddings": w["embeddings"], "net": net}
    state = TrainState(params=params, app=app, opt_g=optim.init_adam(params),
                       opt_a=optim.init_adam(app_groups(app)), alive=alive,
                       stats=G.init_densify_stats(alive.shape[0], block.dev))
    state.opt_g["count"] = state.opt_a["count"] = start_iter - 1
    return state


def leaves(state) -> Dict[str, torch.Tensor]:
    """The state's trainable tensors under the reference's leaf names."""
    out = dict(state.params)
    out["embeddings"] = state.app["embeddings"]
    for i, conv in enumerate(state.app["net"].convs()):
        out[f"conv{i}.weight"], out[f"conv{i}.bias"] = conv.weight, conv.bias
    return out


def moments(state, part: str = "mu") -> Dict[str, torch.Tensor]:
    """Adam's first (``mu``) or second (``nu``) moments under the same
    names."""
    out = {k: v[0] for k, v in state.opt_g[part].items()}
    out["embeddings"] = state.opt_a[part]["embeddings"][0]
    net = state.opt_a[part]["net"]
    for i in range(len(net) // 2):
        out[f"conv{i}.weight"], out[f"conv{i}.bias"] = net[2 * i], net[2 * i + 1]
    return out


def clones(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tensors.items()}


def snapshot(state) -> Dict:
    """A copy of the port's training state, in the reference's terms: the
    block's slots and live mask, the appearance weights, both Adam moments
    under the leaf names and the densify statistics."""
    return {"params": clones(state.params), "alive": state.alive.clone(),
            "app": {"embeddings": state.app["embeddings"].detach().clone(),
                    "convs": [(c.weight.detach().clone(),
                               c.bias.detach().clone())
                              for c in state.app["net"].convs()]},
            "m": clones(moments(state, "mu")),
            "v": clones(moments(state, "nu")),
            "stats": clones(state.stats)}


def norm(t: torch.Tensor) -> float:
    return float(t.detach().double().norm())


def host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


class Loop:
    """The loop's body, as ``train_scene`` runs it, over the seed's view
    order from ``first_iter``; ``step(it)`` runs iteration ``it``."""

    def __init__(self, block: Block, state, ocfg, order: List[int],
                 first_iter: int):
        from pcp_tpu_torch.scene.cameras import Camera

        self.block, self.state, self.ocfg = block, state, ocfg
        self.order, self.first_iter = order, first_iter
        self.cams = [Camera(uid=v.uid, viewmat=v.viewmat, fx=v.fx, fy=v.fy,
                            width=v.width, height=v.height)
                     for v in block.views]
        # the GT bank on the card as uint8, as the loop keeps it
        self.gt = {v.uid: block.gt(v) for v in block.views}
        self.generator = torch.Generator().manual_seed(
            int(block.seed) % (1 << 63))
        self.noise = None
        self.nonfinite = 0       # logged losses that were not finite

    def view_of(self, it: int) -> int:
        return self.order[it - self.first_iter]

    def sh_degree(self, it: int) -> int:
        return min(int(self.block.cfg["sh_degree"]), (it - 1) // 1000)

    def step(self, it: int, after_train: Optional[Callable] = None):
        from pcp_tpu_torch.scene.cameras import camera_tensors
        from pcp_tpu_torch.train.step import (
            densify_impl,
            opacity_reset_impl,
            train_step_impl,
        )

        o = self.ocfg
        cam = self.cams[self.view_of(it)]
        with record_function("gpubench.camera"):
            viewmat, intrin = camera_tensors(cam, self.block.dev)
        with record_function("gpubench.train_step"):
            self.state, metrics = train_step_impl(
                self.state, viewmat, intrin, self.gt[cam.uid], cam.uid,
                self.block.background, self.block.extent, ocfg=o,
                image_size=(cam.width, cam.height),
                sh_degree=self.sh_degree(it), use_appearance=True)
        if after_train is not None:
            after_train(self.state)
        if it < o.densify_until_iter:
            if (it % o.densification_interval == 0
                    and it > o.densify_from_iter):
                with record_function("gpubench.densify"):
                    self.state = densify_impl(
                        self.state, self.generator, self.block.extent,
                        ocfg=o, prune_big=it > o.opacity_reset_interval,
                        noise=self.noise)
            if it % o.opacity_reset_interval == 0:
                with record_function("gpubench.opacity_reset"):
                    self.state = opacity_reset_impl(self.state)
        if it % 100 == 0:
            # the loop's log reads (each a wait for the card)
            with record_function("gpubench.log"):
                self.nonfinite += not math.isfinite(float(metrics["loss"]))
                int(self.state.alive.sum())
                bool(metrics["tile_saturated"])
                float(metrics["n_pairs"])
                int(metrics["n_dropped"])
        if it % 50 == 0:
            # the loop's look for its cooperative STOP file
            os.path.exists(STOP_FILE)
        return metrics


def check_start(it: int, n: int, ocfg) -> int:
    """The first iteration from ``it`` on at which ``n`` check steps end
    on a densify iteration."""
    iv = ocfg.densification_interval
    return -(-(it + n - 1) // iv) * iv - n + 1


def check_steps(loop: Loop, start: int, n: int, seed: int) -> Dict:
    """Iterations ``start`` .. ``start + n - 1`` through the loop, the last
    a densify iteration, with what the comparison needs: each step's
    loss, every leaf's first gradient (from Adam's first moment before and
    after one step), every leaf's change after the n steps and what the n
    steps added to the densify statistics (before the densify call), and
    densify's inputs and output on the host."""
    o = loop.ocfg
    last = start + n - 1
    if not (last % o.densification_interval == 0
            and o.densify_from_iter < last < o.densify_until_iter):
        raise ValueError(f"check iteration {last} is not a densify iteration")
    p0 = clones(leaves(loop.state))
    m0 = clones(moments(loop.state))
    s0 = clones(loop.state.stats)
    prog: Dict = {"loss": []}

    def first(state):
        prog["grad"] = {k: norm(v - ref_train.B1 * m0[k]) / (1 - ref_train.B1)
                        for k, v in moments(state).items()}

    def final(state):
        prog["change"] = {k: norm(v.detach() - p0[k])
                          for k, v in leaves(state).items()}
        prog["stats"] = {k: norm(v - s0[k]) for k, v in state.stats.items()}
        prog["densify_in"] = {"params": host(state.params),
                              "alive": state.alive.to("cpu", copy=True),
                              "stats": host(state.stats)}

    def both(state):
        first(state)
        final(state)

    for it in range(start, last + 1):
        cb = both if n == 1 else first if it == start else (
            final if it == last else None)
        if it == last:
            loop.noise = scene.split_noise(seed, it, o.capacity,
                                           loop.block.dev)
        m = loop.step(it, after_train=cb)
        prog["loss"].append(float(m["loss"]))
    loop.noise = None
    prog["densify_out"] = {"params": host(loop.state.params),
                           "alive": loop.state.alive.to("cpu", copy=True)}
    prog["densify_iter"] = last
    return prog


def reference_run(block: Block, start: int, n: int, order: List[int],
                  trainer=ref_train.Trainer, snap: Optional[Dict] = None
                  ) -> Dict:
    """The plain reference's check steps on the views ``order[:n]``, from
    the seed's inputs or, given ``snap``, from that copy of the port's
    state, recorded as ``check_steps`` records the port's: each step's
    loss, every leaf's first gradient (Adam's first moment before and after
    one step), every leaf's change and what the steps added to the densify
    statistics, and its own densify's inputs and output in the block's
    slots. ``trainer`` puts a variant of the reference in the port's place
    (``gpubench/control``)."""
    cfg, dev = block.cfg, block.dev
    if snap is None:
        params, alive = block.gaussians()
        app = block.appearance()
    else:
        params, alive, app = clones(snap["params"]), snap["alive"], snap["app"]
    tr = trainer({k: v[alive] for k, v in params.items()},
                 app, cfg, block.extent, count=start - 1)
    if snap is not None:
        tr.m, tr.v = ({k: (v[alive] if k in params else v).clone()
                       for k, v in snap[part].items()} for part in "mv")
        tr.stats = {k: snap["stats"][k][alive].clone() for k in tr.stats}
    p0, m0, s0 = clones(tr.leaves()), clones(tr.m), clones(tr.stats)
    out: Dict = {"loss": []}
    for i in range(n):
        view = block.views[order[i]]
        r = tr.step(view, block.gt(view), block.background,
                    min(int(cfg["sh_degree"]), (start + i - 1) // 1000))
        out["loss"].append(r["loss"])
        if i == 0:
            out["grad"] = {k: norm(m - ref_train.B1 * m0[k])
                           / (1 - ref_train.B1) for k, m in tr.m.items()}
    out["change"] = {k: norm(v - p0[k]) for k, v in tr.leaves().items()}
    out["stats"] = {k: norm(v - s0[k]) for k, v in tr.stats.items()}
    for k in params:
        params[k][alive] = tr.p[k]
    stats = {}
    for k, v in tr.stats.items():
        stats[k] = torch.zeros(alive.shape[0], device=dev)
        stats[k][alive] = v
    it = start + n - 1
    new_p, new_alive = ref_train.densify(
        params, alive, stats,
        scene.split_noise(block.seed, it, alive.shape[0], dev), cfg,
        block.extent, prune_big=it > cfg["opacity_reset_interval"])
    out["densify_in"] = {"params": params, "alive": alive, "stats": stats}
    out["densify_out"] = {"params": new_p, "alive": new_alive}
    out["densify_iter"] = it
    return out


def reference_check(block: Block, start: int, n: int, order: List[int],
                    prog: Dict, snap: Optional[Dict] = None):
    """(notes, the numbers compared) of the port's check steps ``prog``
    against the reference's (``reference_run``, from ``snap`` if given):
    the losses, the first gradients, the changes, the statistics and the
    population after densify. The notes also hold the port's pre-densify
    state densified by the reference, slot for slot."""
    ref = reference_run(block, start, n, order, snap=snap)
    dev = block.dev
    d_in, d_out = prog["densify_in"], prog["densify_out"]
    new_p, new_alive = ref_train.densify(
        {k: v.to(dev) for k, v in d_in["params"].items()},
        d_in["alive"].to(dev),
        {k: v.to(dev) for k, v in d_in["stats"].items()},
        scene.split_noise(block.seed, prog["densify_iter"],
                          d_in["alive"].shape[0], dev),
        block.cfg, block.extent,
        prune_big=prog["densify_iter"] > block.cfg["opacity_reset_interval"])
    out_alive = d_out["alive"].to(dev)
    both = out_alive & new_alive
    n_prog = float(out_alive.sum())
    n_ref = float(ref["densify_out"]["alive"].sum())
    skip = compare.negligible(ref["grad"])
    notes = {"grad_gaps": compare.leaf_gaps(prog["grad"], ref["grad"]),
             "change_gaps": compare.leaf_gaps(prog["change"], ref["change"],
                                              skip),
             "loss": prog["loss"], "ref_loss": ref["loss"],
             "ref_grad": ref["grad"],
             "negligible": sorted(skip),
             "alive_after_densify": [int(n_prog), int(n_ref)],
             "densify_slots_apart": int((out_alive != new_alive).sum()),
             "densify_value_gap": max(
                 float((d_out["params"][k].to(dev)[both] - new_p[k][both])
                       .abs().max()) if bool(both.any()) else 0.0
                 for k in new_p)}
    return notes, {
        "loss_gap": max(compare.rel_gap(p, r)
                        for p, r in zip(prog["loss"], ref["loss"])),
        "grad_gap": compare.leaf_gap(prog["grad"], ref["grad"]),
        "change_gap": compare.leaf_gap(prog["change"], ref["change"], skip),
        "stats_gap": max(compare.rel_gap(prog["stats"][k], v)
                         for k, v in ref["stats"].items()),
        "densify_alive_gap": compare.rel_gap(n_prog, n_ref),
    }


def counts_of(snap: Dict, dev) -> Dict:
    """The blend's work on a profiled step's inputs, by the reference."""
    p = {k: v.to(dev) for k, v in snap["params"].items()}
    c = ref_render.render_params(p, snap["view"], snap["sh_degree"],
                                 torch.zeros(3, device=dev), counts=True)[2]
    c["live"] = p["xyz"].shape[0]
    return c


def host_step_quantiles(marks: List[float]) -> List[float]:
    """Quartiles, 10th and 90th percentiles and largest of the host's
    time between two steps' starts in the window, ms."""
    d = sorted(1e3 * (b - a) for a, b in zip(marks, marks[1:]))
    if len(d) < 10:
        return d
    q = statistics.quantiles(d, n=20)
    return [q[1], q[4], q[9], q[14], q[17], d[-1]]


def run(cfg: Dict, traffic: Dict, seed: int, seconds: float, traced: bool,
        device, t_start: float) -> Dict:
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    block = Block(cfg, seed, dev)
    ocfg = optim_config(cfg)
    start = int(traffic["start_iteration"])
    n_check = int(traffic["check_steps"])
    max_steps = int(traffic.get("max_window_steps", 100_000))
    n_tail = int(traffic["tail_check_steps"])
    order = scene.camera_order(seed, len(block.views),
                               n_check + max_steps + n_tail
                               + ocfg.densification_interval)
    loop = Loop(block, port_state(block, start), ocfg, order, start)
    prog = check_steps(loop, start, n_check, seed)
    sync()

    # the window
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    profile_at = range(int(traffic["profile_offset"]),
                       int(traffic["profile_offset"])
                       + int(traffic["profile_steps"])) if traced else ()
    it = start + n_check
    steps, traced_s, parts, snaps = 0, 0.0, [], []
    marks = []
    t_setup = time.perf_counter() - t_start
    t0 = time.perf_counter()
    while True:
        marks.append(time.perf_counter())
        if steps in profile_at:
            ts = time.perf_counter()
            snaps.append({"params": host({k: v[loop.state.alive] for k, v in
                                          loop.state.params.items()}),
                          "view": loop.block.views[loop.view_of(it)],
                          "sh_degree": loop.sh_degree(it)})
            with torch.profiler.profile(activities=trace.ACTIVITIES) as prof:
                sync()
                tp = time.perf_counter()
                loop.step(it)
                sync()
                wall = time.perf_counter() - tp
            parts.append(trace.reduce(prof, 1, wall))
            traced_s += time.perf_counter() - ts
        else:
            loop.step(it)
        it += 1
        steps += 1
        if time.perf_counter() - t0 >= seconds or steps >= max_steps:
            break
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    result = {
        "attempted": steps, "failed": loop.nonfinite,
        "memory_peak_bytes": int(peak),
        "window_s": window_s,
        # the rate under both names: the host-bound cells report it as
        # a metric of its own, with a bound of its own
        "end_to_end": {"setup_s": t_setup,
                       "train_steps_per_s": steps / window_s,
                       "train_steps_per_s.host_bound": steps / window_s,
                       "train_peak_mem_gib": peak / GIB},
    }
    # after the window, the same loop on to the tail's check steps
    tail_start = check_start(it, n_tail, ocfg)
    while it < tail_start:
        loop.step(it)
        it += 1
    snap = snapshot(loop.state)
    tail = check_steps(loop, tail_start, n_tail, seed)
    tail_views = [loop.view_of(tail_start + i) for i in range(n_tail)]
    del loop
    if on_card:
        torch.cuda.empty_cache()

    if traced:
        t = trace.merge(parts)
        counts = [counts_of(s, dev) for s in snaps]
        ideal: Dict[str, float] = {}
        for c, s in zip(counts, snaps):
            for k, v in roofline.train_stages(
                    c["live"], c, s["sh_degree"], int(cfg["width"]),
                    int(cfg["height"])).items():
                ideal[k] = ideal.get(k, 0.0) + v / len(counts)
        t.update(kind="train", ideal_ms=ideal, counts=counts,
                 step_ms_untraced=1e3 * (window_s - traced_s)
                 / max(steps - len(parts), 1))
        result["trace"] = t
    notes, values = reference_check(block, start, n_check, order, prog)
    notes["tail"], tail_values = reference_check(
        block, tail_start, n_tail, tail_views, tail, snap)
    del snap
    notes["tail"]["iterations"] = [tail_start, tail_start + n_tail - 1]
    notes["values"] = {"setup": values, "tail": tail_values}
    # each number compared is the worse of the set-up's and the tail's, but
    # the first gradient: after the window its worst leaf reads within a
    # factor of two of what TF32 gives at set-up, so the tail's is printed
    # and not compared (its steps' changes are)
    result["values"] = {k: v if k == "grad_gap" else max(v, tail_values[k])
                        for k, v in values.items()}
    result["values"]["tail_grad_gap"] = tail_values["grad_gap"]
    result["notes"] = notes
    result["notes"]["window_host_ms"] = host_step_quantiles(marks)
    return result
