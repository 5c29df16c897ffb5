"""The `train_loop` traffic: the program's two-stage training on the cell's
scene, as the train command line drives it.

Set-up makes the inputs from the seed (ground-truth views, exact matches,
the initial depths), hands them to `pipeline.setup_from_matches` (kNN,
init stage, promotion, `create_model`), then starts ONE
`pipeline.run_main_stage` loop; its first `setup_steps` iterations are
set-up (they warm every shape up and are the steps the reference follows),
the window is the iterations after them, until the first iteration boundary
past `--seconds` or the end of the schedule. After each iteration the
callback reads the loss to the host, as the command line's does.

The check (once the window has closed, the peak read and the program's
state freed). The reference reads back only the init stage's depths; from
them it builds the start model itself (promotion, a plain kNN,
`create_model`'s leaves) and holds the program's against it; it follows
the first three steps from the program's start model (each stage held by
itself: a start model that differs by rounding in a few near-coincident
points' scales would otherwise swamp the steps' numbers); it recomputes
the window's first densify event from the state the program had just
before it; and it follows `follow.steps` steps inside the window from the
program's state after iteration `follow.from` - 1 (the cell's limits name
it: with background Gaussians alive, past the SH degree's rise where the
window surely reaches it). A window that misses either fails the check.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.lib import reference, scene
from benchmark.lib import trace as tr
from benchmark.lib import yardstick

B1 = 0.9  # Adam's first-moment decay: the first gradient is m / (1 - B1) after one step


class WindowClosed(Exception):
    pass


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def inputs(cfg: dict, seed: int, device: torch.device) -> dict:
    """The seed's scene: views, ground truth [3, H, W] each, matches,
    initial depths [pairs, matches] drawn in [near, far]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    views = scene.train_views(cfg)
    tex = scene.Texture.draw(cfg, gen, device)
    truths = [scene.render_truth(v, cfg["surface"], tex, device) for v in views]
    pixels = scene.exact_matches(views, cfg["surface"], cfg["matches_per_pair"], gen, device)
    pairs = len(views) * (len(views) - 1)
    near, far = cfg["near_far"]
    z0 = near + (far - near) * torch.rand(pairs, cfg["matches_per_pair"], generator=gen,
                                          device=device)
    return dict(views=views, truths=truths, pixels=pixels, z0=z0,
                extent=scene.camera_extent(views), stack_seed=seed, split_seed=seed + 1)


def leaves_of(model, names, to_cpu: bool = True) -> Dict[str, torch.Tensor]:
    out = {}
    for k in names:
        v = getattr(model, k).detach().clone()
        out[k] = v.cpu() if to_cpu else v
    return out


def state_of(model, opt_state, to_cpu: bool) -> Dict[str, torch.Tensor]:
    """Leaves, buffers, statistics and moments, as `reference.densify` takes them."""
    s = leaves_of(model, reference.PARAMS + reference.BUFFERS
                  + ("xyz_gradient_accum", "denom"), to_cpu)
    for mom, tree in (("m", opt_state.m), ("v", opt_state.v)):
        for k, v in tree.items():
            v = v.detach().clone()
            s[f"{mom}.{k}"] = v.cpu() if to_cpu else v
    return s


def opt_dict(cfg: dict) -> dict:
    return dict(cfg["optimization"], match_weight=cfg["extras"]["render_match_loss_weight"])


class Run:
    """One run of the cell: set-up, the window, then what the check and the
    metrics need."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool, t0: float,
                 device: torch.device, stop_when_captured: bool = False):
        self.cfg, self.traffic = spec["config"], spec["traffic"]
        self.follow = spec["limits"]["follow"]
        self.follow_cap: dict = {}
        self.seed, self.seconds, self.trace, self.t0 = seed, seconds, trace, t0
        self.device = device
        self.stop_when_captured = stop_when_captured
        self.losses: List[float] = []
        self.window_losses: List[float] = []
        self.densify_s: List[float] = []
        self.capture: Optional[dict] = None
        self.sub = tr.SubWindow(device) if trace else None
        self.sub_first = None
        self.sub_done = False
        self.launches = tr.Launches()
        self.model = None

    # ---------------- the program's side ----------------

    def run(self) -> None:
        from scgaussian_tpu_torch.config import OptimizationConfig, TrainExtras
        from scgaussian_tpu_torch.core.cameras import Camera
        from scgaussian_tpu_torch.model.matches import build_match_bundle
        from scgaussian_tpu_torch.renderer import project as project_mod
        from scgaussian_tpu_torch.renderer import raster
        from scgaussian_tpu_torch.train import main_stage, pipeline

        cfg, dev = self.cfg, self.device
        self.inp = inp = inputs(cfg, self.seed, dev)
        views = inp["views"]
        cams = [Camera.create(v.R, v.T, v.fovx, v.fovy, v.width, v.height, device=dev)
                for v in views]
        images = [t.permute(1, 2, 0).cpu().numpy() for t in inp["truths"]]
        bundle = build_match_bundle(
            images, [v.K() for v in views], [v.w2c() for v in views],
            [np.asarray(cfg["near_far"], np.float32)] * len(views), inp["pixels"], device=dev)
        del images
        extras = TrainExtras(**cfg["extras"])
        opt_cfg = OptimizationConfig(**cfg["optimization"])

        sync(dev)
        t = time.perf_counter()
        model, init = pipeline.setup_from_matches(bundle, None, cfg["sh_degree"], inp["extent"],
                                                  extras=extras, z0=inp["z0"])
        sync(dev)
        self.from_matches_s = time.perf_counter() - t
        self.best_z = init.best_z.detach().clone()  # all the reference reads of set-up
        self.start = leaves_of(model, reference.PARAMS + reference.BUFFERS)
        del init
        self.ray_gaussians = model.num_ray

        targets = [(pipeline, "densify_and_prune", self.densify_wrapper)]
        if self.trace:
            targets += self.launches.targets(raster)
            targets += [(pipeline, "train_step", tr.spanned("train_step")),
                        (pipeline, "densify_and_prune", tr.spanned("densify")),
                        (pipeline, "reset_opacity", tr.spanned("reset_opacity")),
                        (main_stage, "render_model", tr.spanned("render")),
                        (project_mod, "project", tr.spanned("project")),
                        (raster, "bin_gaussians", tr.spanned("bin")),
                        (raster, "raster_fwd", tr.spanned("raster_fwd")),
                        (raster, "raster_bwd", tr.spanned("raster_bwd")),
                        (raster, "raster_bwd_entries", tr.spanned("raster_bwd")),
                        (raster, "segsum_runs", tr.spanned("segsum")),
                        (main_stage, "l1_loss", tr.spanned("l1")),
                        (main_stage, "ssim", tr.spanned("ssim")),
                        (main_stage, "matchloss_from_renderdepth", tr.spanned("match_loss")),
                        (main_stage, "update_stats", tr.spanned("update_stats")),
                        (main_stage, "apply_update", tr.spanned("adam"))]
        self.iteration = 0
        self.t_window = self.t_end = None
        try:
            with tr.patched(targets):
                pipeline.run_main_stage(
                    model, bundle, cams, inp["truths"], list(range(len(views))),
                    stack_seed=inp["stack_seed"], opt_cfg=opt_cfg, extras=extras,
                    cameras_extent=inp["extent"], callback=self.callback,
                    generator=torch.Generator(device=dev).manual_seed(inp["split_seed"]))
            sync(dev)
            self.t_end = time.perf_counter()
        except WindowClosed:
            pass
        finally:
            if self.sub is not None and self.sub_first is not None and not self.sub_done:
                self.close_sub()
        self.window_s = self.t_end - self.t_window
        self.memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        self.alive_bg = int(self.model.bg_alive.sum())
        self.bg_capacity = self.model.bg_capacity
        self.model = None
        del model, bundle, cams

    def densify_wrapper(self, fn):
        def wrapper(model, opt_state, *args, generator=None, **kwargs):
            first = self.capture is None and self.t_window is not None
            if first:
                before = state_of(model, opt_state, to_cpu=False)
                gen_state = generator.get_state()
            if self.trace:
                sync(self.device)
                t = time.perf_counter()
            out = fn(model, opt_state, *args, generator=generator, **kwargs)
            if self.trace:
                sync(self.device)
                self.densify_s.append(time.perf_counter() - t)
            if first:
                self.capture = dict(before=before, after=state_of(out[0], out[1], to_cpu=False),
                                    generator=gen_state, iteration=self.iteration + 1)
            return out
        return wrapper

    def follow_capture(self, iteration, model, opt_state, loss) -> None:
        """The program's state after iteration F - 1 = `follow.from` - 1, its
        first moments after step F, its losses of steps F .. F + k - 1 and
        its leaves after them (kept on the device)."""
        first, k = self.follow["from"], self.follow["steps"]
        if iteration == first - 1:
            self.follow_cap = dict(before=state_of(model, opt_state, to_cpu=False),
                                   steps_done=opt_state.count, losses=[])
        elif "before" in self.follow_cap and first <= iteration < first + k:
            self.follow_cap["losses"].append(loss)
            if iteration == first:
                self.follow_cap["m"] = {n: v.detach().clone() for n, v in opt_state.m.items()}
            if iteration == first + k - 1:
                self.follow_cap["after"] = leaves_of(model, reference.PARAMS, to_cpu=False)

    def close_sub(self) -> None:
        self.launches.on = False
        self.sub.stop()
        self.sub_done = True
        self.sub.units = self.iteration - self.sub_first + 1

    def callback(self, iteration, model, metrics, opt_state=None, raster=None) -> None:
        loss = float(metrics.loss)  # the loss to the host, as the command line's callback reads it
        self.iteration = iteration
        self.model = model
        steps = self.traffic["setup_steps"]
        if iteration <= steps:
            self.losses.append(loss)
            if iteration == 1:
                self.m1 = {k: v.detach().cpu() for k, v in opt_state.m.items()}
            if iteration == steps:
                self.after = leaves_of(model, reference.PARAMS)
                if self.sub is not None:
                    self.sub.warm()
                sync(self.device)
                self.t_window = time.perf_counter()
                self.setup_s = self.t_window - self.t0
            return
        self.window_losses.append(loss)
        self.follow_capture(iteration, model, opt_state, loss)
        now = time.perf_counter()
        if self.sub is not None and not self.sub_done:
            if (self.sub_first is None
                    and now - self.t_window >= self.traffic["trace_after"] * self.seconds):
                self.sub_first = iteration + 1
                self.sub.start()
                self.launches.on = True
            elif (self.sub_first is not None
                  and iteration - self.sub_first + 1 >= self.traffic["trace_iterations"]):
                self.close_sub()
        if self.stop_when_captured and self.capture is not None and "after" in self.follow_cap:
            sync(self.device)
            self.t_end = time.perf_counter()
            raise WindowClosed
        open_sub = self.sub is not None and self.sub_first is not None and not self.sub_done
        if now - self.t_window >= self.seconds and not open_sub:
            sync(self.device)
            self.t_end = time.perf_counter()
            raise WindowClosed

    # ---------------- what the metrics read ----------------

    def metrics_context(self) -> dict:
        ctx = dict(kind="train", setup_s=self.setup_s, from_matches_s=self.from_matches_s,
                   iterations=len(self.window_losses), window_s=self.window_s,
                   densify_s=self.densify_s)
        if self.trace and self.sub_done:
            summary = tr.reduce(self.sub.prof)
            ctx["trace"] = summary
            ctx["units"] = self.sub.units
            ctx["launches"] = self.launch_work()
        return ctx

    def launch_work(self) -> dict:
        """Each captured launch's least time (s, in call order) and the
        sub-window's counted operations."""
        fwd, bwd, flops = [], [], 0.0
        pairs_of = {}
        for bins, attrs, W, H in self.launches.fwd:
            pairs = yardstick.count_pairs(attrs, W, H)
            pairs_of[id(bins)] = pairs
            tiles = bins.tile_starts.numel() - 1
            fwd.append(yardstick.bound_ms(
                yardstick.fwd_bytes(bins.num_entries, attrs.shape[0], tiles, W, H),
                pairs * yardstick.OPS_PER_PAIR)[0] * 1e-3)
            alive = int((attrs[:, 5] > 0).sum())
            flops += (pairs * (yardstick.OPS_PER_PAIR + yardstick.OPS_LIVE_BWD)
                      + alive * (yardstick.PROJ_OPS_FWD + yardstick.PROJ_OPS_BWD
                                 + yardstick.PARAMS_PER_GAUSSIAN * yardstick.ADAM_OPS)
                      + W * H * (yardstick.LOSS_OPS_FWD + yardstick.LOSS_OPS_BWD)
                      + (len(self.inp["views"]) - 1) * self.cfg["matches_per_pair"]
                      * yardstick.MATCH_OPS)
        for bins, attrs, W, H, per_entry in self.launches.bwd:
            tiles = bins.tile_starts.numel() - 1
            bwd.append(yardstick.bound_ms(
                yardstick.bwd_bytes(bins.num_entries, attrs.shape[0], tiles, W, H, per_entry),
                pairs_of[id(bins)] * yardstick.OPS_LIVE_BWD)[0] * 1e-3)
        seg = [yardstick.route_bound(rows, n)[0] * 1e-3 for rows, n in self.launches.seg]
        self.launches = tr.Launches()
        return dict(fwd=fwd, bwd=bwd, seg=seg, flops=flops)

    # ---------------- the check ----------------

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_start(self, tf32: bool = False, z=None, knn_k: int = 3):
        """The reference's start model from the init stage's depths (the
        program's `best_z` unless `z` is given): (leaves, the init stage's
        error at those depths [P, M])."""
        inp, dev = self.inp, self.device
        with reference.precision(tf32):
            return reference.start_model(
                reference.Matches(inp["views"], inp["pixels"], dev), inp["pixels"],
                inp["truths"], self.best_z if z is None else z,
                self.cfg["extras"]["promote_err_threshold"], self.cfg["sh_degree"],
                self.cfg["extras"]["bg_capacity"], knn_k)

    def trainer(self, leaves, trainer_cls=reference.Trainer, steps_done: int = 0, **kwargs):
        inp = self.inp
        return trainer_cls(leaves, inp["views"], inp["truths"],
                           reference.Matches(inp["views"], inp["pixels"], self.device),
                           opt_dict(self.cfg), inp["extent"], inp["stack_seed"],
                           steps_done=steps_done, **kwargs)

    def reference_steps(self, trainer_cls=reference.Trainer, **kwargs):
        """The reference's first steps from the program's start model (held
        against the reference's own by `start_numbers`): (losses, first
        gradients, leaves after the steps)."""
        trainer = self.trainer({k: v.to(self.device) for k, v in self.start.items()},
                               trainer_cls, **kwargs)
        losses, g1 = [], None
        for it in range(1, self.traffic["setup_steps"] + 1):
            loss, g = trainer.step(it)
            losses.append(loss)
            if it == 1:
                g1 = {k: v.detach().cpu() for k, v in g.items()}
        after = {k: v.detach().cpu() for k, v in trainer.p.items()}
        return losses, g1, after

    def reference_follow(self, trainer_cls=reference.Trainer, **kwargs):
        """The reference's `follow.steps` steps from the program's state
        after iteration `follow.from` - 1: (losses, first gradients, leaves
        after the steps), or None where the window never reached them."""
        cap = self.follow_cap
        if "after" not in cap:
            return None
        trainer = self.trainer(cap["before"], trainer_cls, steps_done=cap["steps_done"],
                               **kwargs)
        losses, g1 = [], None
        for it in range(self.follow["from"], self.follow["from"] + self.follow["steps"]):
            loss, g = trainer.step(it)
            losses.append(loss)
            if g1 is None:
                g1 = {k: v.detach().cpu() for k, v in g.items()}
        return losses, g1, {k: v.detach().cpu() for k, v in trainer.p.items()}

    def program_follow(self):
        """The program's side of the followed steps: its losses, its first
        gradient worked out from the first moments before and after the
        first step, its leaves after the steps."""
        cap = self.follow_cap
        g = {k: ((cap["m"][k] - B1 * cap["before"][f"m.{k}"]) / (1 - B1)).cpu()
             for k in reference.PARAMS}
        return cap["losses"], g, {k: v.cpu() for k, v in cap["after"].items()}

    def numbers(self) -> Dict[str, Optional[float]]:
        """Every compared number of the run: the start model's, the first
        steps', the followed steps' (None where the window never reached
        them) and the densify event's."""
        ref_start, err = self.reference_start()
        out = start_numbers(self.start, ref_start, err)
        prog = (self.losses, {k: v / (1 - B1) for k, v in self.m1.items()}, self.after)
        out.update(step_numbers(prog, self.reference_steps(), self.start))
        out.update(self.follow_numbers())
        out.update(self.densify_numbers())
        return out

    def follow_numbers(self, ref=None, prog=None) -> Dict[str, Optional[float]]:
        """follow_loss_gap, follow_grad_gap, follow_delta_gap: as the first
        steps' numbers, for the followed steps from one state (None where
        the window never reached them)."""
        if "after" not in self.follow_cap:
            return dict(follow_loss_gap=None, follow_grad_gap=None, follow_delta_gap=None)
        ref = ref or self.reference_follow()
        prog = prog or self.program_follow()
        start = {k: self.follow_cap["before"][k].cpu() for k in reference.PARAMS}
        out = {"follow_" + k: v for k, v in step_numbers(prog, ref, start).items()}
        out.update(follow_worst_leaf=worst_leaf(prog[1], ref[1]))  # not compared
        return out

    def densify_numbers(self, tf32: bool = False) -> Dict[str, Optional[float]]:
        """The window's first densify event recomputed from the state before
        it (None where the window held none)."""
        if self.capture is None:
            return dict(densify_gap=None, densify_slots=None)
        dev = self.device
        cap = self.capture
        gen = torch.Generator(device=dev)
        gen.set_state(cap["generator"])
        with reference.precision(tf32):
            ref = reference.densify(cap["before"], self.cfg["optimization"], self.inp["extent"],
                                    cap["iteration"], gen, self.cfg["extras"]["prune_min_opacity"])
        return densify_gap(cap["after"], ref)


def densify_gap(got: dict, ref: dict) -> Dict[str, float]:
    """densify_slots: the background slots whose alive bit differs.
    densify_gap: by the worst leaf or moment, the largest difference over
    the reference's largest magnitude."""
    slots = int((ref["bg_alive"] != got["bg_alive"]).sum())
    gap = 0.0
    for k in list(reference.PARAMS) + [f"{m}.{p}" for m in "mv" for p in reference.PARAMS]:
        scale = float(ref[k].abs().max()) if ref[k].numel() else 0.0
        if scale > 0:
            gap = max(gap, float((got[k] - ref[k]).abs().max()) / scale)
    return dict(densify_gap=gap, densify_slots=float(slots))


def worst_leaf(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> str:
    """The leaf whose gradient norms differ most against the reference's
    norm of that leaf or of the median leaf, with that gap."""
    rn, pn = norms(ref), norms(prog)
    med = float(np.median([v for v in rn.values() if v > 0]))
    k = max(rn, key=lambda k: abs(pn[k] - rn[k]) / max(rn[k], med))
    return f"{k} {abs(pn[k] - rn[k]) / max(rn[k], med):.3g}"


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.to(torch.float64))) for k, v in tree.items()}


def start_numbers(prog: dict, ref: dict, err: torch.Tensor) -> Dict[str, float]:
    """init_err_p90: the 90th percentile over the matches of the init
    stage's reprojection error at its depths (normalized image
    coordinates), as the reference works it out. start_promoted: how many
    more or fewer ray Gaussians the program's start model has than the
    reference's. start_gap: by the worst leaf or ray, the largest difference
    over the reference's largest magnitude (the difference itself where that
    is 0), the log-scales taken as the kNN's mean squared distance
    exp(2 scaling) that they are made from; 1 where the counts differ.
    Not compared: start_log_scale_gap, the same for the log-scales
    themselves, and start_log_scale_worst_dist2, the reference's mean
    squared distance at the Gaussian where they differ most."""
    out = dict(init_err_p90=float(torch.quantile(err.reshape(-1).to(torch.float64), 0.9)),
               start_promoted=float(abs(prog["zval"].shape[0] - ref["zval"].shape[0])))
    if out["start_promoted"]:
        return dict(out, start_gap=1.0)

    def gap(p, r):
        scale = float(r.abs().max())
        return float((p - r).abs().max()) / (scale if scale > 0 else 1.0)

    worst = 0.0
    for k in reference.PARAMS + ("rayo", "rayd"):
        if not ref[k].numel():
            continue
        r, p = ref[k].cpu().to(torch.float64), prog[k].to(torch.float64)
        if k == "scaling":
            out["start_log_scale_gap"] = gap(p, r)
            i = int((p - r).abs().max(dim=1).values.argmax())
            out["start_log_scale_worst_dist2"] = float(torch.exp(2.0 * r[i, 0]))
        if k in ("scaling", "bg_scaling"):
            r, p = torch.exp(2.0 * r), torch.exp(2.0 * p)
        worst = max(worst, gap(p, r))
    out["start_gap"] = worst
    return out


def step_numbers(prog, ref, start) -> Dict[str, float]:
    """loss_gap: the largest relative gap of a step's loss. grad_gap and
    delta_gap: by the worst leaf, the gap between the two sides' norms of
    the first gradient and of the change after the steps from `start`,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger. Leaves whose reference gradient is under a
    thousandth of the median non-zero leaf's are left out (they move by
    round-off alone)."""
    (pl, pg, pa), (rl, rg, ra) = prog, ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(pl, rl))
    rgn, pgn = norms(rg), norms(pg)
    nonzero = sorted(v for v in rgn.values() if v > 0)
    med = float(np.median(nonzero))
    counted = [k for k in rgn if rgn[k] >= 1e-3 * med]
    med_g = float(np.median([rgn[k] for k in counted]))
    grad_gap = max(abs(pgn[k] - rgn[k]) / max(rgn[k], med_g) for k in counted)
    rd = norms({k: ra[k] - start[k] for k in counted})
    pd = norms({k: pa[k] - start[k] for k in counted})
    med_d = float(np.median(list(rd.values())))
    delta_gap = max(abs(pd[k] - rd[k]) / max(rd[k], med_d) for k in counted)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, delta_gap=delta_gap)
