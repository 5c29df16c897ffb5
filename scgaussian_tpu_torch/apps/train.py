"""Training CLI — flag-compatible with the reference `train.py:278-307`.

Port of the JAX package's `apps/train.py`. Usage (as the reference's
README.md:63-85):

    python -m scgaussian_tpu_torch.apps.train -s <scene> -m <out> -r 8 --eval

It runs on `--device` (default `cuda`; without a GPU it raises unless
`--device cpu` is given, which runs the CUDA kernels' plain versions).
The flags and their defaults are the JAX CLI's, except:

- `--backend` takes `cuda` (the tile path, default) or `oracle`;
- `--device` is new;
- `--data_parallel D` trains over a process group of D ranks, one per
  device (`parallel/dp.py`): under `--multihost` the D processes are
  launched by the user, the same command once each with its
  `--process_id` (or the `env://` variables), and D must equal their
  number; without it the CLI starts D local ranks itself, one process per
  visible GPU, or D gloo processes with `--device cpu`. Only process 0
  evaluates, saves and writes `cfg_args.json`. The guards come first,
  before the scene is read;
- `--port` starts the SIBR viewer's listener (`viewer/network_gui.py`) on
  `--ip`, polled every iteration as in the JAX CLI;
- `--detect_anomaly` turns on `torch.autograd.set_detect_anomaly`;
- `--profile_dir` writes a `torch.profiler` trace of the main stage.

Random draws cannot equal the JAX CLI's `jax.random` draws. Each comes from
`--seed`: the init stage's z0 from a `torch.Generator` on the device seeded
with `seed`, the main stage's camera stack from
`np.random.default_rng(seed)`, and the densify split noise from a
`torch.Generator` on the device seeded with `seed + 1`. The scene's camera
order comes from `np.random.default_rng(seed)` in both packages.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from scgaussian_tpu_torch.parallel import dp, hosts


def build_parser() -> argparse.ArgumentParser:
    """Flags mirror `arguments/__init__.py:47-91` + `train.py:284-292`."""
    p = argparse.ArgumentParser(description="Training script parameters")
    # ModelParams
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--source_path", "-s", type=str, default="")
    p.add_argument("--model_path", "-m", type=str, default="")
    p.add_argument("--images", "-i", type=str, default="images")
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--eval", action="store_true")
    # PipelineParams
    p.add_argument("--convert_SHs_python", action="store_true")
    p.add_argument("--compute_cov3D_python", action="store_true")
    p.add_argument("--debug", action="store_true")
    # OptimizationParams
    p.add_argument("--iterations", type=int, default=2_000)
    p.add_argument("--position_lr_init", type=float, default=0.00016)
    p.add_argument("--position_lr_final", type=float, default=0.0000016)
    p.add_argument("--position_lr_delay_mult", type=float, default=0.01)
    p.add_argument("--position_lr_max_steps", type=int, default=2_000)
    p.add_argument("--feature_lr", type=float, default=0.002)
    p.add_argument("--opacity_lr", type=float, default=0.055)
    p.add_argument("--scaling_lr", type=float, default=0.0055)
    p.add_argument("--rotation_lr", type=float, default=0.0015)
    p.add_argument("--percent_dense", type=float, default=0.01)
    p.add_argument("--lambda_dssim", type=float, default=0.2)
    p.add_argument("--densification_interval", type=int, default=100)
    p.add_argument("--opacity_reset_interval", type=int, default=200)
    p.add_argument("--opacity_reset_until_iter", type=int, default=2_000)
    p.add_argument("--densify_from_iter", type=int, default=500)
    p.add_argument("--densify_until_iter", type=int, default=2_000)
    p.add_argument("--densify_grad_threshold", type=float, default=0.0004)
    p.add_argument("--random_background", action="store_true")
    # train.py extras
    p.add_argument("--test_iterations", nargs="+", type=int,
                   default=[500, 1000, 1500, 2000, 2500, 3000, 4000, 5000])
    p.add_argument("--save_iterations", nargs="+", type=int,
                   default=[500, 1000, 1500, 2000, 2500, 3000, 4000, 5000])
    p.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    p.add_argument("--start_checkpoint", type=str, default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init_iterations", type=int, default=2_000)
    p.add_argument("--bg_capacity", type=int, default=65536)
    p.add_argument("--backend", type=str, default="cuda", choices=["cuda", "oracle"])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on; 'cpu' runs the kernels' plain versions")
    p.add_argument("--data_parallel", type=int, default=0, metavar="D",
                   help="train data-parallel over D devices, one rank each (camera-batch "
                        "DP: each iteration consumes D cameras, gradients all-reduced). "
                        "0/1 = single-device. With --multihost, D counts the ranks of all "
                        "hosts; without it, the CLI starts D local ranks")
    p.add_argument("--multihost", action="store_true",
                   help="join a torch.distributed process group before touching the device "
                        "(rendezvous from --coordinator_address/--num_processes/--process_id, "
                        "or the env:// variables). Launch the SAME command once per rank.")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (implies --multihost)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the main stage into this dir")
    p.add_argument("--no_tensorboard", action="store_true")
    p.add_argument("--no_fg_split_log_quirk", action="store_true",
                   help="disable the reference's log-domain fg split-scale "
                        "division (grows scales); use the activated-domain shrink")
    p.add_argument("--detect_anomaly", action="store_true",
                   help="enable torch.autograd.set_detect_anomaly")
    p.add_argument("--ip", type=str, default="127.0.0.1")
    p.add_argument("--port", "--viewer_port", dest="viewer_port", type=int,
                   default=-1,
                   help="SIBR remote-viewer port; -1 disables the listener")
    return p


def main(argv=None):
    from scgaussian_tpu_torch import resolve_device
    from scgaussian_tpu_torch.config import OptimizationConfig, RasterizerConfig, TrainExtras
    from scgaussian_tpu_torch.data.scene import Scene
    from scgaussian_tpu_torch.losses import l1_loss, psnr
    from scgaussian_tpu_torch.model import io as model_io
    from scgaussian_tpu_torch.train import pipeline
    from scgaussian_tpu_torch.train.main_stage import render_model
    from scgaussian_tpu_torch.utils.logging import TrainLogger
    from scgaussian_tpu_torch.utils.profiling import trace

    args = build_parser().parse_args(argv)
    multihost = args.multihost or args.coordinator_address is not None
    dev = resolve_device(args.device)
    if multihost:
        if not args.model_path:
            raise SystemExit("--multihost requires an explicit -m/--model_path "
                             "(the random default would diverge per process)")
        if args.viewer_port >= 0:
            raise SystemExit("--port (viewer) is unsupported with --multihost")
        if args.data_parallel <= 1:
            raise SystemExit(
                "--multihost requires --data_parallel D (the process group is the only "
                "thing that spans hosts; single-device training would run "
                f"{args.num_processes or 'several'} isolated replicas)")
        # the group forms before anything touches the device
        hosts.initialize_multihost(args.coordinator_address, args.num_processes,
                                   args.process_id, device=dev)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if args.data_parallel != world:
            hosts.shutdown()
            raise SystemExit(
                f"--data_parallel {args.data_parallel} != {world} ranks: under --multihost "
                "the group must span every rank of every participating host")
        dev = hosts.local_device(dev)
        print(f"[multihost] rank {dist.get_rank()}/{world} on {dev}")
    elif args.data_parallel > 1:
        n_avail = (torch.cuda.device_count() if dev.type == "cuda" else os.cpu_count() or 1)
        if args.data_parallel > n_avail:
            raise SystemExit(f"--data_parallel {args.data_parallel} > {n_avail} available "
                             f"devices ({dev.type})")
        if args.viewer_port >= 0:
            raise SystemExit("--port (viewer) is unsupported with --data_parallel: "
                             "the ranks are separate processes")
        argv = list(argv if argv is not None else sys.argv[1:])
        if not args.model_path:  # one output directory for every rank
            import uuid

            argv += ["-m", os.path.join("./output/", str(uuid.uuid4())[:10])]
        return launch_local_ranks(argv, args.data_parallel)
    primary = hosts.is_primary()

    if not args.model_path:
        import uuid

        args.model_path = os.path.join("./output/", str(uuid.uuid4())[:10])
    os.makedirs(args.model_path, exist_ok=True)
    print(f"Optimizing {args.model_path}")

    # cfg persistence (JSON analog of the reference cfg_args, train.py:225-226)
    if primary:
        with open(os.path.join(args.model_path, "cfg_args.json"), "w") as f:
            json.dump(vars(args), f, indent=2)

    opt_cfg = OptimizationConfig(
        iterations=args.iterations,
        position_lr_init=args.position_lr_init,
        position_lr_final=args.position_lr_final,
        position_lr_delay_mult=args.position_lr_delay_mult,
        position_lr_max_steps=args.position_lr_max_steps,
        feature_lr=args.feature_lr,
        opacity_lr=args.opacity_lr,
        scaling_lr=args.scaling_lr,
        rotation_lr=args.rotation_lr,
        percent_dense=args.percent_dense,
        lambda_dssim=args.lambda_dssim,
        densification_interval=args.densification_interval,
        opacity_reset_interval=args.opacity_reset_interval,
        opacity_reset_until_iter=args.opacity_reset_until_iter,
        densify_from_iter=args.densify_from_iter,
        densify_until_iter=args.densify_until_iter,
        densify_grad_threshold=args.densify_grad_threshold,
        random_background=args.random_background,
    )
    extras = TrainExtras(
        init_iterations=args.init_iterations,
        bg_capacity=args.bg_capacity,
        dtu_dark_threshold=(15.0 if "scan110" in args.source_path else 30.0) / 255.0,
        fg_split_log_quirk=not args.no_fg_split_log_quirk,
    )

    scene = Scene(
        source_path=os.path.abspath(args.source_path),
        model_path=args.model_path,
        images=args.images,
        resolution=args.resolution,
        white_background=args.white_background,
        eval=args.eval,
        seed=args.seed,
        device=dev,
    )
    print(
        f"Scene: {scene.kind}, {len(scene.train_cameras)} train / "
        f"{len(scene.test_cameras)} test cameras, extent {scene.cameras_extent:.3f}"
    )

    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    first_iter = 0
    restored_opt = None
    if args.start_checkpoint:
        # Resume: skip init+promotion, restore the full hybrid state
        model, restored_opt, first_iter = model_io.load_checkpoint(args.start_checkpoint, dev)
        print(f"Resumed from {args.start_checkpoint} at iteration {first_iter}")
    else:
        # ---- init stage (`train.py:49-97`)
        t0 = time.time()
        model, init_result = pipeline.setup_from_matches(
            scene.bundle,
            torch.Generator(device=dev).manual_seed(args.seed),
            sh_degree=args.sh_degree,
            spatial_lr_scale=scene.cameras_extent,
            extras=extras,
        )
        print(
            f"[Init Stage] {extras.init_iterations} iters in {time.time()-t0:.1f}s, "
            f"final loss {float(init_result.final_loss):.5f}, "
            f"{model.num_ray} ray Gaussians promoted"
        )
        if primary:
            model_io.save_matchpoints(
                scene.bundle,
                init_result.best_z,
                scene.base_names,
                scene.init_point_cloud_dir(extras.init_iterations),
            )

    # ---- main stage (`train.py:99-212`)
    test_iterations = set(args.test_iterations)
    save_iterations = set(args.save_iterations) | {args.iterations}
    ckpt_iterations = set(args.checkpoint_iterations)
    raster = RasterizerConfig()
    # only process 0 writes logs and artifacts: the replicas are equal
    logger = TrainLogger(args.model_path, use_tensorboard=primary and not args.no_tensorboard,
                         enabled=primary)

    # live SIBR viewer (polled every iteration, `train.py:109-122`)
    gui = None
    if args.viewer_port >= 0:
        from scgaussian_tpu_torch.viewer.network_gui import NetworkGUI

        gui = NetworkGUI(host=args.ip, port=args.viewer_port)
        print(f"Viewer listening on {args.ip}:{gui.listener.getsockname()[1]}")

    cam0 = scene.train_cameras[0]
    pixels = cam0.width * cam0.height
    t_start = time.time()
    ema = {"loss": 0.0}
    # step time on the host clock: from the end of one callback to the loss
    # read of the next, which waits for the step's device work; and its EMA
    clock = {"last": None, "dt": None}

    first_test_iter = min(test_iterations) if test_iterations else -1
    bg = torch.tensor([1.0, 1.0, 1.0] if args.white_background else [0.0, 0.0, 0.0],
                      device=dev)

    @torch.no_grad()
    def evaluate(model, cams, name, iteration, eval_raster):
        l1s, psnrs = [], []
        for idx, c in enumerate(cams):
            out = render_model(c.camera, model, bg, backend=args.backend, raster=eval_raster)
            img = torch.clamp(out.render, 0, 1)
            gt = torch.clamp(c.gt_image(), 0, 1)
            if idx < 5:  # image panels, `train.py:252-260`
                view = c.image_name or str(idx)
                logger.images(f"{name}_view_{view}/render", img, iteration)
                if iteration == first_test_iter:
                    logger.images(f"{name}_view_{view}/ground_truth", gt, iteration)
            if c.dtumask is not None:
                m = torch.as_tensor(c.dtumask, device=dev) > 0
                l1s.append(float(torch.mean(torch.abs(img - gt) * m) / torch.mean(m.float())))
                mse = torch.sum(((img - gt) * m) ** 2) / (3 * torch.sum(m))
                psnrs.append(float(20 * torch.log10(1.0 / torch.sqrt(mse))))
            else:
                l1s.append(float(l1_loss(img, gt)))
                psnrs.append(float(psnr(img[None], gt[None])[0, 0]))
        print(
            f"\n[ITER {iteration}] Evaluating {name}: L1 {np.mean(l1s):.5f} "
            f"PSNR {np.mean(psnrs):.3f}"
        )
        return float(np.mean(l1s)), float(np.mean(psnrs))

    clock["last"] = time.perf_counter()

    def callback(iteration, model, metrics, opt_state=None, raster=raster):
        # one host sync per iteration, as in the JAX CLI
        loss = float(metrics.loss)
        dt = time.perf_counter() - clock["last"]
        clock["dt"] = dt if clock["dt"] is None else 0.9 * clock["dt"] + 0.1 * dt
        rays_per_s = pixels / clock["dt"] if clock["dt"] else 0.0
        if gui is not None:
            gui.poll(model, os.path.abspath(args.source_path), iteration,
                     opt_cfg.iterations, backend=args.backend, raster=raster)
        ema["loss"] = 0.4 * loss + 0.6 * ema["loss"]
        logger.step(iteration, float(metrics.l1), loss, dt)
        if iteration % 100 == 0 or iteration == 1:
            rec = {
                "iter": iteration,
                "loss": loss,
                "ema_loss": ema["loss"],
                "l1": float(metrics.l1),
                "match_loss": float(metrics.match_loss),
                "visible": int(metrics.num_visible),
                "rays_per_s": rays_per_s,
                "elapsed_s": time.time() - t_start,
            }
            logger.json(rec)
            print(
                f"[{iteration}] loss {ema['loss']:.5f} visible {rec['visible']} "
                f"({rays_per_s/1e6:.2f} Mrays/s)"
            )
        if iteration in test_iterations and primary:
            if scene.test_cameras:
                l1t, pt = evaluate(model, scene.test_cameras, "test", iteration, raster)
                logger.eval("test", l1t, pt, iteration)
            l1t, pt = evaluate(model, scene.train_cameras, "train", iteration, raster)
            logger.eval("train", l1t, pt, iteration)
            logger.histogram("scene/opacity_histogram", model.get_opacity(), iteration)
            logger.scalar("total_points", int(model.alive_mask().sum()), iteration)
        if iteration in save_iterations and primary:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            model_io.save_ply(
                model, os.path.join(scene.point_cloud_dir(iteration), "point_cloud.ply")
            )
        if iteration in ckpt_iterations and opt_state is not None and primary:
            print(f"\n[ITER {iteration}] Saving Checkpoint")
            model_io.save_checkpoint(
                os.path.join(args.model_path, f"chkpnt{iteration}.npz"),
                model, opt_state, iteration,
            )
        clock["last"] = time.perf_counter()

    group = None
    if multihost:
        group = dp.make_group(args.data_parallel)
        dp.broadcast_model(group, model)  # the replicas start equal
        print(f"Data-parallel training over {args.data_parallel} ranks "
              f"({args.data_parallel} cameras per iteration)")
    try:
        with trace(args.profile_dir):
            state = pipeline.run_main_stage(
                model,
                scene.bundle,
                [c.camera for c in scene.train_cameras],
                [c.gt_image() for c in scene.train_cameras],
                view_ids=[scene.view_id(c) for c in scene.train_cameras],
                stack_seed=args.seed,
                opt_cfg=opt_cfg,
                raster=raster,
                extras=extras,
                white_background=args.white_background,
                is_dtu=scene.is_dtu,
                backend=args.backend,
                cameras_extent=scene.cameras_extent,
                callback=callback,
                first_iteration=first_iter,
                opt_state=restored_opt,
                generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
                group=group,
            )
        if primary:
            model_io.save_checkpoint(
                os.path.join(args.model_path, f"chkpnt{args.iterations}.npz"),
                state.model,
                state.opt_state,
                args.iterations,
            )
    finally:
        if gui is not None:
            gui.close()
        if multihost:
            hosts.shutdown()
    logger.close()
    print("\nTraining complete.")
    return state


def _local_rank(rank: int, argv: list, port: int, world: int) -> None:
    main(argv + ["--coordinator_address", f"127.0.0.1:{port}", "--num_processes", str(world),
                 "--process_id", str(rank)])


def launch_local_ranks(argv: list, world: int) -> None:
    """`--data_parallel D` without `--multihost`: D processes of this CLI
    on this host, each joining a D-rank group over a free local port as a
    `--multihost` rank. Returns when every rank has finished; raises if
    one failed."""
    import torch.multiprocessing as mp

    port = hosts.free_port()
    print(f"Starting {world} local ranks (127.0.0.1:{port})")
    mp.start_processes(_local_rank, args=(list(argv), port, world), nprocs=world,
                       start_method="spawn")


if __name__ == "__main__":
    main()
