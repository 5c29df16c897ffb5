#!/usr/bin/env python3
"""Time variants of the port's compositing kernels side by side on one
NVIDIA GPU.

    python3 tools/torch_kernel_ab.py [--reps N] VARIANT [VARIANT ...]

Variants:
  new_fwd, new_bwd        csrc/raster_fwd.cu, csrc/raster_bwd.cu of this checkout
  new_fwd@P=4,Batch=64    the same with `constexpr int kP`, `kBatch` (any
                          `constexpr int k<Name>` of the source or of
                          csrc/raster_common.cuh) set
  parent_fwd, parent_bwd  tmp/parent_csrc/raster_{fwd,bwd}.cu: another commit's
                          sources, unpacked there (git show <commit>:<path>)
  <dir>_fwd, <dir>_bwd    tmp/<dir>/raster_{fwd,bwd}.cu with tmp/<dir>/raster_common.cuh
                          (another design of the same interface; `@` works too)
  abl:bwd_noreduce        the parent's backward (per-pixel threads) summing each
                          pixel's terms into a register instead of reducing them
  abl:bwd_nolive          the parent's backward with the live chain never taken
  abl:fwd_constexp        the parent's forward with expf(power) replaced by 0.5
  abl:fwd_fastexp         the parent's forward with __expf for expf

Each variant is built with nvcc (the flags of renderer/_build.py) under
tmp/kernel_ab/. The script makes chip_smoke.py's 1080p main view and the 4K
pipeline's view 0 (setup_from_matches and 12 main-stage iterations), holds
every `new_*` variant against the plain versions there, and times every
variant at both with CUDA events (median of --reps after a warm-up), in turns:
the list, then the list reversed. One JSON line per result; a failed build
is reported and its variant skipped. The ablations are for timing only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from scgaussian_tpu_torch.config import OptimizationConfig, TrainExtras  # noqa: E402
from scgaussian_tpu_torch.model.gaussians import model_from_numpy  # noqa: E402
from scgaussian_tpu_torch.model.matches import init_zvals  # noqa: E402
from scgaussian_tpu_torch.renderer import _build, raster  # noqa: E402
from scgaussian_tpu_torch.renderer.binning import bin_gaussians  # noqa: E402
from scgaussian_tpu_torch.train.pipeline import run_main_stage, setup_from_matches  # noqa: E402

PARENT = ROOT / "tmp" / "parent_csrc"
NEW = ROOT / "scgaussian_tpu_torch" / "csrc"
OUT = ROOT / "tmp" / "kernel_ab"

# text edits of the parent sources (the per-pixel-thread kernels) for the ablations
_BWD_REDUCE = """      if (!__any_sync(0xffffffffu, contrib)) continue;
#pragma unroll
      for (int k = 0; k < kGrads; ++k) {
        const float s = warp_sum(contrib ? v[k] : 0.0f);
        if (lane == 0) {
          if constexpr (kPerEntry) {
            s_grad[warp][k][j] = s;  // this warp's own slot
          } else {
            atomicAdd(&s_grad[0][k][j], s);
          }
        }
      }"""
_BWD_REGISTER = """      if (contrib) {
#pragma unroll
        for (int k = 0; k < kGrads; ++k) acc += v[k];
      }"""
_BWD_END = """          if (s != 0.0f) atomicAdd(dst + k, s);
        }
      }
    }
  }
}"""
_LIVE = "          if (alpha >= kAlphaMin) {\n            contrib = true;"
ABLATIONS = {
    "bwd_noreduce": [(_BWD_REDUCE, _BWD_REGISTER),
                     ("  float T = 1.0f, tail = 0.0f;", "  float T = 1.0f, tail = 0.0f, acc = 0.0f;"),
                     (_BWD_END, _BWD_END[:-2] + "\n  if (acc == 1.2345e-30f) d_out[0] = acc;\n}")],
    # `height < 0` is never true, and the compiler cannot know it
    "bwd_nolive": [(_LIVE, _LIVE.replace("kAlphaMin)", "kAlphaMin && height < 0)"))],
    "fwd_constexp": [("expf(power)", "0.5f")],
    "fwd_fastexp": [("expf(power)", "__expf(power)")],
}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def variant_source(v: str):
    """(kind, source text, header text or None) of variant `v`."""
    if v.startswith("abl:"):
        kind = v[4:7]
        src = (PARENT / f"raster_{kind}.cu").read_text()
        for old, new in ABLATIONS[v[4:]]:
            if old not in src:
                raise ValueError(f"{v}: the parent source lacks the text to edit")
            src = src.replace(old, new)
        return kind, src, None
    base, _, opt = v.partition("@")
    origin, kind = base.rsplit("_", 1)
    if origin == "parent":
        return kind, (PARENT / f"raster_{kind}.cu").read_text(), None
    src_dir = NEW if origin == "new" else ROOT / "tmp" / origin
    texts = [(src_dir / f"raster_{kind}.cu").read_text(),
             (src_dir / "raster_common.cuh").read_text()]
    for setting in filter(None, opt.split(",")):
        key, val = setting.split("=")
        decl = f"constexpr int k{key} = "
        k = next(k for k, text in enumerate(texts) if decl in text)
        i = texts[k].index(decl)
        texts[k] = texts[k][:i] + decl + val + texts[k][texts[k].index(";", i):]
    return kind, *texts


def build(v: str):
    kind, src, hdr = variant_source(v)
    d = OUT / v.replace(":", "_").replace("@", "_").replace("=", "").replace(",", "_")
    d.mkdir(parents=True, exist_ok=True)
    cu = d / f"raster_{kind}.cu"
    cu.write_text(src)
    if hdr is not None:
        (d / "raster_common.cuh").write_text(hdr)
    so = d / "variant.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    log = (proc.stdout + proc.stderr).splitlines()
    ptxas = [ln.strip() for ln in log if "registers" in ln or "stack" in ln]
    return v, kind, (so if proc.returncode == 0 else None), ptxas, "\n".join(log[-40:])


def bind(kind: str, so: Path) -> dict:
    lib = ctypes.CDLL(str(so))
    names = ("raster_fwd",) if kind == "fwd" else ("raster_bwd", "raster_bwd_entries")
    fns = {}
    for name in names:
        f = getattr(lib, name)
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * (
            6 if kind == "fwd" else 7)
        f.restype = ctypes.c_int
        fns[name] = f
    blocks = {}
    for query, args, key in (("raster_fwd_occupancy", (), "raster_fwd"),
                             ("raster_bwd_occupancy", (0,), "raster_bwd"),
                             ("raster_bwd_occupancy", (1,), "raster_bwd_entries")):
        if hasattr(lib, query):
            fn = getattr(lib, query)
            fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            n = ctypes.c_int(0)
            if fn(*args, ctypes.byref(n)) == 0:
                blocks[key] = n.value
    return fns, blocks


def call_fwd(f, s):
    W, H, dev = s["W"], s["H"], s["attrs"].device
    f32 = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty(3, H, W, **f32), torch.empty(H, W, **f32), torch.empty(H, W, **f32),
            torch.empty(H, W, **f32), torch.empty(H, W, dtype=torch.int32, device=dev))
    err = f(s["bins"].tile_starts.data_ptr(), s["bins"].gauss_ids.data_ptr(),
            s["attrs"].data_ptr(), s["bg"].data_ptr(), W, H, *(o.data_ptr() for o in outs),
            torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, f"launch failed: CUDA error {err}")
    return outs


def call_bwd(f, s, per_entry: bool):
    """As raster._raster_bwd_cuda: a zeroed output, then the launch."""
    bins, attrs = s["bins"], s["attrs"]
    shape = (bins.num_entries, raster.NUM_GRADS) if per_entry else (attrs.shape[0],
                                                                     raster.ATTR_WIDTH)
    d = torch.zeros(shape, dtype=torch.float32, device=attrs.device)
    err = f(bins.tile_starts.data_ptr(), bins.gauss_ids.data_ptr(), attrs.data_ptr(),
            s["bg"].data_ptr(), s["W"], s["H"], s["T"].data_ptr(), s["last"].data_ptr(),
            *(c.data_ptr() for c in s["cots"]), d.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, f"launch failed: CUDA error {err}")
    return d


def scene_from_proj(proj, W, H) -> dict:
    bins = bin_gaussians(proj, W, H)
    attrs = raster.pack_attrs(proj)
    bg = torch.tensor([0.1, 0.2, 0.3], device=attrs.device)
    _, _, _, T, last = raster.raster_fwd_plain(bins, attrs, bg, W, H)
    return dict(bins=bins, attrs=attrs, bg=bg, T=T, last=last, W=W, H=H,
                cots=cs.random_cotangents(W, H, 1, attrs.device))


def main_view(dev) -> dict:
    """chip_smoke.py's main path, view 0: the 106,384-slot model at 1080p."""
    W, H, _ = cs.FULL
    model = model_from_numpy(cs.hybrid_leaves(*cs.HYBRID, seed=7), 3, device=dev)
    cam = cs.view_cameras(W, H, cs.VIEWS, dev)[0]
    with torch.no_grad():
        return scene_from_proj(cs.project_model(cam, model), W, H)


def pipeline_view(dev) -> dict:
    """chip_smoke.py's 4K pipeline after its 12 main-stage iterations, view 0."""
    W, H = cs.PIPE_SIZE
    gt = model_from_numpy(cs.hybrid_leaves(*cs.PIPE_GT, seed=11, surface=True), 3, device=dev)
    cams = cs.view_cameras(W, H, cs.TRAIN_VIEWS, dev)
    bundle, gts = cs.match_bundle_for(gt, cams, seed=12, matches=cs.PIPE_MATCHES)
    del gt
    extras = TrainExtras(bg_capacity=cs.PIPE_BG_CAPACITY)
    cfg = OptimizationConfig(**cs.PIPE_OPT)
    extent = cs.nerfpp_radius(cams)
    z0 = init_zvals(bundle, torch.Generator(device=dev).manual_seed(13))
    model, _ = setup_from_matches(bundle, None, 3, extent, extras=extras,
                                  init_iterations=cs.PIPE_INIT_ITERS, z0=z0)
    state = run_main_stage(model, bundle, cams, gts, list(range(cs.TRAIN_VIEWS)), stack_seed=14,
                           opt_cfg=cfg, extras=extras, cameras_extent=extent,
                           iterations=cs.PIPE_STEPS,
                           generator=torch.Generator(device=dev).manual_seed(15))
    with torch.no_grad():
        return scene_from_proj(cs.project_model(cams[0], state.model), W, H)


def check_new(fns: dict, scenes: dict) -> None:
    """Every new_* variant against the plain versions: forward alpha, T and
    last contributor, backward per column group, two per-entry launches."""
    for name, s in scenes.items():
        fwd_stats, bwd_stats = {}, {}
        p_fwd = raster.raster_fwd_plain(s["bins"], s["attrs"], s["bg"], s["W"], s["H"],
                                        stats=fwd_stats)
        args = (s["bins"], s["attrs"], s["bg"], s["T"], s["last"], *s["cots"], s["W"], s["H"])
        p_bwd = raster.raster_bwd_plain(*args, stats=bwd_stats)
        p_ent = raster.raster_bwd_entries_plain(*args)
        emit(scene=name, entries=s["bins"].num_entries, gaussians=s["attrs"].shape[0],
             plain_fwd_stats=fwd_stats, plain_bwd_stats=bwd_stats)
        for v, (kind, f) in fns.items():
            if not v.startswith("new"):
                continue
            if kind == "fwd":
                k = call_fwd(f["raster_fwd"], s)
                torch.cuda.synchronize()
                emit(check=v, scene=name, image_err=float((k[0] - p_fwd[0]).abs().max()),
                     alpha_err=float((k[2] - p_fwd[2]).abs().max()),
                     T_err=float((k[3] - p_fwd[3]).abs().max()),
                     last_mismatch=int((k[4] != p_fwd[4]).sum()))
            else:
                a = call_bwd(f["raster_bwd"], s, False)
                e1 = call_bwd(f["raster_bwd_entries"], s, True)
                e2 = call_bwd(f["raster_bwd_entries"], s, True)
                torch.cuda.synchronize()
                emit(check=v, scene=name, atomic=cs.group_errors(a, p_bwd),
                     entries=cs.group_errors(e1, p_ent), entries_bitwise=bool(torch.equal(e1, e2)),
                     atomic_pad_zero=float(a[:, 10:].abs().max()) == 0.0)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("variants", nargs="+")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    emit(card=cs.nvidia_smi("name,power.limit"))
    with ThreadPoolExecutor(len(opts.variants)) as pool:
        built = list(pool.map(build, opts.variants))
    fns = {}
    for v, kind, so, ptxas, log in built:
        if so is None:
            emit(variant=v, nvcc_failed=log)
            continue
        fns[v], blocks = bind(kind, so)
        fns[v] = (kind, fns[v])
        emit(variant=v, ptxas=ptxas, resident_blocks_per_sm=blocks)
    variants = [v for v in opts.variants if v in fns]
    scenes = {"main_path_view0": main_view(dev)}
    torch.cuda.empty_cache()
    scenes["pipeline_4k_view0"] = pipeline_view(dev)
    with torch.no_grad():
        check_new(fns, scenes)
        for name, s in scenes.items():
            for v in variants + variants[::-1]:
                kind, f = fns[v]
                jobs = ({"raster_fwd": lambda: call_fwd(f["raster_fwd"], s)} if kind == "fwd" else
                        {"raster_bwd": lambda: call_bwd(f["raster_bwd"], s, False),
                         "raster_bwd_entries": lambda: call_bwd(f["raster_bwd_entries"], s, True)})
                for entry, fn in jobs.items():
                    emit(time=v, entry=entry, scene=name, **cs.cuda_times(fn, reps=opts.reps))
    emit(card_state=cs.nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
