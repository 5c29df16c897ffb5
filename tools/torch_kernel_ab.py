#!/usr/bin/env python3
"""Time variants of the port's kernels side by side on one NVIDIA GPU.

    python3 tools/torch_kernel_ab.py [--reps N] VARIANT [VARIANT ...]

Variants:
  new_fwd, new_bwd, new_seg  csrc/raster_fwd.cu, csrc/raster_bwd.cu, csrc/segsum.cu of
                          this checkout
  new_fwd@P=4,Batch=64    the same with `constexpr int kP`, `kBatch` (any
                          `constexpr int k<Name>` of the source or of
                          csrc/raster_common.cuh) set
  parent_fwd, parent_bwd, parent_seg
                          tmp/parent_csrc/{raster_fwd,raster_bwd,segsum}.cu (with
                          raster_common.cuh where the parent has it): another
                          commit's sources, unpacked there (git show
                          <commit>:<path>); parent_seg must have the keys-form
                          interface of the first, searching segsum.cu
  <dir>_fwd, <dir>_bwd, <dir>_seg
                          tmp/<dir>/ sources of this checkout's interfaces
                          (with tmp/<dir>/raster_common.cuh; `@` works too)
  abl:bwd_noreduce        the first backward (per-pixel threads) summing each
                          pixel's terms into a register instead of reducing them
  abl:bwd_nolive          the first backward with the live chain never taken
  abl:fwd_constexp        the first forward (per-pixel threads) with expf(power) replaced by 0.5
  abl:fwd_fastexp         the first forward with __expf for expf
  abl:seg_bounds          the first segsum.cu with each run's bounds read from the
                          bins' Gaussian-major starts instead of searched for
  abl:seg_gather          this checkout's segsum.cu gathering each Gaussian-major
                          slot's row from the tiles' order through the inverse
                          permutation (the route's other design)
  lib:reorder             the two-step route's reorder: index_copy_ of the
                          per-entry rows by the int64 permutation
  lib:index_add_gauss     torch.zeros(n, 10).index_add_(0, gauss_ids, per-entry rows):
                          the whole route in one library call
  lib:index_add_sorted    index_add_ of the Gaussian-major rows by their keys

What each variant times (its "entry"): a forward `raster_fwd`; a backward
`raster_bwd` and `raster_bwd_entries`, and for this checkout's interface
`raster_bwd_entries_gmaj` (rows stored at their Gaussian-major slots); a
parent segment sum `segsum` (on the Gaussian-major rows) and
`two_step_route` (reorder, then it); this checkout's segment sum
`segsum_keys` (searchsorted, then the kernel), `route` (the main path's
launch: contiguous runs of the Gaussian-major rows into [n, 12]),
and with the checkout's backward kernel `route_total` (raster_bwd_entries
storing Gaussian-major, then `route`); `abl:seg_gather` times
`route_gather` (the rows left in the tiles' order and gathered through the
inverse permutation) and `route_gather_total` (the backward storing each
entry's row at its own slot, then `route_gather`).

Each built variant is compiled with nvcc (the flags of renderer/_build.py)
under tmp/kernel_ab/. The script makes chip_smoke.py's 1080p main view and
the 4K pipeline's view 0 (setup_from_matches and 12 main-stage iterations),
with the per-entry backward rows of this checkout's kernel, holds every
`new_*` variant against the plain versions there (and `abl:seg_gather`
against this checkout's route, bitwise), and times every variant
at both, in turns (the list, then the list reversed): CUDA events around
one call (median of --reps after a warm-up, host enqueue included) and the
profiler's device time of the kernels the call launched (per call, over
--reps calls). One JSON line per result; a failed build is reported and its
variant skipped. The ablations are for timing only.
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

# text edits, for the ablations, of the first sources (in tmp/parent_csrc/; their
# backward and forward had a thread per pixel, their segment sum searched for its
# runs) and of this checkout's segsum.cu (NEW_BASED)
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
    # `keys` carries the Gaussian-major starts [n + 1]
    "seg_bounds": [("const int hi = lower_bound(keys, e, g + 1);",
                    "const int hi = keys[min(g + 1, n)];"),
                   ("if (lane == 0) lo = lower_bound(keys, e, g0);",
                    "if (lane == 0) lo = keys[g0];")],
    # slot s of the 10-column route reads row src[s]: the piece's src entries
    # are copied into shared memory first
    "seg_gather": [
        ("              const float* __restrict__ vals,",
         "              const int32_t* __restrict__ src,\n"
         "              const float* __restrict__ vals,"),
        ("  float* buf = s_rows[warp];\n",
         "  float* buf = s_rows[warp];\n"
         "  __shared__ int32_t s_src[kWarps][kPieceRows];\n"
         "  int32_t* sbuf = s_src[warp];\n"),
        ("    // 1. the piece's rows, lanes on consecutive words\n",
         "    for (int r = lane; r < rows; r += 32)\n"
         "      __pipeline_memcpy_async(sbuf + r, src + p0 + r, 4);\n"
         "    __pipeline_commit();\n"
         "    __pipeline_wait_prior(0);\n"
         "    __syncwarp();\n"
         "    // 1. the piece's rows, lanes on consecutive words\n"),
        ("vals + static_cast<int64_t>(p0) * kRouteCols + 2 * f,",
         "vals + static_cast<int64_t>(sbuf[f / kPairs]) * kRouteCols + 2 * (f % kPairs),"),
        ('extern "C" int segsum(const void* starts, const void* vals,',
         'extern "C" int segsum(const void* starts, const void* src, const void* vals,'),
        ("<<<blocks, kThreads, 0, st>>>(s, v,",
         "<<<blocks, kThreads, 0, st>>>(s, static_cast<const int32_t*>(src), v,"),
    ],
}
NEW_BASED = {"seg_gather"}
SOURCES = {"fwd": "raster_fwd.cu", "bwd": "raster_bwd.cu", "seg": "segsum.cu"}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def variant_source(v: str):
    """(kind, origin, source text, header text or None) of variant `v`."""
    if v.startswith("abl:"):
        kind, origin = v[4:7], "new" if v[4:] in NEW_BASED else "parent"
        src = ((NEW if origin == "new" else PARENT) / SOURCES[kind]).read_text()
        for old, new in ABLATIONS[v[4:]]:
            if old not in src:
                raise ValueError(f"{v}: the {origin} source lacks the text to edit")
            src = src.replace(old, new)
        return kind, origin, src, None
    base, _, opt = v.partition("@")
    origin, kind = base.rsplit("_", 1)
    if origin == "parent":
        hdr = PARENT / "raster_common.cuh"
        return (kind, origin, (PARENT / SOURCES[kind]).read_text(),
                hdr.read_text() if kind != "seg" and hdr.exists() else None)
    src_dir = NEW if origin == "new" else ROOT / "tmp" / origin
    hdr = src_dir / "raster_common.cuh"
    texts = [(src_dir / SOURCES[kind]).read_text(), hdr.read_text() if hdr.exists() else ""]
    for setting in filter(None, opt.split(",")):
        key, val = setting.split("=")
        decl = f"constexpr int k{key} = "
        k = next(k for k, text in enumerate(texts) if decl in text)
        i = texts[k].index(decl)
        texts[k] = texts[k][:i] + decl + val + texts[k][texts[k].index(";", i):]
    return kind, origin, *texts


def build(v: str):
    kind, origin, src, hdr = variant_source(v)
    d = OUT / v.replace(":", "_").replace("@", "_").replace("=", "").replace(",", "_")
    d.mkdir(parents=True, exist_ok=True)
    cu = d / SOURCES[kind]
    cu.write_text(src)
    if hdr is not None:
        (d / "raster_common.cuh").write_text(hdr)
    so = d / "variant.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    log = (proc.stdout + proc.stderr).splitlines()
    ptxas = [ln.strip() for ln in log if "registers" in ln or "stack" in ln]
    # this checkout's interfaces: the per-entry epilogue takes the rows'
    # destinations; the segment sum takes run starts ("gather": and src)
    if kind == "bwd":
        current = "entry_dst" in src
    else:
        current = "gather" if "const void* src" in src else origin != "parent"
    return v, kind, current, (so if proc.returncode == 0 else None), ptxas, "\n".join(log[-40:])


def bind(kind: str, current: bool, so: Path):
    lib = ctypes.CDLL(str(so))
    fns = {}
    if kind == "seg":
        f = lib.segsum
        if current:  # starts, (src,) vals, n, c, ldo, out, stream
            pointers = 3 if current == "gather" else 2
            f.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        else:  # the first kernel's keys form: keys, vals, e, n, c, out, stream
            f.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        f.restype = ctypes.c_int
        fns["segsum"] = f
        queries = ((("segsum_occupancy", (10,), "segsum@c=10"),
                    ("segsum_occupancy", (0,), "segsum@c=other")) if current else
                   (("segsum_occupancy", (), "segsum"),))
    else:
        names = ("raster_fwd",) if kind == "fwd" else ("raster_bwd", "raster_bwd_entries")
        for name in names:
            f = getattr(lib, name)
            pointers = 6 if kind == "fwd" else 8 if name == "raster_bwd_entries" and current else 7
            f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * pointers
            f.restype = ctypes.c_int
            fns[name] = f
        queries = (("raster_fwd_occupancy", (), "raster_fwd"),
                   ("raster_bwd_occupancy", (0,), "raster_bwd"),
                   ("raster_bwd_occupancy", (1,), "raster_bwd_entries"))
    blocks = {}
    for query, args, key in queries:
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


def call_bwd(f, s, per_entry: bool, current: bool = False, gmaj: bool = False):
    """As raster._raster_bwd_cuda: a zeroed output, then the launch; with
    `current`, the per-entry epilogue's destinations: bins.order with
    `gmaj` (the main path's), else each entry's own row."""
    bins, attrs = s["bins"], s["attrs"]
    shape = (bins.num_entries, raster.NUM_GRADS) if per_entry else (attrs.shape[0],
                                                                     raster.ATTR_WIDTH)
    d = torch.zeros(shape, dtype=torch.float32, device=attrs.device)
    dst = ((bins.order if gmaj else s["identity"]).data_ptr(),) if per_entry and current else ()
    err = f(bins.tile_starts.data_ptr(), bins.gauss_ids.data_ptr(), attrs.data_ptr(),
            s["bg"].data_ptr(), s["W"], s["H"], s["T"].data_ptr(), s["last"].data_ptr(),
            *(c.data_ptr() for c in s["cots"]), d.data_ptr(), *dst,
            torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, f"launch failed: CUDA error {err}")
    return d


def call_seg(f, current: bool, runs, vals, n: int, src=None, ldo: int = 10):
    """A segment sum launch: the first kernel's keys form (`runs` the sorted keys) or
    this checkout's (`runs` the starts [n + 1], rows contiguous, or through
    `src` for the gathering variant, [n, ldo] out)."""
    stream = torch.cuda.current_stream().cuda_stream
    if current:
        out = torch.empty(n, ldo, device=vals.device)
        gather = () if src is None else (src.data_ptr(),)
        err = f(runs.data_ptr(), *gather, vals.data_ptr(), n, vals.shape[1], ldo,
                out.data_ptr(), stream)
    else:
        out = torch.empty(n, vals.shape[1], device=vals.device)
        err = f(runs.data_ptr(), vals.data_ptr(), runs.shape[0], n, vals.shape[1],
                out.data_ptr(), stream)
    cs.check(err == 0, f"launch failed: CUDA error {err}")
    return out


def add_route_inputs(s: dict) -> None:
    """The route's inputs at a scene: the per-entry rows of this checkout's
    backward kernel in Gaussian-major order and in the tiles' order, the
    sort's permutation, the identity (each entry's own row) and the
    inverse permutation (Gaussian-major slot -> entry, int32) for the
    gathering design."""
    bins = s["bins"]
    args = (bins, s["attrs"], s["bg"], s["T"], s["last"], *s["cots"], s["W"], s["H"])
    s["gmaj"] = raster.raster_bwd_entries(*args)
    s["entries"] = s["gmaj"][bins.order]
    s["order"] = bins.order
    s["identity"] = torch.arange(bins.num_entries, device=bins.order.device)
    s["src"] = torch.empty(bins.num_entries, dtype=torch.int32, device=bins.order.device)
    s["src"][bins.order] = s["identity"].to(torch.int32)
    s["n"] = s["attrs"].shape[0]


def jobs_for(v: str, kind: str, current: bool, f: dict, s: dict) -> dict:
    """entry -> callable: what variant `v` times at scene `s`."""
    bins, n = s["bins"], s["n"]
    if v.startswith("lib:"):
        zeros = lambda: torch.zeros(n, raster.NUM_GRADS, device=s["entries"].device)  # noqa: E731
        return {v[4:]: {
            "reorder": lambda: torch.empty_like(s["entries"]).index_copy_(0, s["order"],
                                                                        s["entries"]),
            "index_add_gauss": lambda: zeros().index_add_(0, bins.gauss_ids, s["entries"]),
            "index_add_sorted": lambda: zeros().index_add_(0, bins.gmaj_ids, s["gmaj"]),
        }[v[4:]]}
    if kind == "fwd":
        return {"raster_fwd": lambda: call_fwd(f["raster_fwd"], s)}
    if kind == "bwd":
        jobs = {"raster_bwd": lambda: call_bwd(f["raster_bwd"], s, False),
                "raster_bwd_entries": lambda: call_bwd(f["raster_bwd_entries"], s, True, current)}
        if current:
            jobs["raster_bwd_entries_gmaj"] = lambda: call_bwd(f["raster_bwd_entries"], s, True,
                                                               True, gmaj=True)
        return jobs
    seg = f["segsum"]
    if not current:
        runs = bins.gmaj_starts if v == "abl:seg_bounds" else bins.gmaj_ids
        return {"segsum": lambda: call_seg(seg, False, runs, s["gmaj"], n),
                "two_step_route": lambda: call_seg(
                    seg, False, runs,
                    torch.empty_like(s["entries"]).index_copy_(0, s["order"], s["entries"]), n)}
    args = (bins, s["attrs"], s["bg"], s["T"], s["last"], *s["cots"], s["W"], s["H"])
    if current == "gather":
        return {
            "route_gather": lambda: call_seg(seg, True, bins.gmaj_starts, s["entries"], n,
                                             s["src"], 12),
            "route_gather_total": lambda: call_seg(
                seg, True, bins.gmaj_starts,
                raster._raster_bwd_cuda(*args, entry_dst=s["identity"]), n, s["src"], 12),
        }

    def keys_form():
        bounds = torch.arange(n + 1, dtype=torch.int32, device=bins.gmaj_ids.device)
        starts = torch.searchsorted(bins.gmaj_ids, bounds, out_int32=True)
        return call_seg(seg, True, starts, s["gmaj"], n)

    return {
        "segsum_keys": keys_form,
        "route": lambda: call_seg(seg, True, bins.gmaj_starts, s["gmaj"], n, ldo=12),
        "route_total": lambda: call_seg(seg, True, bins.gmaj_starts,
                                        raster.raster_bwd_entries(*args), n, ldo=12),
    }


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


def check_new(fns: dict, name: str, s: dict) -> None:
    """Every new_* variant against the plain versions at scene `s`: forward
    alpha, T and last contributor; backward per column group, two per-entry
    launches bitwise equal, the Gaussian-major rows bitwise the reordered
    tile-order rows; the segment sum's route and keys forms per column
    within 1e-5 * (max|plain| + 1), two route launches bitwise equal; the
    gathering variant bitwise this checkout's route."""
    news = {v: fns[v] for v in fns if v.startswith("new") or v == "abl:seg_gather"}
    bins, n = s["bins"], s["n"]
    args = (bins, s["attrs"], s["bg"], s["T"], s["last"], *s["cots"], s["W"], s["H"])
    if any(kind in ("fwd", "bwd") for kind, _, _ in news.values()):
        fwd_stats, bwd_stats = {}, {}
        p_fwd = raster.raster_fwd_plain(bins, s["attrs"], s["bg"], s["W"], s["H"],
                                        stats=fwd_stats)
        p_bwd = raster.raster_bwd_plain(*args, stats=bwd_stats)
        p_ent = raster.raster_bwd_entries_plain(*args)
        emit(scene=name, plain_fwd_stats=fwd_stats, plain_bwd_stats=bwd_stats)
    for v, (kind, current, f) in news.items():
        if kind == "fwd":
            k = call_fwd(f["raster_fwd"], s)
            torch.cuda.synchronize()
            emit(check=v, scene=name, image_err=float((k[0] - p_fwd[0]).abs().max()),
                 alpha_err=float((k[2] - p_fwd[2]).abs().max()),
                 T_err=float((k[3] - p_fwd[3]).abs().max()),
                 last_mismatch=int((k[4] != p_fwd[4]).sum()))
        elif kind == "bwd":
            a = call_bwd(f["raster_bwd"], s, False)
            e1 = call_bwd(f["raster_bwd_entries"], s, True, current)
            e2 = call_bwd(f["raster_bwd_entries"], s, True, current)
            g = call_bwd(f["raster_bwd_entries"], s, True, current, gmaj=True)
            torch.cuda.synchronize()
            p_own = p_ent[bins.order]  # the plain rows are in Gaussian-major order
            emit(check=v, scene=name, atomic=cs.group_errors(a, p_bwd),
                 entries=cs.group_errors(e1, p_own), entries_bitwise=bool(torch.equal(e1, e2)),
                 gmaj_bitwise_reordered=bool(torch.equal(g, raster.gaussian_major(bins, e1))),
                 atomic_pad_zero=float(a[:, 10:].abs().max()) == 0.0)
        elif current == "gather":
            gather = jobs_for(v, kind, current, f, s)["route_gather"]()
            route = raster.route_by_sort(bins, s["gmaj"], n)
            torch.cuda.synchronize()
            emit(check=v, scene=name, gather_bitwise_route=bool(torch.equal(gather, route)))
        else:
            jobs = jobs_for(v, kind, current, f, s)
            r1, r2, keys = (jobs[k]() for k in ("route", "route", "segsum_keys"))
            p_route = raster.segsum_runs_plain(bins.gmaj_starts, s["gmaj"], n, 12)
            p_keys = raster.segsum_plain(bins.gmaj_ids, s["gmaj"], n)
            torch.cuda.synchronize()
            err = {}
            for form, got, want in (("route", r1, p_route), ("keys", keys, p_keys)):
                col = (got - want).abs().amax(0) / (want.abs().amax(0) + 1)
                err[f"{form}_max_rel_err"] = float(col.max())
            emit(check=v, scene=name, route_bitwise=bool(torch.equal(r1, r2)),
                 route_pad_zero=float(r1[:, 10:].abs().max()) == 0.0, **err,
                 longest_run=int((bins.gmaj_starts[1:] - bins.gmaj_starts[:-1]).max()))


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
    to_build = [v for v in opts.variants if not v.startswith("lib:")]
    with ThreadPoolExecutor(max(len(to_build), 1)) as pool:
        built = list(pool.map(build, to_build))
    fns = {v: ("lib", True, {}) for v in opts.variants if v.startswith("lib:")}
    for v, kind, current, so, ptxas, log in built:
        if so is None:
            emit(variant=v, nvcc_failed=log)
            continue
        f, blocks = bind(kind, current, so)
        fns[v] = (kind, current, f)
        emit(variant=v, ptxas=ptxas, resident_blocks_per_sm=blocks)
    variants = [v for v in opts.variants if v in fns]
    scenes = {"main_path_view0": main_view(dev)}
    torch.cuda.empty_cache()
    scenes["pipeline_4k_view0"] = pipeline_view(dev)
    with torch.no_grad():
        for name, s in scenes.items():
            add_route_inputs(s)
            emit(scene=name, entries=s["bins"].num_entries, gaussians=s["n"])
            check_new({v: fns[v] for v in variants}, name, s)
            for v in variants + variants[::-1]:
                kind, current, f = fns[v]
                for entry, fn in jobs_for(v, kind, current, f, s).items():
                    emit(time=v, entry=entry, scene=name,
                         device_ms=cs.kernel_device_ms(fn, reps=opts.reps),
                         **cs.cuda_times(fn, reps=opts.reps))
    emit(card_state=cs.nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
