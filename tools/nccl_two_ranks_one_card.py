#!/usr/bin/env python3
"""Try an NCCL group of two ranks on one GPU, once, and report what NCCL says.

    python3 tools/nccl_two_ranks_one_card.py

Two spawned processes both take `cuda:0`, join an NCCL group of world size
2 over a free localhost port and all-reduce a tensor. NCCL is expected to
refuse two ranks on one device ("Duplicate GPU detected", ncclInvalidUsage);
that is why `chip_smoke.py` shares its one card between two processes over
gloo instead. Prints one JSON line per rank (what it raised, or its result)
and a last line with the outcome; the processes are joined within 120 s and
killed after. Exits 0 whatever NCCL did, once both ranks reported.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scgaussian_tpu_torch.parallel import hosts  # noqa: E402

JOIN_S = 120


def rank_main(rank: int, port: int, out_dir: str) -> None:
    report = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                                rank=rank, timeout=datetime.timedelta(seconds=60))
        x = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        report.update(ok=True, result=x.tolist())
    except Exception as e:  # the finding is what NCCL raises
        report.update(ok=False, error=f"{type(e).__name__}: {e}"[:4000])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def main() -> int:
    if not torch.cuda.is_available():
        print("nccl_two_ranks_one_card: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(rank_main, args=(hosts.free_port(), tmp), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + JOIN_S
        timed_out, exited = False, None
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    timed_out = True
                    break
        except mp.ProcessExitedException as e:  # a rank killed by NCCL itself
            exited = str(e)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        reports = []
        for r in (0, 1):
            path = os.path.join(tmp, f"rank{r}.json")
            reports.append(json.load(open(path)) if os.path.exists(path) else
                           {"rank": r, "ok": None, "error": "no report"})
    for rep in reports:
        print(json.dumps(rep), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "cards": torch.cuda.device_count(),
                      "timed_out": timed_out, "exited": exited,
                      "refused": all(rep.get("ok") is False for rep in reports)}), flush=True)
    return 0 if all(rep.get("ok") is not None for rep in reports) else 1


if __name__ == "__main__":
    sys.exit(main())
