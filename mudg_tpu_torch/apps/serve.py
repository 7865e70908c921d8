"""Serving daemon: warm-model multi-request inference over a spool directory
(port of `mudg_tpu/apps/serve.py`).

Production counterpart of one-shot render_infer: the model is loaded, cast
and its kernel weights packed ONCE, then requests stream through with no
reload (the reference re-launches virtual_pose_render.py per scene, paying
the model load every time).

Protocol (filesystem spool — works on any shared filesystem, no server deps):
  * a request is a JSON file dropped into --spool:
        {"items": "<item-list path>", "out": "<output dir>",
         "prompt"?: str, "seed"?: int, "max_windows"?: int,
         "task_serial"?: bool}
  * requests are processed oldest-first; while one is in flight it is renamed
    to <name>.active (also makes concurrent daemons on a shared spool safe);
  * on success it becomes <name>.done holding {'windows', 'seconds'};
    on failure <name>.err holding the traceback. Outputs are written exactly
    like render_infer (per-task frames, depth .npy, compare mp4s).

Model/sampler flags (preset, ckpt, steps, size, dtype, ...) are fixed for
the daemon's lifetime — per-request knobs are only
prompt/seed/items/out/max_windows/task_serial.

Under torchrun with --seq_parallel every rank samples each clip
(`parallel/sp.py`): rank 0 alone polls and claims the spool's requests and
broadcasts each to the other ranks, and rank 0 alone writes the outputs and
the .done/.err files, so the ranks never race on the spool.

Usage:
    python -m mudg_tpu_torch serve --spool requests/ --preset mdm512 --ckpt m.ckpt [--device cpu]
    torchrun --nproc_per_node N -m mudg_tpu_torch serve --seq_parallel --spool requests/ ...
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from .render_infer import (DTYPES, TASKS, add_quantize_args, build_server, idle_rank,
                           render_items)


def process_request(req, mdm, sample_fn, tokenizer, *, video_length,
                    resolution, fps, default_prompt, write=True):
    import torch

    from ..data.waymo import read_items

    dev = next(mdm.parameters()).device
    items = read_items(req["items"])
    prompt = req.get("prompt", default_prompt)
    tokens = torch.as_tensor(tokenizer([prompt] * len(TASKS)), device=dev).long()
    null_tokens = torch.as_tensor(tokenizer([""])[0], device=dev).long()
    return render_items(
        mdm, sample_fn, items, req["out"],
        tokens=tokens, null_tokens=null_tokens, video_length=video_length,
        resolution=resolution, task_serial=bool(req.get("task_serial")),
        fps=fps, max_windows=req.get("max_windows"),
        seed=int(req.get("seed", 123)), write=write,
    )


def parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--spool", required=True, help="request spool directory")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--bpe", default=None)
    p.add_argument("--preset", default="mdm512")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--video_length", type=int, default=16)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=7.5)
    p.add_argument("--cfg_img", type=float, default=None)
    p.add_argument("--multiple_cond_cfg", action="store_true")
    p.add_argument("--guidance_rescale", type=float, default=0.7)
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--timestep_spacing", default="uniform_trailing")
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--prompt", default="A photo a of driving scene.")
    p.add_argument("--dtype", default="bf16", choices=DTYPES)
    add_quantize_args(p)
    p.add_argument("--seq_parallel", action="store_true",
                   help="shard each clip's sampling over the processes torchrun runs "
                        "(ignored on one)")
    p.add_argument("--base_scale", type=float, default=None)
    p.add_argument("--sampler", default="ddim", choices=("ddim", "dpmpp"))
    p.add_argument("--poll", type=float, default=2.0,
                   help="spool scan interval (seconds)")
    p.add_argument("--max_requests", type=int, default=None,
                   help="exit after N requests (tests / batch drains)")
    p.add_argument("--exit_when_empty", action="store_true",
                   help="exit once the spool is empty instead of polling")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if idle_rank(args.seq_parallel):
        return 0
    mdm, sample_fn, tokenizer = build_server(args)
    return _serve(args, mdm, sample_fn, tokenizer)


def _claim(args, n_done):
    """Rank 0's turn at the spool, oldest request first: ("req", name,
    request, None), or ("req", name, None, traceback) when its file does not
    read; ("wait",) when the spool is empty or a concurrent daemon took the
    request (the rename to .active claims it atomically); ("stop",) when
    the daemon ends."""
    pending = sorted((f for f in os.listdir(args.spool) if f.endswith(".json")),
                     key=lambda f: os.path.getmtime(os.path.join(args.spool, f)))
    if not pending:
        if args.exit_when_empty or (args.max_requests and n_done >= args.max_requests):
            return ("stop",)
        time.sleep(args.poll)
        return ("wait",)
    name = pending[0]
    path = os.path.join(args.spool, name)
    active = path[: -len(".json")] + ".active"
    try:
        os.rename(path, active)
    except OSError:
        return ("wait",)
    try:
        with open(active) as f:
            return ("req", name, json.load(f), None)
    except Exception:
        return ("req", name, None, traceback.format_exc())


def _serve(args, mdm, sample_fn, tokenizer):
    """The spool loop: rank 0 claims each request and broadcasts it, every
    rank renders it (rank 0 writes), rank 0 settles the request's file. In
    one process the broadcast is the request itself."""
    from ..parallel import mesh as PM

    root = PM.rank() == 0
    if root:
        os.makedirs(args.spool, exist_ok=True)
        print(f"serve: watching {args.spool} (poll {args.poll}s, {PM.world()} rank(s))",
              flush=True)
    n_done = 0
    while True:
        msg = PM.broadcast_object(_claim(args, n_done) if root else None)
        if msg[0] == "stop":
            break
        if msg[0] == "wait":
            continue
        _, name, req, bad = msg
        active = os.path.join(args.spool, name[: -len(".json")] + ".active")
        t0 = time.time()
        try:
            if bad is not None:
                raise ValueError(f"request {name} does not read:\n{bad}")
            metrics = process_request(
                req, mdm, sample_fn, tokenizer, video_length=args.video_length,
                resolution=(args.height, args.width), fps=args.fps,
                default_prompt=args.prompt, write=root)
            if root:
                metrics["request"] = name
                with open(active[: -len(".active")] + ".done", "w") as f:
                    json.dump(metrics, f)
                print(f"serve: {name} done in {time.time()-t0:.1f}s", flush=True)
        except Exception:
            if root:
                with open(active[: -len(".active")] + ".err", "w") as f:
                    f.write(traceback.format_exc())
                print(f"serve: {name} FAILED", flush=True)
        finally:
            if root and os.path.exists(active):
                os.remove(active)
        n_done += 1
        if args.max_requests and n_done >= args.max_requests:
            break
    PM.print0(f"serve: exiting after {n_done} requests", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
