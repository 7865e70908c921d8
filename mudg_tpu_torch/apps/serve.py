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

Usage:
    python -m mudg_tpu_torch serve --spool requests/ --preset mdm512 --ckpt m.ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from .render_infer import DTYPES, TASKS, build_server, render_items


def process_request(req, mdm, sample_fn, tokenizer, *, video_length,
                    resolution, fps, default_prompt):
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
        seed=int(req.get("seed", 123)),
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
    p.add_argument("--quantize", default="none",
                   choices=("none", "int8", "int8-conv", "int8-conv-wide",
                            "int8-weights"),
                   help="int8 serving; not ported yet (exits 2 unless 'none')")
    p.add_argument("--quantize_min_size", type=int, default=None,
                   help="min weight elements to quantize (with --quantize); not "
                        "ported yet (exits 2 when given)")
    p.add_argument("--seq_parallel", action="store_true",
                   help="shard each clip's sampling over all GPUs; not ported "
                        "yet (exits 2 with more than one GPU), ignored on one")
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
    mdm, sample_fn, tokenizer = build_server(args)

    os.makedirs(args.spool, exist_ok=True)
    print(f"serve: watching {args.spool} (poll {args.poll}s)", flush=True)
    n_done = 0
    while True:
        pending = sorted(
            (f for f in os.listdir(args.spool) if f.endswith(".json")),
            key=lambda f: os.path.getmtime(os.path.join(args.spool, f)),
        )
        if not pending:
            if args.exit_when_empty or (
                args.max_requests and n_done >= args.max_requests
            ):
                break
            time.sleep(args.poll)
            continue
        name = pending[0]
        path = os.path.join(args.spool, name)
        active = path[: -len(".json")] + ".active"
        try:  # claim atomically; a concurrent daemon may have taken it
            os.rename(path, active)
        except OSError:
            continue
        t0 = time.time()
        try:
            with open(active) as f:
                req = json.load(f)
            metrics = process_request(
                req, mdm, sample_fn, tokenizer,
                video_length=args.video_length,
                resolution=(args.height, args.width), fps=args.fps,
                default_prompt=args.prompt,
            )
            metrics["request"] = name
            with open(active[: -len(".active")] + ".done", "w") as f:
                json.dump(metrics, f)
            print(f"serve: {name} done in {time.time()-t0:.1f}s", flush=True)
        except Exception:
            with open(active[: -len(".active")] + ".err", "w") as f:
                f.write(traceback.format_exc())
            print(f"serve: {name} FAILED", flush=True)
        finally:
            if os.path.exists(active):
                os.remove(active)
        n_done += 1
        if args.max_requests and n_done >= args.max_requests:
            break
    print(f"serve: exiting after {n_done} requests", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
