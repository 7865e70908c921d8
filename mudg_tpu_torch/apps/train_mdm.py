"""MDM training app, stage-1 512 / stage-2 1024 fine-tuning (port of
`mudg_tpu/apps/train_mdm.py`, single GPU).

Rebuild of `main/trainer.py`: loads the DynamiCrafter/MuDG torch checkpoint
with import-time surgery (conv_in 8->12, class-embed clone), builds the
Waymo dataset and batch loader and the train step, runs the step loop with
metric logging, validation, sample logging and periodic checkpoints.

Usage:
    python -m mudg_tpu_torch train --items train_items.txt --out run1/ \
        [--ckpt dynamicrafter_512.ckpt] [--stage 1|2] [--max_steps N] [--device cpu]

Writes `metrics.jsonl` (step, loss, grad_norm, sec_per_step; step, val_loss),
`step_N` and `final` (the merged MDM state dict, which `render --ckpt`
loads), `trainstate_N` (parameters, AdamW moments, update count, EMA, step)
and, with --sample_every, `samples/step_N.mp4`. `--auto_resume` continues
from the newest trainstate_N, or from the newest step_N when that is later.
SIGUSR1 saves both artifacts at the end of the running step. `--fsdp` on one
GPU shards nothing, as the JAX app on one device; `--tp` or `--sp` above 1
exit with code 2 (the multi-GPU slice). `--ckpt` is a MuDG `.ckpt` or the
port's own saved MDM state dict, where the JAX app reads an orbax
directory. `train` is the loop over a loader, so that a caller can feed it
batches from memory.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time

import numpy as np

from .render_infer import not_ported

REMATS = ("full", "dots_small", "dots_gn", "dots_ln", "dots_attn", "convs", "dots", "names",
          "except_ff")
VAL_BATCHES = 8   # the most validation batches a validation pass reads


def parser():
    p = argparse.ArgumentParser("train")
    p.add_argument("--items", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--ckpt", default=None,
                   help="MuDG .ckpt (surgery applied) or a saved MDM state dict")
    p.add_argument("--stage", type=int, default=1, choices=(1, 2))
    p.add_argument("--bpe", default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--video_length", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--accum", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--ckpt_every", type=int, default=500)
    p.add_argument("--full_ckpt_every", type=int, default=1000,
                   help="save the full train state (params + optimizer moments + EMA) "
                        "every N steps as trainstate_N; 0 disables. --auto_resume "
                        "prefers these over weights-only step_N")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=20230211)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--remat", default="dots_attn", choices=REMATS,
                   help="backward recompute policy (nn/remat.py); full = every block "
                        "recomputed")
    p.add_argument("--profile_dir", default=None, help="torch.profiler trace dir")
    p.add_argument("--val_items", default=None)
    p.add_argument("--val_every", type=int, default=2000)
    p.add_argument("--sample_every", type=int, default=0,
                   help="log sampled videos every N steps (ImageLogger analog)")
    p.add_argument("--preset", default=None, choices=(None, "mdm512", "mdm1024", "tiny"))
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from the latest checkpoint in --out")
    p.add_argument("--fsdp", action="store_true",
                   help="shard params, moments, EMA and frozen towers (nothing to shard "
                        "on one GPU)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel degree (multi-GPU)")
    p.add_argument("--latents", action="store_true",
                   help="train from precomputed VAE moment caches "
                        "(`python -m mudg_tpu_torch precompute-latents` first)")
    p.add_argument("--train_labels", default="color,semantic,depth",
                   help="comma list of tasks to sample (waymo_data.py:342-362)")
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel degree (multi-GPU)")
    p.add_argument("--device", default="cuda")
    return p


def recipe(args):
    """(MDMConfig, resolution, temporal_frozen) of the stage, the preset
    overriding the config (configs/stage{1,2}-*_mdm_waymo/config.yaml)."""
    from ..models import mdm as M

    if args.stage == 1:
        resolution = (args.height or 320, args.width or 512)
        cfg = M.MDMConfig(base_scale=0.7)
        temporal_frozen = False
    else:
        resolution = (args.height or 576, args.width or 1024)
        cfg = M.stage2_config()
        temporal_frozen = True
    if args.preset:
        from ..models import presets

        cfg = presets.get(args.preset)
    return cfg, resolution, temporal_frozen


def load_model(args, cfg, device):
    """The MDM in fp32 on `device`: a .ckpt with the DynamiCrafter -> MuDG
    surgery, a saved MDM state dict, or init_mdm from --seed."""
    import torch

    from ..models import mdm as M
    from ..train import checkpoint as C

    if not args.ckpt:
        print("WARNING: training from scratch (no pretrained checkpoint)")
        return M.init_mdm(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    with torch.device("meta"):
        mdm = M.MDM(cfg)
    mdm.to_empty(device=device)
    if args.ckpt.endswith(".ckpt"):
        C.load_into(mdm, C.load_mudg_checkpoint(args.ckpt, expand_conv_in=True,
                                                add_class_embed=True))
    else:
        mdm.load_state_dict(C.load(args.ckpt, device), strict=True)
    return mdm


def loaders(args, resolution, tokenizer):
    """(train loader, val loader or None) over the item lists."""
    from ..data.waymo import BatchLoader, WaymoDataset

    labels = tuple(s for s in args.train_labels.split(",") if s)
    ds = WaymoDataset(args.items, video_length=args.video_length, resolution=resolution,
                      seed=args.seed, latents=args.latents, train_labels=labels)
    loader = BatchLoader(ds, args.batch_size, accum_steps=args.accum, tokenizer=tokenizer,
                         seed=args.seed)
    val_loader = None
    if args.val_items:
        val_ds = WaymoDataset(args.val_items, video_length=args.video_length,
                              resolution=resolution, seed=args.seed + 1,
                              latents=args.latents, train_labels=labels)
        val_loader = BatchLoader(val_ds, args.batch_size, accum_steps=1, tokenizer=tokenizer,
                                 shuffle=False)
    return loader, val_loader


def to_device(batch: dict, device) -> dict:
    """A loader's numpy batch as tensors: floats fp32, integers int64."""
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, torch.float32 if v.dtype.kind == "f" else torch.int64) for k, v in batch.items()}


def log_samples(args, mdm, state, batch, tokenizer, step_i, sink=None):
    """ImageLogger analog (main/callbacks.py:15-101): a 10-step sample of the
    batch's first clip under the EMA weights when there are any (swapped
    into the parameters and back, bit for bit), written to
    out/samples/step_N.mp4, or handed to sink(step_i, video) instead."""
    import torch

    from ..models import mdm as M
    from ..utils import media

    device = next(mdm.unet.parameters()).device
    latents = "sparse_moments" in batch
    key = "sparse_moments" if latents else "sparse_frames"
    first = (lambda v: v[0][:1]) if batch[key].ndim == 6 else (lambda v: v[:1])
    b = {k: first(v) for k, v in batch.items()}
    if latents:
        conds = dict(sparse_moments=b["sparse_moments"], depth_moments=b["depth_moments"],
                     frame0=b["sparse_frame0"])
    else:
        conds = dict(sparse_frames=b["sparse_frames"], sparse_depth=b["sparse_depth"])
    swap = state.ema is not None

    def swap_ema():
        for n, p in state.params.items():
            p.data, state.ema[n] = state.ema[n], p.data

    if swap:
        swap_ema()
    try:
        out = M.sample(mdm, generator=torch.Generator(device=device).manual_seed(step_i),
                       tokens=b["tokens"],
                       null_tokens=torch.as_tensor(tokenizer([""])[0], device=device).long(),
                       class_label=b["class_label"], num_steps=10, guidance_scale=7.5,
                       guidance_rescale=0.7, **conds)
    finally:
        if swap:
            swap_ema()
    video = out[0].cpu().numpy()
    if sink is not None:
        sink(step_i, video)
        return
    sdir = os.path.join(args.out, "samples")
    os.makedirs(sdir, exist_ok=True)
    media.save_video(os.path.join(sdir, f"step_{step_i}.mp4"), media.to_uint8(video), fps=10)


def _newest(out, prefix):
    found = sorted((int(d.split("_")[1]), d) for d in os.listdir(out)
                   if d.startswith(prefix) and d.split("_")[1].isdigit())
    return found[-1] if found else (None, None)


def auto_resume(args, state, device):
    """The JAX app's choice: the newest trainstate_N when its step is at or
    after the newest step_N's, else step_N (weights only, optimizer fresh).
    A trainstate whose structure differs (an --use_ema mismatch) restores
    its weights only. Returns the step to continue from."""
    import torch

    from ..train import checkpoint as C

    w_step, w_name = _newest(args.out, "step_")
    f_step, f_name = _newest(args.out, "trainstate_")
    if f_step is not None and (w_step is None or f_step >= w_step):
        step_i, latest = f_step, f_name
        saved = C.load(os.path.join(args.out, latest), device)
        try:
            C.restore_train_state(state, saved)
        except (ValueError, KeyError) as e:
            print(f"auto-resume: full restore of {latest} failed ({type(e).__name__}; "
                  "--use_ema flag mismatch with the saving run?) — restoring weights "
                  "only, optimizer state reset")
            with torch.no_grad():
                for n, p in state.params.items():
                    p.copy_(saved["params"][n])
        state.step = step_i
    elif w_step is not None:
        step_i, latest = w_step, w_name
        merged = C.load(os.path.join(args.out, latest), device)
        with torch.no_grad():
            for n, p in state.params.items():
                p.copy_(merged[n])
        state.step = step_i
    else:
        return 0
    print(f"auto-resume: restored {latest} at step {step_i}")
    return step_i


def _write(path, obj, report):
    from ..train import checkpoint as C

    t0 = time.perf_counter()
    size = C.save(path, obj)
    report[os.path.basename(path)] = {"bytes": size, "write_s": time.perf_counter() - t0}


def train(args, loader, val_loader=None, *, tokenizer=None, on_step=None, sample_sink=None):
    """The step loop over `loader` (a BatchLoader, or anything that yields
    its batches) until --max_steps. on_step(step_i, state, metrics) runs
    once before the first step (metrics None, after any resume) and after
    each optimizer step's record, before its validation, sample and
    checkpoints; sample_sink(step_i, video) takes the logged samples
    instead of the mp4 writer. Returns {"mdm", "state", "step",
    "artifacts": {file: {"bytes", "write_s"}}, "sec_per_step": [...]}."""
    import torch

    from ..conditioning.tokenizer import default_tokenizer
    from ..models import mdm as M
    from ..train import checkpoint as C
    from ..train import step as TS

    if args.tp > 1 or args.sp > 1:
        not_ported("--tp/--sp above 1")
    device = torch.device(args.device)
    cfg, _, temporal_frozen = recipe(args)
    tc = TS.TrainConfig(learning_rate=args.lr, accum_steps=args.accum, use_ema=args.use_ema,
                        temporal_frozen=temporal_frozen)
    mdm = load_model(args, cfg, device)
    if args.fsdp:
        print("fsdp: one GPU, nothing to shard")
    grad_mask = None
    if temporal_frozen:
        # the unet's temporal transformers frozen, image_proj all trainable
        grad_mask = {"unet." + n: v for n, v in TS.temporal_frozen_mask(mdm.unet).items()}
    if tokenizer is None:
        tokenizer = default_tokenizer(args.bpe, require_real=bool(args.ckpt))
    null_tokens = torch.as_tensor(tokenizer([""])[0], device=device).long()
    state = TS.init_train_state(mdm, tc)
    step_fn = TS.make_train_step(mdm, tc, null_tokens, grad_mask=grad_mask, impl="train",
                                 remat=True if args.remat == "full" else args.remat)
    with torch.no_grad():
        null_emb = M.encode_text(mdm, null_tokens[None])

    os.makedirs(args.out, exist_ok=True)
    log_path = os.path.join(args.out, "metrics.jsonl")

    def emit(rec):
        print(json.dumps(rec))
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    step_i = auto_resume(args, state, device) if args.auto_resume else 0
    gen = torch.Generator(device=device).manual_seed(args.seed)
    artifacts, secs = {}, []
    want_ckpt = {"flag": False}
    prev_handler = signal.signal(signal.SIGUSR1, lambda *_: want_ckpt.update(flag=True))
    prof = None
    if args.profile_dir:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                      + ([torch.profiler.ProfilerActivity.CUDA]
                                         if device.type == "cuda" else []))
        prof.start()
    if on_step is not None:
        on_step(step_i, state, None)
    t0 = time.time()
    try:
        while step_i < args.max_steps:
            n_batches = 0
            for batch in loader:
                n_batches += 1
                tb = to_device(batch, device)
                state, metrics = step_fn(state, tb, gen)
                step_i += 1
                if step_i % args.log_every == 0:
                    loss = float(metrics["loss"])
                    dt = (time.time() - t0) / args.log_every
                    t0 = time.time()
                    secs.append(dt)
                    emit({"step": step_i, "loss": loss,
                          "grad_norm": float(metrics["grad_norm"]),
                          "sec_per_step": round(dt, 3)})
                if on_step is not None:
                    on_step(step_i, state, metrics)
                if val_loader is not None and step_i % args.val_every == 0:
                    emit({"step": step_i, "val_loss": validate(mdm, val_loader, null_emb, device)})
                if args.sample_every and step_i % args.sample_every == 0:
                    log_samples(args, mdm, state, tb, tokenizer, step_i, sample_sink)
                # SIGUSR1 (preemption) saves both artifacts
                save_weights = want_ckpt["flag"] or step_i % args.ckpt_every == 0
                save_full = want_ckpt["flag"] or (
                    args.full_ckpt_every and step_i % args.full_ckpt_every == 0)
                want_ckpt["flag"] = False
                if save_weights:
                    # with the frozen towers, so that render runs from it alone
                    _write(os.path.join(args.out, f"step_{step_i}"), mdm.state_dict(),
                           artifacts)
                if save_full:
                    _write(os.path.join(args.out, f"trainstate_{step_i}"),
                           C.train_state(state), artifacts)
                if step_i >= args.max_steps:
                    break
            if not n_batches:
                raise ValueError("the loader yields no batch: fewer items than "
                                 "batch_size x accum")
    finally:
        signal.signal(signal.SIGUSR1, prev_handler)
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    _write(os.path.join(args.out, "final"), mdm.state_dict(), artifacts)
    print("training done")
    return {"mdm": mdm, "state": state, "step": step_i, "artifacts": artifacts,
            "sec_per_step": secs}


def validate(mdm, val_loader, null_emb, device) -> float:
    """Mean loss over at most VAL_BATCHES validation batches (reference
    validation_step, ddpm3d.py:398-405): no gradient, remat=False, each
    batch's draws and dropout from a generator seeded with its index."""
    import torch

    from ..models import mdm as M

    cfg = mdm.cfg
    losses = []
    with torch.no_grad():
        for vi, vb in enumerate(val_loader):
            if vi >= VAL_BATCHES:
                break
            vb = to_device(vb, device)
            gen = torch.Generator(device=device).manual_seed(vi)
            draws = M.draw_training_noise(cfg, M.training_shapes(cfg, vb), gen)
            loss, _ = M.training_loss(mdm, vb, draws, null_emb=null_emb, remat=False,
                                      generator=gen)
            losses.append(float(loss))
    return float(np.mean(losses))


def main(argv=None):
    args = parser().parse_args(argv)
    if args.tp > 1 or args.sp > 1:
        not_ported("--tp/--sp above 1")
    from ..conditioning.tokenizer import default_tokenizer

    _, resolution, _ = recipe(args)
    tokenizer = default_tokenizer(args.bpe, require_real=bool(args.ckpt))
    loader, val_loader = loaders(args, resolution, tokenizer)
    train(args, loader, val_loader, tokenizer=tokenizer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
