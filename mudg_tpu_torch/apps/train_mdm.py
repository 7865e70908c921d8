"""MDM training app, stage-1 512 / stage-2 1024 fine-tuning (port of
`mudg_tpu/apps/train_mdm.py`), on one GPU or several.

Rebuild of `main/trainer.py`: loads the DynamiCrafter/MuDG torch checkpoint
with import-time surgery (conv_in 8->12, class-embed clone), builds the
Waymo dataset and batch loader and the train step, runs the step loop with
metric logging, validation, sample logging and periodic checkpoints.

Usage:
    python -m mudg_tpu_torch train --items train_items.txt --out run1/ \
        [--ckpt dynamicrafter_512.ckpt] [--stage 1|2] [--max_steps N] [--device cpu]
    torchrun --nproc_per_node N -m mudg_tpu_torch train ... [--fsdp] [--tp K | --sp K]

Writes `metrics.jsonl` (step, loss, grad_norm, sec_per_step; step, val_loss),
`step_N` and `final` (the merged MDM state dict, which `render --ckpt`
loads), `trainstate_N` (parameters, AdamW moments, update count, EMA, step)
and, with --sample_every, `samples/step_N.mp4`. `--auto_resume` continues
from the newest trainstate_N, or from the newest step_N when that is later.
SIGUSR1 saves both artifacts at the end of the running step. `--ckpt` is a
MuDG `.ckpt` or the port's own saved MDM state dict, where the JAX app reads
an orbax directory. `train` is the loop over a loader, so that a caller can
feed it batches from memory.

Under torchrun (one process per GPU, `parallel/mesh.py`; gloo with
`--device cpu`) the mesh follows the JAX app (train_mdm.py:198-249): `--tp`
and `--sp` exclude each other; n_data = gcd(batch, world / model_par) ranks
on `data`, beside `--tp` ranks on `model` or `--sp` ranks on `seq`, and the
ranks past n_data x model_par idle. Every rank builds the same loader from
the same seed and takes its rows of each batch. The parameters are ZeRO-2
(moments cut over `data`), or FSDP with `--fsdp` (over `seq` when `--sp`
leaves one data rank); `--tp`/`--sp` run the UNet on the plain path, as
JAX's "xla", and data parallelism alone keeps the kernels. Validation
losses are averaged over `data`; rank 0 writes metrics.jsonl, samples and
the checkpoints, gathered from every rank, and a run at one world size
resumes at another. SIGUSR1's flag is summed over the ranks each step, so
that every rank saves at the same step. `--fsdp` on one GPU shards
nothing, as the JAX app on one device; `--tp` or `--sp` above the running
processes exit with code 2.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import signal
import sys
import time

import numpy as np

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
                   help="shard params, moments, EMA and frozen towers over the ranks "
                        "(FSDP2; nothing to shard on one GPU)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree (ranks on 'model'; under torchrun)")
    p.add_argument("--latents", action="store_true",
                   help="train from precomputed VAE moment caches "
                        "(`python -m mudg_tpu_torch precompute-latents` first)")
    p.add_argument("--train_labels", default="color,semantic,depth",
                   help="comma list of tasks to sample (waymo_data.py:342-362)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree (ranks on 'seq'; under torchrun)")
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


class Parallel:
    """The run's layout over the ranks (`setup_parallel`): mesh None on one
    process."""

    def __init__(self, mesh=None, sp=None, tp_axis=None, fsdp_axis="data", impl="train"):
        self.mesh, self.sp, self.tp_axis = mesh, sp, tp_axis
        self.fsdp_axis, self.impl = fsdp_axis, impl

    @property
    def active(self) -> bool:
        return self.mesh is None or self.mesh.active

    @property
    def root(self) -> bool:
        """The rank that writes (rank 0)."""
        from ..parallel import mesh as PM

        return PM.rank() == 0


def refuse(msg: str):
    print(f"train: {msg}", file=sys.stderr)
    raise SystemExit(2)


def setup_parallel(args) -> Parallel:
    """The mesh of train_mdm.py:198-249 over the processes torchrun runs:
    --tp with --sp refused; n_data = gcd(batch, world / model_par) ranks on
    'data' beside --tp ranks on 'model' or --sp on 'seq'; the mesh lines
    printed. One process (no torchrun, or WORLD_SIZE 1): no mesh, and --tp
    or --sp above 1 exit 2."""
    from ..parallel import mesh as PM

    if args.tp > 1 and args.sp > 1:
        refuse("--tp and --sp are mutually exclusive")
    model_par = max(args.tp, args.sp)
    if not PM.init_distributed(args.device):
        if model_par > 1:
            refuse(f"--tp/--sp {model_par} needs {model_par} processes (torchrun "
                   "--nproc_per_node N -m mudg_tpu_torch train ...)")
        if args.fsdp:
            print("fsdp: one GPU, nothing to shard")
        return Parallel()
    world = PM.world()
    if world % model_par:
        refuse(f"--tp/--sp {model_par} must divide the {world} processes")
    n_data = math.gcd(args.batch_size, world // model_par)
    if args.tp > 1:
        mesh = PM.Mesh([n_data, args.tp], ("data", "model"))
        PM.print0(f"mesh: {n_data} devices on 'data' x {args.tp} on 'model' "
                  f"(batch {args.batch_size})")
    elif args.sp > 1:
        mesh = PM.Mesh([n_data, args.sp], ("data", "seq"))
        PM.print0(f"mesh: {n_data} devices on 'data' x {args.sp} on 'seq' "
                  f"(batch {args.batch_size}, sequence-parallel activations)")
    else:
        mesh = PM.Mesh([n_data], ("data",))
        PM.print0(f"mesh: {n_data} devices on 'data' (batch {args.batch_size})")
    sp = None
    if args.sp > 1:
        from ..parallel import sp as SP

        sp = SP.make_seq_sharding(mesh)
    # one clip per step leaves no data axis to FSDP over: shard over seq
    fsdp_axis = "seq" if (args.fsdp and args.sp > 1 and n_data == 1) else "data"
    if args.fsdp:
        PM.print0(f"fsdp: params/moments/EMA/frozen towers sharded over '{fsdp_axis}'")
    if not mesh.active:
        print(f"rank {PM.rank()}: outside the mesh, idle")
    return Parallel(mesh, sp, "model" if args.tp > 1 else None, fsdp_axis,
                    "plain" if model_par > 1 else "train")


def log_samples(args, mdm, state, batch, tokenizer, step_i, sink=None, par=None):
    """ImageLogger analog (main/callbacks.py:15-101): a 10-step sample of the
    batch's first clip under the EMA weights when there are any (swapped
    into the parameters and back, bit for bit), written to
    out/samples/step_N.mp4, or handed to sink(step_i, video) instead. Over
    several ranks every rank samples (the layout's collectives; the plain
    path under --tp/--sp) and rank 0 writes."""
    import torch

    from ..models import mdm as M
    from ..train import step as TS
    from ..utils import media

    par = par or Parallel()
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
        with torch.no_grad():
            for n, p in TS.local_params(state).items():
                kept = p.clone()
                p.copy_(state.ema[n])
                state.ema[n].copy_(kept)

    if swap:
        swap_ema()
    try:
        out = M.sample(mdm, generator=torch.Generator(device=device).manual_seed(step_i),
                       tokens=b["tokens"],
                       null_tokens=torch.as_tensor(tokenizer([""])[0], device=device).long(),
                       class_label=b["class_label"], num_steps=10, guidance_scale=7.5,
                       guidance_rescale=0.7, sp=par.sp,
                       **({} if par.mesh is None or par.impl == "train" else
                          {"impl": "plain"}), **conds)
    finally:
        if swap:
            swap_ema()
    if not par.root:
        return
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
    its weights only. Every rank reads the files and keeps its part.
    Returns the step to continue from."""
    import torch

    from ..parallel import mesh as PM
    from ..train import checkpoint as C
    from ..train import step as TS

    def weights(src):
        with torch.no_grad():
            for n, p in TS.local_params(state).items():
                p.copy_(src[n] if state.layout is None else state.layout.local("params", n,
                                                                               src[n]))

    w_step, w_name = _newest(args.out, "step_")
    f_step, f_name = _newest(args.out, "trainstate_")
    if f_step is not None and (w_step is None or f_step >= w_step):
        step_i, latest = f_step, f_name
        saved = C.load(os.path.join(args.out, latest), device)
        try:
            C.restore_train_state(state, saved)
        except (ValueError, KeyError) as e:
            PM.print0(f"auto-resume: full restore of {latest} failed ({type(e).__name__}; "
                      "--use_ema flag mismatch with the saving run?) — restoring weights "
                      "only, optimizer state reset")
            weights(saved["params"])
        state.step = step_i
    elif w_step is not None:
        step_i, latest = w_step, w_name
        weights(C.load(os.path.join(args.out, latest), device))
        state.step = step_i
    else:
        return 0
    PM.print0(f"auto-resume: restored {latest} at step {step_i}")
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
    "artifacts": {file: {"bytes", "write_s"}}, "sec_per_step": [...]}; a
    rank outside the mesh returns None at once."""
    import torch

    from ..conditioning.tokenizer import default_tokenizer
    from ..models import mdm as M
    from ..parallel import mesh as PM
    from ..train import checkpoint as C
    from ..train import step as TS
    from ..utils import profiling

    par = setup_parallel(args)
    if not par.active:
        return None
    mesh = par.mesh
    device = PM.local_device(args.device)
    cfg, _, temporal_frozen = recipe(args)
    tc = TS.TrainConfig(learning_rate=args.lr, accum_steps=args.accum, use_ema=args.use_ema,
                        temporal_frozen=temporal_frozen)
    mdm = load_model(args, cfg, device)
    grad_mask = None
    if temporal_frozen:
        # the unet's temporal transformers frozen, image_proj all trainable
        grad_mask = {"unet." + n: v for n, v in TS.temporal_frozen_mask(mdm.unet).items()}
    if tokenizer is None:
        tokenizer = default_tokenizer(args.bpe, require_real=bool(args.ckpt))
    null_tokens = torch.as_tensor(tokenizer([""])[0], device=device).long()
    if mesh is None:
        state = TS.init_train_state(mdm, tc)
    else:
        state = TS.place_train_state(mdm, tc, mesh, fsdp=args.fsdp, axis=par.fsdp_axis,
                                     tp_axis=par.tp_axis, sp=par.sp)
    step_fn = TS.make_train_step(mdm, tc, null_tokens, grad_mask=grad_mask, impl=par.impl,
                                 remat=True if args.remat == "full" else args.remat)
    with torch.no_grad():
        null_emb = M.encode_text(mdm, null_tokens[None])

    os.makedirs(args.out, exist_ok=True)
    log_path = os.path.join(args.out, "metrics.jsonl")

    def emit(rec):
        if not par.root:
            return
        print(json.dumps(rec))
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def write(name, gathered):
        # every rank gathers alike; rank 0 writes
        if par.root:
            _write(os.path.join(args.out, name), gathered, artifacts)

    layout = state.layout
    step_i = auto_resume(args, state, device) if args.auto_resume else 0
    gen = torch.Generator(device=device).manual_seed(args.seed)
    artifacts, secs = {}, []
    want_ckpt = {"flag": False}
    prev_handler = signal.signal(signal.SIGUSR1, lambda *_: want_ckpt.update(flag=True))
    # --profile_dir: the loop under torch.profiler with the program's spans on
    profiled = (profiling.trace(args.profile_dir) if args.profile_dir and par.root
                else contextlib.nullcontext())
    try:
        with profiled:
            if on_step is not None:
                on_step(step_i, state, None)
            t0 = time.time()
            while step_i < args.max_steps:
                n_batches = 0
                for batch in loader:
                    n_batches += 1
                    tb = to_device(batch, device)
                    if mesh is not None:
                        tb = PM.shard_batch(tb, mesh, "data", dim=1 if args.accum > 1 else 0)
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
                        emit({"step": step_i,
                              "val_loss": validate(mdm, val_loader, null_emb, device, par)})
                    if args.sample_every and step_i % args.sample_every == 0:
                        log_samples(args, mdm, state, tb, tokenizer, step_i, sample_sink, par)
                    # SIGUSR1 (preemption) saves both artifacts; it reaches the
                    # ranks at different times, so every rank reads the sum
                    flag = want_ckpt["flag"]
                    if mesh is not None:
                        f = torch.tensor(float(flag), device=device)
                        torch.distributed.all_reduce(f, group=mesh.all)
                        flag = bool(f > 0)
                    save_weights = flag or step_i % args.ckpt_every == 0
                    save_full = flag or (args.full_ckpt_every
                                         and step_i % args.full_ckpt_every == 0)
                    want_ckpt["flag"] = False
                    if save_weights:
                        # with the frozen towers, so that render runs from it alone
                        write(f"step_{step_i}", C.model_state_dict(mdm, layout))
                    if save_full:
                        write(f"trainstate_{step_i}", C.train_state(state))
                    if step_i >= args.max_steps:
                        break
                if not n_batches:
                    raise ValueError("the loader yields no batch: fewer items than "
                                     "batch_size x accum")
    finally:
        signal.signal(signal.SIGUSR1, prev_handler)
    write("final", C.model_state_dict(mdm, layout))
    PM.print0("training done")
    return {"mdm": mdm, "state": state, "step": step_i, "artifacts": artifacts,
            "sec_per_step": secs}


def validate(mdm, val_loader, null_emb, device, par=None) -> float:
    """Mean loss over at most VAL_BATCHES validation batches (reference
    validation_step, ddpm3d.py:398-405): no gradient, remat=False, each
    batch's draws and dropout from a generator seeded with its index. Over
    several ranks each takes its rows of the batch and of the draws (made
    at the global batch) and the losses are averaged over `data`."""
    import torch
    import torch.distributed as dist

    from ..models import mdm as M
    from ..parallel import mesh as PM
    from ..train import step as TS

    par = par or Parallel()
    mesh = par.mesh
    n_data = mesh.shape.get("data", 1) if mesh is not None else 1
    cfg = mdm.cfg
    losses = []
    with torch.no_grad():
        for vi, vb in enumerate(val_loader):
            if vi >= VAL_BATCHES:
                break
            vb = to_device(vb, device)
            gen = torch.Generator(device=device).manual_seed(vi)
            draws = M.draw_training_noise(cfg, M.training_shapes(cfg, vb), gen)
            if mesh is not None:
                vb = PM.shard_batch(vb, mesh, "data")
                draws = TS.shard_draws(draws, n_data, mesh.coord("data"))
            loss, _ = M.training_loss(mdm, vb, draws, null_emb=null_emb, remat=False,
                                      generator=gen, sp=par.sp,
                                      **({} if mesh is None else {"impl": par.impl}))
            if n_data > 1:
                dist.all_reduce(loss, group=mesh.group("data"))
                loss = loss / n_data
            losses.append(float(loss))
    return float(np.mean(losses))


def main(argv=None):
    args = parser().parse_args(argv)
    if args.tp > 1 and args.sp > 1:
        refuse("--tp and --sp are mutually exclusive")
    from ..conditioning.tokenizer import default_tokenizer

    _, resolution, _ = recipe(args)
    tokenizer = default_tokenizer(args.bpe, require_real=bool(args.ckpt))
    loader, val_loader = loaders(args, resolution, tokenizer)
    train(args, loader, val_loader, tokenizer=tokenizer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
