"""Multi-modal inference app: autoregressive novel-view video synthesis
(port of `mudg_tpu/apps/render_infer.py`).

Rebuild of `virtual_render/virtual_pose_render.py:150-368` (run_inference_multi):
  * three task batches (color / depth / semantic) share one sparse-RGB + one
    sparse-depth condition window; distinct class labels 0/500/1,
  * all three tasks AND their CFG variants run in ONE sampler call (batch
    tasks*variants per UNet step, 6 with 2-point CFG),
  * autoregressive sliding window: advance by video_length//2 frames, splice
    the previous window's generated color frames into the next window's
    sparse condition, always re-anchoring frame 0 to dense GT (:246,271-274),
  * per-task saving: color PNGs, depth .npy + Spectral visualization,
    semantic nearest-palette decode, side-by-side compare mp4s.

`render_windows` is the device loop (the sampler calls and the carry) over
in-memory condition windows; `render_items` wraps it with the loading of
each window from an item list and the savers (OpenCV, imported lazily).

Usage:
    python -m mudg_tpu_torch render --items items.txt --out out/ \
        [--ckpt model.ckpt] [--height 320 --width 512] [--steps 50] [--device cpu]

`--quantize int8 | int8-conv | int8-conv-wide | int8-weights` serves the
UNet in int8 (`quant.py`: W8A8 on every conv and linear, on the spatial
convs only, on those and the wide matmuls, or weight-only), quantized from
the fp32 weights before the cast to --dtype; `--ckpt` also takes an
artifact of `python -m mudg_tpu_torch quantize`.

`--seq_parallel` under torchrun (one process per GPU; gloo with `--device
cpu`) shards each clip's sampling over every rank (`parallel/sp.py`, the
plain path): rank 0 reads the item list and broadcasts it, every rank loads
the windows and samples, and rank 0 alone writes. On one process it is
ignored, as the JAX app ignores it on one device; without it, the ranks past
0 of a torchrun launch stay idle.

    torchrun --nproc_per_node N -m mudg_tpu_torch render --seq_parallel ...
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

TASKS = ("color", "depth", "semantic")
DTYPES = ("bf16", "f32")


def load_params(args, cfg, device):
    """The MDM in fp32 on `device`: a MuDG `.ckpt` through
    `train/checkpoint.py`, another path as a `torch.save`d MDM state dict
    (a `quantize` artifact's int8 layers restructured to match its keys,
    their buffers loaded intact), else random weights from `init_mdm`
    (generator seeded 0); every sub-model loads strictly."""
    import torch

    from ..models import mdm as M

    if not args.ckpt:
        print("WARNING: no checkpoint given; using random weights")
        return M.init_mdm(cfg, torch.Generator(device=device).manual_seed(0), device)
    with torch.device("meta"):
        mdm = M.MDM(cfg)
    mdm.to_empty(device=device)
    if args.ckpt.endswith(".ckpt"):
        from ..train import checkpoint as C

        C.load_into(mdm, C.load_mudg_checkpoint(args.ckpt))
    else:
        from .. import quant

        sd = torch.load(args.ckpt, map_location=device, weights_only=True)
        quant.quantize_like(mdm, sd)
        mdm.load_state_dict(sd, strict=True)
    return mdm


def make_sp(seq_parallel: bool, device):
    """(sp, impl) (render_infer.py:57-67): with --seq_parallel over more than
    one process, a one-axis `seq` mesh over every rank and the plain path
    (JAX's "xla"); else (None, "auto"), --seq_parallel ignored on one."""
    from ..parallel import mesh as PM

    if seq_parallel and PM.init_distributed(device):
        from ..parallel import sp as SP

        return SP.make_seq_sharding(PM.make_mesh(axis_names=("seq",))), "plain"
    return None, "auto"


def idle_rank(seq_parallel: bool) -> bool:
    """A torchrun rank past 0 without --seq_parallel: it has no part in the
    run (the JAX app uses one device) and returns at once."""
    return not seq_parallel and int(os.environ.get("RANK", "0")) > 0


QUANTIZE = ("none", "int8", "int8-conv", "int8-conv-wide", "int8-weights")


def quantize_options(quantize: str, sharded=False) -> dict:
    """`quant.quantize_module`'s options for a --quantize mode other than
    'none'; under `sharded` the convs take weight-only."""
    return dict(mode="w8" if quantize == "int8-weights" else "w8a8",
                which={"int8-conv": "conv", "int8-conv-wide": "conv_wide"}.get(quantize, "all"),
                conv_mode="w8" if sharded else None)


def prepare_serving_params(mdm, quantize: str, dtype, min_size=None, sharded=False):
    """The serving-time form of the loaded fp32 MDM (render_infer.py:71-116):
    the UNet quantized as `quantize` names ('int8' W8A8 on every conv and
    linear, 'int8-conv' on the spatial convs only, 'int8-conv-wide' on those
    and the wide matmuls, 'int8-weights' weight-only; `min_size` the least
    weight elements quantized, quant.MIN_QUANT_SIZE by default), then cast to
    the compute dtype and every float kernel site's weights packed
    (`kernels.prepare_kernels`). `sharded` (sequence parallelism over
    several processes): conv layers take weight-only, and a loaded
    artifact's W8A8 convs are demoted (`quant.conv_w8a8_to_w8`), as JAX
    does because its SPMD partitioner cannot split int8 convs."""
    from .. import quant
    from ..kernels import prepare_kernels

    if quantize != "none":
        quant.quantize_module(mdm.unet, min_size=min_size,
                              **quantize_options(quantize, sharded))
    if sharded:
        n = quant.conv_w8a8_to_w8(mdm.unet)
        if n:
            print(f"seq-parallel: {n} int8 conv layers demoted to weight-only", flush=True)
    if quantize != "none":
        rep = quant.size_report(mdm.unet)
        print(f"{quantize} UNet: {rep['int8_bytes'] / 2**20:.0f} MiB int8 + "
              f"{rep['other_bytes'] / 2**20:.0f} MiB fp", flush=True)
    mdm.to(dtype).eval()
    prepare_kernels(mdm)
    return mdm


def add_quantize_args(p):
    """render's and serve's --quantize and --quantize_min_size."""
    p.add_argument("--quantize", default="none", choices=QUANTIZE,
                   help="post-training int8 quantization of the UNet for serving: "
                        "'int8' W8A8 on every conv and linear (the fused kernels 1-4 "
                        "then leave every quantized site), 'int8-conv' W8A8 on the "
                        "spatial convs only, 'int8-conv-wide' those and the matmuls "
                        "of C >= 1024, 'int8-weights' weight-only (int8 storage, "
                        "compute in --dtype)")
    p.add_argument("--quantize_min_size", type=int, default=None,
                   help="min weight elements to quantize (default: quant.MIN_QUANT_SIZE)")


def torch_dtype(name: str):
    import torch

    return {"bf16": torch.bfloat16, "f32": torch.float32}[name]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--items", required=True, help="dict-per-line item file")
    p.add_argument("--out", required=True)
    p.add_argument("--ckpt", default=None,
                   help="a MuDG .ckpt, or a torch.save'd MDM state dict")
    p.add_argument("--bpe", default=None, help="CLIP BPE vocab path")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--video_length", type=int, default=16)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=7.5)
    p.add_argument("--cfg_img", type=float, default=None)
    p.add_argument("--multiple_cond_cfg", action="store_true")
    p.add_argument("--guidance_rescale", type=float, default=0.7)
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--sampler", default="ddim", choices=("ddim", "dpmpp"),
                   help="dpmpp = DPM-Solver++(2M): ~50-step-DDIM quality in "
                        "~20 steps (ddim is the reference recipe)")
    p.add_argument("--timestep_spacing", default="uniform_trailing")
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--prompt", default="A photo a of driving scene.")
    p.add_argument("--task_serial", action="store_true",
                   help="run the 3 tasks as separate UNet batches (batch 2 "
                        "instead of 6: less memory, more sampler calls)")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--max_windows", type=int, default=None)
    p.add_argument("--preset", default="mdm512",
                   choices=("mdm512", "mdm1024", "tiny"))
    p.add_argument("--base_scale", type=float, default=None,
                   help="dynamic-rescale base override (0.7 stage1 / 0.3 stage2)")
    p.add_argument("--dtype", default="bf16", choices=DTYPES,
                   help="compute dtype; bf16 matches the reference's fp16 "
                        "autocast inference (virtual_pose_render.py:218); fp32 "
                        "norm/softmax islands apply either way")
    add_quantize_args(p)
    p.add_argument("--seq_parallel", action="store_true",
                   help="shard each clip's sampling over the processes torchrun runs "
                        "(ignored on one)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    import torch

    from ..data.waymo import read_items
    from ..parallel import mesh as PM

    assert args.height % 16 == 0 and args.width % 16 == 0, \
        "image size must be a multiple of 16"  # virtual_pose_render.py:165
    if idle_rank(args.seq_parallel):
        return 0

    mdm, sample_fn, tokenizer = build_server(args)
    device = next(mdm.parameters()).device
    items = PM.broadcast_object(read_items(args.items) if PM.rank() == 0 else None)
    tokens = torch.as_tensor(tokenizer([args.prompt] * len(TASKS)), device=device).long()
    null_tokens = torch.as_tensor(tokenizer([""])[0], device=device).long()
    render_items(
        mdm, sample_fn, items, args.out,
        tokens=tokens, null_tokens=null_tokens, video_length=args.video_length,
        resolution=(args.height, args.width), task_serial=args.task_serial, fps=args.fps,
        max_windows=args.max_windows, seed=args.seed, write=PM.rank() == 0,
    )
    return 0


def build_server(args):
    """The warm state of `render` and `serve` from their flags: (mdm,
    sample_fn, tokenizer), the MDM loaded, cast to --dtype and its kernel
    weights packed; under --seq_parallel over several processes, on this
    rank's GPU, the sampler sequence-parallel."""
    from ..conditioning.tokenizer import default_tokenizer
    from ..models import presets

    cfg = presets.get(args.preset)
    if args.base_scale is not None:
        import dataclasses as _dc

        cfg = _dc.replace(cfg, base_scale=args.base_scale)
    from ..parallel import mesh as PM

    sp, impl = make_sp(args.seq_parallel, args.device)
    mdm = load_params(args, cfg, PM.local_device(args.device))
    mdm = prepare_serving_params(mdm, args.quantize, torch_dtype(args.dtype),
                                 args.quantize_min_size, sharded=sp is not None)
    # real checkpoints demand the real BPE table (hash ids would index
    # meaningless rows of the learned text embedding)
    tokenizer = default_tokenizer(args.bpe, require_real=bool(args.ckpt))
    sample_fn = build_sampler(
        steps=args.steps, cfg_scale=args.cfg_scale, cfg_img=args.cfg_img,
        multiple_cond_cfg=args.multiple_cond_cfg,
        guidance_rescale=args.guidance_rescale, eta=args.eta,
        timestep_spacing=args.timestep_spacing, fps=args.fps,
        dtype=torch_dtype(args.dtype), impl=impl, sampler=args.sampler, sp=sp,
    )
    return mdm, sample_fn, tokenizer


def build_sampler(*, steps, cfg_scale=7.5, cfg_img=None, multiple_cond_cfg=False,
                  guidance_rescale=0.7, eta=1.0, timestep_spacing="uniform_trailing",
                  fps=10, dtype=None, impl="auto", sampler="ddim", sp=None):
    """The 3-task guided sampler, reused across windows and requests
    (apps/serve.py keeps it warm): sample_fn(mdm, tokens, null_tokens,
    generator, sparse_frames, sparse_depth, class_label, x_T=None) -> the
    clip (B, T, H, W, 3) in [-1, 1], its start noise x_T or drawn from
    `generator`; sequence-parallel under `sp`."""
    import torch

    from ..models import mdm as M

    dtype = torch.bfloat16 if dtype is None else dtype

    def sample_fn(mdm, tokens, null_tokens, generator, sparse_frames, sparse_depth,
                  class_label, x_T=None):
        return M.sample(
            mdm, generator=generator,
            sparse_frames=sparse_frames, sparse_depth=sparse_depth,
            tokens=tokens, null_tokens=null_tokens, class_label=class_label,
            num_steps=steps, guidance_scale=cfg_scale,
            cfg_img=cfg_img, multiple_cond_cfg=multiple_cond_cfg,
            guidance_rescale=guidance_rescale, eta=eta,
            timestep_spacing=timestep_spacing, fs=fps,
            dtype=dtype, impl=impl, sampler=sampler, x_T=x_T, sp=sp,
        )

    return sample_fn


def render_windows(mdm, sample_fn, windows, *, tokens, null_tokens, video_length,
                   generator, task_serial=False):
    """The autoregressive device loop. `windows` yields dicts of numpy
    arrays: "sparse_frames" (T, H, W, 3) the sparse color condition,
    "frame0" (H, W, 3) the dense GT frame 0, "sparse_depth" (T, H, W, 3),
    "class_labels" (len(TASKS),). From the second window on, the first half
    of the sparse condition is the previous window's generated color second
    half, frame 0 re-anchored to the GT. Yields (window, the sparse
    condition used, the generated (len(TASKS), T, H, W, 3) clip in [-1, 1]);
    one sampler call per window, or one per task with `task_serial`, each
    task's call drawing the same noise from `generator`."""
    import torch

    from ..utils import profiling

    vl = video_length
    dev = tokens.device
    n = len(TASKS)
    carry_color = None  # generated frames spliced into the next window
    for win in windows:
        with profiling.span("render.upload"):
            sparse = win["sparse_frames"].copy()
            if carry_color is not None:
                # splice previous generated colors into the first half
                sparse[0 : vl // 2] = carry_color[: vl // 2]
                sparse[0] = win["frame0"]  # re-anchor GT
            sparse_b = torch.from_numpy(np.stack([sparse] * n)).to(dev)
            depth_b = torch.from_numpy(np.stack([win["sparse_depth"]] * n)).to(dev)
            labels = torch.as_tensor(np.asarray(win["class_labels"]), device=dev).long()
        with profiling.span("render.sample"):
            if task_serial:
                # the three calls share the window's noise, start and steps alike,
                # as the JAX loop gives each of them the window's one key
                state, outs = generator.get_state(), []
                for ti in range(n):
                    generator.set_state(state)
                    outs.append(sample_fn(mdm, tokens[ti : ti + 1], null_tokens, generator,
                                          sparse_b[ti : ti + 1], depth_b[ti : ti + 1],
                                          labels[ti : ti + 1]))
                out = torch.cat(outs)
            else:
                out = sample_fn(mdm, tokens, null_tokens, generator, sparse_b, depth_b, labels)
        with profiling.span("render.to_host"):
            out = out.float().cpu().numpy()
            # autoregressive carry: second half of the generated color window
            carry_color = out[0, vl // 2 :].copy()
        yield win, sparse, out


def item_windows(items, resolution, video_length):
    """render_windows' windows from an item list, loaded as they are
    reached: one every video_length // 2 items, each carrying its index and
    its per-task data ("index", "task_data") for the savers."""
    from ..data import conditions as DC

    index = 0
    while index < len(items):
        sample = items[index]
        task_data = {t: DC.get_task_frames(sample, t, resolution) for t in TASKS}
        yield {
            "index": index, "task_data": task_data,
            "sparse_frames": task_data["color"]["sparse_frames"],
            "frame0": task_data["color"]["dense_frames"][0],
            "sparse_depth": DC.get_sparse_depth(sample, resolution),
            "class_labels": np.asarray([task_data[t]["class_label"] for t in TASKS], np.int32),
        }
        index += video_length // 2


def render_items(mdm, sample_fn, items, out_dir, *, tokens, null_tokens,
                 video_length, resolution, task_serial=False, fps=10,
                 max_windows=None, seed=123, write=True):
    """The autoregressive 3-task window loop (virtual_pose_render.py:150-368)
    over one item list; writes per-task frames + compare videos under
    out_dir (nothing with write False: a sequence-parallel rank past 0).
    Returns {'windows': N, 'seconds': dt}."""
    import torch

    from ..utils import media

    vl = video_length
    generator = torch.Generator(device=tokens.device).manual_seed(seed)
    if write:
        os.makedirs(out_dir, exist_ok=True)
    compare = {t: [] for t in TASKS}

    n_windows = 0
    t_start = time.time()
    for win, _, out in render_windows(
            mdm, sample_fn, item_windows(items, resolution, vl), tokens=tokens,
            null_tokens=null_tokens, video_length=vl, generator=generator,
            task_serial=task_serial):
        index, task_data = win["index"], win["task_data"]
        for ti, task in enumerate(TASKS if write else ()):
            video = out[ti]
            dense = task_data[task]["dense_frames"]
            tdir = os.path.join(out_dir, f"virtual_{task}")
            os.makedirs(tdir, exist_ok=True)
            for fi in range(vl):
                gi = index + fi
                re_u8 = media.to_uint8(video[fi])
                gt_u8 = media.to_uint8(dense[fi])
                if task == "depth":
                    # mean over channels -> metric depth (eval_tools.py:72-75)
                    d = (video[fi].mean(-1) + 1) / 2 * 100.0
                    np.save(os.path.join(tdir, f"depth_re_{gi}.npy"), d)
                    re_u8 = media.visualize_depth(d, vmin=0, vmax=100)
                elif task == "semantic":
                    re_u8, _ = media.decode_semantic(re_u8.astype(np.float32))
                media.save_image(os.path.join(tdir, f"{task}_re_{gi}.png"), re_u8)
                media.save_image(os.path.join(tdir, f"{task}_gt_{gi}.png"), gt_u8)
                if fi >= 1 and fi <= vl // 2:
                    compare[task].append(np.concatenate([re_u8, gt_u8], axis=1))
        n_windows += 1
        if max_windows and n_windows >= max_windows:
            break
        if write:
            print(f"window {n_windows}: frames {index}..{index + vl // 2}")

    for task in TASKS if write else ():
        if compare[task]:
            media.save_video(
                os.path.join(out_dir, f"compare_{task}.mp4"),
                np.stack(compare[task]), fps=fps,
            )
    dt = time.time() - t_start
    if write:
        print(f"done: {n_windows} windows in {dt:.1f}s "
              f"({dt / max(n_windows, 1):.1f}s/window)")
    return {"windows": n_windows, "seconds": dt}


if __name__ == "__main__":
    raise SystemExit(main())
