"""The comparison that decides `correct`: what the timed path produced,
against the plain reference in float32 on the same weights and inputs.

Serving: a sampler's chain cannot be compared whole in another precision,
so the reference follows the program step by step from the program's own
state, and checks by themselves the start (the conditions and the start
noise) and the update between steps. For one timed window drawn from the
seed it works out again, from the seeded weights, the window's inputs and
the previous window's clip (the autoregressive carry), the conditions (the
VAE encode of the spliced sparse color and depth videos, both CLIP towers,
the resampler), and replays the sampler's draws from the window's
generator state. Five numbers:

  start_gap   the largest difference of the program's start noise from the
              replayed draw (exact: limit 0);
  cond_gap    the largest relative L2 distance of the conditions the
              program's UNet was given (the encoded sparse videos, on frames
              drawn from the seed, and each guidance variant's context) from
              the reference's;
  unet_gap    the largest root-mean-square difference of the program's
              UNet prediction from the reference UNet's on the same inputs
              (a v-prediction, whose scale is 1): at the last step for
              every row of the UNet's batch (each task and guidance
              variant), at the first and one step drawn from the seed for
              each guidance variant of a task drawn from the seed;
  step_gap    the last step's update from the program's predictions (CFG,
              guidance rescale, the DDIM update with the replayed noise),
              compared at the decoder's input: the distance of the
              program's from the reference's, over the part of the
              reference's that the prediction moves (its update against its
              update with a zero prediction), the largest over the tasks;
  decode_gap  the relative L2 distance of the clip of a task drawn from the
              seed from the reference decoder's on the program's decoder
              inputs, clamped to [-1, 1].

With the control "fp8" the reference in fp8 (e4m3) takes the program's
place in cond_gap, step_gap and decode_gap, whose readings then judge the
control, and the program's own go to the details: the check has to refuse
it. The training cell's numbers are set out in `train`.
"""
from __future__ import annotations

import contextlib

import numpy as np

from . import traffic, weights
from ..reference import mdm as R
from ..reference import sampler as RS

FRAMES_PER_CALL = 4   # frames the reference VAE encodes or decodes at once


def serve_steps(mix: dict, rng) -> list[int]:
    """The checked steps: any of the first, one drawn from the seed and the
    last, as the mix's `check_steps` names them."""
    s = mix["steps"]
    mid = int(rng.integers(1, s - 1)) if s > 2 else 0
    picked = {"first": 0, "drawn": mid, "last": s - 1}
    return sorted({picked[k] for k in mix["check_steps"]})


def _frames(fn, x):
    import torch

    return torch.cat([fn(x[i:i + FRAMES_PER_CALL]) for i in range(0, x.shape[0],
                                                                    FRAMES_PER_CALL)])


def _rel(a, b) -> float:
    return float((a.float() - b).norm() / b.norm().clamp_min(1e-30))


def serve(cfg: dict, mix: dict, seed: int, record: dict, steps: list[int], device,
          control: str | None = None) -> dict:
    """The serving numbers of one window (see the module's docstring).
    record: the window's inputs, the previous clip, the program's clip
    (tasks, T, H, W, 3), its sampler calls (generator state, the UNet's
    inputs and outputs by step, the decoder's inputs) and the token ids.
    control "fp8": cond_gap, step_gap and decode_gap read with the reference
    in fp8 in the program's place (the program's own int8 path is the
    UNet's control). Returns (numbers, the readings behind them)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    u, v = cfg["unet"], cfg["vae"]
    tasks = len(mix["class_labels"])
    variants = 2                 # 2-point CFG: unconditional, full
    calls = record["calls"]
    rng = np.random.default_rng(traffic.sub_seed(seed, "check.sample"))
    video = cfg["video_length"]
    frames = np.sort(rng.choice(video, size=min(video, mix["check_frames"]), replace=False))
    modes = (None,) if control is None else (None, "fp8")
    out, detail = {}, {"unet": []}
    with torch.no_grad():
        P = {k: t.float() for k, t in weights.make(R.param_shapes(cfg), seed, device).items()}

        def program(task, step):
            """The UNet's inputs (x, t, context, label, fs) and predictions
            of `task` at `step`, (variants, ...) each, as the program's
            UNet took and made them."""
            r = calls[0]["records"][step]
            return {k: r[k][task::tasks] for k in ("x", "t", "context", "label", "fs", "v")}

        # the start: the replayed start noise against the program's
        gen = torch.Generator(device=device)
        gen.set_state(calls[0]["state"])
        f = 2 ** (len(v["ch_mult"]) - 1)
        shape = (tasks, video, cfg["height"] // f, cfg["width"] // f, u["out_channels"])
        x_T, noise = RS.draws(gen, shape, mix["steps"], calls[0]["records"][steps[0]]["x"].dtype)
        out["start_gap"] = max(float((program(k, 0)["x"][0, ..., :shape[-1]].float()
                                      - x_T[k].float()).abs().max())
                               for k in range(tasks)) if steps[0] == 0 else 0.0

        sparse = torch.as_tensor(traffic.splice(record["window"], record["previous"], video),
                                 device=device)
        depth = torch.as_tensor(record["window"]["sparse_depth"], device=device)
        idx = torch.as_tensor(frames, device=device)

        def conditions():
            enc = lambda x: R.vae_encode(P, v, x)   # noqa: E731
            c = torch.cat([_frames(enc, sparse[idx]), _frames(enc, depth[idx])], dim=-1)
            text = R.text_encode(P, cfg["clip_text"], torch.as_tensor(record["tokens"],
                                                                      device=device))
            null = R.text_encode(P, cfg["clip_text"], torch.as_tensor(record["null"],
                                                                      device=device)[None])
            img = sparse[0][None]
            img_emb, null_img = R.resample(P, cfg["resampler"], R.image_encode(
                P, cfg["clip_image"], torch.cat([img, torch.zeros_like(img)]))).chunk(2)
            ctx = [[torch.cat([null, null_img], 1), torch.cat([text[k:k + 1], img_emb], 1)]
                   for k in range(tasks)]
            return c, ctx

        for mode in modes:
            with (R.fp8() if mode else contextlib.nullcontext()):
                c_ref, ctx_ref = conditions()
            if mode is None:
                ref = (c_ref, ctx_ref)
                gap = 0.0
                for k in range(tasks):
                    p = program(k, steps[0])
                    gap = max(gap, _rel(p["x"][0][idx][..., shape[-1]:], c_ref),
                              *(_rel(p["context"][j], ctx_ref[k][j][0]) for j in range(variants)))
                out["cond_gap"] = gap
            else:
                out["cond_gap.fp8_control"] = max(
                    _rel(c_ref, ref[0]), *(_rel(ctx_ref[k][j], ref[1][k][j])
                                           for k in range(tasks) for j in range(variants)))

        # the UNet on the program's own inputs: at the last step every row
        # of its batch, at the other checked steps one task drawn from the
        # seed for each guidance variant
        gap = 0.0
        last = mix["steps"] - 1
        for step in steps:
            for var in range(variants):
                for task in (range(tasks) if step == last else [int(rng.integers(tasks))]):
                    p = program(task, step)
                    v_ref = R.unet(P, u, p["x"][var:var + 1].float(), p["t"][var:var + 1],
                                   p["context"][var:var + 1].float(), p["label"][var:var + 1],
                                   p["fs"][var:var + 1])[0]
                    rms = float((p["v"][var].float() - v_ref).square().mean().sqrt())
                    gap = max(gap, rms)
                    detail["unet"].append(
                        (step, task, var, round(rms, 6), round(_rel(p["v"][var], v_ref), 5),
                         round(float(v_ref.std()), 4)))
        out["unet_gap"] = gap

        # the last update, from the program's predictions
        const = RS.ddim_constants(cfg, mix["steps"], mix["eta"])[-1]

        def update(p, n, zero=False):
            g = RS.guide(R.lowered(p["v"].float()), mix["cfg_scale"], mix.get("cfg_img"),
                         mix["guidance_rescale"])
            z0 = R.lowered(RS.ddim_update(R.lowered(p["x"][0, ..., :shape[-1]].float()),
                                          0 * g if zero else R.lowered(g), const, n))
            return R.lowered(R.vae_post_quant(P, v, z0))

        def decoder_input(task):
            return torch.cat(calls[0]["decoder"])[task * video:(task + 1) * video]

        for mode in modes:
            gap = 0.0
            for task in range(tasks):
                p = program(task, last)
                n = noise[-1][task]
                h_ref, h_zero = update(p, n), update(p, n, zero=True)
                if mode is None:
                    h_p = decoder_input(task).float()
                else:
                    with R.fp8():
                        h_p = update(p, n)
                moved = (h_ref - h_zero).norm().clamp_min(1e-30)
                gap = max(gap, float((h_p - h_ref).norm() / moved))
            out["step_gap" + ("" if mode is None else f".{mode}_control")] = gap

        # the decoder on the program's inputs, one task drawn
        task = int(rng.integers(tasks))
        h_p = decoder_input(task).float()
        dec = lambda h: R.vae_decoder(P, v, h)   # noqa: E731
        ref_clip = _frames(dec, h_p).clamp(-1.0, 1.0)
        out["decode_gap"] = _rel(torch.as_tensor(record["clip"][task], device=device), ref_clip)
        if control is not None:
            with R.fp8():
                out["decode_gap.fp8_control"] = _rel(_frames(dec, h_p).clamp(-1.0, 1.0), ref_clip)
    del P
    return _control_in_place(out, detail), detail


def _control_in_place(out: dict, detail: dict) -> dict:
    """The control's readings ("<number>.fp8_control") in place of the
    program's, which go to the details."""
    for k in [k for k in out if k.endswith(".fp8_control")]:
        number = k[:-len(".fp8_control")]
        detail[number + ".program"] = out[number]
        out[number] = out.pop(k)
    return out


def _leaf_gaps(prog: dict, ref: dict, names, over=max) -> float:
    """Each leaf's gap of the program's norm from the reference's, against
    the larger of that leaf's reference norm and the median leaf's; the
    worst leaf's (or `over` the leaves)."""
    names = list(names)
    med = float(np.median([ref[n] for n in names]))
    return float(over([abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names]))


def train(cfg: dict, mix: dict, seed: int, record: dict, ids, null, device,
          control: str | None = None) -> dict:
    """The training numbers of the first steps, which the reference follows
    from the seeded weights with the same batches and replayed draws:

      loss_gap    the relative gap of the first step's loss;
      grad_gap    the first gradient as the optimizer got it (clipped),
                  per leaf by its norm: the worst leaf's gap of norms;
      change_gap  each leaf's change over the steps by its norm: the median
                  leaf's gap; leaves whose reference gradient is under a
                  thousandth of the median leaf's (moved by round-off alone
                  under Adam) left out.

    The later steps' losses and the worst leaf's change go to the details,
    uncompared until they are read on the card against this reference.
    Where the mix computes in bf16 over fp32 masters, the reference uses
    each weight as the program's forward does, rounded to bf16 (the
    gradient passing through to the fp32 master): Adam's first update of
    about the learning rate (1e-5) per element rounds away on most bf16
    weights, and a reference on the unrounded masters sees the whole of it
    (PERF.md).

    control "fp8": every number read with the reference in fp8 in the
    program's place. Returns (numbers, the readings behind them)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    v = cfg["vae"]
    f = 2 ** (len(v["ch_mult"]) - 1)
    tc = dict(learning_rate=1.0e-5, weight_decay=0.01, beta1=0.9, beta2=0.999, grad_clip=0.5)
    runs = {"": None} if control is None else {"": None, ".fp8_control": "fp8"}
    out, detail = {}, {}
    ref = None
    for suffix, mode in runs.items():
        with (R.fp8() if mode else contextlib.nullcontext()):
            got = _train_reference(cfg, mix, seed, record, null, device, tc, f)
        if mode is None:
            ref = got
            prog = {"losses": record["losses"], "first": record["first_grad"],
                    "change": record["change"]}
        else:
            prog = got
        moved = [n for n in ref["first"] if ref["first"][n] >= 1e-3 * float(
            np.median(list(ref["first"].values())))]
        out["loss_gap" + suffix] = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
        med_g = float(np.median(list(ref["first"].values())))
        med_c = float(np.median([ref["change"][n] for n in moved]))
        worst_g = sorted(ref["first"], key=lambda n: -abs(prog["first"][n] - ref["first"][n])
                         / max(ref["first"][n], med_g))[:3]
        worst_c = sorted(moved, key=lambda n: -abs(prog["change"][n] - ref["change"][n])
                         / max(ref["change"][n], med_c))[:3]
        detail["train" + suffix] = {
            "later_losses_gap": max(abs(a - b) / abs(b) for a, b in
                                    zip(prog["losses"][1:], ref["losses"][1:])),
            "worst_change_gap": _leaf_gaps(prog["change"], ref["change"], moved),
            "losses": [prog["losses"], ref["losses"]], "median_grad": med_g,
            "median_change": med_c, "moved": len(moved), "leaves": len(ref["first"]),
            "worst_grad": [(n, prog["first"][n], ref["first"][n]) for n in worst_g],
            "worst_change": [(n, prog["change"][n], ref["change"][n]) for n in worst_c]}
        out["grad_gap" + suffix] = _leaf_gaps(prog["first"], ref["first"], ref["first"])
        out["change_gap" + suffix] = _leaf_gaps(prog["change"], ref["change"], moved, np.median)
    return _control_in_place(out, detail), detail


def _train_reference(cfg, mix, seed, record, null, device, tc, f):
    """The reference's losses, first clipped gradient norms and changes by
    leaf over the recorded steps."""
    import torch

    from ..reference import train as RT

    P = {k: t.float() for k, t in weights.make(R.param_shapes(cfg), seed, device).items()}
    params = {n: p.requires_grad_() for n, p in P.items() if n.startswith(RT.TRAINABLE)}
    start = {n: p.detach().clone() for n, p in params.items()}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    tables = RT.train_tables(cfg, device)
    with torch.no_grad():
        null_emb = R.text_encode(P, cfg["clip_text"], torch.as_tensor(null, device=device)[None])
    gen = torch.Generator(device=device)
    losses, first = [], {}
    accum = mix["accum_steps"]
    for i, batch in enumerate(record["batches"]):
        gen.set_state(record["states"][i])
        # the frozen weights are drawn in bf16 (weights.make), so exact there
        used = P if mix["dtype"] != "bf16" else {
            n: p + (p.detach().to(torch.bfloat16).float() - p.detach()) if n in params else p
            for n, p in P.items()}
        total = 0.0
        for j in range(accum):
            mb = {k: a[j] for k, a in batch.items()} if accum > 1 else batch
            b, t = mb["dense_frames"].shape[:2]
            d = RT.draws(cfg, b, t, cfg["height"] // f, cfg["width"] // f, gen)
            for s in range(b):
                loss = RT.sample_loss(used, cfg, mb, d, tables, s, null_emb)
                loss.backward()
                total += float(loss.detach())
        grads = {n: p.grad / accum for n, p in params.items()}
        with torch.no_grad():
            gnorm = RT.adamw_step(params, grads, mu, nu, i + 1, tc)
            if i == 0:
                scale = tc["grad_clip"] / gnorm if not gnorm < tc["grad_clip"] else 1.0
                first = {n: float(g.norm()) * scale for n, g in grads.items()}
        for p in params.values():
            p.grad = None
        del used
        losses.append(total / accum)
    change = {n: float((p.detach() - start[n]).norm()) for n, p in params.items()}
    return {"losses": losses, "first": first, "change": change}
