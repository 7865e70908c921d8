"""The ranks of the multi-process tests (tests/test_torch_parallel*.py).

`spawn` starts `world` processes with torch.multiprocessing, each joining a
gloo group through a FileStore under the test's tmp_path (no TCP port, so
xdist workers cannot collide), runs fn(rank, world, *args) and returns each
rank's result. Every collective has the group's timeout, and the processes
are joined with a deadline and killed on it: a hang fails one test, never
the suite. The ranks import torch and the port only (no JAX compile in a
spawned rank): the single-process results they are held to are made by the
test process on the same weights and inputs, and the port's single-process
path is held against JAX by the parity tests.
"""
from __future__ import annotations

import dataclasses
import datetime
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEADLINE = 120   # seconds for one spawn, and each collective's timeout (a few times a spawn's ~40 s under a loaded tier-1 run)


def _rank_main(rank, fn, world, store, deadline, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=deadline))
    try:
        out = fn(rank, world, *args)
        torch.save(out, f"{store}.out{rank}")
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args, deadline: int = DEADLINE):
    """[fn(rank, world, *args) for each rank], run in `world` processes."""
    store = str(tmp_path / f"store_{fn.__name__}_{world}")
    ctx = mp.start_processes(_rank_main, args=(fn, world, store, deadline, args), nprocs=world,
                             join=False, start_method="spawn")
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=max(0.5, end - time.monotonic())):
            if time.monotonic() >= end:
                raise TimeoutError(f"{fn.__name__} at {world} ranks: no end in {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(f"{store}.out{r}", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# The tiny model, inputs and single-process results
# ---------------------------------------------------------------------------

B, T, H, W = 2, 4, 16, 16      # the global training batch: 2 clips of 4 frames, 16x16
LR = 1e-3


def tiny_cfg():
    """The tiny preset with dropout off."""
    from mudg_tpu_torch.models import presets as P

    c = P.tiny()
    return dataclasses.replace(c, unet=dataclasses.replace(c.unet, dropout=0.0))


def tiny_mdm(seed=3):
    """The tiny MDM in fp32, every zero-initialised layer made non-zero so
    that every path of the UNet moves its output."""
    from mudg_tpu_torch.models import mdm as M

    mdm = M.init_mdm(tiny_cfg(), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in mdm.unet.parameters():
            if not p.abs().max():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return mdm


def train_batch(accum=2, b=B):
    """A pixel-form batch (accum, b, T, H, W, 3) from a numpy seed."""
    rng = np.random.default_rng(5)

    def video():
        return torch.from_numpy(rng.uniform(-1, 1, (accum, b, T, H, W, 3)).astype(np.float32))

    return dict(dense_frames=video(), sparse_frames=video(), sparse_depth=video(),
                tokens=torch.from_numpy(rng.integers(0, 49408, (accum, b, 77))).long(),
                class_label=torch.from_numpy(rng.integers(0, 3, (accum, b))).long())


def train_draws(accum=2, b=B):
    """Each microbatch's draws at the global batch, from a seeded generator."""
    from mudg_tpu_torch.models import mdm as M

    cfg, gen = tiny_cfg(), torch.Generator().manual_seed(11)
    mb = {k: v[0] for k, v in train_batch(accum, b).items()}
    return [M.draw_training_noise(cfg, M.training_shapes(cfg, mb), gen) for _ in range(accum)]


def unet_inputs(b=2, t=T, h=H, w=W):
    """UNet inputs at a (b, t, h, w) latent from a numpy seed."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((b, t, h, w, 12)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((b, 77 + t * 2, 16)).astype(np.float32))
    ts = torch.tensor([3, 700, 250, 999][:b])
    return x, ts, ctx


def run_step(mdm, state, impl, accum=2, batch=None, draws=None, remat="dots_attn"):
    """One optimizer step of `state` (ZeRO-free or laid over ranks) on the
    global batch's rows this rank holds, with the global draws."""
    from mudg_tpu_torch.parallel import mesh as PM
    from mudg_tpu_torch.train import step as TS

    tc = TS.TrainConfig(learning_rate=LR, accum_steps=accum, use_ema=True)
    batch = train_batch(accum) if batch is None else batch
    if state.layout is not None:
        batch = PM.shard_batch(batch, state.layout.mesh, "data", dim=1)
    step = TS.make_train_step(mdm, tc, torch.arange(77), impl=impl, remat=remat,
                              compute_dtype=torch.float32)
    state, m = step(state, batch, torch.Generator().manual_seed(9),
                    train_draws(accum) if draws is None else draws)
    return state, {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def whole_state(state) -> dict:
    """params, mu, nu and ema of a state as whole tensors (gathered from
    the ranks' parts: every rank calls this alike)."""
    lay = state.layout
    out = {}
    for kind in ("params", "mu", "nu", "ema"):
        tree = getattr(state, kind)
        out[kind] = {n: (t.detach().clone() if lay is None else lay.full(kind, n, t))
                     for n, t in tree.items()}
    return out


def single_step(impl):
    """The single-process step: its metrics and its state, whole."""
    from mudg_tpu_torch.train import step as TS

    mdm = tiny_mdm()
    state = TS.init_train_state(mdm, TS.TrainConfig(learning_rate=LR, use_ema=True))
    state, m = run_step(mdm, state, impl)
    return m, whole_state(state)


def state_errors(got: dict, ref: dict) -> dict:
    """max|diff| per kind, over its leaves."""
    return {k: max(float((got[k][n] - ref[k][n]).abs().max()) for n in ref[k]) for k in ref}


def rel_err(y, ref) -> float:
    return float((y - ref).abs().max()) / float(ref.abs().max())


# ---------------------------------------------------------------------------
# The ranks' checks
# ---------------------------------------------------------------------------

def _step_check(state_fn, impl, ref, remat="dots_attn"):
    """The rank's step of state_fn(mdm) against the single-process `ref`."""
    mdm = tiny_mdm()
    state = state_fn(mdm)
    state, m = run_step(mdm, state, impl, remat=remat)
    got = whole_state(state)
    dtensors = sum(hasattr(p, "to_local") for p in state.params.values())
    scale = {k: max(float(t.abs().max()) for t in v.values()) for k, v in ref[1].items()}
    return {"metrics": m, "errors": state_errors(got, ref[1]), "scale": scale,
            "ref_metrics": ref[0], "dtensor_params": dtensors, "layout": state.layout}


def _summary(out):
    lay = out.pop("layout")
    out["zero_leaves"] = len(lay.zero)
    out["fsdp_leaves"] = len(lay.fsdp_dims)
    out["tp_leaves"] = len(lay.tp)
    return out


def checks_world2(rank, world, refs):
    """DP with ZeRO-2, FSDP, SP and TP train steps and the TP forward at 2
    ranks, each against the single-process result in `refs`; the naive
    GEGLU split's TP forward."""
    from mudg_tpu_torch.parallel import mesh as PM
    from mudg_tpu_torch.parallel import sp as SP
    from mudg_tpu_torch.parallel import tp as TP
    from mudg_tpu_torch.train import step as TS

    refs = torch.load(refs, weights_only=False)
    tc = TS.TrainConfig(learning_rate=LR, use_ema=True)
    res = {}
    dp = PM.Mesh([2], ("data",))
    res["dp"] = _summary(_step_check(
        lambda m: TS.place_train_state(m, tc, dp), "train", refs["train"]))
    res["fsdp"] = _summary(_step_check(
        lambda m: TS.place_train_state(m, tc, dp, fsdp=True), "train", refs["train"]))
    seq = PM.Mesh([1, 2], ("data", "seq"))
    res["sp_step"] = _summary(_step_check(
        lambda m: TS.place_train_state(m, tc, seq, sp=SP.make_seq_sharding(seq)), "plain",
        refs["plain"]))
    res["sp_fsdp_step"] = _summary(_step_check(
        lambda m: TS.place_train_state(m, tc, seq, fsdp=True, axis="seq",
                                       sp=SP.make_seq_sharding(seq)), "plain", refs["plain"]))
    model = PM.Mesh([1, 2], ("data", "model"))
    res["tp_step"] = _summary(_step_check(
        lambda m: TS.place_train_state(m, tc, model, tp_axis="model"), "plain", refs["plain"]))
    # the policy that keeps every op of a block: TP's collectives replay in step
    res["tp_step_except_ff"] = _summary(_step_check(
        lambda m: TS.place_train_state(m, tc, model, tp_axis="model"), "plain", refs["plain"],
        remat="except_ff"))
    # and FSDP2's gathers, which the replay does not repeat, kept out of it
    res["fsdp_step_except_ff"] = _summary(_step_check(
        lambda m: TS.place_train_state(m, tc, dp, fsdp=True), "train", refs["train"],
        remat="except_ff"))
    x, ts, ctx = unet_inputs()
    with torch.no_grad():
        unet = tiny_mdm().unet
        TP.shard_unet_tp(unet, model, "model")
        res["tp_fwd"] = rel_err(unet(x, ts, ctx, c_label=ts, impl="plain"), refs["fwd"])
        naive = TP.geglu_rows
        TP.geglu_rows = lambda total, n, i: torch.arange(*PM.block(total, n, i))
        try:
            unet = tiny_mdm().unet
            TP.shard_unet_tp(unet, model, "model")
            res["fault_naive_geglu"] = rel_err(unet(x, ts, ctx, c_label=ts, impl="plain"),
                                               refs["fwd"])
        finally:
            TP.geglu_rows = naive
    res["replicated_for_heads"] = TP.replicated_for_heads(tiny_mdm().unet, 2)
    return res


def checks_world4(rank, world, refs):
    """SP forwards at 4 ranks on the explicit path and on the all-gather
    fallback, its planted faults, a 2-step sample under SP, the TP forward
    at 4 model ranks (whole heads), and data 2 x model 2 with FSDP's train
    step, each against the single-process result in `refs`."""
    from mudg_tpu_torch.parallel import mesh as PM
    from mudg_tpu_torch.parallel import sp as SP
    from mudg_tpu_torch.parallel import tp as TP
    from mudg_tpu_torch.train import step as TS

    refs = torch.load(refs, weights_only=False)
    res = {}
    seq = PM.Mesh([4], ("seq",))
    sp = SP.make_seq_sharding(seq)
    unet = tiny_mdm().unet
    with torch.no_grad():
        for name, shape in (("explicit", (2, T, H, W)), ("fallback", FALLBACK)):
            x, ts, ctx = unet_inputs(*shape)
            res["sp_fwd_" + name] = rel_err(unet(x, ts, ctx, c_label=ts, impl="plain", sp=sp),
                                            refs["fwd_" + name])
        x, ts, ctx = unet_inputs()
        stats = SP.stats_sum
        SP.stats_sum = lambda sp: None
        try:
            res["fault_gn_unreduced"] = rel_err(
                unet(x, ts, ctx, c_label=ts, impl="plain", sp=sp), refs["fwd_explicit"])
        finally:
            SP.stats_sum = stats
        order = SP._concat_order
        SP._concat_order = lambda n: list(range(n))[::-1]
        try:
            res["fault_concat_reversed"] = rel_err(
                unet(x, ts, ctx, c_label=ts, impl="plain", sp=sp), refs["fwd_explicit"])
        finally:
            SP._concat_order = order
        res["sp_sample"] = rel_err(sample(tiny_mdm(), sp), refs["sample"])
        model4 = PM.Mesh([4], ("model",))
        unet = tiny_mdm().unet
        TP.shard_unet_tp(unet, model4, "model")
        res["tp4_fwd"] = rel_err(unet(x, ts, ctx, c_label=ts, impl="plain"), refs["fwd_explicit"])
        res["tp4_replicated"] = TP.replicated_for_heads(tiny_mdm().unet, 4)
    grid = PM.Mesh([2, 2], ("data", "model"))
    tc = TS.TrainConfig(learning_rate=LR, use_ema=True)
    res["tp_fsdp_step"] = _summary(_step_check(
        lambda m: TS.place_train_state(m, tc, grid, fsdp=True, tp_axis="model"), "plain",
        refs["plain"]))
    dp4 = PM.Mesh([2, 2], ("data", "seq"))
    res["dp_sp_step"] = _summary(_step_check(
        lambda m: TS.place_train_state(m, tc, dp4, sp=SP.make_seq_sharding(dp4)),
        "plain", refs["plain"]))
    return res


FALLBACK = (1, 3, 16, 12)   # B*T = 3 and W = 12, 6: the all-gather path at 4 ranks


def sample(mdm, sp=None):
    """A 2-step fp32 `sample` of one seeded clip (pixels, token ids)."""
    from mudg_tpu_torch.models import mdm as M

    rng = np.random.default_rng(7)

    def video():
        return torch.from_numpy(rng.uniform(-1, 1, (1, T, H, W, 3)).astype(np.float32))

    return M.sample(mdm, generator=torch.Generator().manual_seed(2), sparse_frames=video(),
                    sparse_depth=video(), tokens=torch.arange(77)[None],
                    null_tokens=torch.zeros(77, dtype=torch.int64),
                    class_label=torch.tensor([1]), num_steps=2, impl="plain", sp=sp)


def make_refs(path: str, world: int) -> str:
    """The single-process results the ranks of `checks_world<world>` are
    held to, saved to `path`."""
    x, ts, ctx = unet_inputs()
    refs = {"plain": single_step("plain")}
    with torch.no_grad():
        unet = tiny_mdm().unet
        refs["fwd"] = refs["fwd_explicit"] = unet(x, ts, ctx, c_label=ts, impl="plain")
        if world == 2:
            refs["train"] = single_step("train")
        else:
            x, ts, ctx = unet_inputs(*FALLBACK)
            refs["fwd_fallback"] = unet(x, ts, ctx, c_label=ts, impl="plain")
            refs["sample"] = sample(tiny_mdm())
    torch.save(refs, path)
    return path


def run_apps(rank, world, runs):
    """Each (argv, writes-to-count) of `runs` through `python -m
    mudg_tpu_torch`'s main on every rank; returns per run the exit code and
    the number of files this rank wrote through the savers and torch.save."""
    import mudg_tpu_torch.__main__ as entry
    from mudg_tpu_torch.train import checkpoint as C
    from mudg_tpu_torch.utils import media

    counts = {"n": 0}

    def counted(fn):
        def wrapper(*a, **k):
            counts["n"] += 1
            return fn(*a, **k)
        return wrapper

    media.save_image = counted(media.save_image)
    media.save_video = counted(media.save_video)
    C.save = counted(C.save)
    out = []
    for argv in runs:
        counts["n"] = 0
        try:
            rc = entry.main(list(argv))
        except SystemExit as e:
            rc = e.code
        out.append({"rc": rc, "writes": counts["n"]})
    return out

