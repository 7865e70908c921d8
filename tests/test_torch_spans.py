"""The program's spans (`mudg_tpu_torch/utils/profiling.span`) over one served
window of the tiny MDM on the CPU: off, the shared null context and no
range; on under a torch profiler, one `mudg.` range per span, nested as the
serving path nests them and counted per sampler step, UNet call and VAE
frame; on without a profiler, the totals alone. No JAX."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mudg_tpu_torch.apps import render_infer as RI
from mudg_tpu_torch.models import mdm as M
from mudg_tpu_torch.models import presets
from mudg_tpu_torch.nn import unet3d as U
from mudg_tpu_torch.utils import profiling as P

T, H, W, STEPS = 4, 16, 16, 2
TASKS = len(RI.TASKS)


@pytest.fixture(scope="module")
def tiny():
    """The tiny MDM (one VAE frame a call, as the served configs) and one
    3-task window."""
    torch.manual_seed(0)
    cfg = dataclasses.replace(presets.tiny(), vae_chunk=1)
    mdm = M.MDM(cfg).eval()
    rng = np.random.default_rng(0)
    window = {"sparse_frames": rng.uniform(-1, 1, (T, H, W, 3)).astype(np.float32),
              "frame0": rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
              "sparse_depth": rng.uniform(-1, 1, (T, H, W, 3)).astype(np.float32),
              "class_labels": np.array([0, 500, 1], np.int32)}
    return cfg, mdm, window


@pytest.fixture
def spans():
    P.reset_spans()
    yield
    P.enable_spans(False)
    P.reset_spans()


def serve_window(mdm, window):
    """One window through render_windows, the guided DDIM sampler in fp32."""
    ids = torch.randint(0, mdm.cfg.clip_text.vocab_size, (TASKS, 77))
    loop = RI.render_windows(mdm, RI.build_sampler(steps=STEPS, dtype=torch.float32), [window],
                             tokens=ids, null_tokens=ids[0], video_length=T,
                             generator=torch.Generator().manual_seed(1))
    (_, _, out), = list(loop)
    assert out.shape == (TASKS, T, H, W, 3) and np.isfinite(out).all()


def profiled_window(mdm, window):
    """The window under a CPU torch.profiler: the `mudg.` ranges, each as
    (name, start ns, end ns)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve_window(mdm, window)
    return sorted((e.name()[len(P.PREFIX):], e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation() and e.name().startswith(P.PREFIX))


def nesting_paths(ranges):
    """Each range's nesting path ("render.sample/sampler.step/unet"), from
    which ranges hold it in time."""
    paths, open_ = [], []
    for name, start, end in sorted(ranges, key=lambda r: (r[1], -r[2])):
        while open_ and open_[-1][1] < end:
            open_.pop()
        path = f"{open_[-1][0]}/{name}" if open_ else name
        paths.append(path)
        open_.append((path, end))
    return paths


def expected_counts(cfg):
    """Span path -> count of one window: 2 towers' text calls (condition and
    null), one image pass, the VAE per frame (color and depth encoded, the
    clip decoded, each task's T frames), one UNet call a step."""
    inp, mid, out = U.block_plan(cfg.unet)
    layers = [lt for block in (*inp, mid, *out) for lt, _ in block]
    sample, unet = "render.sample", "render.sample/sampler.step/unet"
    return {
        "render.upload": 1, sample: 1, "render.to_host": 1,
        f"{sample}/vae.encode": 2 * TASKS * T, f"{sample}/vae.decode": TASKS * T,
        f"{sample}/clip_text": 2, f"{sample}/clip_image": 1, f"{sample}/image_proj": 1,
        f"{sample}/sampler.step": STEPS, unet: STEPS,
        f"{unet}/unet.res": STEPS * layers.count("res"),
        f"{unet}/unet.spatial": STEPS * layers.count("spatial"),
        f"{unet}/unet.temporal": STEPS * (layers.count("temporal") + 1),   # + init_attn
        f"{unet}/unet.resample": STEPS * (layers.count("down") + layers.count("up")),
    }


def test_spans_off_open_nothing(tiny, spans):
    """Off, every span is one shared null context: the window leaves no
    `mudg.` range in the profiler's trace and no totals."""
    _, mdm, window = tiny
    assert P.span("unet") is P.span("kernel.geglu_ff") is P.span("vae.decode")
    assert profiled_window(mdm, window) == []
    assert P.span_totals() == {}


def test_spans_nest_and_count_under_the_profiler(tiny, spans):
    """On under the profiler: a range per span, nested as the totals' paths
    say, with the counts of the window's steps, UNet calls and VAE frames."""
    cfg, mdm, window = tiny
    P.enable_spans(True)
    ranges = profiled_window(mdm, window)
    P.enable_spans(False)
    totals = P.span_totals()
    counted = {path: t["count"] for path, t in totals.items()}
    assert counted == expected_counts(cfg)
    paths = nesting_paths(ranges)
    assert {p: paths.count(p) for p in paths} == counted
    assert all(t["ns"] > 0 for t in totals.values())
    step = totals["render.sample/sampler.step"]["ns"]
    assert totals["render.sample/sampler.step/unet"]["ns"] < step < totals["render.sample"]["ns"]


def test_spans_without_a_profiler_keep_totals_only(tiny, spans, monkeypatch):
    """On with no profiler recording: totals, and no range opened."""
    cfg, mdm, window = tiny

    def no_range(name):
        raise AssertionError(f"a range {name!r} opened with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    P.enable_spans(True)
    serve_window(mdm, window)
    P.enable_spans(False)
    assert {p: t["count"] for p, t in P.span_totals().items()} == expected_counts(cfg)
    P.reset_spans()
    assert P.span_totals() == {}


def test_spans_open_in_the_remat_replay(tiny, spans):
    """Under remat's except_ff policy, which keeps every op's output for the
    replay, the profiler's ranges still open in the replay: each ResBlock
    span's range appears in the forward and again in the backward."""
    cfg, mdm, _ = tiny
    u = cfg.unet
    x = torch.randn(1, T, H // 2, W // 2, u.in_channels)
    context = torch.randn(1, u.text_context_len + T * u.image_tokens_per_frame, u.context_dim)
    label = torch.zeros(1, dtype=torch.long)
    P.enable_spans(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = mdm.unet(x, torch.tensor([500]), context, c_label=label, impl="train",
                     remat="except_ff")
        y.square().mean().backward()
    mdm.zero_grad(set_to_none=True)
    res = sum(1 for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation() and e.name() == P.PREFIX + "unet.res")
    inp, mid, out = U.block_plan(u)
    assert res == 2 * sum(lt == "res" for block in (*inp, mid, *out) for lt, _ in block)


def test_every_kernel_wrapper_opens_its_span():
    """Each of the 14 kernels of `kernels.KERNELS` opens `kernel.<name>`
    once in its module, around the call into the library (the card test
    test_small_unet_kernel_spans_hold_every_port_kernel counts them)."""
    import inspect

    from mudg_tpu_torch import kernels as K

    for name, (mod, _) in K.KERNELS.items():
        assert inspect.getsource(mod).count(f'profiling.span("kernel.{name}")') == 1, name
